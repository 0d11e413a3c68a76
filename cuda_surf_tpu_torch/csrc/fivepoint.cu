// Kernel E: the five-point minimal solver of the essential matrix, one warp
// a hypothesis, from the 5 correspondences to the 20 candidate matrices and
// their validity, in one launch for all the hypotheses of a call.
//
// Replaces no TPU kernel.  The JAX package's geometry/fivepoint.py:
// five_point is XLA-compiled jnp, one fused program; its port,
// cuda_surf_tpu_torch/geometry/fivepoint.py:_five_point_plain (the plain
// twin), is eager torch, and on the card each of its terms is a launch:
// about 9,900 of them for one call (the constraint matrix and det B(z) as
// some 2,000 single multiply-adds, 2 x 96 Durand-Kerner rounds of about 38
// operations, the Gauss-Newton polish), which held two thirds of a VO
// frame's host time.  This kernel exists to make that chain one launch.
//
// What bounds it on the H100: neither bytes (80 bytes in and 740 out a
// hypothesis) nor operations (about 0.4 MFLOP a hypothesis, 50 MFLOP for a
// RANSAC call of 128, under a microsecond at the float32 rate) but the
// dependent chain of the 96 Durand-Kerner rounds, each a product of ten
// complex differences, a Horner evaluation and a complex division that wait
// on the round before.  The design:
//
//   * one warp a hypothesis, 4 warps a block, no block barrier: a hypothesis
//     is independent of every other, and 128 hypotheses spread over 32 SMs;
//   * the small matrices live in the warp's shared memory (FpShared, 3 KB):
//     the 5x9 Gauss-Jordan and the Gram-Schmidt on lane 0 (short), the nine
//     quadratics of E E^T on lanes 0..8, the ten constraint rows on lanes
//     0..9, the 10x10 solve's LU on lanes 0..9 (a column each) and its
//     substitutions for the ten right-hand columns on lanes 10..19, B(z)
//     on lanes 0..2;
//   * Durand-Kerner runs the forward pass on lanes 0..9 and the reversed
//     pass on lanes 10..19, a root a lane, the pass's other roots read with
//     __shfl_sync each round, so a round costs one product of ten and one
//     Horner chain, not 38 launches; the Newton and Gauss-Newton polish and
//     the candidate matrix stay on the root's lane;
//   * nothing is allocated and nothing waits for the host: the wrapper
//     (geometry/fivepoint.py:five_point) allocates the outputs with
//     torch.empty and launches on torch's current stream.
//
// Arithmetic: csrc/fivepoint_body.cuh, which repeats the twin's operations
// and rounding; its head lists where the card's torch and cuBLAS kernels
// fix the order.

#include <cuda_runtime.h>
#include <math.h>

#include "fivepoint_body.cuh"

#define FP_WARPS 4   // hypotheses (warps) a block

__global__ void __launch_bounds__(FP_WARPS * 32)
    fivepoint_kernel(const float* __restrict__ x1,
                     const float* __restrict__ x2, int n, int gn_iters,
                     float* __restrict__ Es,
                     unsigned char* __restrict__ valid) {
  __shared__ FpShared shared[FP_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x * FP_WARPS + warp;
  if (h >= n) return;   // the whole warp leaves together
  fp_solve_one(x1 + h * 10, x2 + h * 10, gn_iters, Es + h * FP_SLOTS * 9,
               valid + h * FP_SLOTS, shared[warp], lane);
}

extern "C" int surf_fivepoint(const float* x1, const float* x2, int n,
                              int gn_iters, float* Es, unsigned char* valid,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + FP_WARPS - 1) / FP_WARPS;
  fivepoint_kernel<<<blocks, FP_WARPS * 32, 0, stream>>>(x1, x2, n, gn_iters,
                                                         Es, valid);
  return (int)cudaGetLastError();
}
