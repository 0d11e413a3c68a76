// The per-keypoint body of the describe kernels: one block samples one
// keypoint's window and bins it into its unnormalised descriptor row.
// Included by describe.cu (kernel B: any step, one frame or a stack of
// frames) and describe_step.cu (the static-step kernel), so that all of
// them do the same arithmetic in the same order and their rows for one
// keypoint are equal bit for bit.
//
// The sample geometry follows ops/descriptor.py:_describe_chunk: window
// |i|,|j| <= iradius on the image-aligned grid, the bilinear cell
// coordinates rx/cx in (-1, 4) of the grid offset turned by the
// keypoint's orientation (sine, cose; computed by the wrapper with
// torch.sin / torch.cos, so kernel and twin share them), frame borders
// with the iscale margin, clamped reads, the Gaussian weight
// exp(-(trunc(r^2)+0.5)/8) taken from a 40-entry table the wrapper
// computes with the twin's own expression, the responses turned by the
// orientation, then bilinear binning into 4x4 cells x 4 channels [dx<0,
// dx>=0, dy<0, dy>=0], or 8 when extended (dx and |dx| split by the sign
// of the unturned dy, dy and |dy| by that of the unturned dx).  Products
// are written with __fmul_rn & co. in the twin's order so that nvcc
// contracts nothing.
//
// Determinism: every thread bins its samples into its own column of
// shared memory (acc[bin][thread], conflict-free), and the bins are then
// summed over the threads in a fixed order.  No float atomics, so the rows
// repeat bit for bit run to run.  acc holds 64 bins x 128 threads, or 128
// bins x 64 threads when extended: 32 KB either way, under the 48 KB a
// block gets without opting in to dynamic shared memory.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ int ii_at(const int* __restrict__ ii, int iw, int y,
                                     int x) {
  return __ldg(ii + y * iw + x);
}

// box_sum (getSum, surfd.cu:334-343): cols [x2..x1], rows [y2..y1]
__device__ __forceinline__ int box_sum(const int* __restrict__ ii, int iw,
                                       int x1, int y1, int x2, int y2) {
  return ((ii_at(ii, iw, y1 + 1, x1 + 1) + ii_at(ii, iw, y2, x2))
          - ii_at(ii, iw, y2, x1 + 1)) - ii_at(ii, iw, y1 + 1, x2);
}

template <int OSZ>
__host__ __device__ constexpr int desc_threads() { return OSZ == 8 ? 64 : 128; }

// All threads of the block write zeros to an invalid slot's row.
template <int OSZ>
__device__ __forceinline__ void zero_row(float* __restrict__ out_row) {
  for (int b = threadIdx.x; b < 16 * OSZ; b += desc_threads<OSZ>())
    out_row[b] = 0.f;
}

// One keypoint's row, by the whole block.  `ii` is the keypoint's own
// (ih, iw) frame.  SD > 0 fixes the sampling step at compile time (the
// static-step kernel); SD == 0 takes `step_rt`.
template <bool UPRIGHT, int OSZ, int SD>
__device__ __forceinline__ void describe_row(
    const int* __restrict__ ii, int ih, int iw, int ix, int iy, int step_rt,
    int s, int irad, float fracr, float fracc, float spacing, float sine,
    float cose, const float* __restrict__ wtab, float* __restrict__ out_row) {
  constexpr int BINS = 16 * OSZ;
  constexpr int THREADS = desc_threads<OSZ>();
  __shared__ float acc[BINS][THREADS];
  const int t = threadIdx.x;
  const int step = SD > 0 ? SD : step_rt;
  const float stepf = (float)step;

  for (int b = 0; b < BINS; ++b) acc[b][t] = 0.f;

  const int n = 2 * irad + 1;
  for (int q = t; q < n * n; q += THREADS) {
    const int i = q / n - irad;
    const int j = q % n - irad;
    const float fi = (float)i, fj = (float)j;
    float rpos, cpos;
    if constexpr (UPRIGHT) {
      rpos = __fdiv_rn(__fsub_rn(__fmul_rn(stepf, fi), fracr), spacing);
      cpos = __fdiv_rn(__fsub_rn(__fmul_rn(stepf, fj), fracc), spacing);
    } else {  // (step (cose i + sine j) - fracr) / spacing, ...
      rpos = __fdiv_rn(__fsub_rn(__fmul_rn(stepf, __fadd_rn(__fmul_rn(cose, fi),
                                                            __fmul_rn(sine, fj))),
                                 fracr), spacing);
      cpos = __fdiv_rn(__fsub_rn(__fmul_rn(stepf, __fadd_rn(__fmul_rn(-sine, fi),
                                                            __fmul_rn(cose, fj))),
                                 fracc), spacing);
    }
    const float rx = __fadd_rn(rpos, 1.5f);  // + (wsz/2 - 1/2)
    const float cx = __fadd_rn(cpos, 1.5f);
    if (!(rx > -1.f && rx < 4.f && cx > -1.f && cx < 4.f)) continue;
    const int r = iy + i * step;
    const int c = ix + j * step;
    if (r < 1 + s || r >= ih - 1 - s || c < 1 + s || c >= iw - 1 - s) continue;

    const float widx = truncf(__fadd_rn(__fmul_rn(rpos, rpos), __fmul_rn(cpos, cpos)));
    const float weight = wtab[(int)fminf(fmaxf(widx, 0.f), 39.f)];
    const int rc = min(max(r, s), ih - s - 2);
    const int cc = min(max(c, s), iw - s - 2);
    // getWavelet2 / getWavelet1 (surfd.cu:1171-1182)
    const int wdx = box_sum(ii, iw, cc + s, rc + s, cc, rc - s)
                    - box_sum(ii, iw, cc, rc + s, cc - s, rc - s);
    const int wdy = box_sum(ii, iw, cc + s, rc, cc - s, rc - s)
                    - box_sum(ii, iw, cc + s, rc + s, cc - s, rc);
    const float dxx = __fmul_rn(__fmul_rn(weight, (float)wdx), 0.003921568627f);
    const float dyy = __fmul_rn(__fmul_rn(weight, (float)wdy), 0.003921568627f);
    float dx = dxx, dy = dyy;
    if constexpr (!UPRIGHT) {
      dx = __fadd_rn(__fmul_rn(cose, dxx), __fmul_rn(sine, dyy));
      dy = __fsub_rn(__fmul_rn(sine, dxx), __fmul_rn(cose, dyy));
    }
    // (channel, value) pairs this sample adds to each cell it touches
    constexpr int NV = OSZ / 2;
    int ch[NV];
    float val[NV];
    if constexpr (OSZ == 8) {
      const int oy = dyy < 0.f ? 0 : 1;  // dx, |dx| by the sign of dyy
      const int ox = dxx < 0.f ? 4 : 5;  // dy, |dy| by the sign of dxx
      ch[0] = oy;      val[0] = dx;
      ch[1] = oy + 2;  val[1] = fabsf(dx);
      ch[2] = ox;      val[2] = dy;
      ch[3] = ox + 2;  val[3] = fabsf(dy);
    } else {
      ch[0] = dx < 0.f ? 0 : 1;  val[0] = dx;
      ch[1] = dy < 0.f ? 2 : 3;  val[1] = dy;
    }

    // placeInIndex: bilinear into the 4x4 cells
    const float rfl = floorf(rx), cfl = floorf(cx);
    const float rfrac = __fsub_rn(rx, rfl), cfrac = __fsub_rn(cx, cfl);
    const int r0 = (int)rfl, c0 = (int)cfl;
    for (int a = 0; a < 2; ++a) {
      const int ra = r0 + a;
      if (ra < 0 || ra >= 4) continue;
      const float wr = a ? rfrac : __fsub_rn(1.f, rfrac);
      for (int b = 0; b < 2; ++b) {
        const int cb = c0 + b;
        if (cb < 0 || cb >= 4) continue;
        const float wc = b ? cfrac : __fsub_rn(1.f, cfrac);
        const int cell = (ra * 4 + cb) * OSZ;
#pragma unroll
        for (int e = 0; e < NV; ++e)
          acc[cell + ch[e]][t] = __fadd_rn(acc[cell + ch[e]][t],
                                           __fmul_rn(wr, __fmul_rn(wc, val[e])));
      }
    }
  }
  __syncthreads();
  for (int b = t; b < BINS; b += THREADS) {
    float sum = 0.f;
    for (int u = 0; u < THREADS; ++u) sum = __fadd_rn(sum, acc[b][u]);
    out_row[b] = sum;
  }
}
