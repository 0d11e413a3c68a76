// Kernel B: unnormalised SURF descriptor rows, one block per keypoint, for
// every keypoint span: upright or rotated, 64-d or extended 128-d.
//
// Replaces two TPU kernels that compute the same rows and were split only
// by the TPU's VMEM budget:
//   cuda_surf_tpu/ops/patch_wavelets.py:_kernel_tiles_res (span <= 63) and
//   cuda_surf_tpu/ops/patch_bucketed.py:_kernel, mode="desc" (span > 63),
// including their shared per-keypoint body patch_common._emit_group_kp ->
// _bin_descriptor, whose rotated and extended branches
// (patch_common.py:147, 184-197, 284-300) are the templates' other three
// modes.  Plain twin: cuda_surf_tpu_torch/ops/descriptor.py:_describe_chunk.
//
// What bounds it on the H100: integral-image gathers.  A keypoint samples
// up to (2*22+1)^2 = 2025 grid points upright, (2*31+1)^2 = 3969 rotated
// (the window grows by 1.4 to hold the turned square), each reading 12 int32
// corners for its Haar dx/dy pair; the 4.9 MB integral image of a
// 1280x960 frame stays in L2, so the reads are L2 hits scattered by the
// sampling step.  The TPU needed int8 limb planes and selection matmuls
// because it has no fast gather; here each thread gathers its corners
// directly.  There is no span routing: one block per keypoint whatever its
// scale.
//
// Determinism: every thread bins its samples into its own column of
// shared memory (acc[bin][thread], conflict-free), and the bins are then
// summed over the threads in a fixed order.  No float atomics, so the rows
// repeat bit for bit run to run.  acc holds 64 bins x 128 threads, or 128
// bins x 64 threads when extended: 32 KB either way, under the 48 KB a
// block gets without opting in to dynamic shared memory.
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

// meta: int32 (6, K) rows [ix, iy, step, iscale, iradius, valid];
// fpar: f32 (5, K) rows [fracr, fracc, spacing, sine, cose], upright only
// the first 3; wtab: f32 (40,).
template <bool UPRIGHT, int OSZ>
__global__ void __launch_bounds__(desc_threads<OSZ>())
describe_kernel(const int* __restrict__ ii, int ih, int iw,
                const int* __restrict__ meta, const float* __restrict__ fpar,
                const float* __restrict__ wtab, int K, int R,
                float* __restrict__ out) {
  constexpr int BINS = 16 * OSZ;
  constexpr int THREADS = desc_threads<OSZ>();
  __shared__ float acc[BINS][THREADS];
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  if (!meta[5 * K + k]) {  // invalid slot: an all-zero row
    for (int b = t; b < BINS; b += THREADS) out[(size_t)k * BINS + b] = 0.f;
    return;
  }
  const int ix = meta[k], iy = meta[K + k], step = meta[2 * K + k];
  const int s = meta[3 * K + k];
  const int irad = min(meta[4 * K + k], R);
  const float fracr = fpar[k], fracc = fpar[K + k], spacing = fpar[2 * K + k];
  float sine = 0.f, cose = 1.f;
  if constexpr (!UPRIGHT) {
    sine = fpar[3 * K + k];
    cose = fpar[4 * K + k];
  }
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
    out[(size_t)k * BINS + b] = sum;
  }
}

template <bool UPRIGHT, int OSZ>
static int launch(const int* ii, int ih, int iw, const int* meta,
                  const float* fpar, const float* wtab, int K, int R,
                  float* out, cudaStream_t st) {
  describe_kernel<UPRIGHT, OSZ><<<K, desc_threads<OSZ>(), 0, st>>>(
      ii, ih, iw, meta, fpar, wtab, K, R, out);
  return (int)cudaGetLastError();
}

// out: (K, 16 * osz) rows; osz is 4, or 8 when extended.
extern "C" int surf_describe(const int* ii, int ih, int iw, const int* meta,
                             const float* fpar, const float* wtab, int K,
                             int R, int upright, int osz, float* out,
                             void* stream) {
  if (K <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (osz == 4)
    return upright ? launch<true, 4>(ii, ih, iw, meta, fpar, wtab, K, R, out, st)
                   : launch<false, 4>(ii, ih, iw, meta, fpar, wtab, K, R, out, st);
  if (osz == 8)
    return upright ? launch<true, 8>(ii, ih, iw, meta, fpar, wtab, K, R, out, st)
                   : launch<false, 8>(ii, ih, iw, meta, fpar, wtab, K, R, out, st);
  return (int)cudaErrorInvalidValue;
}
