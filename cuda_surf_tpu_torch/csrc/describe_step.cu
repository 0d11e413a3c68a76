// The static-step describe kernel: unnormalised descriptor rows for the
// keypoints of ONE sampling step SD, fixed at compile time, that a prefix
// sum has already placed in stable order into at most `cap` slots.
//
// Replaces cuda_surf_tpu/ops/patch_bucketed.py:_kernel_sdec (reached through
// _run_step_dec).  On the TPU a static step exists to decimate the integral
// image's rows into SD phase planes, so that the four row classes of the
// Haar stencil become contiguous slices and the row-selection matmul goes
// away; its planes, padding (P0, HQ), column windows (E_cw, c0) and limb
// counts have no counterpart here, because a thread gathers its corners
// directly.  What carries over is _run_step_dec's contract: of the
// keypoints with step == SD the first `cap` in index order are taken,
// rows are computed for those alone, and the rest is left to kernel B.  On
// Hopper a compile-time step gives constant index arithmetic (i * SD,
// (float)SD; little, since the upright body keeps it in its 2n-entry
// tables) and a compacted grid: block j works on keypoint sel[j], so no
// block past `count` does any sampling.
//
// The per-keypoint arithmetic is describe_body.cuh's, shared with kernel B
// (describe.cu), in the same order with the same thread count, so a taken
// keypoint's row equals kernel B's row for it bit for bit.
// Plain twin: cuda_surf_tpu_torch/ops/patch_wavelets.py:step_rows_plain.
//
// What bounds it on the H100: as kernel B, the instructions and L1 cache
// lines of a sample's 12 corner reads; with a few hundred keypoints per
// launch, mostly the launch itself.

#include "describe_body.cuh"

// meta (6, K) and fpar as kernel B's; sel: int32 (cap,), the taken
// keypoints' indices in order; count: int32 (1,) on the device, how many
// of sel's slots are filled; out: (cap + 1, 16 * osz), row j for sel[j],
// zero rows from `count` on (row `cap` is always zero: the wrapper
// gathers it for the keypoints that were not taken).
template <bool UPRIGHT, int OSZ, int SD>
__global__ void __launch_bounds__(desc_threads<UPRIGHT, OSZ>())
describe_step_kernel(const int* __restrict__ ii, int ih, int iw,
                     const int* __restrict__ meta,
                     const float* __restrict__ fpar,
                     const float* __restrict__ wtab, int K,
                     const int* __restrict__ sel,
                     const int* __restrict__ count, int cap, int R,
                     float* __restrict__ out) {
  const int j = blockIdx.x;
  float* out_row = out + (size_t)j * (16 * OSZ);
  if (j >= min(*count, cap)) {
    zero_row<OSZ>(out_row);
    return;
  }
  const int k = sel[j];
  float sine = 0.f, cose = 1.f;
  if constexpr (!UPRIGHT) {
    sine = fpar[3 * K + k];
    cose = fpar[4 * K + k];
  }
  describe_row<UPRIGHT, OSZ, SD>(
      ii, ih, iw, meta[k], meta[K + k], SD, meta[3 * K + k],
      min(max(meta[4 * K + k], 0), R), fpar[k], fpar[K + k], fpar[2 * K + k],
      sine, cose, wtab, out_row);
}

template <bool UPRIGHT, int OSZ, int SD>
static int launch(const int* ii, int ih, int iw, const int* meta,
                  const float* fpar, const float* wtab, int K, const int* sel,
                  const int* count, int cap, int R, float* out,
                  cudaStream_t st) {
  describe_step_kernel<UPRIGHT, OSZ, SD>
      <<<cap + 1, desc_threads<UPRIGHT, OSZ>(), 0, st>>>(
          ii, ih, iw, meta, fpar, wtab, K, sel, count, cap, R, out);
  return (int)cudaGetLastError();
}

template <int SD>
static int launch_mode(const int* ii, int ih, int iw, const int* meta,
                       const float* fpar, const float* wtab, int K,
                       const int* sel, const int* count, int cap, int R,
                       int upright, int osz, float* out, cudaStream_t st) {
  if (osz == 4)
    return upright
        ? launch<true, 4, SD>(ii, ih, iw, meta, fpar, wtab, K, sel, count, cap, R, out, st)
        : launch<false, 4, SD>(ii, ih, iw, meta, fpar, wtab, K, sel, count, cap, R, out, st);
  if (osz == 8)
    return upright
        ? launch<true, 8, SD>(ii, ih, iw, meta, fpar, wtab, K, sel, count, cap, R, out, st)
        : launch<false, 8, SD>(ii, ih, iw, meta, fpar, wtab, K, sel, count, cap, R, out, st);
  return (int)cudaErrorInvalidValue;
}

// sd: the static step, 4..8 (one instantiation each); any other value is
// refused.  The caller guarantees meta[2][sel[j]] == sd for j < count.
extern "C" int surf_describe_step(const int* ii, int ih, int iw,
                                  const int* meta, const float* fpar,
                                  const float* wtab, int K, const int* sel,
                                  const int* count, int cap, int sd, int R,
                                  int upright, int osz, float* out,
                                  void* stream) {
  if (K <= 0 || cap <= 0 || R < 0 || R > DESC_MAX_RADIUS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SURF_STEP_CASE(SD)                                                   \
  case SD:                                                                   \
    return launch_mode<SD>(ii, ih, iw, meta, fpar, wtab, K, sel, count, cap, \
                           R, upright, osz, out, st)
  switch (sd) {
    SURF_STEP_CASE(4);
    SURF_STEP_CASE(5);
    SURF_STEP_CASE(6);
    SURF_STEP_CASE(7);
    SURF_STEP_CASE(8);
  }
#undef SURF_STEP_CASE
  return (int)cudaErrorInvalidValue;
}
