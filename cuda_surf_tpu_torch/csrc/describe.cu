// Kernel B: unnormalised SURF descriptor rows, one block per keypoint, for
// every keypoint span: upright or rotated, 64-d or extended 128-d, over one
// frame's integral image or over a stack of B frames'.
//
// Replaces three TPU kernels that compute the same rows and were split only
// by the TPU's VMEM budget:
//   cuda_surf_tpu/ops/patch_wavelets.py:_kernel_tiles_res (span <= 63, one
//     frame, the image resident in VMEM),
//   cuda_surf_tpu/ops/patch_wavelets.py:_kernel_tiles (span <= 63, shared
//     tiles DMA'd from HBM: frames stacked with a per-keypoint row_base and
//     frame-local border tests) and
//   cuda_surf_tpu/ops/patch_bucketed.py:_kernel, mode="desc" (span > 63),
// including their shared per-keypoint body patch_common._emit_group_kp ->
// _bin_descriptor, whose rotated and extended branches
// (patch_common.py:147, 184-197, 284-300) are the templates' other three
// modes.  Plain twin: cuda_surf_tpu_torch/ops/descriptor.py:_describe_chunk.
// The per-keypoint arithmetic is in describe_body.cuh.
//
// What bounds it on the H100: instructions and the L1 pipe, not bytes.  A
// keypoint samples up to (2*22+1)^2 = 2025 grid points upright, (2*31+1)^2
// = 3969 rotated (the window grows by 1.4 to hold the turned square), each
// reading 12 int32 corners for its Haar dx/dy pair; the 4.9 MB integral
// image of a 1280x960 frame stays in L2 (eight stacked ones, 39 MB, still
// do; a doubled frame's is 19.7 MB), so the reads are L2 hits, but the
// lanes of a warp are a sampling step apart, so one read is several cache
// lines, and the arithmetic around a sample was several times the reads
// (describe_body.cuh says what the body does about both).  The TPU needed
// int8 limb planes and selection matmuls because it has no fast gather;
// here each thread gathers its corners directly.  There is no span
// routing: one block per keypoint slot whatever its scale, and a block of
// an invalid slot writes its zero row and ends.
//
// Frames stacked (surf_describe_stacked): the TPU kernel's tiles, levels
// and the relative bounds of tiles that straddle two frames have no
// counterpart.  What carries over is the contract: keypoint k reads only
// frame meta[6][k], at ii + frame * ih * iw (a size_t offset), its x, y and
// border tests are frame-local, and its row equals the row the single-frame
// call gives for the same keypoint on that frame alone.  A slot whose frame
// lies outside [0, nframes) is never dereferenced: it gets a zero row, as an
// invalid slot does.  The single-frame call is the frame = 0 case of the
// same kernel.

#include "describe_body.cuh"

// meta: int32 (6, K) rows [ix, iy, step, iscale, iradius, valid], and a
// seventh row [frame] when nframes > 0 (ii then holds nframes frames);
// fpar: f32 (5, K) rows [fracr, fracc, spacing, sine, cose], upright only
// the first 3; wtab: f32 (40,).  Block k works on slot k.
template <bool UPRIGHT, int OSZ>
__global__ void __launch_bounds__(desc_threads<UPRIGHT, OSZ>())
describe_kernel(const int* __restrict__ ii, int nframes, int ih, int iw,
                const int* __restrict__ meta, const float* __restrict__ fpar,
                const float* __restrict__ wtab, int K, int R,
                float* __restrict__ out) {
  const int k = blockIdx.x;
  float* out_row = out + (size_t)k * (16 * OSZ);
  const int frame = nframes > 0 ? meta[6 * K + k] : 0;
  if (!meta[5 * K + k] || frame < 0 || frame >= max(nframes, 1)) {
    zero_row<OSZ>(out_row);  // invalid slot: an all-zero row
    return;
  }
  float sine = 0.f, cose = 1.f;
  if constexpr (!UPRIGHT) {
    sine = fpar[3 * K + k];
    cose = fpar[4 * K + k];
  }
  describe_row<UPRIGHT, OSZ, 0>(
      ii + (size_t)frame * ih * iw, ih, iw, meta[k], meta[K + k],
      meta[2 * K + k], meta[3 * K + k], min(max(meta[4 * K + k], 0), R),
      fpar[k], fpar[K + k], fpar[2 * K + k], sine, cose, wtab, out_row);
}

template <bool UPRIGHT, int OSZ>
static int launch(const int* ii, int nframes, int ih, int iw, const int* meta,
                  const float* fpar, const float* wtab, int K, int R,
                  float* out, cudaStream_t st) {
  describe_kernel<UPRIGHT, OSZ><<<K, desc_threads<UPRIGHT, OSZ>(), 0, st>>>(
      ii, nframes, ih, iw, meta, fpar, wtab, K, R, out);
  return (int)cudaGetLastError();
}

static int dispatch(const int* ii, int nframes, int ih, int iw,
                    const int* meta, const float* fpar, const float* wtab,
                    int K, int R, int upright, int osz, float* out,
                    void* stream) {
  if (K <= 0) return 0;
  if (R < 0 || R > DESC_MAX_RADIUS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (osz == 4)
    return upright
        ? launch<true, 4>(ii, nframes, ih, iw, meta, fpar, wtab, K, R, out, st)
        : launch<false, 4>(ii, nframes, ih, iw, meta, fpar, wtab, K, R, out, st);
  if (osz == 8)
    return upright
        ? launch<true, 8>(ii, nframes, ih, iw, meta, fpar, wtab, K, R, out, st)
        : launch<false, 8>(ii, nframes, ih, iw, meta, fpar, wtab, K, R, out, st);
  return (int)cudaErrorInvalidValue;
}

// One frame: ii (ih, iw), meta (6, K).  out: (K, 16 * osz) rows; osz is 4,
// or 8 when extended.
extern "C" int surf_describe(const int* ii, int ih, int iw, const int* meta,
                             const float* fpar, const float* wtab, int K,
                             int R, int upright, int osz, float* out,
                             void* stream) {
  return dispatch(ii, 0, ih, iw, meta, fpar, wtab, K, R, upright, osz, out,
                  stream);
}

// A stack of frames: ii (nframes, ih, iw), meta (7, K) with the frame row.
extern "C" int surf_describe_stacked(const int* ii, int nframes, int ih,
                                     int iw, const int* meta,
                                     const float* fpar, const float* wtab,
                                     int K, int R, int upright, int osz,
                                     float* out, void* stream) {
  if (nframes <= 0) return (int)cudaErrorInvalidValue;
  return dispatch(ii, nframes, ih, iw, meta, fpar, wtab, K, R, upright, osz,
                  out, stream);
}

// Blocks of the kernel's instantiation that fit one SM, from the registers
// and shared memory it was compiled to.
template <bool UPRIGHT, int OSZ>
static int occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, describe_kernel<UPRIGHT, OSZ>, desc_threads<UPRIGHT, OSZ>(), 0);
}

extern "C" int surf_describe_occupancy(int upright, int osz, int* blocks) {
  if (osz == 4) return upright ? occupancy<true, 4>(blocks) : occupancy<false, 4>(blocks);
  if (osz == 8) return upright ? occupancy<true, 8>(blocks) : occupancy<false, 8>(blocks);
  return (int)cudaErrorInvalidValue;
}
