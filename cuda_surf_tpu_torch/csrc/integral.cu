// Kernel G: the zero-padded int32 integral image of a uint8 (H, W) frame or
// a (B, H, W) stack of frames, out[b, y, x] = sum(img[b, :y, :x]), in at
// most three launches and with no host synchronisation.
//
// Replaces no TPU kernel.  The JAX package's ops/integral.py:integral_image
// is XLA-compiled jnp.cumsum; its port, cuda_surf_tpu_torch/ops/integral.py:
// _integral_plain (the plain twin), is eager torch: a cast, a zero fill, two
// int32 cumsums and a slice copy a frame.  torch's scan along the rows
// gives one thread to each column, which walks the frame's rows in turn, so
// a 1280x960 frame keeps ~10 blocks in flight on 132 SMs; the chain moves
// ~45 MB a frame and takes ~200 us.  This kernel exists to make it a fixed
// three launches over the whole stack, near its bound.
//
// What bounds it on the H100: bytes.  A frame reads H * W bytes and writes
// 4 (H + 1)(W + 1): 6.15 MB at 1280x960, 1.84 us at 3.35 TB/s.  The design,
// a reduce-then-scan over bands of `rows` rows of a frame:
//
// - `integral_totals`: a block a (band, frame) but the last band of each
//   frame; each thread sums its 16 columns (one 16-byte load a row) over
//   the band's rows and writes the 16 column totals.
// - `integral_carry`: a thread a (frame, column) turns the band totals into
//   the exclusive prefix over the bands, in place: for each band, the column
//   sums of every row above it.
// - `integral_write`: a block a (band, frame), a thread 16 columns, as in
//   the first launch.  It starts from its band's carry, keeps the 16 column
//   sums down the band's rows in registers and for each row takes their
//   inclusive prefix along the row (in the thread, then a warp-shuffle
//   scan, then across the block's warps), stages the output row in shared
//   memory and writes it once, coalesced.  The next row's source is loaded
//   before the current row is scanned.  Band 0's block writes row 0.
//
// So the source is read twice (the second time mostly from L2) and the
// output written once.  `rows` comes from the wrapper, from the stack's
// shape and the card's SM count (ops/integral.py:band_rows): short bands
// for one frame, long ones for a stack, so that bands x frames fill the
// card either way.
//
// Exactness: every sum is unsigned 32-bit integer addition, exact and
// associative modulo 2^32, so the output equals the twin's int32 cumsums
// bit for bit whatever the order (and wraps as they would).  No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int G_COLS = 16;             // columns a thread: a 16-byte load
constexpr int G_MAX_THREADS = 1024;    // so W <= 16384
constexpr int G_CARRY_THREADS = 256;
constexpr int G_CARRY_UNROLL = 8;

// The 16 source bytes of columns [c0, c0 + 16) of a row, zero beyond w;
// VEC: w % 16 == 0 and the stack 16-byte aligned, one load.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* row, int c0, int w) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(row + c0));
  unsigned q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < G_COLS; ++j)
    if (c0 + j < w)
      q[j >> 2] |= (unsigned)__ldg(row + c0 + j) << (8 * (j & 3));
  return make_uint4(q[0], q[1], q[2], q[3]);
}

__device__ __forceinline__ unsigned byte_at(const uint4& q, int j) {
  const unsigned word = j < 4 ? q.x : j < 8 ? q.y : j < 12 ? q.z : q.w;
  return (word >> (8 * (j & 3))) & 0xffu;
}

template <bool VEC>
__global__ void __launch_bounds__(G_MAX_THREADS)
integral_totals(const uint8_t* __restrict__ src, int h, int w, int rows,
                int nbands, int wp, unsigned* __restrict__ tot) {
  const int band = blockIdx.x, b = blockIdx.y;
  const int c0 = threadIdx.x * G_COLS;
  if (c0 >= w) return;
  const uint8_t* f = src + (size_t)b * h * w;
  const int y0 = band * rows, y1 = min(h, y0 + rows);
  unsigned s[G_COLS];
#pragma unroll
  for (int j = 0; j < G_COLS; ++j) s[j] = 0u;
#pragma unroll 4
  for (int y = y0; y < y1; ++y) {
    const uint4 q = load16<VEC>(f + (size_t)y * w, c0, w);
#pragma unroll
    for (int j = 0; j < G_COLS; ++j) s[j] += byte_at(q, j);
  }
  uint4* o = reinterpret_cast<uint4*>(tot + ((size_t)b * nbands + band) * wp
                                      + c0);
#pragma unroll
  for (int k = 0; k < G_COLS / 4; ++k)
    o[k] = make_uint4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
}

// tot: (nframes, nbands, wp); band k's row becomes the sum of the rows of
// the bands before it.  The last band's row is written, never read.
__global__ void integral_carry(unsigned* __restrict__ tot, int nframes,
                               int nbands, int wp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nframes * wp) return;
  const int b = i / wp;
  unsigned* p = tot + (size_t)b * nbands * wp + (i - b * wp);
  unsigned run = 0u;
  for (int k0 = 0; k0 < nbands; k0 += G_CARRY_UNROLL) {
    unsigned t[G_CARRY_UNROLL];
#pragma unroll
    for (int j = 0; j < G_CARRY_UNROLL; ++j)
      t[j] = k0 + j < nbands - 1 ? p[(size_t)(k0 + j) * wp] : 0u;
#pragma unroll
    for (int j = 0; j < G_CARRY_UNROLL; ++j)
      if (k0 + j < nbands) {
        p[(size_t)(k0 + j) * wp] = run;
        run += t[j];
      }
  }
}

// The staged row's word of output column c >= 1: each thread's 16 values
// are 17 words apart, so the 32 lanes' stores hit 32 banks.
__device__ __forceinline__ int slot(int c) { return (c - 1) + ((c - 1) >> 4); }

template <bool VEC>
__global__ void __launch_bounds__(G_MAX_THREADS)
integral_write(const uint8_t* __restrict__ src, int h, int w, int rows,
               int nbands, int wp, int rb, const unsigned* __restrict__ carry,
               unsigned* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* wsum = smem;               // [2][32] warp totals, by row parity
  const int band = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nt = blockDim.x;
  const int c0 = t * G_COLS;
  const bool live = c0 < w;
  const int ow = w + 1;
  const int y0 = band * rows, y1 = min(h, y0 + rows);
  const uint8_t* f = src + (size_t)b * h * w;
  unsigned* fo = out + (size_t)b * (h + 1) * ow;

  unsigned v[G_COLS];                  // the columns' sums of rows < y
  if (live && band > 0) {
    const uint4* cp = reinterpret_cast<const uint4*>(
        carry + ((size_t)b * nbands + band) * wp + c0);
#pragma unroll
    for (int k = 0; k < G_COLS / 4; ++k) {
      const uint4 q = cp[k];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < G_COLS; ++j) v[j] = 0u;
  }
  if (band == 0)
    for (int i = t; i < ow; i += nt) fo[i] = 0u;

  uint4 next = live ? load16<VEC>(f + (size_t)y0 * w, c0, w)
                    : make_uint4(0u, 0u, 0u, 0u);
  for (int y = y0; y < y1; ++y) {
    const uint4 cur = next;
    if (live && y + 1 < y1) next = load16<VEC>(f + (size_t)(y + 1) * w, c0, w);
    const int par = (y - y0) & 1;
    unsigned p[G_COLS];
    unsigned run = 0u;
#pragma unroll
    for (int j = 0; j < G_COLS; ++j) {
      v[j] += byte_at(cur, j);
      run += v[j];
      p[j] = run;
    }
    unsigned incl = run;               // every lane of the warp takes part
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned n = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += n;
    }
    if (lane == 31) wsum[32 * par + warp] = incl;
    __syncthreads();
    unsigned base = incl - run;
    for (int k = 0; k < warp; ++k) base += wsum[32 * par + k];
    unsigned* buf = smem + 64 + par * rb;
    if (live) {
#pragma unroll
      for (int j = 0; j < G_COLS; ++j)
        if (c0 + j < w) buf[slot(c0 + j + 1)] = base + p[j];
    }
    __syncthreads();
    unsigned* o = fo + (size_t)(y + 1) * ow;
    for (int i = t; i < ow; i += nt) o[i] = i ? buf[slot(i)] : 0u;
  }
}

extern "C" {

// src: nframes x (h, w) uint8, contiguous; out: nframes x (h + 1, w + 1)
// int32; scratch: nframes * ceil(h / rows) * round_up(w, 16) ints, unused
// (may be null) when one band covers a frame.  vec: w % 16 == 0 and src
// 16-byte aligned.
int surf_integral(const uint8_t* src, int nframes, int h, int w, int rows,
                  int vec, unsigned* scratch, unsigned* out, void* stream) {
  const int nt = ((w + G_COLS - 1) / G_COLS + 31) / 32 * 32;
  if (nframes < 1 || nframes > 65535 || h < 1 || w < 1 || rows < 1
      || nt > G_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const int nbands = (h + rows - 1) / rows;
  const int wp = (w + G_COLS - 1) / G_COLS * G_COLS;
  const int rb = (w - 1) + ((w - 1) >> 4) + 1;
  const size_t smem = (64 + 2 * (size_t)rb) * sizeof(unsigned);
  cudaStream_t s = (cudaStream_t)stream;
  if (nbands > 1) {
    const dim3 grid(nbands - 1, nframes);
    if (vec)
      integral_totals<true><<<grid, nt, 0, s>>>(src, h, w, rows, nbands, wp,
                                                scratch);
    else
      integral_totals<false><<<grid, nt, 0, s>>>(src, h, w, rows, nbands, wp,
                                                 scratch);
    const int n = nframes * wp;
    integral_carry<<<(n + G_CARRY_THREADS - 1) / G_CARRY_THREADS,
                     G_CARRY_THREADS, 0, s>>>(scratch, nframes, nbands, wp);
  }
  auto write = vec ? integral_write<true> : integral_write<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        write, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  write<<<dim3(nbands, nframes), nt, smem, s>>>(src, h, w, rows, nbands, wp,
                                                rb, scratch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
