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
// Doubled mode (`surf_integral_doubled`: `integral_doubled_totals`,
// `integral_doubled_carry`, `integral_doubled_write`) is the integral image
// of the frame upsampled 2x bilinearly onto the (2H - 1, 2W - 1) grid,
// (2H, 2W) int32 a frame, as the reference's cuIntegralDoubleU4 makes it
// (integralDoubleRow0U2, surfd.cu:186-205): the same three passes over the
// grid's rows, each thread making its 16 grid columns of a grid row on the
// fly from 9 bytes of the one or two source rows under it.  It holds those
// source rows in registers down its band, so each is loaded once a band
// and a pass, and rounds every mean half to even in integers.  Only the
// (2H, 2W) output goes to memory: 39 MB read and 629 MB written for 32
// 1280x960 frames, 0.20 ms at 3.35 TB/s.
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

// The rows a pass sums, walked down a band by one thread over its 16
// columns [c0, c0 + 16): `take(y, y1, x)` gives row y's 16 values, zero
// beyond the grid, and loads ahead what the band's rows below y need (y1:
// the band's end).  `grid(n)`: the grid's rows (columns) over a source of
// n.  A thread whose columns lie beyond the grid (not `live`) loads nothing.

// The frame's own rows.
template <bool VEC>
struct FrameRows {
  static __device__ __forceinline__ int grid(int n) { return n; }
  const uint8_t* f;
  int w, c0;
  bool live;
  uint4 next;
  __device__ __forceinline__ FrameRows(const uint8_t* frame, int h, int w_,
                                       int c0_, int y0, bool live_)
      : f(frame), w(w_), c0(c0_), live(live_) {
    next = live ? load16<VEC>(f + (size_t)y0 * w, c0, w)
                : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void take(int y, int y1, unsigned (&x)[G_COLS]) {
    const uint4 cur = next;
    if (live && y + 1 < y1) next = load16<VEC>(f + (size_t)(y + 1) * w, c0, w);
#pragma unroll
    for (int j = 0; j < G_COLS; ++j) x[j] = byte_at(cur, j);
  }
};

// Source bytes j0 .. j0 + 8 of a row, zero beyond w: the 8 under a thread's
// 16 grid columns and the one after them.
struct Src9 {
  uint2 q;
  unsigned e;
  __device__ __forceinline__ unsigned at(int k) const {
    if (k == 8) return e;
    return ((k < 4 ? q.x : q.y) >> (8 * (k & 3))) & 0xffu;
  }
};

// VEC: w % 8 == 0 and the stack 8-byte aligned, one load for the 8.
template <bool VEC>
__device__ __forceinline__ Src9 load9(const uint8_t* row, int j0, int w) {
  Src9 s;
  if (VEC) {
    s.q = __ldg(reinterpret_cast<const uint2*>(row + j0));
  } else {
    unsigned q[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (j0 + k < w)
        q[k >> 2] |= (unsigned)__ldg(row + j0 + k) << (8 * (k & 3));
    s.q = make_uint2(q[0], q[1]);
  }
  s.e = j0 + 8 < w ? (unsigned)__ldg(row + j0 + 8) : 0u;
  return s;
}

// a / 2 and a / 4 rounded half to even, as the twin's torch.round of the
// float32 means (exact: multiples of 1/4 below 2^10) rounds them
__device__ __forceinline__ unsigned half_even2(unsigned a) {
  const unsigned q = a >> 1;
  return q + (a & q & 1u);
}
__device__ __forceinline__ unsigned half_even4(unsigned a) {
  const unsigned q = a >> 2;
  return q + (((a & 3u) + (q & 1u) + 1u) >> 2);
}

// The rows of the frame upsampled 2x onto the (2h - 1, 2w - 1) grid.  Grid
// row 2i is source row i with the mean of each two neighbours between
// them; grid row 2i + 1 the means of rows i and i + 1, and of each 2 x 2
// block between them.  Grid column c0 + 2k lies over source column j0 + k,
// j0 = c0 / 2, and the odd column c0 + 2k + 1 inside the grid if k < nodd.
// The thread holds source rows i (`a`) and i + 1 (`b`) under the grid row
// it is at, and loads row i + 2 as it leaves grid row 2i + 1.
template <bool VEC>
struct DoubledRows {
  static __device__ __forceinline__ int grid(int n) { return 2 * n - 1; }
  const uint8_t* f;
  int w, j0, nodd, i;
  bool live;
  Src9 a, b;
  __device__ __forceinline__ DoubledRows(const uint8_t* frame, int h, int w_,
                                         int c0, int y0, bool live_)
      : f(frame), w(w_), j0(c0 >> 1), nodd(w_ - 1 - (c0 >> 1)), i(y0 >> 1),
        live(live_) {
    const Src9 zero = {make_uint2(0u, 0u), 0u};
    a = live ? load9<VEC>(f + (size_t)i * w, j0, w) : zero;
    b = live && i + 1 < h ? load9<VEC>(f + (size_t)(i + 1) * w, j0, w) : zero;
  }
  __device__ __forceinline__ void take(int y, int y1, unsigned (&x)[G_COLS]) {
    if ((y & 1) == 0) {
#pragma unroll
      for (int k = 0; k < G_COLS / 2; ++k) {
        x[2 * k] = a.at(k);
        x[2 * k + 1] = k < nodd ? half_even2(a.at(k) + a.at(k + 1)) : 0u;
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < G_COLS / 2; ++k) {
      x[2 * k] = half_even2(a.at(k) + b.at(k));
      x[2 * k + 1] = k < nodd ? half_even4(a.at(k) + a.at(k + 1) + b.at(k)
                                           + b.at(k + 1))
                              : 0u;
    }
    a = b;
    ++i;
    if (live && y + 2 < y1) b = load9<VEC>(f + (size_t)(i + 1) * w, j0, w);
  }
};

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

// The first pass in doubled mode: h and w are the source's; the band's
// rows are the grid's.
template <bool VEC>
__global__ void __launch_bounds__(G_MAX_THREADS)
integral_doubled_totals(const uint8_t* __restrict__ src, int h, int w,
                        int rows, int nbands, int wp,
                        unsigned* __restrict__ tot) {
  using Rows = DoubledRows<VEC>;
  const int band = blockIdx.x, b = blockIdx.y;
  const int c0 = threadIdx.x * G_COLS;
  if (c0 >= Rows::grid(w)) return;
  const int y0 = band * rows, y1 = min(Rows::grid(h), y0 + rows);
  Rows r(src + (size_t)b * h * w, h, w, c0, y0, true);
  unsigned s[G_COLS];
#pragma unroll
  for (int j = 0; j < G_COLS; ++j) s[j] = 0u;
  for (int y = y0; y < y1; ++y) {
    unsigned x[G_COLS];
    r.take(y, y1, x);
#pragma unroll
    for (int j = 0; j < G_COLS; ++j) s[j] += x[j];
  }
  uint4* o = reinterpret_cast<uint4*>(tot + ((size_t)b * nbands + band) * wp
                                      + c0);
#pragma unroll
  for (int k = 0; k < G_COLS / 4; ++k)
    o[k] = make_uint4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
}

// tot: (nframes, nbands, wp); band k's row becomes the sum of the rows of
// the bands before it.  The last band's row is written, never read.
__device__ __forceinline__ void carry_bands(unsigned* __restrict__ tot,
                                            int nframes, int nbands, int wp) {
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

__global__ void integral_carry(unsigned* __restrict__ tot, int nframes,
                               int nbands, int wp) {
  carry_bands(tot, nframes, nbands, wp);
}

__global__ void integral_doubled_carry(unsigned* __restrict__ tot,
                                       int nframes, int nbands, int wp) {
  carry_bands(tot, nframes, nbands, wp);
}

// The staged row's word of output column c >= 1: each thread's 16 values
// are 17 words apart, so the 32 lanes' stores hit 32 banks.
__device__ __forceinline__ int slot(int c) { return (c - 1) + ((c - 1) >> 4); }

// The last pass over the grid of `Rows` (h and w the source's).
template <class Rows>
__device__ __forceinline__ void write_band(
    const uint8_t* __restrict__ src, int sh, int sw, int rows, int nbands,
    int wp, int rb, const unsigned* __restrict__ carry,
    unsigned* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* wsum = smem;               // [2][32] warp totals, by row parity
  const int h = Rows::grid(sh), w = Rows::grid(sw);
  const int band = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nt = blockDim.x;
  const int c0 = t * G_COLS;
  const bool live = c0 < w;
  const int ow = w + 1;
  const int y0 = band * rows, y1 = min(h, y0 + rows);
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

  Rows next(src + (size_t)b * sh * sw, sh, sw, c0, y0, live);
  for (int y = y0; y < y1; ++y) {
    unsigned cur[G_COLS];
    next.take(y, y1, cur);
    const int par = (y - y0) & 1;
    unsigned p[G_COLS];
    unsigned run = 0u;
#pragma unroll
    for (int j = 0; j < G_COLS; ++j) {
      v[j] += cur[j];
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

template <bool VEC>
__global__ void __launch_bounds__(G_MAX_THREADS)
integral_write(const uint8_t* __restrict__ src, int h, int w, int rows,
               int nbands, int wp, int rb, const unsigned* __restrict__ carry,
               unsigned* __restrict__ out) {
  write_band<FrameRows<VEC>>(src, h, w, rows, nbands, wp, rb, carry, out);
}

template <bool VEC>
__global__ void __launch_bounds__(G_MAX_THREADS)
integral_doubled_write(const uint8_t* __restrict__ src, int h, int w,
                       int rows, int nbands, int wp, int rb,
                       const unsigned* __restrict__ carry,
                       unsigned* __restrict__ out) {
  write_band<DoubledRows<VEC>>(src, h, w, rows, nbands, wp, rb, carry, out);
}

using TotalsFn = void (*)(const uint8_t*, int, int, int, int, int,
                          unsigned*);
using CarryFn = void (*)(unsigned*, int, int, int);
using WriteFn = void (*)(const uint8_t*, int, int, int, int, int, int,
                         const unsigned*, unsigned*);

// The three passes over an (gh, gw) grid of nframes source frames of
// (h, w): out is nframes x (gh + 1, gw + 1).
static int run_passes(TotalsFn totals, CarryFn carry, WriteFn write,
                      const uint8_t* src, int nframes, int h, int w, int gh,
                      int gw, int rows, unsigned* scratch, unsigned* out,
                      cudaStream_t s) {
  const int nt = ((gw + G_COLS - 1) / G_COLS + 31) / 32 * 32;
  if (nframes < 1 || nframes > 65535 || h < 1 || w < 1 || rows < 1
      || nt > G_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const int nbands = (gh + rows - 1) / rows;
  const int wp = (gw + G_COLS - 1) / G_COLS * G_COLS;
  const int rb = (gw - 1) + ((gw - 1) >> 4) + 1;
  const size_t smem = (64 + 2 * (size_t)rb) * sizeof(unsigned);
  if (nbands > 1) {
    totals<<<dim3(nbands - 1, nframes), nt, 0, s>>>(src, h, w, rows, nbands,
                                                    wp, scratch);
    const int n = nframes * wp;
    carry<<<(n + G_CARRY_THREADS - 1) / G_CARRY_THREADS, G_CARRY_THREADS, 0,
            s>>>(scratch, nframes, nbands, wp);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        write, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  write<<<dim3(nbands, nframes), nt, smem, s>>>(src, h, w, rows, nbands, wp,
                                                rb, scratch, out);
  return (int)cudaGetLastError();
}

extern "C" {

// src: nframes x (h, w) uint8, contiguous; out: nframes x (h + 1, w + 1)
// int32; scratch: nframes * ceil(h / rows) * round_up(w, 16) ints, unused
// (may be null) when one band covers a frame.  vec: w % 16 == 0 and src
// 16-byte aligned.
int surf_integral(const uint8_t* src, int nframes, int h, int w, int rows,
                  int vec, unsigned* scratch, unsigned* out, void* stream) {
  return run_passes(vec ? integral_totals<true> : integral_totals<false>,
                    integral_carry,
                    vec ? integral_write<true> : integral_write<false>, src,
                    nframes, h, w, h, w, rows, scratch, out,
                    (cudaStream_t)stream);
}

// Doubled: src nframes x (h, w) uint8, contiguous; out nframes x (2h, 2w)
// int32, the integral image of each frame upsampled onto (2h - 1, 2w - 1);
// rows: the grid's rows a band; scratch: nframes * ceil((2h - 1) / rows) *
// round_up(2w - 1, 16) ints, unused (may be null) when one band covers a
// frame.  vec: w % 8 == 0 and src 8-byte aligned.
int surf_integral_doubled(const uint8_t* src, int nframes, int h, int w,
                          int rows, int vec, unsigned* scratch, unsigned* out,
                          void* stream) {
  return run_passes(
      vec ? integral_doubled_totals<true> : integral_doubled_totals<false>,
      integral_doubled_carry,
      vec ? integral_doubled_write<true> : integral_doubled_write<false>,
      src, nframes, h, w, 2 * h - 1, 2 * w - 1, rows, scratch, out,
      (cudaStream_t)stream);
}

}  // extern "C"
