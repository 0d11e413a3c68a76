// The per-keypoint body of the describe kernels: one block samples one
// keypoint's window and bins it into its unnormalised descriptor row.
// Included by describe.cu (kernel B: any step, one frame or a stack of
// frames) and describe_step.cu (the static-step kernel), so that all of
// them do the same arithmetic in the same order and their rows for one
// keypoint are equal bit for bit.
//
// Replaces the TPU kernels' shared body, cuda_surf_tpu/ops/patch_common.py:
// _emit_group_kp -> _bin_descriptor (:147), with its rotated and extended
// branches as the template's other three modes.
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
// of the unturned dy, dy and |dy| by that of the unturned dx).  The
// positions, the weight index and the responses are written with
// __fmul_rn, __fdiv_rn & co. in the twin's order, so that nvcc contracts
// nothing and replaces no division by a reciprocal (which moves samples
// across the weight rings' edges).
//
// What bounds it on the H100: instructions.  With the gathers and the
// accumulator updates both compiled out, the one-column-per-thread body
// this replaces still took 62 % of its time: a sample cost ~250 warp
// instructions per 32 lanes, of which the 12 integral-image reads (L2 hits
// through L1) and the 8 accumulator updates are the smaller part.  More
// resident warps did not help and fewer hurt, so the design spends as few
// instructions per sample as it can.
//
// Upright (describe_upright).  rpos depends on the window row alone and
// cpos on the column alone, so:
// - a table per row and per column holds position, cell, fraction and the
//   clamped image coordinate (2n entries, two IEEE divisions each, where
//   the sample loop had n^2 of each);
// - a thread owns a window column and walks down the rows; a warp is 32
//   columns, the block's 4 warps take a quarter of the rows each.  A
//   column's cells, weights and its four corner columns are then loop
//   constants, a row's are the same for the whole warp, a corner's address
//   is a row pointer plus a column: no division, modulo, or test per
//   sample;
// - the sums are kept in registers: a column adds to 2 cell columns, a row
//   to 2 cell rows, so 2 x 2 cells x channels accumulators follow the walk
//   down the rows, and the upper pair is flushed when the row's cell
//   changes (every ~6 rows);
// - a flush adds the lanes of one cell column with a segmented shuffle
//   tree and the segment's first lane adds the total to the warp's own
//   64 (128) bins in shared memory: 1 KB (2 KB) a block where the
//   accumulators took 32 KB;
// - the four warps' bins are added in order at the end.
// Rotated (describe_rotated): both positions depend on row and column, and
// a sample's cells on both, so every thread bins its samples into its own
// column of shared memory, acc[bin][thread], and the bins are then summed
// over the threads in order.  The rows of acc are padded by one word: the
// final pass reads acc[b][u] with b the thread, and without the pad all
// lanes of a warp hit one bank (a quarter of the kernel's time).  The
// sample index advances without division.
// Both: every sum is taken in a fixed order, with no float atomics, so a
// row repeats bit for bit run to run and every kernel built on this body
// gives the same row for a keypoint.
//
// What was tried and measured slower (probe_stages.py --kernels, H100): 8 accumulator
// copies per warp with the lanes taking turns (8 KB a block, 12 blocks an
// SM): its four predicated turns per sample cost more instructions than the
// 32 KB of private columns cost occupancy; and several slots per block, so
// that an invalid slot costs a loop turn instead of a block: 1 / 2 / 4 slots
// took 63 / 71 / 94 us, because an empty block costs next to nothing and the
// hardware's dynamic scheduler balances whole blocks better.  The upright
// body compiles to 48 registers (72 extended): 10 (7) blocks an SM.  Capped
// to 40 for 12 blocks it spills and takes 67 us where it took 48; with 2 or
// 8 warps a block instead of 4, 58 and 55 us.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

// the largest window radius the upright row / column tables hold (upright
// 22, rotated 31 at the configurations the package supports)
constexpr int DESC_MAX_RADIUS = 31;
constexpr int DESC_MAX_N = 2 * DESC_MAX_RADIUS + 1;

// Threads of a block: 128, or 64 rotated and extended (128 bins x 65 words
// of private columns: 33 KB of static shared memory).
template <bool UPRIGHT, int OSZ>
__host__ __device__ constexpr int desc_threads() {
  return !UPRIGHT && OSZ == 8 ? 64 : 128;
}

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

// All threads of the block write zeros to an invalid slot's row.
template <int OSZ>
__device__ __forceinline__ void zero_row(float* __restrict__ out_row) {
  for (int b = threadIdx.x; b < 16 * OSZ; b += blockDim.x) out_row[b] = 0.f;
}

// One window row's or column's share of an upright sample: its position in
// units of the spacing, the fraction of its bilinear cell coordinate, and
// packed = (clamped image coordinate << 3) | (cell + 2), cell = floor of
// the cell coordinate in [-1, 3]; packed == 0 marks a row or column no
// sample of which counts (outside the cells' reach or the frame's border).
struct AxisEntry {
  float pos, frac;
  int packed;
};

__device__ __forceinline__ AxisEntry axis_entry(int i, int centre, int step,
                                                float stepf, float frac0,
                                                float spacing, int s, int dim) {
  AxisEntry e;
  e.pos = __fdiv_rn(__fsub_rn(__fmul_rn(stepf, (float)i), frac0), spacing);
  const float x = __fadd_rn(e.pos, 1.5f);  // + (wsz/2 - 1/2)
  const float fl = floorf(x);
  e.frac = __fsub_rn(x, fl);
  const int p = centre + i * step;
  const bool ok = x > -1.f && x < 4.f && p >= 1 + s && p < dim - 1 - s;
  e.packed = ok ? ((min(max(p, s), dim - s - 2) << 3) | ((int)fl + 2)) : 0;
  return e;
}

// The upright body.  128 threads; irad <= DESC_MAX_RADIUS.
template <int OSZ>
__device__ __forceinline__ void describe_upright(
    const int* __restrict__ ii, int ih, int iw, int ix, int iy, int step,
    int s, int irad, float fracr, float fracc, float spacing,
    const float* __restrict__ wtab, float* __restrict__ out_row) {
  constexpr int BINS = 16 * OSZ;
  constexpr int THREADS = desc_threads<true, OSZ>();
  constexpr int WARPS = THREADS / 32;
  constexpr int NVAL = OSZ / 2;  // values a sample adds to a cell
  __shared__ AxisEntry rtab[DESC_MAX_N], ctab[DESC_MAX_N];
  __shared__ float bins[WARPS][BINS];
  __shared__ float wts[40];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float stepf = (float)step;
  const int n = 2 * irad + 1;

  for (int b = t; b < WARPS * BINS; b += THREADS) (&bins[0][0])[b] = 0.f;
  for (int a = t; a < 2 * n; a += THREADS) {
    if (a < n)
      rtab[a] = axis_entry(a - irad, iy, step, stepf, fracr, spacing, s, ih);
    else
      ctab[a - n] = axis_entry(a - n - irad, ix, step, stepf, fracc, spacing,
                               s, iw);
  }
  for (int b = t; b < 40; b += THREADS) wts[b] = wtab[b];
  __syncthreads();

  // this warp's rows; the columns in chunks of 32, lane = column
  const int rows_per_warp = (n + WARPS - 1) / WARPS;
  const int a_lo = warp * rows_per_warp;
  const int a_hi = min(n, a_lo + rows_per_warp);
  float* mine = bins[warp];
  for (int b0 = 0; b0 < n; b0 += 32) {
    const int b = b0 + lane;
    AxisEntry ce;
    ce.pos = 0.f; ce.frac = 0.f; ce.packed = 0;
    if (b < n) ce = ctab[b];
    const bool col_ok = ce.packed != 0;
    const int c0 = (ce.packed & 7) - 2;  // -2: the column does not count
    const int cc = ce.packed >> 3;
    const float cpos2 = __fmul_rn(ce.pos, ce.pos);
    const float wc[2] = {__fsub_rn(1.f, ce.frac), ce.frac};
    // The lanes of one cell column are neighbours (a cell is at most 9
    // columns wide): same[k] says that lane + 2^k belongs to this lane's
    // cell column, head that this lane is its first.
    bool same[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      same[k] = __shfl_down_sync(0xffffffffu, c0, 1 << k) == c0
                && lane + (1 << k) < 32;
    const int left = __shfl_up_sync(0xffffffffu, c0, 1);  // by every lane
    const bool head = col_ok && (lane == 0 || left != c0);

    // acc[u][v][.]: cell row cur + u, cell column c0 + v; 64-d: [dx<0,
    // dx>=0, dy<0, dy>=0]; 128-d: the eight channels
    float acc[2][2][OSZ];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < OSZ; ++e) acc[u][v][e] = 0.f;
    int cur = INT_MIN;  // the cell row of acc[0]; none yet

    // Add acc[0] into the warp's bins of cell row `cur`, then move acc[1]
    // down.  Uniform over the warp.
    auto flush = [&]() {
      if (cur >= 0 && cur < 4) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int cb = c0 + v;
#pragma unroll
          for (int e = 0; e < OSZ; ++e) {
            float x = acc[0][v][e];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float y = __shfl_down_sync(0xffffffffu, x, 1 << k);
              if (same[k]) x = __fadd_rn(x, y);
            }
            if (head && cb >= 0 && cb < 4) {
              float* p = mine + (cur * 4 + cb) * OSZ + e;
              *p = __fadd_rn(*p, x);
            }
          }
          // cell column c0 + 1 of this segment is c0 of the next one
          __syncwarp();
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < OSZ; ++e) {
          acc[0][v][e] = acc[1][v][e];
          acc[1][v][e] = 0.f;
        }
    };

    for (int a = a_lo; a < a_hi; ++a) {
      const AxisEntry re = rtab[a];
      if (re.packed == 0) continue;  // the row does not count
      const int r0 = (re.packed & 7) - 2;
      const int rc = re.packed >> 3;
      if (cur == INT_MIN) cur = r0;
      while (cur < r0) { flush(); ++cur; }
      if (!col_ok) continue;

      const float widx = truncf(__fadd_rn(__fmul_rn(re.pos, re.pos), cpos2));
      const float weight = wts[(int)fminf(fmaxf(widx, 0.f), 39.f)];
      // getWavelet2 / getWavelet1 (surfd.cu:1171-1182): the 12 corners on
      // rows rc - s, rc, rc + 1, rc + s + 1 and columns cc - s, cc, cc + 1,
      // cc + s + 1
      const int* top = ii + (rc - s) * iw;
      const int* mid = ii + rc * iw;
      const int* bot = ii + (rc + s + 1) * iw;
      const int xl = cc - s, xr = cc + s + 1;
      const int tl = __ldg(top + xl), tc = __ldg(top + cc);
      const int td = __ldg(top + cc + 1), tr = __ldg(top + xr);
      const int bl = __ldg(bot + xl), bc = __ldg(bot + cc);
      const int bd = __ldg(bot + cc + 1), br = __ldg(bot + xr);
      const int ml = __ldg(mid + xl), mr = __ldg(mid + xr);
      const int nl = __ldg(mid + iw + xl), nr = __ldg(mid + iw + xr);
      const int wdx = (((br + tc) - tr) - bc) - (((bd + tl) - td) - bl);
      const int wdy = (((nr + tl) - tr) - nl) - (((br + ml) - mr) - bl);
      const float dx = __fmul_rn(__fmul_rn(weight, (float)wdx), 0.003921568627f);
      const float dy = __fmul_rn(__fmul_rn(weight, (float)wdy), 0.003921568627f);
      float val[NVAL];
      bool upper[NVAL];  // the value goes to the upper channel of its pair
      if constexpr (OSZ == 8) {
        // pairs (0,1) (2,3) by dy's sign, (4,5) (6,7) by dx's
        val[0] = dx; val[1] = fabsf(dx); val[2] = dy; val[3] = fabsf(dy);
        upper[0] = upper[1] = !(dy < 0.f);
        upper[2] = upper[3] = !(dx < 0.f);
      } else {
        val[0] = dx; val[1] = dy;
        upper[0] = !(dx < 0.f);
        upper[1] = !(dy < 0.f);
      }
      const float wr[2] = {__fsub_rn(1.f, re.frac), re.frac};
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int e = 0; e < NVAL; ++e) {
            const float x = __fmul_rn(wr[u], __fmul_rn(wc[v], val[e]));
            if (upper[e])
              acc[u][v][2 * e + 1] = __fadd_rn(acc[u][v][2 * e + 1], x);
            else
              acc[u][v][2 * e] = __fadd_rn(acc[u][v][2 * e], x);
          }
    }
    if (cur != INT_MIN) {
      flush();
      ++cur;
      flush();
    }
  }
  __syncthreads();

  for (int b = t; b < BINS; b += THREADS) {
    float sum = bins[0][b];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum = __fadd_rn(sum, bins[w][b]);
    out_row[b] = sum;
  }
}

// The rotated body.  desc_threads<false, OSZ>() threads.
template <int OSZ>
__device__ __forceinline__ void describe_rotated(
    const int* __restrict__ ii, int ih, int iw, int ix, int iy, int step,
    int s, int irad, float fracr, float fracc, float spacing, float sine,
    float cose, const float* __restrict__ wtab, float* __restrict__ out_row) {
  constexpr int BINS = 16 * OSZ;
  constexpr int THREADS = desc_threads<false, OSZ>();
  __shared__ float acc[BINS][THREADS + 1];  // + 1: a row starts a bank on
  const int t = threadIdx.x;
  const float stepf = (float)step;

  for (int b = 0; b < BINS; ++b) acc[b][t] = 0.f;

  // sample q = a * n + b, a the window row and b the column; q advances by
  // THREADS, (a, b) by the constant (THREADS / n, THREADS % n) with a carry
  const int n = 2 * irad + 1;
  int a = t / n, b = t - a * n;
  const int da = THREADS / n, db = THREADS - da * n;
  for (int q = t; q < n * n; q += THREADS) {
    const int i = a - irad, j = b - irad;
    a += da;
    b += db;
    if (b >= n) { b -= n; ++a; }
    const float fi = (float)i, fj = (float)j;
    // (step (cose i + sine j) - fracr) / spacing, ...
    const float rpos = __fdiv_rn(
        __fsub_rn(__fmul_rn(stepf, __fadd_rn(__fmul_rn(cose, fi),
                                             __fmul_rn(sine, fj))), fracr),
        spacing);
    const float cpos = __fdiv_rn(
        __fsub_rn(__fmul_rn(stepf, __fadd_rn(__fmul_rn(-sine, fi),
                                             __fmul_rn(cose, fj))), fracc),
        spacing);
    const float rx = __fadd_rn(rpos, 1.5f);  // + (wsz/2 - 1/2)
    const float cx = __fadd_rn(cpos, 1.5f);
    if (!(rx > -1.f && rx < 4.f && cx > -1.f && cx < 4.f)) continue;
    const int r = iy + i * step;
    const int c = ix + j * step;
    if (r < 1 + s || r >= ih - 1 - s || c < 1 + s || c >= iw - 1 - s) continue;

    const float widx = truncf(__fadd_rn(__fmul_rn(rpos, rpos),
                                        __fmul_rn(cpos, cpos)));
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
    // the responses turned into the keypoint's frame
    const float dx = __fadd_rn(__fmul_rn(cose, dxx), __fmul_rn(sine, dyy));
    const float dy = __fsub_rn(__fmul_rn(sine, dxx), __fmul_rn(cose, dyy));
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
    for (int u = 0; u < 2; ++u) {
      const int ra = r0 + u;
      if (ra < 0 || ra >= 4) continue;
      const float wr = u ? rfrac : __fsub_rn(1.f, rfrac);
      for (int v = 0; v < 2; ++v) {
        const int cb = c0 + v;
        if (cb < 0 || cb >= 4) continue;
        const float wc = v ? cfrac : __fsub_rn(1.f, cfrac);
        const int cell = (ra * 4 + cb) * OSZ;
#pragma unroll
        for (int e = 0; e < NV; ++e)
          acc[cell + ch[e]][t] = __fadd_rn(acc[cell + ch[e]][t],
                                           __fmul_rn(wr, __fmul_rn(wc, val[e])));
      }
    }
  }
  __syncthreads();
  for (int bin = t; bin < BINS; bin += THREADS) {
    float sum = 0.f;
    for (int u = 0; u < THREADS; ++u) sum = __fadd_rn(sum, acc[bin][u]);
    out_row[bin] = sum;
  }
}

// One keypoint's row, by the whole block of desc_threads<UPRIGHT, OSZ>()
// threads; every thread must call it (it synchronises the block), once in
// a block's life (it does not wait for an earlier call's readers).  `ii` is
// the keypoint's own (ih, iw) frame.  SD > 0 fixes the sampling step at
// compile time (the static-step kernel); SD == 0 takes `step_rt`.
template <bool UPRIGHT, int OSZ, int SD>
__device__ __forceinline__ void describe_row(
    const int* __restrict__ ii, int ih, int iw, int ix, int iy, int step_rt,
    int s, int irad, float fracr, float fracc, float spacing, float sine,
    float cose, const float* __restrict__ wtab, float* __restrict__ out_row) {
  const int step = SD > 0 ? SD : step_rt;
  if constexpr (UPRIGHT)
    describe_upright<OSZ>(ii, ih, iw, ix, iy, step, s, irad, fracr, fracc,
                          spacing, wtab, out_row);
  else
    describe_rotated<OSZ>(ii, ih, iw, ix, iy, step, s, irad, fracr, fracc,
                          spacing, sine, cose, wtab, out_row);
}
