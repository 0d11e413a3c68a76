// Kernel F: the detection glue after kernel A, for one frame or a stack of
// frames: the stable compaction of the NMS candidates of every octave, the
// first quadratic fit and move of every candidate, the walk of the first
// max(cap / 8, 64) movers, and the keypoint fields, in three launches and
// with no host synchronisation.
//
// Replaces no TPU kernel.  The JAX package's ops/extrema.py:detect is
// XLA-compiled jnp; its port, cuda_surf_tpu_torch/ops/extrema.py:
// _detect_plain (the plain twin), is eager torch, and on the card every
// term of it is a launch: two prefix-sum compactions, a host-to-device copy
// of the small tables (from pageable memory, so a host sync), and five
// fits of some 100 elementwise launches each, ~1,005 operations a call,
// whatever the number of frames.  This kernel exists to make that chain a
// fixed three launches.
//
// What bounds it on the H100: it reads the masks once (~2 MB a 1280x960
// frame, 3 bytes more a candidate slot written) and makes 19 gathers for
// each of at most 5 fits of a few thousand candidates: a few microseconds
// of HBM time.  What it waits for is the chain of dependent launches and,
// inside a launch, the 5 dependent fits of a walker.  The design:
//
// - Chunks.  The candidate order is frame-major, then octave-major, then
//   index order inside an octave's (ms, oh, ow) layers.  The grid of the
//   count and place launches walks chunks of at most F_CHUNK mask bytes in
//   that order, a chunk inside one (frame, octave) segment, so a block's
//   candidates share their octave's geometry.  Kernel A's layers and masks
//   are read in place (a pointer an octave, passed by value): its layout is
//   octave-major, [octave: frame 0 | frame 1 | ...], and a segment is one
//   contiguous run of it.
// - Prefix scan, never an atomic append.  (1) `extrema_count`: each block
//   counts its chunk's candidates and, with their first fit, its step-1
//   movers.  (2) `extrema_scan`: one block turns both counts into exclusive
//   offsets (the candidate's slot and the mover's rank in slot order), and
//   writes `count` = min(candidates, cap).  (3) `extrema_place`: each block
//   ranks its candidates again inside the chunk (a block scan), takes the
//   first fit, walks the movers whose rank is below the walker set's size
//   for the remaining interp_moves - 1 moves, and writes every field of its
//   slots; blocks past the chunks write the empty slots from `count` on.
//   Movers are counted among the candidates inside the capacity only: the
//   offsets of a chunk that starts below `cap` count whole chunks before it,
//   all inside it.  The first fit is computed three times (count, and the
//   place launch's two passes) rather than stored: it is 19 gathers, and a
//   frame has a few thousand candidates.
// - The geometry of all octaves (shapes, per-frame offsets, octave numbers,
//   chunk counts), the walk borders and the 19 stencil offsets are a small
//   int32 table that the wrapper builds once per shape and keeps on the
//   device (ops/extrema.py:extrema_plan): nothing is copied per call.
//
// Exactness: every output equals the twin's on the card bit for bit.  The
// fit is written with __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn in the
// twin's operation order, so nvcc contracts nothing into an FMA; Python
// scalars act as float32 constants, as torch applies them; the division of
// `ns` by 3.0 is torch's on the card, a product with the float32 reciprocal
// (torch takes a * (1 / b) for a CPU scalar b).  A stencil read outside
// the stack is clamped into it as the twin clamps its flat index, and is
// decoded to its (frame, octave, element) wherever it lands.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int F_THREADS = 256;
constexpr int F_WARPS = F_THREADS / 32;
constexpr int F_WORDS = 4;                          // mask words a thread
// mask bytes a chunk (ops/extrema.py:CHUNK): at any alignment they span at
// most F_THREADS * F_WORDS aligned words
constexpr int F_CHUNK = 4092;
static_assert(F_CHUNK + 3 <= F_THREADS * F_WORDS * 4, "chunk too large");
constexpr int F_FILL = F_THREADS * 4;               // empty slots a block
constexpr int F_SCAN_THREADS = 1024;
constexpr int F_MAX_OCT = 8;
constexpr int F_MAX_MS = 16;
constexpr int F_NFIT = 19;
// the plan's layout (ops/extrema.py:extrema_plan)
constexpr int F_HEADER = 8;     // noct, nframes, total_f, nch_f, ms_p, 19, chunk
constexpr int F_OCT_INTS = 8;   // oh, ow, ms, size, off, octave, chunk0
constexpr float F_THIRD = 1.0f / 3.0f;

struct FArgs {
  const float* resp[F_MAX_OCT];
  const unsigned char* mask[F_MAX_OCT];
  const int* plan;
  int cap, cap2, interp_moves;
  float thresh, init_lobe, max_scale;
  int* counts;     // 2 an chunk: candidates, movers
  int* offs;       // 2 an chunk: exclusive offsets of both
  bool* valid;
  float* nx;
  float* ny;
  float* ns;
  float* strength;
  int* octave;
  int* frame;
  int* count;
  int* walkers;
};

struct FShared {
  int noct, total_f, nch_f, ms_p, total;
  int oh[F_MAX_OCT], ow[F_MAX_OCT], size[F_MAX_OCT], off[F_MAX_OCT];
  int octnum[F_MAX_OCT], chunk0[F_MAX_OCT];
  int border[F_MAX_OCT * F_MAX_MS];
  int st[3][F_NFIT];
  const float* resp[F_MAX_OCT];
  const unsigned char* mask[F_MAX_OCT];
  int scan[F_WARPS + 1];
};

__device__ void load_plan(const FArgs& a, FShared& S) {
  const int* p = a.plan;
  const int t = threadIdx.x;
  if (t == 0) {
    S.noct = p[0];
    S.total_f = p[2];
    S.nch_f = p[3];
    S.ms_p = p[4];
    S.total = p[1] * p[2];
  }
  const int noct = p[0], ms_p = p[4];
  if (t < noct) {
    const int* q = p + F_HEADER + t * F_OCT_INTS;
    S.oh[t] = q[0];
    S.ow[t] = q[1];
    S.size[t] = q[3];
    S.off[t] = q[4];
    S.octnum[t] = q[5];
    S.chunk0[t] = q[6];
    S.resp[t] = a.resp[t];
    S.mask[t] = a.mask[t];
  }
  const int* bq = p + F_HEADER + noct * F_OCT_INTS;
  for (int i = t; i < noct * ms_p; i += blockDim.x) S.border[i] = bq[i];
  const int* sq = bq + noct * ms_p;
  for (int i = t; i < 3 * F_NFIT; i += blockDim.x)
    S.st[i / F_NFIT][i % F_NFIT] = sq[i];
  __syncthreads();
}

// A candidate's segment: frame b, octave o, and the frame-major flat index
// of its element 0.
struct Seg {
  int b, o, lo, size, oh, ow, plane, octnum;
  const float* resp;    // element 0 of the segment's layers
};

__device__ Seg segment(const FShared& S, int b, int o) {
  Seg g;
  g.b = b;
  g.o = o;
  g.lo = b * S.total_f + S.off[o];
  g.size = S.size[o];
  g.oh = S.oh[o];
  g.ow = S.ow[o];
  g.plane = g.oh * g.ow;
  g.octnum = S.octnum[o];
  g.resp = S.resp[o] + (size_t)b * g.size;
  return g;
}

// The layer value at frame-major flat index idx (already clamped).
__device__ float fetch(const FShared& S, const Seg& g, int idx) {
  const int e = idx - g.lo;
  if (e >= 0 && e < g.size) return __ldg(g.resp + e);
  const int b = idx / S.total_f;
  const int rem = idx - b * S.total_f;
  int o = S.noct - 1;
  while (o > 0 && S.off[o] > rem) --o;
  return __ldg(S.resp[o] + (size_t)b * S.size[o] + (rem - S.off[o]));
}

struct Fit {
  float x0, x1, x2, s;
};

// fitQuadrat + solveLinearSystem in the twin's order
// (extrema.py:fit_sparse, _fit_closed_form): the 19 stencil values in
// _FIT_OFFSETS order, the gradient and Hessian, the partially pivoted 3x3
// solve with its swaps as selects, the peak strength.
__device__ Fit fit_at(const FShared& S, const Seg& g, int lin) {
  float v[F_NFIT];
#pragma unroll
  for (int k = 0; k < F_NFIT; ++k) {
    int idx = lin + S.st[0][k] * g.plane + S.st[1][k] * g.ow + S.st[2][k];
    idx = min(max(idx, 0), S.total - 1);
    v[k] = fetch(S, g, idx);
  }
  const float c = v[0];
  const float g_s = __fmul_rn(__fsub_rn(v[1], v[2]), 0.5f);
  const float g_r = __fmul_rn(__fsub_rn(v[3], v[4]), 0.5f);
  const float g_c = __fmul_rn(__fsub_rn(v[5], v[6]), 0.5f);
  const float c2 = __fmul_rn(2.0f, c);
  const float h_ss = __fsub_rn(__fadd_rn(v[1], v[2]), c2);
  const float h_rr = __fsub_rn(__fadd_rn(v[3], v[4]), c2);
  const float h_cc = __fsub_rn(__fadd_rn(v[5], v[6]), c2);
  const float h_sr = __fmul_rn(
      __fsub_rn(__fsub_rn(v[7], v[8]), __fsub_rn(v[9], v[10])), 0.25f);
  const float h_sc = __fmul_rn(
      __fsub_rn(__fsub_rn(v[11], v[12]), __fsub_rn(v[13], v[14])), 0.25f);
  const float h_rc = __fmul_rn(
      __fsub_rn(__fsub_rn(v[15], v[16]), __fsub_rn(v[17], v[18])), 0.25f);

  const float R[3][4] = {{h_ss, h_sr, h_sc, -g_s},
                         {h_sr, h_rr, h_rc, -g_r},
                         {h_sc, h_rc, h_cc, -g_c}};
  const float a0 = fabsf(R[0][0]), a1 = fabsf(R[1][0]), a2 = fabsf(R[2][0]);
  // torch.maximum propagates NaN, and a comparison with NaN is false
  int p0 = a1 > a0 ? 1 : 0;
  if (a2 > a0 && a2 > a1) p0 = 2;
  float r0[4], r1[4], r2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r0[j] = p0 == 0 ? R[0][j] : (p0 == 1 ? R[1][j] : R[2][j]);
    r1[j] = p0 == 1 ? R[0][j] : R[1][j];
    r2[j] = p0 == 2 ? R[0][j] : R[2][j];
  }
  const float f1 = __fdiv_rn(r1[0], r0[0]);
  const float f2 = __fdiv_rn(r2[0], r0[0]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r1[j] = __fsub_rn(r1[j], __fmul_rn(f1, r0[j]));
    r2[j] = __fsub_rn(r2[j], __fmul_rn(f2, r0[j]));
  }
  if (fabsf(r2[1]) > fabsf(r1[1])) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = r1[j];
      r1[j] = r2[j];
      r2[j] = t;
    }
  }
  const float f3 = __fdiv_rn(r2[1], r1[1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) r2[j] = __fsub_rn(r2[j], __fmul_rn(f3, r1[j]));
  Fit f;
  f.x2 = __fdiv_rn(r2[3], r2[2]);
  f.x1 = __fdiv_rn(__fsub_rn(r1[3], __fmul_rn(r1[2], f.x2)), r1[1]);
  f.x0 = __fdiv_rn(__fsub_rn(__fsub_rn(r0[3], __fmul_rn(r0[1], f.x1)),
                             __fmul_rn(r0[2], f.x2)),
                   r0[0]);
  f.s = __fadd_rn(
      c, __fmul_rn(0.5f, __fadd_rn(__fadd_rn(__fmul_rn(f.x0, g_s),
                                             __fmul_rn(f.x1, g_r)),
                                   __fmul_rn(f.x2, g_c))));
  return f;
}

// One walk move (extrema.py:_detect_plain's `step`): -> moved; updates the
// position.
__device__ bool move(const Fit& f, int border, int oh, int ow, int& lin,
                     int& r, int& c) {
  const int dr = (f.x1 > 0.6f && r < oh - border) -
                 (f.x1 < -0.6f && r > border);
  const int dc = (f.x2 > 0.6f && c < ow - border) -
                 (f.x2 < -0.6f && c > border);
  lin += dr * ow + dc;
  r += dr;
  c += dc;
  return dr != 0 || dc != 0;
}

// The keypoint fields of one slot, in the twin's order.
__device__ void write_slot(const FArgs& a, int slot, bool valid, const Fit& f,
                           int s, int rf, int cf, int octnum, int o, int b) {
  const bool good = valid && !(isnan(f.x0) || isnan(f.x1) || isnan(f.x2)) &&
                    !(fabsf(f.x0) > 1.5f || fabsf(f.x1) > 1.5f ||
                      fabsf(f.x2) > 1.5f) &&
                    f.s >= a.thresh;
  const float oc = (float)octnum;
  const float lead =
      __fadd_rn(a.init_lobe, __fmul_rn(__fsub_rn(oc, 1.0f), a.max_scale));
  const float span =
      __fmul_rn(__fmul_rn(__fadd_rn((float)s, f.x0), 2.0f), oc);
  a.valid[slot] = good;
  a.ns[slot] = __fmul_rn(__fadd_rn(lead, span), F_THIRD);
  a.ny[slot] = __fmul_rn(oc, __fadd_rn((float)rf, f.x1));
  a.nx[slot] = __fmul_rn(oc, __fadd_rn((float)cf, f.x2));
  a.strength[slot] = f.s;
  a.octave[slot] = o;
  a.frame[slot] = b;
}

// Exclusive block scan of one int a thread; every thread of the block must
// call it.  -> the thread's offset; `total` gets the block's sum.
__device__ int block_scan(int v, int& total, FShared& S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) S.scan[warp + 1] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    S.scan[0] = 0;
    for (int w = 1; w <= F_WARPS; ++w) S.scan[w] += S.scan[w - 1];
  }
  __syncthreads();
  const int out = S.scan[warp] + x - v;
  total = S.scan[F_WARPS];
  __syncthreads();
  return out;
}

// The chunk of block g: its segment, element range, and this thread's
// set mask bytes as bits (bit k: element e_first + k).
struct Chunk {
  Seg seg;
  int e0, e1, e_first;
  unsigned bits;
};

__device__ Chunk load_chunk(const FShared& S, int g) {
  Chunk ch;
  const int b = g / S.nch_f;
  const int j = g - b * S.nch_f;
  int o = S.noct - 1;
  while (o > 0 && S.chunk0[o] > j) --o;
  ch.seg = segment(S, b, o);
  ch.e0 = (j - S.chunk0[o]) * F_CHUNK;
  ch.e1 = min(ch.e0 + F_CHUNK, ch.seg.size);
  const unsigned char* base = S.mask[o] + (size_t)b * ch.seg.size;
  const uintptr_t lo = (uintptr_t)(base + ch.e0);
  const unsigned* words = (const unsigned*)(lo & ~(uintptr_t)3);
  ch.e_first = ch.e0 - (int)(lo & 3) + threadIdx.x * (4 * F_WORDS);
  ch.bits = 0;
#pragma unroll
  for (int i = 0; i < F_WORDS; ++i) {
    const int e = ch.e_first + 4 * i;
    if (e + 3 < ch.e0 || e >= ch.e1) continue;
    const unsigned w = __ldg(words + threadIdx.x * F_WORDS + i);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (((w >> (8 * k)) & 0xffu) && e + k >= ch.e0 && e + k < ch.e1)
        ch.bits |= 1u << (4 * i + k);
  }
  return ch;
}

// Element e of a segment -> scale, row, column and flat index.
__device__ void decode(const Seg& g, int e, int& s, int& r, int& c,
                       int& lin) {
  s = e / g.plane;
  const int rem = e - s * g.plane;
  r = rem / g.ow;
  c = rem - r * g.ow;
  lin = g.lo + e;
}

__global__ void __launch_bounds__(F_THREADS)
    extrema_count(const FArgs a) {
  __shared__ FShared S;
  load_plan(a, S);
  const Chunk ch = load_chunk(S, blockIdx.x);
  int movers = 0;
  for (unsigned m = ch.bits; m; m &= m - 1) {
    int s, r, c, lin;
    decode(ch.seg, ch.e_first + __ffs(m) - 1, s, r, c, lin);
    const Fit f = fit_at(S, ch.seg, lin);
    movers += move(f, S.border[ch.seg.o * S.ms_p + s], ch.seg.oh, ch.seg.ow,
                   lin, r, c);
  }
  int nc, nm;
  block_scan(__popc(ch.bits), nc, S);
  block_scan(movers, nm, S);
  if (threadIdx.x == 0) {
    a.counts[2 * blockIdx.x] = nc;
    a.counts[2 * blockIdx.x + 1] = nm;
  }
}

// One block: exclusive offsets of both counts over the chunks, in order.
__global__ void __launch_bounds__(F_SCAN_THREADS)
    extrema_scan(const FArgs a, int nchunks) {
  __shared__ long long part[F_SCAN_THREADS / 32 + 1];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nchunks + F_SCAN_THREADS - 1) / F_SCAN_THREADS;
  const int i0 = min(t * per, nchunks), i1 = min(i0 + per, nchunks);
  // candidates in the high word, movers in the low: neither sum reaches 2^31
  long long sum = 0;
  for (int i = i0; i < i1; ++i)
    sum += ((long long)a.counts[2 * i] << 32) + a.counts[2 * i + 1];
  long long x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) part[warp + 1] = x;
  __syncthreads();
  if (t == 0) {
    part[0] = 0;
    for (int w = 1; w <= F_SCAN_THREADS / 32; ++w) part[w] += part[w - 1];
  }
  __syncthreads();
  long long run = part[warp] + x - sum;
  for (int i = i0; i < i1; ++i) {
    a.offs[2 * i] = (int)(run >> 32);
    a.offs[2 * i + 1] = (int)(run & 0xffffffffLL);
    run += ((long long)a.counts[2 * i] << 32) + a.counts[2 * i + 1];
  }
  if (t == 0) {
    const int total = (int)(part[F_SCAN_THREADS / 32] >> 32);
    *a.count = min(total, a.cap);
    *a.walkers = 0;
  }
}

__global__ void __launch_bounds__(F_THREADS)
    extrema_place(const FArgs a, int nchunks) {
  __shared__ FShared S;
  load_plan(a, S);
  if ((int)blockIdx.x >= nchunks) {
    // the empty slots: the twin's fields at flat index 0 with a zero fit
    const int count = *a.count;
    const Fit zero = {0.f, 0.f, 0.f, 0.f};
    const int first = (blockIdx.x - nchunks) * F_FILL;
    for (int k = threadIdx.x; k < F_FILL; k += F_THREADS) {
      const int slot = first + k;
      if (slot >= count && slot < a.cap)
        write_slot(a, slot, false, zero, 0, 0, 0, S.octnum[0], 0, 0);
    }
    return;
  }
  const int cand_off = a.offs[2 * blockIdx.x];
  if (cand_off >= a.cap) return;           // the whole block: past the cap
  const int mover_off = a.offs[2 * blockIdx.x + 1];
  const Chunk ch = load_chunk(S, blockIdx.x);
  const Seg& g = ch.seg;
  int nc;
  const int t_off = cand_off + block_scan(__popc(ch.bits), nc, S);

  // pass 1: this thread's movers among the candidates inside the cap
  int movers = 0, j = 0;
  for (unsigned m = ch.bits; m && t_off + j < a.cap; m &= m - 1, ++j) {
    int s, r, c, lin;
    decode(g, ch.e_first + __ffs(m) - 1, s, r, c, lin);
    movers += move(fit_at(S, g, lin), S.border[g.o * S.ms_p + s], g.oh, g.ow,
                   lin, r, c);
  }
  int nm;
  int rank = mover_off + block_scan(movers, nm, S);
  if (threadIdx.x == 0 && nm) atomicAdd(a.walkers, nm);

  // pass 2: first fit, the walk of the movers ranked below cap2, fields
  j = 0;
  for (unsigned m = ch.bits; m && t_off + j < a.cap; m &= m - 1, ++j) {
    int s, r, c, lin;
    decode(g, ch.e_first + __ffs(m) - 1, s, r, c, lin);
    const int border = S.border[g.o * S.ms_p + s];
    Fit f = fit_at(S, g, lin);
    int rf = r, cf = c;
    if (move(f, border, g.oh, g.ow, lin, r, c) && rank++ < a.cap2) {
      for (int it = 1; it < a.interp_moves; ++it) {
        f = fit_at(S, g, lin);
        rf = r;
        cf = c;
        if (!move(f, border, g.oh, g.ow, lin, r, c)) break;
      }
    }
    write_slot(a, t_off + j, true, f, s, rf, cf, g.octnum, g.o, g.b);
  }
}

extern "C" {

// resp / masks: host arrays of noct device pointers, each octave's
// (nframes, ms, oh, ow) float32 layers and one-byte masks; plan: the
// device table of ops/extrema.py:extrema_plan with nchunks = nframes *
// chunks a frame; scratch: 4 * nchunks ints; fields: nx, ny, ns, strength,
// cap floats each; ifields: octave, frame (cap ints each), count, walkers.
int surf_extrema(const void* const* resp, const void* const* masks, int noct,
                 const int* plan, int nchunks, int cap, int cap2,
                 int interp_moves, float thresh, float init_lobe,
                 float max_scale, int* scratch, bool* valid, float* fields,
                 int* ifields, void* stream) {
  if (noct < 1 || noct > F_MAX_OCT || nchunks < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  FArgs a;
  for (int o = 0; o < F_MAX_OCT; ++o) {
    a.resp[o] = o < noct ? (const float*)resp[o] : nullptr;
    a.mask[o] = o < noct ? (const unsigned char*)masks[o] : nullptr;
  }
  a.plan = plan;
  a.cap = cap;
  a.cap2 = cap2;
  a.interp_moves = interp_moves;
  a.thresh = thresh;
  a.init_lobe = init_lobe;
  a.max_scale = max_scale;
  a.counts = scratch;
  a.offs = scratch + 2 * nchunks;
  a.valid = valid;
  a.nx = fields;
  a.ny = fields + cap;
  a.ns = fields + 2 * (size_t)cap;
  a.strength = fields + 3 * (size_t)cap;
  a.octave = ifields;
  a.frame = ifields + cap;
  a.count = ifields + 2 * (size_t)cap;
  a.walkers = a.count + 1;
  cudaStream_t s = (cudaStream_t)stream;
  extrema_count<<<nchunks, F_THREADS, 0, s>>>(a);
  extrema_scan<<<1, F_SCAN_THREADS, 0, s>>>(a, nchunks);
  const int nfill = (cap + F_FILL - 1) / F_FILL;
  extrema_place<<<nchunks + nfill, F_THREADS, 0, s>>>(a, nchunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
