// Kernel C: fused brute-force matcher, fp32 dot products + running best /
// second-best / index, with the score matrix never written to HBM.
//
// Replaces the TPU kernel cuda_surf_tpu/ops/matcher_pallas.py:_kernel
// (launched by fused_best2).  Plain twin:
// cuda_surf_tpu_torch/ops/matcher_kernel.py:_best2_plain (torch.matmul in
// fp32 + masked max / argmax).
//
// What bounds it on the H100: instruction rates.  4096 x 4096 x 64 is 1.07
// GFMA, and the (N1, N2) f32 score matrix it avoids writing is 67 MB, more
// than the L2.  On the FMA pipe nvcc's code starts an FMA only every 1.5-1.7
// cycles a scheduler even in a loop without loads (probe_rates.cu beside
// probe_stages.py), ~60 % of the card's 67 TFLOP/s, and an fp32 version
// of this kernel (8 x 8 scores a thread, operands 16 bytes a load) sat at
// half of it whatever its tiles, ring or unrolling.  The tensor cores take
// the same product as 3xTF32 at 6.6-7.0 cycles per m16n8k8 mma.sync a
// scheduler (measured; 4 at the data-sheet rate), three mma a product: a
// quarter to 40 % less time than the FMAs, the same answers to ~1e-6.  The
// design:
//
//   * both sets lie row-major in shared memory, as they lie in device
//     memory, with rows padded by four floats, so that the lanes of an mma
//     fragment (8 rows x 4 depths) hit 32 distinct banks;
//   * a block owns 128 set-1 rows, which it loads once and keeps for its life
//     (32 KB at D = 64, 64 KB at D = 128: dynamic shared memory);
//   * set 2 streams in chunks of 128 columns x 32 depths through a ring of
//     MT_STAGES buffers filled with cp.async, one __syncthreads a chunk, so
//     the loads of chunk c + 2 are in flight while chunk c multiplies;
//   * a block is 2 x 2 warps of 64 x 64 scores (two blocks an SM at D = 64);
//     a warp's scores stay in its mma accumulators for all of D and are
//     folded straight into the threads' running top-2.  Operands are split
//     into TF32 big and small parts in registers by integer rounding
//     (cvt.rna.tf32 measured slower);
//   * when the row blocks alone cannot fill the card, set 2 is split over
//     `splits` blocks per row block; each writes its partial top-2, and the
//     last one to finish (a device counter behind a __threadfence) merges
//     them in split order: one launch, no merge kernel.  The counter holds
//     the launch's number beside the arrivals, so what an earlier launch
//     left there, whole or cut short, counts as nothing and need not be
//     cleared (a memset before the launch is a second device operation);
//   * grid z is a pair index: P independent (set 1, set 2) pairs in one
//     launch.
//
// Measured slower or no faster on the card (PERF.md, section 6): the fp32
// FMA version above (bit-equal to this kernel's first version; 79-81 us
// against 60-62 at D = 64); as build-time variants of this source, none
// shipped: a ring of 2 or 4 buffers, 4 x 2 warps of 32 x 64, a register cap
// for two blocks of those an SM.  wgmma (the full tensor rate) is not tried.
//
// Tie rules (matcher_pallas.py:65-76, ops/matcher.py:match):
//   * a thread visits its columns in increasing order: a strictly larger
//     score replaces best and the old best moves to second; an equal or
//     smaller score can only raise second, so second excludes exactly the
//     argmax column and the first index wins exact ties;
//   * threads, warps and then splits merge with the smallest index winning
//     equal bests (and the tie value becoming second), a commutative,
//     associative rule, so neither the shuffle tree, the number of splits
//     nor which block finishes last can change the result;
//   * invalid set-2 columns score -1e30.

#include <cuda_runtime.h>
#include <stdint.h>

// The measured shape, fixed.
#define MT_MI 4            // 16-row mma tiles down a warp
#define MT_NI 8            // 8-column mma tiles across a warp
#define MT_WR 2            // warps down a block
#define MT_WC 2            // warps across a block
#define MT_STAGES 3        // ring buffers of set-2 chunks
#define MT_BK 32                     // depths a chunk
#define MT_LDB (MT_BK + 4)           // padded row of a chunk, floats
#define MT_NEG (-1e30f)

__device__ __forceinline__ void merge_top2(float& b, float& s, int& i, float ob,
                                           float os, int oi) {
  if (ob > b || (ob == b && oi < i)) {
    s = (ob == b) ? b : fmaxf(os, b);
    b = ob;
    i = oi;
  } else {
    s = (ob == b) ? b : fmaxf(s, ob);
  }
}

// 16 bytes global -> shared, past L1; `bytes` = 0 writes zeros instead
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small + (an error below 2^-21 |x|): big is x rounded to TF32's
// 10 mantissa bits (half away from zero, in integer arithmetic on the bits:
// cvt.rna.tf32 measured several times slower than these ALU operations),
// small is the exact rest cut to 10 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's tile of scores in registers, on the tensor cores as 3xTF32: each
// operand is split into a TF32 big part and a TF32 small part, and a product
// is small x big + big x small + big x big in three m16n8k8 mma with fp32
// accumulators (only small x small, below 2^-22 of the product, is dropped).
// Lane (g, t) = (lane / 4, lane % 4) holds rows 16 mi + g, + 8 and columns
// 8 ni + 2 t, + 1 of the warp's (16 MT_MI) x (8 MT_NI) scores.
struct Tile {
  static constexpr int WM = 16 * MT_MI, WN = 8 * MT_NI;   // a warp's scores
  static constexpr int WR = MT_WR, WC = MT_WC;           // a block's warps
  static constexpr int ROWS = 2 * MT_MI;                 // rows a thread
  static constexpr int PEER = 2;   // lanes t = 0..3 share a row: xor 2, 1
  float acc[MT_MI][MT_NI][4];
  int g, t;
  __device__ explicit Tile(int lane) : g(lane >> 2), t(lane & 3) {}
  __device__ int row(int r) const { return 16 * (r >> 1) + 8 * (r & 1) + g; }
  __device__ bool writer() const { return t == 0; }
  __device__ void zero() {
#pragma unroll
    for (int mi = 0; mi < MT_MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < MT_NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  }
  // += a (WM rows, stride lda) x b (WN rows, stride MT_LDB) over MT_BK depths
  __device__ void product(const float* a_rows, int lda, const float* b_rows) {
    const float* a_ptr = a_rows + g * lda + t;
    const float* b_ptr = b_rows + g * MT_LDB + t;
#pragma unroll
    for (int k8 = 0; k8 < MT_BK; k8 += 8) {
      uint32_t ab[MT_MI][4], as[MT_MI][4], bb[MT_NI][2], bs[MT_NI][2];
#pragma unroll
      for (int mi = 0; mi < MT_MI; ++mi) {
        const float* q = a_ptr + 16 * mi * lda + k8;
        split_tf32(q[0], ab[mi][0], as[mi][0]);
        split_tf32(q[8 * lda], ab[mi][1], as[mi][1]);
        split_tf32(q[4], ab[mi][2], as[mi][2]);
        split_tf32(q[8 * lda + 4], ab[mi][3], as[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < MT_NI; ++ni) {
        const float* q = b_ptr + 8 * ni * MT_LDB + k8;
        split_tf32(q[0], bb[ni][0], bs[ni][0]);
        split_tf32(q[4], bb[ni][1], bs[ni][1]);
      }
      // small terms first; a sum's three mma depend on each other, so each
      // term goes over the whole tile before the next
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int mi = 0; mi < MT_MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < MT_NI; ++ni)
            mma_tf32(acc[mi][ni], term == 0 ? as[mi] : ab[mi],
                     term == 1 ? bs[ni] : bb[ni]);
    }
  }
  // f(column in the warp's tile, the thread's ROWS scores of it), columns
  // in increasing order
  template <class F>
  __device__ void columns(F f) const {
#pragma unroll
    for (int ni = 0; ni < MT_NI; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) v[r] = acc[r >> 1][ni][2 * (r & 1) + e];
        f(8 * ni + 2 * t + e, v);
      }
  }
};

struct Geometry {
  static constexpr int THREADS = Tile::WR * Tile::WC * 32;
  static constexpr int BM = Tile::WR * Tile::WM;   // set-1 rows a block: 128
  static constexpr int BN = Tile::WC * Tile::WN;   // set-2 columns a tile: 128
  static_assert(BM == 128 && BN == 128,
                "ops/matcher_kernel.py plans splits and sizes `done` by these");
  static_assert(BM <= THREADS, "one thread per block row in the epilogue");
  static_assert((BN * MT_BK / 4) % THREADS == 0, "whole chunk loads");
  static_assert(MT_STAGES * BN * MT_LDB >= 3 * Tile::WC * BM,
                "the ring holds the cross-warp merge");
  static int smem_bytes(int D) {
    return (BM * (D + 4) + MT_STAGES * BN * MT_LDB) * (int)sizeof(float);
  }
};

// d1 (P, N1, D), d2 (P, N2, D), valid2 (P, N2); grid (row blocks, splits, P).
// part_*: (P, splits, N1) partial top-2s and done: (P, row blocks) counters,
// epoch << 8 | arrivals, where `epoch` (24 bits) differs from launch to launch
// on this scratch; both unused at splits = 1.
__global__ void __launch_bounds__(Geometry::THREADS)
best2_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
             const bool* __restrict__ valid2, int N1, int N2, int D, int chunk,
             float* part_best, float* part_second, int* part_index,
             unsigned* done, unsigned epoch, float* __restrict__ best_out, float* __restrict__ second_out,
             int* __restrict__ index_out) {
  constexpr int BM = Geometry::BM, BN = Geometry::BN;
  constexpr int THREADS = Geometry::THREADS, WC = Tile::WC;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);     // BM x (D + 4)
  const int lda = D + 4;
  float* Bs = As + BM * lda;                       // MT_STAGES x BN x MT_LDB
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = warp / WC, wc = warp % WC;
  const int p = blockIdx.z, splits = gridDim.y;
  const int m0 = blockIdx.x * BM;
  d1 += (size_t)p * N1 * D;
  d2 += (size_t)p * N2 * D;
  valid2 += (size_t)p * N2;
  // this block's share of set 2: columns [c_begin, c_end)
  const int c_begin = min(N2, blockIdx.y * chunk);
  const int c_end = min(N2, c_begin + chunk);
  const int KC = D / MT_BK;
  const int nchunks = ((c_end - c_begin + BN - 1) / BN) * KC;

  auto load_chunk = [&](int c) {
    const int n0 = c_begin + (c / KC) * BN, k0 = (c % KC) * MT_BK;
    float* dst = Bs + (c % MT_STAGES) * BN * MT_LDB;
#pragma unroll
    for (int r = 0; r < BN * MT_BK / 4 / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int col = e >> 3, k4 = (e & 7) * 4;
      const int gc = n0 + col;
      const bool ok = gc < c_end;
      cp_async16(dst + col * MT_LDB + k4,
                 d2 + (size_t)(ok ? gc : 0) * D + k0 + k4, ok ? 16 : 0);
    }
  };

  // prologue: set 1 and the first MT_STAGES - 1 chunks
  for (int e = tid; e < BM * (D / 4); e += THREADS) {
    const int row = e / (D / 4), k4 = (e % (D / 4)) * 4;
    const bool ok = m0 + row < N1;
    cp_async16(As + row * lda + k4,
               d1 + (size_t)(ok ? m0 + row : 0) * D + k4, ok ? 16 : 0);
  }
#pragma unroll
  for (int s = 0; s < MT_STAGES - 1; ++s) {
    if (s < nchunks) load_chunk(s);
    cp_async_commit();
  }

  float best[Tile::ROWS], second[Tile::ROWS];
  int idx[Tile::ROWS];
#pragma unroll
  for (int r = 0; r < Tile::ROWS; ++r) {
    best[r] = MT_NEG;
    second[r] = MT_NEG;
    idx[r] = 0;
  }
  Tile tile(lane);

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<MT_STAGES - 2>();   // chunk c has landed (this thread's part)
    __syncthreads();                  // ... everyone's; chunk c - 1 is consumed
    if (c + MT_STAGES - 1 < nchunks) load_chunk(c + MT_STAGES - 1);
    cp_async_commit();

    const int kc = c % KC;
    if (kc == 0) tile.zero();
    tile.product(As + wr * Tile::WM * lda + kc * MT_BK, lda,
                 Bs + ((c % MT_STAGES) * BN + wc * Tile::WN) * MT_LDB);

    if (kc == KC - 1) {   // the tile's scores are whole: fold them in
      const int n0 = c_begin + (c / KC) * BN + wc * Tile::WN;
      tile.columns([&](int j, const float (&v)[Tile::ROWS]) {
        const int col = n0 + j;
        const bool ok = col < c_end && valid2[col];
#pragma unroll
        for (int r = 0; r < Tile::ROWS; ++r) {
          const float x = ok ? v[r] : MT_NEG;
          // x > best: best moves to second; else x can only raise second
          second[r] = fmaxf(second[r], fminf(x, best[r]));
          idx[r] = x > best[r] ? col : idx[r];
          best[r] = fmaxf(best[r], x);
        }
      });
    }
  }
  cp_async_wait<0>();
  __syncthreads();        // the ring is free: it holds the cross-warp merge

  // merge the lanes that share a row ...
#pragma unroll
  for (int off = Tile::PEER; off >= 1; off >>= 1) {
#pragma unroll
    for (int r = 0; r < Tile::ROWS; ++r) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[r], off);
      const float os = __shfl_xor_sync(0xffffffffu, second[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[r], off);
      merge_top2(best[r], second[r], idx[r], ob, os, oi);
    }
  }
  // ... then the WC warps across, through shared memory
  float* m_best = Bs;
  float* m_second = Bs + WC * BM;
  int* m_index = reinterpret_cast<int*>(Bs + 2 * WC * BM);
  if (tile.writer()) {
#pragma unroll
    for (int r = 0; r < Tile::ROWS; ++r) {
      const int q = wc * BM + wr * Tile::WM + tile.row(r);
      m_best[q] = best[r];
      m_second[q] = second[r];
      m_index[q] = idx[r];
    }
  }
  __syncthreads();
  const int row = m0 + tid;
  const bool mine = tid < BM && row < N1;
  float b = MT_NEG, s = MT_NEG;
  int ix = 0;
  if (mine) {
    b = m_best[tid];
    s = m_second[tid];
    ix = m_index[tid];
    for (int w = 1; w < WC; ++w)
      merge_top2(b, s, ix, m_best[w * BM + tid], m_second[w * BM + tid],
                 m_index[w * BM + tid]);
  }
  const size_t out0 = (size_t)p * N1;
  if (splits == 1) {
    if (mine) {
      best_out[out0 + row] = b;
      second_out[out0 + row] = s;
      index_out[out0 + row] = ix;
    }
    return;
  }

  // several splits: publish this one's partials; the last block of the row
  // block to get here merges them all, in split order
  const size_t part0 = (size_t)p * splits * N1;
  if (mine) {
    const size_t q = part0 + (size_t)blockIdx.y * N1 + row;
    part_best[q] = b;
    part_second[q] = s;
    part_index[q] = ix;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned* counter = done + p * gridDim.x + blockIdx.x;
    unsigned seen = *counter, held, arrivals;
    do {   // a count of another epoch is no count
      held = seen;
      arrivals = (held >> 8) == epoch ? (held & 255u) + 1u : 1u;
      seen = atomicCAS(counter, held, epoch << 8 | arrivals);
    } while (seen != held);
    s_last = arrivals == (unsigned)splits;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (mine) {
    const size_t q = part0 + row;
    b = __ldcg(part_best + q);
    s = __ldcg(part_second + q);
    ix = __ldcg(part_index + q);
    for (int k = 1; k < splits; ++k) {
      const size_t qk = q + (size_t)k * N1;
      merge_top2(b, s, ix, __ldcg(part_best + qk), __ldcg(part_second + qk),
                 __ldcg(part_index + qk));
    }
    best_out[out0 + row] = b;
    second_out[out0 + row] = s;
    index_out[out0 + row] = ix;
  }
}

// P pairs: d1 (P, N1, D), d2 (P, N2, D), valid2 (P, N2) -> best, second,
// index (P, N1).  D a multiple of 32.  part_*: (P, splits, N1) scratch and
// done: (P, row blocks) counters with `epoch`, a number that the caller
// changes with every launch on this scratch (its low 24 bits count); both are
// used only when splits > 1, which is at most 255.
extern "C" int surf_best2(const float* d1, const float* d2, const bool* valid2,
                          int P, int N1, int N2, int D, int splits,
                          float* part_best, float* part_second,
                          int* part_index, unsigned* done, unsigned epoch,
                          float* best, float* second, int* index,
                          void* stream) {
  using G = Geometry;
  if (N1 <= 0 || P <= 0) return 0;
  if (splits < 1 || splits > 255 || P > 65535 || D <= 0 || D % MT_BK != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = G::smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      best2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // columns per split, a whole number of tiles
  const int tiles = (N2 + G::BN - 1) / G::BN;
  const int chunk = ((tiles + splits - 1) / splits) * G::BN;
  dim3 grid((N1 + G::BM - 1) / G::BM, splits, P);
  best2_kernel<<<grid, G::THREADS, smem, (cudaStream_t)stream>>>(
      d1, d2, valid2, N1, N2, D, chunk, part_best, part_second, part_index,
      done, epoch & 0xffffffu, best, second, index);
  return (int)cudaGetLastError();
}

// Blocks of kernel C that fit one SM at depth D, from the registers it was
// compiled to and its dynamic shared memory; *warps is a block's warps.
extern "C" int surf_best2_occupancy(int D, int* blocks, int* warps) {
  const int smem = Geometry::smem_bytes(D);
  *warps = Geometry::THREADS / 32;
  cudaError_t err = cudaFuncSetAttribute(
      best2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, best2_kernel, Geometry::THREADS, smem);
}
