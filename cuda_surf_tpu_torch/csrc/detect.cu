// Kernel A: the box-filter Hessian response layers of every octave and
// their 3x3x3 NMS candidate masks, for one frame or a stack of frames, in
// one launch.
//
// Replaces the TPU kernel cuda_surf_tpu/ops/fused_detect.py:_octave_kernel
// (launched by fused_octave / fused_pyramid).  Plain twins:
// cuda_surf_tpu_torch/ops/hessian.py:response_pyramid (layers) and
// cuda_surf_tpu_torch/ops/extrema.py:_candidate_mask (mask).
//
// What bounds it on the H100: by bytes it is the integral image read once
// and the float32 layers and one-byte masks written once, a few microseconds
// of HBM time; what it really waits for is the L1 pipe: every layer value
// gathers 32 integral-image corners, and the lanes of a warp are d words
// apart (d = 2 at octave 0, up to 16, doubled 32), so one gather is d / 8
// to d cache lines.  The per-octave version of it also paid eight launches
// and their tails (octaves 2 and 3 are 375 and 120 small blocks that cannot
// fill 132 SMs) and read every layer back for the mask.  The design:
//
// - One launch.  A 1-D grid walks a table of 30x14 output tiles of every
//   octave; with a stack of B frames every tile appears B times.  The
//   highest octave comes first: its tiles gather corners a sector and more
//   apart and are the slowest blocks, so they must not be the tail
//   (measured with octave 0 first: 75 against 66 us a frame, 182 against
//   128 doubled).
// - Layers and mask fused.  A block computes its tile of all `ms` layers
//   plus a one-cell halo into shared memory, writes the tile's layers
//   once, and takes the 3x3x3 test from shared memory.  Positions outside
//   the octave hold -inf, so they never win.  A halo value is computed
//   by the expression that computes it as an interior value of the
//   neighbouring tile, so the test sees the same numbers as a pass over
//   the finished layers would.  The tile plus halo is 32x16: a warp is one
//   row of it, lane = column, and the 8 warps take two rows each, so a
//   layer's geometry and corner offsets are the same for the whole warp and
//   each offset is read once for two values.  The halo is 22 % more values
//   than the tile has.
// - The geometry of all octaves (embed rectangles, the 32 corner offsets of
//   every layer, norms, NMS windows, the tile table) is one small int32
//   tensor that the wrapper builds once per configuration and frame size
//   and keeps on the device (ops/fused_detect.py:pyramid_plan): nothing is
//   rebuilt or passed by value per call.
// - Octave 0 is three quarters of the outputs and its filters are small
//   (corners at most 17 pixels from the centre), so its tile's
//   integral-image patch, 64 x 96 words, is staged in shared memory with
//   plain coalesced loads and all 5 x 32 corner reads of the tile are
//   served there.  The patch is stored in d column planes (column x in
//   plane x % d at x / d, the TPU kernel's phase planes in small), so the
//   lanes of a warp, d columns apart in the image, read consecutive words:
//   no bank conflict.  Measured, staging is 57 against 65 us on a frame and
//   no different on a stack of 8.  The other octaves' patches (60 KB on a
//   doubled frame's octave 0, 100 KB and more elsewhere) leave an SM three
//   blocks or fewer, and staging the doubled octave 0 measured slower (150
//   against 123 us); they gather with __ldg through L1 from the L2-resident
//   integral image.  Which octaves stage is the plan's decision, from the
//   patch size alone.
// - Registers: 56 a thread, 4 blocks (32 warps) an SM.  Capping them for 5,
//   6 or 8 blocks spilled and measured slower (63, 89, 97 us a frame).
// - Tile and block size.  A frame is only two waves of blocks, so fewer,
//   larger ones lose more at the tail than they save in halo: 30x30 tiles
//   (halo 14 % instead of 22 %) measured 71-76 against 50-55 us a frame
//   under the profiler and 147-149 against 107-111 on a doubled frame;
//   128-thread blocks on the same tile (36 warps an SM) 90 against 53,
//   136-138 against 115-117 doubled.  On a doubled frame, where no octave
//   stages and a gather is 4 cache lines and more, the halo's gathers make
//   this kernel slower than the per-octave pair of kernels it replaced
//   (107-117 against 88.6 us summed under the profiler, though 123-138
//   against 156-210 between events, which see the gaps between launches).
//
// Exactness: the determinant is written with __fmul_rn / __fsub_rn in the
// twin's evaluation order, so nvcc cannot contract it into an FMA, and the
// layers are bit-identical to the eager PyTorch twin.  The NMS `>=` ties
// and the 0.8*thresh cut therefore cannot flip between the two.  The two
// seed layers of octaves > 0 are computed at the previous octave's filter
// geometry straight from the integral image rather than by decimation.

#include <cuda_runtime.h>
#include <math.h>

constexpr int SURF_MAX_LAYERS = 8;
// 30x14 outputs a tile, so that the tile plus its halo is 32x16: a warp is
// one row of it (lane = column), and the 8 warps take two rows each
constexpr int TILE_W = 30, TILE_H = 14;
constexpr int HALO_W = TILE_W + 2, HALO_H = TILE_H + 2;
constexpr int A_THREADS = 256;
constexpr int A_WARPS = A_THREADS / 32;
static_assert(HALO_W == 32 && HALO_H == 2 * A_WARPS, "a warp is two halo rows");

// The plan's layout, int32 words (ops/fused_detect.py:pyramid_plan writes
// it and tests/test_torch_pyramid_plan.py reads it back):
//   [0] octaves  [1] ms, layers per octave  [2] tiles  [3..7] unused
//   per octave, OCT_INTS words from PLAN_HEADER:
//     [0] oh  [1] ow  [2] d, the sampling step  [3] 1 if the patch is staged
//     [4] dy0  [5] dx0, the patch's origin relative to d * (tile's halo
//     origin)  [6] patch rows  [7] patch columns  [8] columns per plane
//     [9] the octave's first element in the outputs, per frame
//     per layer, LAYER_INTS words from OCT_HEADER:
//       [0..3] r0 r1 c0 c1, the embed rectangle (zero outside)
//       [4] the norm's float bits  [5..8] r0 r1 c0 c1 of the NMS window
//       [16..47] the 32 corner offsets from the output's base address
//   per tile, 3 words after the octaves: octave, first row, first column
constexpr int PLAN_HEADER = 8;
constexpr int OCT_HEADER = 16;
constexpr int LAYER_INTS = 48;
constexpr int LAYER_CORNERS = 16;
constexpr int OCT_INTS = OCT_HEADER + SURF_MAX_LAYERS * LAYER_INTS;

// Corner k of a layer's 32 belongs to box k / 4: dxx = A - 3 B, dyy = C - 3 D,
// dxy = E + F - G - H, and within a box (getSum, surfd.cu:334-343) the
// corners count +(y1+1, x1+1) +(y2, x2) -(y2, x1+1) -(y1+1, x2).  Integer
// sums: exact in any order.
__host__ __device__ constexpr int corner_coef(int k) {
  const int box = k >> 2;
  const int c = box == 1 || box == 3 ? -3 : (box >= 6 ? -1 : 1);
  return (k & 3) < 2 ? c : -c;
}

// The layer's values at two outputs (base addresses b0, b1; ok0 / ok1: the
// output lies inside the layer's rectangle, where every corner is inside
// the frame).  q: the layer's 32 corner offsets, each read once for both.
// STAGED: p is the tile's patch in shared memory, which holds every corner
// of every halo cell, so nothing is predicated.
template <bool STAGED>
__device__ __forceinline__ void det2(const int* __restrict__ p, int b0,
                                     bool ok0, int b1, bool ok1, const int* q,
                                     float rr, float norm, float& v0,
                                     float& v1) {
  int dxx[2] = {0, 0}, dyy[2] = {0, 0}, dxy[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int o = q[k];
    int c0, c1;
    if constexpr (STAGED) {
      c0 = p[b0 + o];
      c1 = p[b1 + o];
    } else {
      c0 = ok0 ? __ldg(p + b0 + o) : 0;
      c1 = ok1 ? __ldg(p + b1 + o) : 0;
    }
    int* acc = k < 8 ? dxx : (k < 16 ? dyy : dxy);
    acc[0] += corner_coef(k) * c0;
    acc[1] += corner_coef(k) * c1;
  }
  float v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float fxx = (float)dxx[e];
    const float fyy = (float)dyy[e];
    const float fxy = __fmul_rn(0.6f, (float)dxy[e]);
    // rr * (dxx*dyy - dxy*dxy) * norm, no contraction (hessian.py order)
    v[e] = __fmul_rn(__fmul_rn(rr, __fsub_rn(__fmul_rn(fxx, fyy),
                                             __fmul_rn(fxy, fxy))), norm);
  }
  v0 = v[0];
  v1 = v[1];
}

__global__ void __launch_bounds__(A_THREADS)
pyramid_kernel(const int* __restrict__ ii, int nframes, int ih, int iw,
               const int* __restrict__ plan, float rr, float pre_t,
               float* __restrict__ layers, bool* __restrict__ masks) {
  extern __shared__ int dyn[];  // the tile's layers + halo, then the patch
  __shared__ int g[OCT_INTS];   // the tile's octave
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int noct = __ldg(plan), ms = __ldg(plan + 1);
  const int tile = blockIdx.x / nframes;
  const int f = blockIdx.x - tile * nframes;
  const int* te = plan + PLAN_HEADER + noct * OCT_INTS + 3 * tile;
  const int o = __ldg(te), row0 = __ldg(te + 1), col0 = __ldg(te + 2);
  for (int i = t; i < OCT_INTS; i += A_THREADS)
    g[i] = __ldg(plan + PLAN_HEADER + o * OCT_INTS + i);
  __syncthreads();

  const int oh = g[0], ow = g[1], d = g[2];
  const bool staged = g[3] != 0;
  const int pwd = g[8], pitch = d * pwd;
  float* lay = reinterpret_cast<float*>(dyn);    // [ms][HALO_H][HALO_W]
  int* patch = dyn + ms * HALO_H * HALO_W;       // [rows][d planes][pwd]
  const int* frame = ii + (size_t)f * ih * iw;
  if (staged) {
    // column x0 + pos * d + k of the frame goes to plane k, position pos:
    // consecutive lanes write consecutive words, and nothing is divided
    const int ph = g[6], pcols = g[7];
    const int y0 = d * (row0 - 1) + g[4], x0 = d * (col0 - 1) + g[5];
    for (int py = warp; py < ph; py += A_WARPS) {
      const int y = y0 + py;
      const bool y_in = y >= 0 && y < ih;
      const int* src = frame + (size_t)(y_in ? y : 0) * iw;
      for (int k = 0; k < d; ++k)
        for (int pos = lane; pos < pwd; pos += 32) {
          const int px = pos * d + k, x = x0 + px;
          // outside the frame: never read by a value inside its rectangle
          patch[py * pitch + k * pwd + pos] =
              (y_in && px < pcols && x >= 0 && x < iw) ? __ldg(src + x) : 0;
        }
    }
    __syncthreads();
  }

  // halo rows `warp` and `warp + A_WARPS`, halo column `lane`
  const size_t plane = (size_t)oh * ow;
  const size_t first = (size_t)nframes * g[9] + (size_t)f * ms * plane;
  const int c = col0 - 1 + lane;
  const bool c_in = c >= 0 && c < ow;
  const bool c_core = lane >= 1 && lane <= TILE_W;
  int rows[2], bases[2];
  bool in[2], core[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int hr = warp + e * A_WARPS;
    rows[e] = row0 - 1 + hr;
    in[e] = c_in && rows[e] >= 0 && rows[e] < oh;
    core[e] = in[e] && c_core && hr >= 1 && hr <= TILE_H;
    bases[e] = staged ? d * hr * pitch + lane : d * rows[e] * iw + d * c;
  }
  for (int li = 0; li < ms; ++li) {
    const int* L = g + OCT_HEADER + li * LAYER_INTS;
    bool ok[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      ok[e] = in[e] && rows[e] >= L[0] && rows[e] < L[1] && c >= L[2] && c < L[3];
    const float norm = __int_as_float(L[4]);
    float v[2] = {0.f, 0.f};
    if (staged)
      det2<true>(patch, bases[0], true, bases[1], true, L + LAYER_CORNERS, rr,
                 norm, v[0], v[1]);
    else if (__any_sync(0xffffffffu, ok[0] || ok[1]))
      det2<false>(frame, bases[0], ok[0], bases[1], ok[1], L + LAYER_CORNERS,
                  rr, norm, v[0], v[1]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // zero outside the layer's rectangle, -inf outside the octave
      const float val = ok[e] ? v[e] : (in[e] ? 0.f : -INFINITY);
      lay[(li * HALO_H + warp + e * A_WARPS) * HALO_W + lane] = val;
      if (core[e])
        layers[first + li * plane + (size_t)rows[e] * ow + c] = val;
    }
  }
  __syncthreads();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!core[e]) continue;
    const int hr = warp + e * A_WARPS;
    for (int s = 0; s < ms; ++s) {
      const int* W = g + OCT_HEADER + s * LAYER_INTS + 5;  // the NMS window
      bool is_max = false;
      if (rows[e] >= W[0] && rows[e] < W[1] && c >= W[2] && c < W[3]) {
        const float* ctr = lay + (s * HALO_H + hr) * HALO_W + lane;
        const float v = *ctr;
        if (v >= pre_t) {
          // 3x3x3 max; scales outside [0, ms) count as -inf too
          float mx = -INFINITY;
          for (int ds = -1; ds <= 1; ++ds) {
            if (s + ds < 0 || s + ds >= ms) continue;
            for (int dr = -1; dr <= 1; ++dr)
              for (int dc = -1; dc <= 1; ++dc)
                mx = fmaxf(mx, ctr[(ds * HALO_H + dr) * HALO_W + dc]);
          }
          is_max = v >= mx;
        }
      }
      masks[first + s * plane + (size_t)rows[e] * ow + c] = is_max;
    }
  }
}

extern "C" {

const char* surf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ii: (nframes, ih, iw) int32; plan: the device tensor described above,
// with `ntiles` tiles; smem_bytes: the plan's dynamic shared memory;
// layers / masks: every octave's (nframes, ms, oh, ow) block, one after
// the other.
int surf_pyramid(const int* ii, int nframes, int ih, int iw, const int* plan,
                 int ntiles, int smem_bytes, float rr, float pre_t,
                 float* layers, bool* masks, void* stream) {
  if (nframes < 1 || ntiles < 1 || smem_bytes < 0 ||
      (long long)ntiles * nframes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  pyramid_kernel<<<ntiles * nframes, A_THREADS, smem_bytes,
                   (cudaStream_t)stream>>>(ii, nframes, ih, iw, plan, rr,
                                           pre_t, layers, masks);
  return (int)cudaGetLastError();
}

// Blocks of kernel A that fit one SM at this much dynamic shared memory.
int surf_pyramid_occupancy(int smem_bytes, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, pyramid_kernel, A_THREADS, smem_bytes);
}

}  // extern "C"
