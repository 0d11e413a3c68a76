// Kernel D: SURF keypoint orientation, one warp per keypoint, from the
// integral image and the keypoint's x, y, scale to the angle.
//
// Replaces the TPU kernel cuda_surf_tpu/ops/patch_bucketed.py:_kernel in
// mode "grids" (reached through patch_wavelets.wavelet_grids from
// orientation.assign_orientations), which only sampled the raw Haar dy/dx
// grids, and folds in the histogram and window stage that the JAX package
// runs in XLA after it.  Modelled on the reference's K16,
// assignOrientationApprox (surfd.cu:1711-1960).  Plain twin:
// cuda_surf_tpu_torch/ops/orientation.py:assign_orientations_plain.
//
// What bounds it on the H100: the L1 pipe of the integral-image gathers and
// instruction count.  A keypoint samples the 253 positions of the 19x19
// grid inside radius 9, each reading 12 int32 corners of the integral image
// (4.9 MB, 19.7 MB doubled: it stays in L2), `step` pixels apart, so a
// gather of 32 lanes touches 8-32 sectors; the TPU needed selection matmuls
// over int8 limb planes for this because it has no fast gather.  The bytes
// bound (the image read once) is far below either.  The design:
//
//   * a warp owns a keypoint and walks the table of the 253 disc positions
//     in 8 rounds (the first version walked all 361 grid positions with 128
//     threads); OR_WARPS keypoints share a block and nothing else, so there
//     is no block barrier, and an invalid slot costs one warp's early exit;
//   * the 72 x 4 histogram sums come from a stable counting sort by bin in
//     shared memory instead of 72 threads scanning every sample: a sample's
//     rank in its bin is the bin's count so far plus the lower lanes of the
//     round with the same bin (__match_any_sync), a prefix over the 72 counts
//     gives each bin's offset, the samples' (angle, weighted magnitude) are
//     scattered to offset + rank, and lane b adds its own contiguous run;
//   * the first maximum of the 72 windows is a warp reduction that keeps the
//     lower index on equal values;
//   * the kernel computes the disc's centre, sample spacing and Haar size
//     from x, y, scale itself (orientation.py:orient_geometry's expressions),
//     so the wrapper launches it on the keypoint fields as they are;
//   * over a stack of B frames' integral images, keypoint k reads frame
//     frame[k] at ii + frame[k] * ih * iw (a size_t offset), with x, y and
//     the border tests frame-local, so its angle is the one the single-frame
//     launch gives on that frame alone: the batch frontend orients all its
//     B * max_pts slots in one launch.  A slot whose frame lies outside
//     [0, nframes) is never read and gets 0, as an invalid slot does.
//
// Determinism: no float atomics.  Every bin's sums run over its samples in
// increasing sample index, as in the first version, whose angles this one
// repeats bit for bit; results repeat bit for bit run to run.
//
// Arithmetic follows the twin's expressions and order with __fmul_rn /
// __fadd_rn / __fdiv_rn / __fsqrt_rn so that nvcc contracts nothing into
// an FMA: fast_atan2's polynomial, the bin index trunc((a + pi) / sep) %
// 72, psum = lut1[distsq] * mag, avg with the bin-centre fallback, the
// +/-2pi wrapped copies, the 11-bin sums and the fractional edges.  The
// wrapper passes the Gaussian LUT, the bin centres and the edge bases as
// float32 tables computed with the twin's own expressions.

#include <cuda_runtime.h>
#include <math.h>

#define OR_WARPS 4         // keypoints (warps) a block
#define OR_RADIUS 9
#define OR_N (2 * OR_RADIUS + 1)
#define OR_DISC 253        // grid positions with dy^2 + dx^2 < 81.5
#define OR_ROUNDS ((OR_DISC + 31) / 32)
#define OR_NBIN 72
#define OR_HWN 6
#define OR_LUT 83
#define OR_FULL 0xffffffffu

// the disc's positions as indices (dy + 9) * 19 + (dx + 9), increasing
__device__ const unsigned short DISC_Q[OR_ROUNDS * 32] = {
    9, 24, 25, 26, 27, 28, 29, 30, 31, 32, 42, 43, 44, 45, 46, 47,
    48, 49, 50, 51, 52, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70,
    71, 72, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91,
    92, 96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110,
    111, 112, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 125, 126, 127, 128,
    129, 130, 131, 134, 135, 136, 137, 138, 139, 140, 141, 142, 143, 144, 145, 146,
    147, 148, 149, 150, 153, 154, 155, 156, 157, 158, 159, 160, 161, 162, 163, 164,
    165, 166, 167, 168, 169, 171, 172, 173, 174, 175, 176, 177, 178, 179, 180, 181,
    182, 183, 184, 185, 186, 187, 188, 189, 191, 192, 193, 194, 195, 196, 197, 198,
    199, 200, 201, 202, 203, 204, 205, 206, 207, 210, 211, 212, 213, 214, 215, 216,
    217, 218, 219, 220, 221, 222, 223, 224, 225, 226, 229, 230, 231, 232, 233, 234,
    235, 236, 237, 238, 239, 240, 241, 242, 243, 244, 245, 248, 249, 250, 251, 252,
    253, 254, 255, 256, 257, 258, 259, 260, 261, 262, 263, 264, 268, 269, 270, 271,
    272, 273, 274, 275, 276, 277, 278, 279, 280, 281, 282, 288, 289, 290, 291, 292,
    293, 294, 295, 296, 297, 298, 299, 300, 308, 309, 310, 311, 312, 313, 314, 315,
    316, 317, 318, 328, 329, 330, 331, 332, 333, 334, 335, 336, 351,
};

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

// dFastAtan2 (surfd.cu:114-126), in ops/orientation.py:fast_atan2's order
__device__ __forceinline__ float fast_atan2(float y, float x) {
  const float PI = 3.14159265358979323846f;
  const float HALF_PI = 1.57079632679489661923f;
  const float absx = fabsf(x), absy = fabsf(y);
  const float a = __fdiv_rn(fminf(absx, absy), fmaxf(absx, absy));
  const float s = __fmul_rn(a, a);
  float r = __fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.0464964749f, s),
                                          0.15931422f), s),
                      0.327622764f);
  r = __fadd_rn(__fmul_rn(__fmul_rn(r, s), a), a);
  if (absy > absx) r = __fsub_rn(HALF_PI, r);
  if (x < 0.f) r = __fsub_rn(PI, r);
  if (y < 0.f) r = -r;
  return r;
}

// a warp's shared memory
struct WarpMem {
  int cnt[OR_NBIN], off[OR_NBIN];          // samples per bin, first slot
  float ang[OR_ROUNDS * 32], psum[OR_ROUNDS * 32];   // sorted by bin, stably
  float part[OR_NBIN], avg[OR_NBIN], pas[OR_NBIN + 2 * OR_HWN];
};

// x, y, scale: f32 (K,), valid: bool (K,); frame: int32 (K,), or null for
// one frame (nframes is then ignored);
// tab: f32 [lut1 (83) | bin centres (72) | base_l (72) | base_r (72)].
__global__ void __launch_bounds__(OR_WARPS * 32)
orient_kernel(const int* __restrict__ ii, int nframes, int ih, int iw,
              const float* __restrict__ kx, const float* __restrict__ ky,
              const float* __restrict__ kscale, const bool* __restrict__ valid,
              const int* __restrict__ frame, int doubled,
              const float* __restrict__ tab, int K, float* __restrict__ out) {
  __shared__ WarpMem mem[OR_WARPS];
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * OR_WARPS + (threadIdx.x >> 5);
  if (k >= K) return;   // a whole warp leaves: no lane waits for it below
  const int f = frame != nullptr ? frame[k] : 0;
  const int nf = frame != nullptr ? nframes : 1;
  if (!valid[k] || f < 0 || f >= nf) {   // invalid slot, or off the stack
    if (lane == 0) out[k] = 0.f;
    return;
  }
  ii += (size_t)f * ih * iw;   // the keypoint's frame; all else frame-local
  WarpMem& m = mem[threadIdx.x >> 5];
  // orient_geometry: centre round(x), round(y); spacing trunc(scale + 0.8);
  // Haar size trunc(2 scale + 1.6); all doubled first on a doubled image
  float fx = kx[k], fy = ky[k], fs = kscale[k];
  if (doubled) {
    fx = __fmul_rn(2.f, fx);
    fy = __fmul_rn(2.f, fy);
    fs = __fmul_rn(2.f, fs);
  }
  const int cx = (int)rintf(fx), cy = (int)rintf(fy);
  const int step = (int)truncf(__fadd_rn(fs, 0.8f));
  const int s = (int)truncf(__fadd_rn(__fmul_rn(2.f, fs), 1.6f));
  const float* lut = tab;
  const float* bins = tab + OR_LUT;
  const float* base_l = bins + OR_NBIN;
  const float* base_r = base_l + OR_NBIN;
  const float PI = 3.14159265358979323846f;
  const float TWO_PI = 6.28318530717958647692f;
  const float SEP = 0.08726646259971647f;
  const unsigned lower = (1u << lane) - 1u;

  for (int b = lane; b < OR_NBIN; b += 32) m.cnt[b] = 0;
  __syncwarp();

  // sample the disc, 32 positions a round; rank[r] is the sample's place
  // among the samples of its bin, in increasing sample index
  int bin[OR_ROUNDS], rank[OR_ROUNDS];
  float ang[OR_ROUNDS], psum[OR_ROUNDS];
#pragma unroll
  for (int r = 0; r < OR_ROUNDS; ++r) {
    const int t = r * 32 + lane;
    bin[r] = -1;   // -1: sample masked
    ang[r] = 0.f;
    psum[r] = 0.f;
    if (t < OR_DISC) {
      const int q = DISC_Q[t];
      const int y1 = q / OR_N - OR_RADIUS, x1 = q % OR_N - OR_RADIUS;
      const int distsq = y1 * y1 + x1 * x1;
      const int xx = cx + x1 * step, yy = cy + y1 * step;
      if (yy + s + 2 < ih && yy - s > -1 && xx + s + 2 < iw && xx - s > -1) {
        // getWavelet2 / getWavelet1 (surfd.cu:1171-1182)
        const int wdx = box_sum(ii, iw, xx + s, yy + s, xx, yy - s)
                        - box_sum(ii, iw, xx, yy + s, xx - s, yy - s);
        const int wdy = box_sum(ii, iw, xx + s, yy, xx - s, yy - s)
                        - box_sum(ii, iw, xx + s, yy + s, xx - s, yy);
        const float dx = __fmul_rn((float)wdx, 0.003921568627f);
        const float dy = __fmul_rn((float)wdy, 0.003921568627f);
        const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        if (mag > 0.f) {  // (0, 0) would be atan2's 0/0: skipped
          const float angle = fast_atan2(dy, dx);
          bin[r] = (int)truncf(__fdiv_rn(__fadd_rn(angle, PI), SEP)) % OR_NBIN;
          ang[r] = angle;
          psum[r] = __fmul_rn(lut[min(distsq, OR_LUT - 1)], mag);
        }
      }
    }
    const unsigned peers = __match_any_sync(OR_FULL, bin[r]);
    rank[r] = bin[r] >= 0 ? m.cnt[bin[r]] + __popc(peers & lower) : 0;
    __syncwarp();
    if (bin[r] >= 0 && (peers & lower) == 0) m.cnt[bin[r]] += __popc(peers);
    __syncwarp();
  }

  // exclusive prefix over the 72 counts, three bins a lane
  {
    int c0 = 0, c1 = 0, c2 = 0;
    if (lane < OR_NBIN / 3) {
      c0 = m.cnt[3 * lane];
      c1 = m.cnt[3 * lane + 1];
      c2 = m.cnt[3 * lane + 2];
    }
    const int mine = c0 + c1 + c2;
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(OR_FULL, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane < OR_NBIN / 3) {
      m.off[3 * lane] = incl - mine;
      m.off[3 * lane + 1] = incl - mine + c0;
      m.off[3 * lane + 2] = incl - mine + c0 + c1;
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < OR_ROUNDS; ++r) {
    if (bin[r] >= 0) {
      const int at = m.off[bin[r]] + rank[r];
      m.ang[at] = ang[r];
      m.psum[at] = psum[r];
    }
  }
  __syncwarp();

  // the per-bin sums, each over the bin's run, i.e. in sample index order
  for (int b = lane; b < OR_NBIN; b += 32) {
    const int n = m.cnt[b], o = m.off[b];
    float asum = 0.f, ps = 0.f, apsum = 0.f;
    for (int e = o; e < o + n; ++e) {
      asum = __fadd_rn(asum, m.ang[e]);
      ps = __fadd_rn(ps, m.psum[e]);
      apsum = __fadd_rn(apsum, __fmul_rn(m.ang[e], m.psum[e]));
    }
    m.part[b] = ps;
    m.avg[b] = n > 0 ? __fdiv_rn(asum, (float)n) : bins[b];
    // wrapped slots (surfd.cu:1798-1806): slot b + HWN holds bin b; slots
    // 0..5 hold bins 66..71 less 2pi, slots 78..83 bins 0..5 plus 2pi
    m.pas[b + OR_HWN] = apsum;
    if (b >= OR_NBIN - OR_HWN)
      m.pas[b - (OR_NBIN - OR_HWN)] = __fsub_rn(apsum, __fmul_rn(TWO_PI, ps));
    if (b < OR_HWN)
      m.pas[b + OR_NBIN + OR_HWN] = __fadd_rn(apsum, __fmul_rn(TWO_PI, ps));
  }
  __syncwarp();

  // window w: the 11 whole bins w-5..w+5, then the fractional edges; each
  // lane keeps the first maximum of its windows w = lane, lane + 32, ...
  float top = 0.f, top_a = 0.f;
  int top_w = OR_NBIN;
  for (int w = lane; w < OR_NBIN; w += 32) {
    float ws = 0.f, was = 0.f;
    for (int j = -OR_HWN + 1; j < OR_HWN; ++j) {
      ws = __fadd_rn(ws, m.part[(w + j + OR_NBIN) % OR_NBIN]);
      was = __fadd_rn(was, m.pas[w + j + OR_HWN]);
    }
    const float ratio_l = __fdiv_rn(__fsub_rn(base_l[w], m.avg[w]), SEP);
    ws = __fadd_rn(ws, __fmul_rn(ratio_l, m.part[(w - OR_HWN + OR_NBIN) % OR_NBIN]));
    was = __fadd_rn(was, __fmul_rn(ratio_l, m.pas[w]));
    const float ratio_r = __fdiv_rn(__fadd_rn(m.avg[w], base_r[w]), SEP);
    ws = __fadd_rn(ws, __fmul_rn(ratio_r, m.part[(w + OR_HWN) % OR_NBIN]));
    was = __fadd_rn(was, __fmul_rn(ratio_r, m.pas[w + 2 * OR_HWN]));
    if (w == lane || ws > top) {
      top = ws;
      top_a = was;
      top_w = w;
    }
  }
  // first maximum across the lanes: an equal value keeps the lower window
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    const float o = __shfl_xor_sync(OR_FULL, top, d);
    const float oa = __shfl_xor_sync(OR_FULL, top_a, d);
    const int ow = __shfl_xor_sync(OR_FULL, top_w, d);
    if (o > top || (o == top && ow < top_w)) {
      top = o;
      top_a = oa;
      top_w = ow;
    }
  }
  if (lane == 0) out[k] = __fdiv_rn(top_a, top);
}

// One frame: ii (ih, iw), frame null.  A stack: ii (nframes, ih, iw) and
// frame (K,), keypoint k in frame frame[k].
extern "C" int surf_orient(const int* ii, int nframes, int ih, int iw,
                           const float* x, const float* y, const float* scale,
                           const bool* valid, const int* frame, int doubled,
                           const float* tab, int K, float* out, void* stream) {
  if (K <= 0) return 0;
  if (frame != nullptr && nframes <= 0) return (int)cudaErrorInvalidValue;
  orient_kernel<<<(K + OR_WARPS - 1) / OR_WARPS, OR_WARPS * 32, 0,
                  (cudaStream_t)stream>>>(ii, nframes, ih, iw, x, y, scale,
                                          valid, frame, doubled, tab, K, out);
  return (int)cudaGetLastError();
}

// Blocks of kernel D that fit one SM, from the registers and shared memory
// it was compiled to; *warps is a block's warps.
extern "C" int surf_orient_occupancy(int* blocks, int* warps) {
  *warps = OR_WARPS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, orient_kernel, OR_WARPS * 32, 0);
}
