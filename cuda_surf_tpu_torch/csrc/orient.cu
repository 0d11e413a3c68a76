// Kernel D: SURF keypoint orientation, one block per keypoint, from the
// integral image to the angle.
//
// Replaces the TPU kernel cuda_surf_tpu/ops/patch_bucketed.py:_kernel in
// mode "grids" (reached through patch_wavelets.wavelet_grids from
// orientation.assign_orientations), which only sampled the raw Haar dy/dx
// grids, and folds in the histogram and window stage that the JAX package
// runs in XLA after it.  Modelled on the reference's K16,
// assignOrientationApprox (surfd.cu:1711-1960).  Plain twin:
// cuda_surf_tpu_torch/ops/orientation.py:assign_orientations_plain.
//
// What bounds it on the H100: integral-image gathers and the per-block
// serial stages.  A keypoint samples the 19x19 disc (at most 253 samples
// inside radius 9), each reading 12 int32 corners of the 4.9 MB integral
// image, which stays in L2; the TPU needed selection matmuls over int8
// limb planes for this because it has no fast gather.  The 72x4 histogram
// and the 72 windows are a few thousand shared-memory operations per block.
//
// Determinism: no float atomics.  Each thread writes its samples' (bin,
// angle, weighted magnitude) into shared memory by sample index; then
// thread b sums bin b over the samples in index order, thread w computes
// window w, and one thread takes the first maximum (an equal value keeps
// the lower index, as jnp.argmax / torch.argmax do).  Results repeat bit
// for bit run to run.
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

#define OR_THREADS 128
#define OR_RADIUS 9
#define OR_N (2 * OR_RADIUS + 1)
#define OR_SAMPLES (OR_N * OR_N)
#define OR_NBIN 72
#define OR_HWN 6
#define OR_LUT 83

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

// meta: int32 (5, K) rows [cx, cy, step, pixsi, valid];
// tab: f32 [lut1 (83) | bin centres (72) | base_l (72) | base_r (72)].
__global__ void __launch_bounds__(OR_THREADS)
orient_kernel(const int* __restrict__ ii, int ih, int iw,
              const int* __restrict__ meta, const float* __restrict__ tab,
              int K, float* __restrict__ out) {
  __shared__ int s_bin[OR_SAMPLES];  // -1: sample masked
  __shared__ float s_ang[OR_SAMPLES], s_psum[OR_SAMPLES];
  __shared__ float s_hist[OR_NBIN], s_avg[OR_NBIN], s_part[OR_NBIN];
  __shared__ float s_pas[OR_NBIN + 2 * OR_HWN];
  __shared__ float s_win[OR_NBIN], s_awin[OR_NBIN];
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  if (!meta[4 * K + k]) {  // invalid slot
    if (t == 0) out[k] = 0.f;
    return;
  }
  const int cx = meta[k], cy = meta[K + k], step = meta[2 * K + k];
  const int s = meta[3 * K + k];
  const float* lut = tab;
  const float* bins = tab + OR_LUT;
  const float* base_l = bins + OR_NBIN;
  const float* base_r = base_l + OR_NBIN;
  const float PI = 3.14159265358979323846f;
  const float TWO_PI = 6.28318530717958647692f;
  const float SEP = 0.08726646259971647f;

  for (int q = t; q < OR_SAMPLES; q += OR_THREADS) {
    const int y1 = q / OR_N - OR_RADIUS, x1 = q % OR_N - OR_RADIUS;
    const int distsq = y1 * y1 + x1 * x1;
    const int xx = cx + x1 * step, yy = cy + y1 * step;
    int bin = -1;
    if (yy + s + 2 < ih && yy - s > -1 && xx + s + 2 < iw && xx - s > -1
        && (float)distsq < 81.5f) {
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
        bin = (int)truncf(__fdiv_rn(__fadd_rn(angle, PI), SEP)) % OR_NBIN;
        s_ang[q] = angle;
        s_psum[q] = __fmul_rn(lut[min(distsq, OR_LUT - 1)], mag);
      }
    }
    s_bin[q] = bin;
  }
  __syncthreads();

  // the four per-bin sums, each over the samples in index order
  if (t < OR_NBIN) {
    float cnt = 0.f, asum = 0.f, psum = 0.f, apsum = 0.f;
    for (int q = 0; q < OR_SAMPLES; ++q) {
      if (s_bin[q] != t) continue;
      cnt = __fadd_rn(cnt, 1.f);
      asum = __fadd_rn(asum, s_ang[q]);
      psum = __fadd_rn(psum, s_psum[q]);
      apsum = __fadd_rn(apsum, __fmul_rn(s_ang[q], s_psum[q]));
    }
    s_hist[t] = cnt;
    s_part[t] = psum;
    s_avg[t] = cnt > 0.f ? __fdiv_rn(asum, fmaxf(cnt, 1.f)) : bins[t];
    // wrapped slots (surfd.cu:1798-1806): slot b + HWN holds bin b; slots
    // 0..5 hold bins 66..71 less 2pi, slots 78..83 bins 0..5 plus 2pi
    s_pas[t + OR_HWN] = apsum;
    if (t >= OR_NBIN - OR_HWN)
      s_pas[t - (OR_NBIN - OR_HWN)] = __fsub_rn(apsum, __fmul_rn(TWO_PI, psum));
    if (t < OR_HWN)
      s_pas[t + OR_NBIN + OR_HWN] = __fadd_rn(apsum, __fmul_rn(TWO_PI, psum));
  }
  __syncthreads();

  // window w: the 11 whole bins w-5..w+5, then the fractional edges
  if (t < OR_NBIN) {
    const int w = t;
    float ws = 0.f, was = 0.f;
    for (int j = -OR_HWN + 1; j < OR_HWN; ++j) {
      ws = __fadd_rn(ws, s_part[(w + j + OR_NBIN) % OR_NBIN]);
      was = __fadd_rn(was, s_pas[w + j + OR_HWN]);
    }
    const float ratio_l = __fdiv_rn(__fsub_rn(base_l[w], s_avg[w]), SEP);
    ws = __fadd_rn(ws, __fmul_rn(ratio_l, s_part[(w - OR_HWN + OR_NBIN) % OR_NBIN]));
    was = __fadd_rn(was, __fmul_rn(ratio_l, s_pas[w]));
    const float ratio_r = __fdiv_rn(__fadd_rn(s_avg[w], base_r[w]), SEP);
    ws = __fadd_rn(ws, __fmul_rn(ratio_r, s_part[(w + OR_HWN) % OR_NBIN]));
    was = __fadd_rn(was, __fmul_rn(ratio_r, s_pas[w + 2 * OR_HWN]));
    s_win[w] = ws;
    s_awin[w] = was;
  }
  __syncthreads();

  if (t == 0) {  // first maximum
    int sel = 0;
    for (int w = 1; w < OR_NBIN; ++w)
      if (s_win[w] > s_win[sel]) sel = w;
    out[k] = __fdiv_rn(s_awin[sel], s_win[sel]);
  }
}

extern "C" int surf_orient(const int* ii, int ih, int iw, const int* meta,
                           const float* tab, int K, float* out, void* stream) {
  if (K <= 0) return 0;
  orient_kernel<<<K, OR_THREADS, 0, (cudaStream_t)stream>>>(ii, ih, iw, meta,
                                                           tab, K, out);
  return (int)cudaGetLastError();
}
