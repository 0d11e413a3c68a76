// Instruction rates that bound kernel C (cuda_surf_tpu_torch/csrc/match.cu),
// measured on the card in loops that touch no memory: cycles a scheduler (an
// SM has four) spends per TF32 m16n8k8 mma.sync and per fp32 FMA of an 8 x 8
// outer product held in registers, at 4, 8 and 16 warps an SM.  At the
// data-sheet rates they would be 4 and 1.  A stand-alone program, not part
// of the kernel library:
//
//     python3 probe_stages.py --rates
//
// builds it with the kernel library's nvcc flags and runs it.  The SM clock
// is read from the device (its maximum, which the card holds in these loops).

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// NACC independent accumulator tiles a warp, one mma into each per iteration
template <int NACC>
__global__ void mma_loop(float* out, int iters, uint32_t seed) {
  float acc[NACC][4];
  for (int i = 0; i < NACC; ++i)
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  uint32_t a[4][4], b[8][2];
  for (int i = 0; i < 4; ++i)
    for (int e = 0; e < 4; ++e) a[i][e] = seed + threadIdx.x * 13 + i * 4 + e;
  for (int i = 0; i < 8; ++i)
    for (int e = 0; e < 2; ++e) b[i][e] = seed * 3 + threadIdx.x * 7 + i * 2 + e;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) mma_tf32(acc[i], a[i % 4], b[i % 8]);
  }
  float s = 0;
  for (int i = 0; i < NACC; ++i)
    for (int e = 0; e < 4; ++e) s += acc[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// 64 FMAs an iteration (and 8 adds that keep the operands changing)
__global__ void fma_loop(float* out, int iters, float seed) {
  float acc[8][8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float a[8], b[8];
  for (int i = 0; i < 8; ++i) {
    a[i] = seed + threadIdx.x + i;
    b[i] = seed * 2 + threadIdx.x * 3 + i;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] += 1e-9f;
  }
  float s = 0;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <class F>
static float time_ms(F launch) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();   // warm up
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "probe_rates: no CUDA device\n");
    return 2;
  }
  const int sms = prop.multiProcessorCount;
  const double hz = prop.clockRate * 1e3;
  const int iters = 20000;
  float* out;
  cudaMalloc(&out, (size_t)sms * 1024 * sizeof(float));
  for (int warps : {4, 8, 16}) {
    // a scheduler runs warps / 4 of the SM's warps
    const double per = iters * (warps / 4.0);
    float ms = time_ms([&] { mma_loop<16><<<sms, warps * 32>>>(out, iters, 1u); });
    printf("{\"loop\": \"mma.sync m16n8k8 tf32, 16 independent sums\", "
           "\"warps_per_sm\": %d, \"cycles_per_instruction\": %.3f}\n", warps,
           ms * 1e-3 * hz / (per * 16));
    ms = time_ms([&] { mma_loop<4><<<sms, warps * 32>>>(out, iters, 1u); });
    printf("{\"loop\": \"mma.sync m16n8k8 tf32, 4 independent sums\", "
           "\"warps_per_sm\": %d, \"cycles_per_instruction\": %.3f}\n", warps,
           ms * 1e-3 * hz / (per * 4));
    ms = time_ms([&] { fma_loop<<<sms, warps * 32>>>(out, iters, 1.f); });
    printf("{\"loop\": \"fp32 fma, 8 x 8 outer product\", "
           "\"warps_per_sm\": %d, \"cycles_per_instruction\": %.3f}\n", warps,
           ms * 1e-3 * hz / (per * 64));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "probe_rates: %s\n", cudaGetErrorString(err));
    return 1;
  }
  printf("{\"sms\": %d, \"sm_clock_mhz\": %.0f}\n", sms, hz / 1e6);
  return 0;
}
