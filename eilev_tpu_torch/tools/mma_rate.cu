// The tensor cores' issue rate for the instructions K6's fp32 body could be
// built on, on the card it runs on: mma.sync m16n8k8 tf32 (8 warps an SM,
// 16 independent accumulators a warp), mma.sync m16n8k16 bf16 (the same),
// and wgmma m64n128k8 tf32 with both operands in shared memory (two
// warpgroups an SM, one k tile's group in flight). No memory traffic: the
// products' own ceiling. Prints TFLOP/s of each, twice.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/mma_rate eilev_tpu_torch/tools/mma_rate.cu && build/mma_rate

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "../csrc/sm90_tf32.cuh"
#include "../csrc/sm90_wgmma.cuh"

using namespace sm90;

constexpr int ITERS = 20000;

__global__ void __launch_bounds__(256, 1) mma_tf32_loop(float* out) {
  float c[16][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const float b0 = threadIdx.x * 0.5f, b1 = 1.f;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) mma_tf32(c[i], a, b0, b1);
  }
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(256, 1) mma_bf16_loop(float* out) {
  float c[16][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b[2] = {threadIdx.x, 5u};
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) mma_bf16_16816(c[i], a, b);
  }
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// A (128 x 32) and B (128 x 32) tf32 tiles, K-major, 128-byte rows
__global__ void __launch_bounds__(256, 1) wgmma_tf32_loop(float* out) {
  extern __shared__ __align__(1024) unsigned char tiles[];
  for (int i = threadIdx.x; i < 32 * 1024 / 4; i += blockDim.x) reinterpret_cast<float*>(tiles)[i] = 1.f / (i + 1);
  fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  float d[64] = {};
  for (int it = 0; it < ITERS; ++it) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32<128>(d, wgmma_desc(tiles + wg * 8192 + kk * 32, 16, 1024),
                      wgmma_desc(tiles + 16384 + kk * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) return 1;
  sms = prop.multiProcessorCount;
  float* out = nullptr;
  cudaMalloc(&out, sms * 256 * sizeof(float));
  cudaFuncSetAttribute(wgmma_tf32_loop, cudaFuncAttributeMaxDynamicSharedMemorySize, 32 * 1024);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const char* names[3] = {"mma.sync m16n8k8 tf32 (8 warps an SM)", "mma.sync m16n8k16 bf16 (8 warps an SM)",
                          "wgmma m64n128k8 tf32, shared operands (2 warpgroups an SM)"};
  // flops a launch: warps x iterations x products x 2 m n k
  const double flops[3] = {2.0 * 16 * 8 * 8 * 16 * ITERS * 8.0 * sms, 2.0 * 16 * 8 * 16 * 16 * ITERS * 8.0 * sms,
                           2.0 * 64 * 128 * 8 * 4 * ITERS * 2.0 * sms};
  printf("%s, %d SMs\n", prop.name, sms);
  for (int k = 0; k < 3; ++k) {
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(e0);
      if (k == 0) mma_tf32_loop<<<sms, 256>>>(out);
      if (k == 1) mma_bf16_loop<<<sms, 256>>>(out);
      if (k == 2) wgmma_tf32_loop<<<sms, 256, 32 * 1024>>>(out);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) {
        printf("%s: %s\n", names[k], cudaGetErrorString(err));
        return 1;
      }
      printf("%s: %.3f ms, %.1f TFLOP/s\n", names[k], ms, flops[k] / ms / 1e9);
    }
  }
  cudaFree(out);
  return 0;
}
