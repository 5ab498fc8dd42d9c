// LayerNorm -> fc1 -> exact-erf gelu -> fc2 for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas kernel eilev_tpu/ops/fused_mlp.py:101 ln_mlp (body
// _kernel :59): K6, the EVA-ViT MLP. x (M, D) with M = frames * tokens,
// LayerNorm scale/bias (D), w1 (D, F), b1 (F), w2 (F, D), b2 (D); the
// weights keep the JAX (in, out) layout.
//
// What bounds it on the H100: operations. At the ViT shape (136 x 257 rows,
// D = 1408, F = 6144) the two products are 4 M D F = 1.21 TFLOP, 1.22 ms at
// the bf16 tensor-core peak, against ~0.07 ms for the ~231 MB of x, out and
// weights. The design spends its effort on the products and keeps the rest
// to memory-rate passes:
//   * Three launches on one stream. (1) LayerNorm, one warp per row: fp32
//     mean and variance (two passes, as flax's use_fast_variance=False), h =
//     (x - mu) * rsqrt(var + eps) * scale + bias rounded to bf16 - the
//     reference's rounding point - written to scratch (M, D). (2) act =
//     bf16(gelu(h @ w1 + b1)), the fc1 accumulator and gelu in fp32, rounded
//     where the reference rounds (_kernel :82). (3) out = bf16(act @ w2 + b2).
//     The Pallas body keeps one frame's (S, D) fp32 output and the fc1
//     activation in 110 MB of VMEM; a Hopper block has 227 KB, so the
//     activation makes a round trip through device memory in bf16 (~0.26 ms
//     of traffic at the ViT shape, under the operation bound) and the fc2
//     sum over F stays in one block's registers: no split over F, no
//     atomics, the same bits on every run.
//   * Both products are one tiled kernel: 128 x 128 output tiles, 8 warps of
//     64 x 32, mma.sync m16n8k16 (bf16 in, fp32 accumulate), operands by
//     ldmatrix (w row-major (K, N), so its fragments come through
//     ldmatrix.trans), a 3-stage cp.async ring of 64-deep k tiles so loads
//     overlap the tensor cores; two blocks share an SM (a 128 x 256 tile of
//     64 x 64 warps needs 209 registers a thread, so one block an SM, and
//     ran slower). Ragged M, N and K edges are zero-filled on load and
//     masked on store; K and N must be multiples of 8 (16-byte rows).
//     With mma.sync every operand passes through shared memory and
//     registers: ldmatrix and the cp.async writes take more of the SM's
//     shared-memory bandwidth than the tensor cores take time, so the
//     products run at about a quarter of the bf16 peak.
//   * gelu is the exact one with CUDA's erff; the Pallas body's
//     Abramowitz-Stegun polynomial stood in for an erf Mosaic lacks, and both
//     are far below bf16 resolution.
// wgmma, TMA and a persistent schedule are later steps.
//
// The fp32 body (eilev_ln_mlp_f32), for an fp32 model, where the reference's
// roundings to the model dtype are the identity: the same three launches in
// fp32 on the CUDA cores (the tensor cores take no fp32, and TF32 keeps too
// few bits for the 1e-4 the fp32 reference is held to). LayerNorm one warp a
// row; both products one plain tiled fp32 kernel: 128 x 128 output tiles,
// 256 threads of 8 x 8 outputs, 8-deep k tiles through shared memory, the
// sum over k in order, + bias (+ erf gelu) in the epilogue. Correct first:
// it runs at a small share of the 67 TFLOP/s fp32 peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using namespace sm90;

constexpr int LN_WARPS = 8;  // rows per LayerNorm block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(LN_WARPS * 32)
layer_norm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ h, int M, int D,
                  float eps) {
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + (size_t)row * D;
  __nv_bfloat16* hr = h + (size_t)row * D;
  const int chunks = D / 8;

  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += __bfloat162float(e[j]);
  }
  const float mu = warp_sum(sum) / D;
  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __bfloat162float(e[j]) - mu;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
  for (int c = lane; c < chunks; c += 32) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    const float4 s0 = *reinterpret_cast<const float4*>(scale + c * 8);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + c * 8 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bias + c * 8);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + c * 8 + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float h0 = (__bfloat162float(e[j]) - mu) * rstd * s[j] + b[j];
      const float h1 = (__bfloat162float(e[j + 1]) - mu) * rstd * s[j + 1] + b[j + 1];
      o[j / 2] = pack_bf16(h0, h1);
    }
    *reinterpret_cast<uint4*>(hr + c * 8) = out;
  }
}

// ---- C (M, N) = bf16(epilogue(A (M, K) @ W (K, N) + bias)), all row-major

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 along M x 4 along N, 64 x BN / 4 each
constexpr int NJ = BN / 32;        // 8-column tiles of a warp
constexpr int LDA = BK + 8;        // padded rows: ldmatrix rows fall in distinct banks
constexpr int LDB = BN + 8;
constexpr int A_TILE = BM * LDA;
constexpr int B_TILE = BK * LDB;
constexpr size_t GEMM_SMEM = sizeof(__nv_bfloat16) * STAGES * (A_TILE + B_TILE);
constexpr int GEMM_MIN_BLOCKS = NJ <= 4 && 2 * (GEMM_SMEM + 1024) <= 233472 ? 2 : 1;

// Starts the copies of A rows [m0, m0 + BM) x cols [k0, k0 + BK) and W rows
// [k0, k0 + BK) x cols [n0, n0 + BN); anything past M, N or K is zero.
__device__ __forceinline__ void load_stage(__nv_bfloat16* as, __nv_bfloat16* bs,
                                           const __nv_bfloat16* A, const __nv_bfloat16* W,
                                           int m0, int n0, int k0, int M, int N, int K) {
  for (int idx = threadIdx.x; idx < BM * (BK / 8); idx += GEMM_THREADS) {
    const int r = idx / (BK / 8);
    const int c = idx % (BK / 8);
    const bool valid = m0 + r < M && k0 + c * 8 < K;
    cp_async16(as + r * LDA + c * 8, valid ? A + (size_t)(m0 + r) * K + k0 + c * 8 : A, valid);
  }
  for (int idx = threadIdx.x; idx < BK * (BN / 8); idx += GEMM_THREADS) {
    const int r = idx / (BN / 8);
    const int c = idx % (BN / 8);
    const bool valid = k0 + r < K && n0 + c * 8 < N;
    cp_async16(bs + r * LDB + c * 8, valid ? W + (size_t)(k0 + r) * N + n0 + c * 8 : W, valid);
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <bool GELU>
__global__ void __launch_bounds__(GEMM_THREADS, GEMM_MIN_BLOCKS)
gemm_bias_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ C, int M, int N,
                 int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * A_TILE;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64;  // the warp's rows within the tile
  const int wn = (warp % 4) * (BN / 4);  // and columns
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;  // ldmatrix: row within the 8x8 matrix
  const int lm = lane >> 3;  // and which matrix

  float acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int k_tiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(As + s * A_TILE, Bs + s * B_TILE, A, W, m0, n0, s * BK, M, N, K);
    cp_async_commit();  // possibly empty: one group per stage keeps the count simple
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // ... for every thread; and slot kt - 1 is free
    const int nk = kt + STAGES - 1;
    if (nk < k_tiles) {
      const int slot = nk % STAGES;
      load_stage(As + slot * A_TILE, Bs + slot * B_TILE, A, W, m0, n0, nk * BK, M, N, K);
    }
    cp_async_commit();

    const __nv_bfloat16* as = As + (kt % STAGES) * A_TILE;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], as + (wm + i * 16 + lr + (lm & 1) * 8) * LDA + kk * 16 + (lm >> 1) * 8);
      uint32_t b[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t r[4];  // b0, b1 of column tile j, then of column tile j + 1
        ldmatrix_x4_trans(r, bs + (kk * 16 + (lm & 1) * 8 + lr) * LDB + wn + j * 8 + (lm >> 1) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
    const float bias0 = bias[col], bias1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + wm + i * 16 + g;
      float v[4] = {acc[i][j][0] + bias0, acc[i][j][1] + bias1, acc[i][j][2] + bias0,
                    acc[i][j][3] + bias1};
      if (GELU) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = gelu_erf(v[e]);
      }
      if (row < M) *reinterpret_cast<uint32_t*>(C + (size_t)row * N + col) = pack_bf16(v[0], v[1]);
      if (row + 8 < M)
        *reinterpret_cast<uint32_t*>(C + (size_t)(row + 8) * N + col) = pack_bf16(v[2], v[3]);
    }
  }
}

template <bool GELU>
int launch_gemm(const __nv_bfloat16* A, const __nv_bfloat16* W, const float* bias,
                __nv_bfloat16* C, int M, int N, int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_bias_kernel<GELU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bias_kernel<GELU><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(A, W, bias, C, M, N, K);
  return (int)cudaGetLastError();
}

// ---- the fp32 body

__global__ void __launch_bounds__(LN_WARPS * 32)
layer_norm_f32_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ h, int M, int D, float eps) {
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  float* hr = h + (size_t)row * D;
  float sum = 0.f;
  for (int i = lane; i < D; i += 32) sum += xr[i];
  const float mu = warp_sum(sum) / D;
  float sq = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = xr[i] - mu;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
  for (int i = lane; i < D; i += 32) hr[i] = (xr[i] - mu) * rstd * scale[i] + bias[i];
}

constexpr int FBM = 128, FBN = 128, FBK = 8;
constexpr int F_THREADS = 256;  // 16 x 16 threads of 8 x 8 outputs

// C (M, N) = epilogue(A (M, K) @ W (K, N) + bias), fp32, all row-major.
// Thread (ty, tx) owns rows 4ty + i and 64 + 4ty + i, columns 4tx + j and 64
// + 4tx + j, so its shared-memory reads are 16-byte loads a half-warp shares.
template <bool GELU>
__global__ void __launch_bounds__(F_THREADS)
sgemm_bias_kernel(const float* __restrict__ A, const float* __restrict__ W,
                  const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // k-major
  __shared__ __align__(16) float Bs[FBK][FBN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[8][8] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    {  // A: row t / 2, k (t % 2) * 4 .. + 3
      const int r = threadIdx.x / 2, kk = (threadIdx.x % 2) * 4, m = m0 + r;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + kk + u;
        As[kk + u][r] = m < M && k < K ? A[(size_t)m * K + k] : 0.f;
      }
    }
    {  // W: k t / 32, columns (t % 32) * 4 .. + 3
      const int kk = threadIdx.x / 32, c = (threadIdx.x % 32) * 4, k = k0 + kk;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + c + u;
        Bs[kk][c + u] = k < K && n < N ? W[(size_t)k * N + n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n >= N) continue;
      const float v = acc[i][j] + bias[n];
      C[(size_t)m * N + n] = GELU ? gelu_erf(v) : v;
    }
  }
}

template <bool GELU>
int launch_sgemm(const float* A, const float* W, const float* bias, float* C, int M, int N, int K,
                 cudaStream_t stream) {
  dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  sgemm_bias_kernel<GELU><<<grid, F_THREADS, 0, stream>>>(A, W, bias, C, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// The fp32 body: every tensor fp32 (x, h, act, out as in eilev_ln_mlp_bf16),
// contiguous; any D and F. Launches three kernels on `stream`, no
// synchronise; returns the first failing launch's cudaError_t (0 on success).
extern "C" int eilev_ln_mlp_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* h, void* act, void* out, int M, int D, int F, float eps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || F <= 0 || (M + FBM - 1) / FBM > 65535) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(ln_scale);
  layer_norm_f32_kernel<<<(M + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
      static_cast<const float*>(x), s, static_cast<const float*>(ln_bias), static_cast<float*>(h), M,
      D, eps);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_sgemm<true>(static_cast<const float*>(h), static_cast<const float*>(w1),
                           static_cast<const float*>(b1), static_cast<float*>(act), M, F, D, st);
  if (err != 0) return err;
  return launch_sgemm<false>(static_cast<const float*>(act), static_cast<const float*>(w2),
                             static_cast<const float*>(b2), static_cast<float*>(out), M, D, F, st);
}

// x: (M, D) bf16; ln_scale, ln_bias: (D) fp32; w1: (D, F) bf16; b1: (F) fp32;
// w2: (F, D) bf16; b2: (D) fp32; scratch h: (M, D) bf16 and act: (M, F) bf16;
// out: (M, D) bf16. All contiguous and 16-byte aligned; D % 8 == 0 and
// F % 8 == 0. Launches three kernels on `stream`, no synchronise; returns the
// first failing launch's cudaError_t (0 on success).
extern "C" int eilev_ln_mlp_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* h, void* act, void* out, int M, int D, int F, float eps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || F <= 0 || D % 8 != 0 || F % 8 != 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  layer_norm_kernel<<<(M + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
      static_cast<const bf*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<bf*>(h), M, D, eps);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_gemm<true>(static_cast<const bf*>(h), static_cast<const bf*>(w1),
                          static_cast<const float*>(b1), static_cast<bf*>(act), M, F, D, st);
  if (err != 0) return err;
  return launch_gemm<false>(static_cast<const bf*>(act), static_cast<const bf*>(w2),
                            static_cast<const float*>(b2), static_cast<bf*>(out), M, D, F, st);
}
