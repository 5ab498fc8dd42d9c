// LayerNorm -> fc1 -> exact-erf gelu -> fc2 for Hopper (sm_90a): K6, bf16 and
// fp32.
//
// Replaces the Pallas kernel eilev_tpu/ops/fused_mlp.py:101 ln_mlp (body
// _kernel :59): K6, the EVA-ViT MLP. x (M, D) with M = frames * tokens,
// LayerNorm scale/bias (D), w1 (D, F), b1 (F), w2 (F, D), b2 (D); the
// weights keep the JAX (in, out) layout.
//
// What it computes (the rounding points of the reference's _xla_fallback):
// LayerNorm statistics and the affine in fp32, h rounded to the model dtype;
// fc1 accumulated in fp32, + b1, exact-erf gelu in fp32 (erff; the Pallas
// body's Abramowitz-Stegun polynomial stood in for an erf Mosaic lacks),
// rounded to the model dtype; fc2 accumulated in fp32, + b2, rounded to the
// model dtype. In fp32 every rounding is the identity.
//
// What bounds it on the H100: operations, in both dtypes. At the ViT shape
// (136 x 257 rows, D = 1408, F = 6144) the two products are 4 M D F = 1.21
// TFLOP: 1.22 ms at the bf16 tensor-core peak (989 TFLOP/s), against ~0.07
// ms for the ~231 MB of x, out and weights. fp32 runs as 3xTF32 (three TF32
// products for each fp32 one, sm90_tf32.cuh), so its bound is 3 x FLOPs at
// 495 TFLOP/s: 7.33 ms at 136 frames, 0.431 ms at 8 (the CUDA cores' 67
// TFLOP/s would give 18.1 and 1.06).
//
// The design: three launches on one stream. (1) LayerNorm, one warp a row:
// fp32 mean and variance (two passes, as flax's use_fast_variance=False), h
// written to scratch (M, D) in the model dtype. (2) act = round(gelu(h @ w1
// + b1)), (3) out = round(act @ w2 + b2): one product kernel each dtype,
// which differs between the two products only in its epilogue. The Pallas
// body keeps one frame's fc1 activation in VMEM; a Hopper block has 227 KB,
// so the activation makes one round trip through device memory in the
// model dtype (429 MB in bf16 at the ViT shape, ~0.26 ms of traffic that
// overlaps the products), and each output tile's sum over K stays in one
// block's registers: no split over K, no atomics, the same bits every run.
//
// bf16 products, wgmma + TMA, warp-specialised and persistent:
//   * a block is one producer warp and two consumer warpgroups (288
//     threads), one block an SM; the grid is one block an SM, each walking
//     output tiles t, t + grid, ... in row-major tile order, so the blocks
//     in flight share a band of A rows, and both weights (17.3 MB each at
//     the ViT shape) stay in the 50 MB L2;
//   * an output tile is 256 x 128: each consumer warpgroup owns two 64-row
//     sub-tiles (128 fp32 accumulators a thread) and issues
//     wgmma.mma_async m64n128k16 with both operands in shared memory; W
//     keeps its row-major layout and is read through the descriptor's
//     transpose bit (MN-major B), no per-call transpose. One k tile's
//     products stay in flight while the next one's are issued (wait_group
//     1), then the older stage is released. 256 x 128 reads as few operand
//     bytes a product as 128 x 256, and fc2's N = 1408 is 11 whole tiles;
//   * the producer's lane 0 issues TMA loads of A (a box of 256 rows x 64
//     k) and W (two boxes of 64 k x 64 n) into a ring of four 48 KB stages,
//     128-byte swizzled, one full and one empty mbarrier a stage; it runs
//     ahead across tiles, so a tile's epilogue overlaps the next tile's
//     loads;
//   * the epilogue (bias, erf gelu for fc1, round to bf16) goes through
//     shared memory: each warp writes its 16 rows x 128 columns with
//     stmatrix into a 4 KB tile of its own (swizzled, conflict-free), then
//     stores whole 16-byte chunks, two 256-byte rows a store. Stored straight
//     from the fragment layout, 16 bytes of a row a store, the outputs took
//     about as long as the products;
//   * ragged M, N and K edges are TMA's zero fill on load and a mask on
//     store; TMA asks 16-byte global strides, so D % 8 == 0 and F % 8 == 0
//     (the wrapper's rule), and 16-byte aligned bases.
//
// fp32 products, 3xTF32 on the tensor cores, warp-specialised and persistent:
//   * every operand value x is split once, when its k tile has landed in
//     shared memory, into hi = tf32(x) and lo = tf32(x - hi)
//     (sm90_tf32.cuh), and each 8-deep k step runs lo_a hi_w + hi_a lo_w +
//     hi_a hi_w as three wgmma m64n128k8 tf32, both operands in shared
//     memory. Not mma.sync: on the H100 mma.sync m16n8k8 tf32 issues at about
//     two thirds of the TF32 peak that wgmma reaches (tools/mma_rate.cu), and
//     a body built on it, each warp loading fragment-order hi/lo records,
//     ran no faster than the fp32 cuBLAS products: the record loads and the
//     products took turns. tf32 wgmma takes K-major operands only, so the
//     split writes W transposed;
//   * a block is two producer and two consumer warpgroups (512 threads;
//     setmaxnreg gives the producers 56 registers, the consumers 200), one
//     block an SM, persistent as above, 128 x 128 output tiles in k tiles of
//     32 (one 128-byte row of fp32);
//   * each producer thread cp.asyncs its share of a k tile into a raw stage
//     (16-byte copies where the rows allow, 4-byte ones otherwise: fp32
//     takes any D and F) and, once it has landed, splits exactly those
//     values into four 128-byte-swizzled K-major tiles (A hi, A lo, W hi, W
//     lo), then arrives on the stage's full mbarrier. Two raw and two record
//     stages: the copy of k tile j + 2 and the split of j + 1 run under the
//     products of j. Splitting is most of the block's work: with one
//     producer warpgroup the products waited on it;
//   * each consumer warpgroup owns 64 rows; a k tile's 12 products are
//     summed from 0 in a partial, then added to the accumulator: the tensor
//     cores' fp32 sums round toward zero, which over the 2,304 products of K
//     = 6144 into one accumulator biased the outputs by ~1e-4;
//   * ragged edges are zero-filled copies and masked stores.
//
// nvcc -Xptxas -v (sm_90a), as chip_smoke.py's build step prints it:
// wg::gemm_kernel<false> 168 registers, no spills, and <true> (gelu) 168
// with 16 bytes of spills in its epilogue: ptxas holds a 288-thread block to
// 168 a thread (as for 384), under the 224 its size would allow; 225 KB of
// shared memory, one block an SM. tf::gemm_kernel<false> and <true>: 128
// registers at launch (512 threads; then 56 / 200 by setmaxnreg), no spills,
// 193 KB. layer_norm_kernel 40, layer_norm_f32_kernel 32, no spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"
#include "sm90_tf32.cuh"
#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

// row indices and TMA coordinates are int: the last tile's rows (< M + 256
// + 8) must fit (ops/fused_mlp.py:_MAX_ROWS)
constexpr int MAX_ROWS = INT_MAX - 511;
constexpr int LN_WARPS = 8;  // rows per LayerNorm block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
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

// The SMs of the current device: the persistent grids' size.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// ---- bf16 products: C (M, N) = bf16(epilogue(A (M, K) @ W (K, N) + bias)) ----

namespace wg {

// An output tile is 256 rows x 128 columns: each consumer warpgroup owns two
// 64-row sub-tiles, 128 accumulators a thread.
constexpr int BM = 256, BN = 128, BK = 64;       // BK: one 128-byte swizzled row of bf16
constexpr int SUBS = BM / 128;                   // 64-row sub-tiles a consumer warpgroup
constexpr int CHUNK = 64;                        // W columns a TMA box: 128 bytes
constexpr int CONSUMERS = 256;                   // two warpgroups
constexpr int THREADS = CONSUMERS + 32;          // and the producer warp
constexpr uint32_t SUB_BYTES = 64 * BK * 2;      // 8 KB: 64 rows of A
constexpr uint32_t A_BYTES = BM * BK * 2;        // 32 KB
constexpr uint32_t CHUNK_BYTES = BK * CHUNK * 2; // 8 KB: 64 k rows of 128 bytes
constexpr uint32_t STAGE = A_BYTES + (BN / CHUNK) * CHUNK_BYTES;  // 48 KB
constexpr int STAGES = 4;
constexpr uint32_t OUT_BYTES = 16 * BN * 2;      // 4 KB a consumer warp: 16 rows x 128 columns
// the stages, the consumer warps' output tiles, a full and an empty barrier
// a stage, and 1 KB to align the base: 225 KB
constexpr uint32_t OFF_OUT = STAGES * STAGE;
constexpr uint32_t OFF_BAR = OFF_OUT + (CONSUMERS / 32) * OUT_BYTES;
constexpr size_t SMEM = OFF_BAR + 2 * STAGES * sizeof(uint64_t) + 1024;

// One k tile's four 16-deep products into this warpgroup's acc, from the
// stage at `st` (the first of a tile overwrites acc).
__device__ __forceinline__ void issue_k_tile(float (&acc)[SUBS][BN / 2], const unsigned char* st, int cw,
                                             bool first) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = wgmma_desc(st + A_BYTES + kk * 16 * 128, CHUNK_BYTES, 1024);
#pragma unroll
    for (int r = 0; r < SUBS; ++r) {
      const uint64_t da = wgmma_desc(st + (cw * SUBS + r) * SUB_BYTES + kk * 32, 16, 1024);
      wgmma_ss_tb<BN>(acc[r], da, db, first && kk == 0 ? 0 : 1);
    }
  }
  wgmma_commit();
}

// Waits until ring position i has landed, then reconverges the warp for the
// warpgroup-wide wgmma.
__device__ __forceinline__ void wait_full(uint64_t* full, uint32_t i) {
  mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
  __syncwarp();
}

template <bool GELU>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_blocks = (N + BN - 1) / BN;
  const long long n_tiles = (long long)((M + BM - 1) / BM) * n_blocks;
  const int k_tiles = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);  // every consumer thread releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- the producer: lane 0 keeps the ring full, across tiles ----
    if (lane != 0) return;
    uint32_t it = 0;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (int)(tile / n_blocks) * BM;
      const int n0 = (int)(tile % n_blocks) * BN;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const uint32_t s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // the first pass finds it free
        unsigned char* st = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], STAGE);  // zero-filled boxes count in full
        tma_load_2d(st, &tm_a, &full[s], kt * BK, m0);
#pragma unroll
        for (int c = 0; c < BN / CHUNK; ++c)
          tma_load_2d(st + A_BYTES + c * CHUNK_BYTES, &tm_w, &full[s], n0 + c * CHUNK, kt * BK);
      }
    }
    return;
  }

  // ---- the consumers: warpgroup cw owns rows 64 SUBS cw.. of each tile ----
  const int cw = warp / 4;
  const int q = lane & 3;
  unsigned char* out_s = smem + OFF_OUT + warp * OUT_BYTES;
  float acc[SUBS][BN / 2];
#pragma unroll
  for (int r = 0; r < SUBS; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;
  uint32_t it = 0;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (int)(tile / n_blocks) * BM;
    const int n0 = (int)(tile % n_blocks) * BN;
#pragma unroll
    for (int r = 0; r < SUBS; ++r) wgmma_pin<BN / 2>(acc[r]);
    wait_full(full, it);
    issue_k_tile(acc, smem + (it % STAGES) * STAGE, cw, true);
    for (int kt = 1; kt < k_tiles; ++kt) {
      wait_full(full, it + 1);
      issue_k_tile(acc, smem + ((it + 1) % STAGES) * STAGE, cw, false);
      wgmma_wait<1>();  // k tile kt - 1's products are done: release its stage
      mbar_arrive(&empty[it % STAGES]);
      ++it;
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[it % STAGES]);
    ++it;
#pragma unroll
    for (int r = 0; r < SUBS; ++r) wgmma_pin<BN / 2>(acc[r]);

    // epilogue: acc[r][4i + e] is row 16 (warp % 4) + lane / 4 (+ 8 for e >=
    // 2) of sub-tile r, column 8i + 2q + (e & 1). Each warp rounds its 16
    // rows into its own shared tile (stmatrix; 256-byte rows, 16-byte chunk c
    // of row y at c ^ (y % 8): conflict-free both ways), then writes them
    // back as whole 16-byte chunks, two rows a store.
#pragma unroll
    for (int r = 0; r < SUBS; ++r) {
      const int row0 = m0 + 64 * (cw * SUBS + r) + 16 * (warp % 4);
#pragma unroll
      for (int i = 0; i < BN / 8; i += 2) {
        uint32_t packed[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = min(n0 + 8 * (i + h) + 2 * q, N - 2);  // past N: any column, not stored
          const float2 b = *reinterpret_cast<const float2*>(bias + col);
          float v[4] = {acc[r][4 * (i + h)] + b.x, acc[r][4 * (i + h) + 1] + b.y, acc[r][4 * (i + h) + 2] + b.x,
                        acc[r][4 * (i + h) + 3] + b.y};
          if (GELU) {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = gelu_erf(v[e]);
          }
          packed[2 * h] = pack_bf16(v[0], v[1]);
          packed[2 * h + 1] = pack_bf16(v[2], v[3]);
        }
        // matrix l / 8: rows 8 ((l / 8) & 1) .., column chunk i + l / 16
        const int y = 8 * ((lane >> 3) & 1) + (lane & 7);
        stmatrix_x4(out_s + y * 256 + (((i + (lane >> 4)) ^ (y & 7)) * 16), packed[0], packed[1], packed[2],
                    packed[3]);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int y = 2 * j + (lane >> 4), c = lane & 15;
        const uint4 v = *reinterpret_cast<const uint4*>(out_s + y * 256 + ((c ^ (y & 7)) * 16));
        if (row0 + y < M && n0 + 8 * c < N) *reinterpret_cast<uint4*>(C + (size_t)(row0 + y) * N + n0 + 8 * c) = v;
      }
      __syncwarp();
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (nothing links -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix as (box_rows x 64)-element boxes,
// 128-byte swizzled; reads past an edge are zeros.
bool make_map(CUtensorMap* map, EncodeTiled fn, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C = bf16(epilogue(A @ W + bias))
template <bool GELU>
int launch(EncodeTiled fn, const __nv_bfloat16* A, const __nv_bfloat16* W, const float* bias,
           __nv_bfloat16* C, int M, int N, int K, int sms, cudaStream_t stream) {
  CUtensorMap tm_a, tm_w;
  if (!make_map(&tm_a, fn, A, M, K, BM) || !make_map(&tm_w, fn, W, K, N, BK)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<GELU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_kernel<GELU><<<grid, THREADS, SMEM, stream>>>(tm_a, tm_w, bias, C, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---- fp32 products: C (M, N) = epilogue(A (M, K) @ W (K, N) + bias), 3xTF32 ----

namespace tf {

// An output tile is 128 rows x 128 columns: each consumer warpgroup owns 64
// rows, 64 accumulators a thread.
constexpr int BM = 128, BN = 128, BK = 32;        // BK: one 128-byte swizzled row of fp32
constexpr int KS = BK / 8;                        // wgmma k steps a k tile
constexpr int CONSUMERS = 256;                    // two warpgroups
constexpr int PRODUCERS = 256;                    // two warpgroups: copies and splits
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr uint32_t OP_BYTES = 128 * BK * 4;       // 16 KB: 128 rows of 128 bytes
constexpr uint32_t OFF_A_HI = 0, OFF_A_LO = OP_BYTES, OFF_W_HI = 2 * OP_BYTES, OFF_W_LO = 3 * OP_BYTES;
constexpr uint32_t REC_STAGE = 4 * OP_BYTES;      // 64 KB: the split operands of one k tile
constexpr uint32_t RAW_STAGE = 2 * OP_BYTES;      // 32 KB: A's and W's values as copied
constexpr uint32_t OFF_RAW = 2 * REC_STAGE;
constexpr uint32_t OFF_BAR = OFF_RAW + 2 * RAW_STAGE;
// two record stages, two raw stages, a full and an empty barrier a record
// stage, and 1 KB to align the base: 193 KB
constexpr size_t SMEM = OFF_BAR + 4 * sizeof(uint64_t) + 1024;

struct Args {
  const float* A;
  const float* W;
  const float* bias;
  float* C;
  int M, N, K;
  int vec_a, vec_w;  // 16-byte copies of A's / W's rows
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// Four floats row[c0 .. c0 + 3] into dst; zero past `limit` or where the
// row is out (row == nullptr). `base` is a valid address for the zero fills.
__device__ __forceinline__ void copy4(float* dst, const float* row, const float* base, int c0, int limit,
                                      bool vec) {
  if (vec) {  // limit % 4 == 0: a chunk is all in or all out
    const bool ok = row != nullptr && c0 < limit;
    cp_async16(dst, ok ? row + c0 : base, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = row != nullptr && c0 + e < limit;
      cp_async4(dst + e, ok ? row + c0 + e : base, ok);
    }
  }
}

// The 16-byte chunk c (k 4c .. 4c + 3) of row y of a 128-byte-swizzled
// K-major operand tile: chunk c lands at c ^ (y % 8), as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B would put it, for wgmma's descriptors.
__device__ __forceinline__ uint32_t swizzled(int y, int c) { return y * 128 + ((c ^ (y & 7)) * 16); }

// One k tile's raw values: A's chunk u (row u / 8, k chunk u % 8) at 16 u;
// W's unit w (k rows 4c .. 4c + 3 of columns 4nb .. 4nb + 3, nb = w / 8, c
// = w % 8), its row e at OP_BYTES + 4096 e + 16 w. Producer thread p copies
// A chunks p + 256 m and W unit p, and later splits exactly those.
__device__ __forceinline__ void copy_tile(const Args& a, unsigned char* raw, int p, int m0, int n0, int k0) {
#pragma unroll 1
  for (int u = p; u < 1024; u += PRODUCERS) {
    const int row = m0 + (u >> 3);
    copy4(reinterpret_cast<float*>(raw + 16 * u), row < a.M ? a.A + (size_t)row * a.K : nullptr, a.A,
          k0 + 4 * (u & 7), a.K, a.vec_a);
  }
#pragma unroll 1
  for (int w = p; w < 256; w += PRODUCERS) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 4 * (w & 7) + e;
      copy4(reinterpret_cast<float*>(raw + OP_BYTES + 4096 * e + 16 * w), k < a.K ? a.W + (size_t)k * a.N : nullptr,
            a.W, n0 + 4 * (w >> 3), a.N, a.vec_w);
    }
  }
}

__device__ __forceinline__ float4 as_float4(const uint32_t (&r)[4]) {
  return make_float4(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]), __uint_as_float(r[3]));
}

// x = hi + lo, four at a time, into the two split tiles at byte offset off
__device__ __forceinline__ void put_split(unsigned char* rec, uint32_t off_hi, uint32_t off_lo, uint32_t off,
                                          const float (&x)[4]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
  *reinterpret_cast<float4*>(rec + off_hi + off) = as_float4(hi);
  *reinterpret_cast<float4*>(rec + off_lo + off) = as_float4(lo);
}

// Producer thread p's values, landed in `raw`, split into the four K-major
// operand tiles of `rec`: A's chunks keep their place (row-major A is
// K-major), W's are transposed (the n rows of 32 k that tf32 wgmma reads).
// A warp's 16-byte stores hit 8 distinct slots of each 128-byte row group.
__device__ __forceinline__ void split_tile(const unsigned char* raw, unsigned char* rec, int p) {
#pragma unroll 1
  for (int u = p; u < 1024; u += PRODUCERS) {
    const float4 v = *reinterpret_cast<const float4*>(raw + 16 * u);
    const float x[4] = {v.x, v.y, v.z, v.w};
    put_split(rec, OFF_A_HI, OFF_A_LO, swizzled(u >> 3, u & 7), x);
  }
#pragma unroll 1
  for (int w = p; w < 256; w += PRODUCERS) {
    float4 r[4];  // k rows 4c .. 4c + 3 of columns 4nb .. 4nb + 3
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = *reinterpret_cast<const float4*>(raw + OP_BYTES + 4096 * e + 16 * w);
    const float x[4][4] = {{r[0].x, r[1].x, r[2].x, r[3].x}, {r[0].y, r[1].y, r[2].y, r[3].y},
                           {r[0].z, r[1].z, r[2].z, r[3].z}, {r[0].w, r[1].w, r[2].w, r[3].w}};
#pragma unroll
    for (int e = 0; e < 4; ++e) put_split(rec, OFF_W_HI, OFF_W_LO, swizzled(4 * (w >> 3) + e, w & 7), x[e]);
  }
}

// A cursor over the block's k tiles, all its output tiles' in order: k
// tile kt of tile `tile`, then the next (no division a step).
struct Cursor {
  int tile, kt;
  __device__ void next(int k_tiles) {
    if (++kt == k_tiles) {
      kt = 0;
      tile += gridDim.x;
    }
  }
};

// One k tile's products into `part`, from 0: per 8-deep k step lo_a hi_w,
// hi_a lo_w, hi_a hi_w (3xTF32), the small terms first.
__device__ __forceinline__ void issue_k_tile(float* part, const unsigned char* rec, int cw) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a = cw * 64 * 128 + kk * 32, w = kk * 32;
    const uint64_t a_hi = wgmma_desc(rec + OFF_A_HI + a, 16, 1024), a_lo = wgmma_desc(rec + OFF_A_LO + a, 16, 1024);
    const uint64_t w_hi = wgmma_desc(rec + OFF_W_HI + w, 16, 1024), w_lo = wgmma_desc(rec + OFF_W_LO + w, 16, 1024);
    wgmma_tf32<BN>(part, a_lo, w_hi, kk > 0);
    wgmma_tf32<BN>(part, a_hi, w_lo, 1);
    wgmma_tf32<BN>(part, a_hi, w_hi, 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ void add_to(float (&acc)[BN / 2], const float (&part)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
}

template <bool GELU>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_blocks = (a.N + BN - 1) / BN;
  const int n_tiles = ((a.M + BM - 1) / BM) * n_blocks;  // the launch checks it fits
  const int k_tiles = (a.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], PRODUCERS);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- the producers: copy k tile j + 2 while k tile j is split ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int p = threadIdx.x - CONSUMERS;
    Cursor copy{(int)blockIdx.x, 0};  // the next k tile to copy
    auto copy_next = [&](unsigned char* raw) {
      if (copy.tile < n_tiles) {
        copy_tile(a, raw, p, copy.tile / n_blocks * BM, copy.tile % n_blocks * BN, copy.kt * BK);
        copy.next(k_tiles);
      }
      cp_async_commit();  // one group a k tile, empty past the last
    };
    copy_next(smem + OFF_RAW);
    copy_next(smem + OFF_RAW + RAW_STAGE);
    uint32_t j = 0;
    for (Cursor work{(int)blockIdx.x, 0}; work.tile < n_tiles; work.next(k_tiles), ++j) {
      const int s = j & 1;
      cp_async_wait<1>();                        // this thread's copies of k tile j have landed
      mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);  // the consumers are done with k tile j - 2
      split_tile(smem + OFF_RAW + s * RAW_STAGE, smem + s * REC_STAGE, p);
      fence_proxy_async();                       // the records, before wgmma reads them
      mbar_arrive(&full[s]);
      copy_next(smem + OFF_RAW + s * RAW_STAGE);  // k tile j + 2
    }
    cp_async_wait<0>();  // nothing in flight at exit
  } else {
    // ---- the consumers: two warpgroups of 64 rows; each k tile's products
    // are summed from 0 in `part`, then added to acc: the tensor cores' fp32
    // sums round toward zero, which over thousands of steps into one
    // accumulator biases it (~1e-4 at K = 6144). ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
    const int cw = warp / 4;
    const int g = lane / 4, q = lane % 4;
    float acc[BN / 2], part[BN / 2] = {};
    uint32_t j = 0;  // the ring position of the next k tile
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile / n_blocks * BM;
      const int n0 = tile % n_blocks * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < k_tiles; ++kt, ++j) {
        mbar_wait(&full[j & 1], (j >> 1) & 1);
        __syncwarp();  // reconverge for the warpgroup-wide wgmma
        issue_k_tile(part, smem + (j & 1) * REC_STAGE, cw);
        wgmma_wait<0>();
        wgmma_pin<BN / 2>(part);
        mbar_arrive(&empty[j & 1]);
        add_to(acc, part);
      }

      // epilogue: acc[4i + e] is row 16 (warp % 4) + g (+ 8 for e >= 2) of
      // this warpgroup's 64, column 8i + 2q + (e & 1)
      const int row = m0 + 64 * cw + 16 * (warp % 4) + g;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int y = row + 8 * h;
          if (y >= a.M || col >= a.N) continue;
          float* c = a.C + (size_t)y * a.N + col;
          float v0 = acc[4 * i + 2 * h] + __ldg(a.bias + col);
          if (GELU) v0 = gelu_erf(v0);
          if (col + 1 < a.N) {
            float v1 = acc[4 * i + 2 * h + 1] + __ldg(a.bias + col + 1);
            if (GELU) v1 = gelu_erf(v1);
            if ((a.N & 1) == 0) {
              *reinterpret_cast<float2*>(c) = make_float2(v0, v1);  // 8-byte aligned: N and col even
            } else {
              c[0] = v0;
              c[1] = v1;
            }
          } else {
            c[0] = v0;
          }
        }
      }
    }
  }
}

template <bool GELU>
int launch(const float* A, const float* W, const float* bias, float* C, int M, int N, int K, int sms,
           cudaStream_t stream) {
  const Args a{A, W, bias, C, M, N, K,
               K % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0,
               N % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0};
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > INT_MAX / 2) return (int)cudaErrorInvalidValue;  // tile indices are int
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<GELU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_kernel<GELU><<<grid, THREADS, SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tf

}  // namespace

// The fp32 body: every tensor fp32 (x, h, act, out as in eilev_ln_mlp_bf16),
// contiguous; any D and F; x, w1, w2 at least 4-byte aligned. Launches
// three kernels on `stream`, no synchronise; returns the first failing
// launch's cudaError_t (0 on success).
extern "C" int eilev_ln_mlp_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* h, void* act, void* out, int M, int D, int F, float eps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || F <= 0 || M > MAX_ROWS) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  layer_norm_f32_kernel<<<(M + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<float*>(h), M, D, eps);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = tf::launch<true>(static_cast<const float*>(h), static_cast<const float*>(w1),
                         static_cast<const float*>(b1), static_cast<float*>(act), M, F, D, sms, st);
  if (err != 0) return err;
  return tf::launch<false>(static_cast<const float*>(act), static_cast<const float*>(w2),
                           static_cast<const float*>(b2), static_cast<float*>(out), M, D, F, sms, st);
}

// x: (M, D) bf16; ln_scale, ln_bias: (D) fp32; w1: (D, F) bf16; b1: (F) fp32;
// w2: (F, D) bf16; b2: (D) fp32; scratch h: (M, D) bf16 and act: (M, F) bf16;
// out: (M, D) bf16. All contiguous and 16-byte aligned (the vectors too);
// D % 8 == 0 and F % 8 == 0 (TMA's 16-byte row strides). Launches three
// kernels on `stream`, no synchronise; returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int eilev_ln_mlp_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* h, void* act, void* out, int M, int D, int F, float eps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || F <= 0 || D % 8 != 0 || F % 8 != 0 || M > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  using bf = __nv_bfloat16;
  layer_norm_kernel<<<(M + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
      static_cast<const bf*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<bf*>(h), M, D, eps);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = wg::launch<true>(fn, static_cast<const bf*>(h), static_cast<const bf*>(w1),
                         static_cast<const float*>(b1), static_cast<bf*>(act), M, F, D, sms, st);
  if (err != 0) return err;
  return wg::launch<false>(fn, static_cast<const bf*>(act), static_cast<const bf*>(w2),
                           static_cast<const float*>(b2), static_cast<bf*>(out), M, D, F, sms, st);
}
