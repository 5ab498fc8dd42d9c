// Flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas kernel eilev_tpu/ops/flash_attention.py:157
// flash_attention (body _flash_kernel :52): K5. q (B, S, H, D) attends over
// k, v (B, L, KVH, D) with an optional (B, L) keep-mask, an optional (H, S, L)
// fp32 bias, causal masking with a query offset, and a q-side or score-side
// scale. Head h reads kv head h / (H / KVH). Output (B, S, H, D).
//
// What bounds it on the H100: operations. At the LLaMA prefill (q 1,984 over
// a 2,048-slot cache, 32 heads x 128, causal) one layer needs ~32 GFLOP of
// tensor-core work and ~65 MB of traffic: 33 us against 19 us at the card's
// peaks. This version keeps scores, probabilities and the output accumulator
// in registers (never in device memory), runs both matmuls on the tensor
// cores with mma.sync, and overlaps each K/V tile's copy with compute on the
// other; wgmma, TMA and warp specialisation are later steps.
//
// Design:
//   * One block of 4 warps per (64-query tile, head, batch row); each warp
//     owns 16 query rows. The grid is ceil(S/64) x H x B: 31 x 32 x B at the
//     LLaMA prefill.
//   * Key tiles of 128 (the Pallas block): K and V row-major in shared memory,
//     zero-filled past L and past D (D is padded to DP, a multiple of 16),
//     copied with cp.async straight from the caller's batch and row strides,
//     so a layer slice of the stacked cache is read in place. The next tile's
//     K is copied while this tile's softmax and PV run, its V while the next
//     QK^T runs (one buffer each).
//   * Operands reach the tensor cores through ldmatrix: Q and K as stored, V
//     transposed on the fly (.trans), all bank-conflict free with rows padded
//     by 16 bytes.
//   * Per tile, S = Q K^T with mma.sync m16n8k16 (bf16 in, fp32 accumulate):
//     16 x 128 fp32 scores per warp in registers. The score-side scale, the
//     bias and the masks are applied in fp32, then the online softmax update
//     of the Pallas body, row by row: m_new = max(m, max s); p = exp(s - m_new)
//     (0 where masked); alpha = exp(m - m_new) (0 while m is still the mask
//     value); l = alpha * l + sum p; O = alpha * O + bf16(p) V. The score
//     accumulator's register layout is the A-operand layout of the PV mma, so
//     p never leaves registers.
//   * Rounding points follow the Pallas body: q * bf16(scale) rounded to bf16
//     on load (q side); scores stay fp32 and are multiplied by the fp32 scale
//     (score side); masked scores are finfo(float32).min; p is rounded to
//     bf16 un-normalised before PV; the output is O / l with l = 0 replaced by
//     1, so a fully masked row is exactly 0.
//   * Key tiles wholly past the causal frontier of the block are not loaded,
//     and a warp skips a tile past its own rows' frontier: in the recurrence a
//     wholly masked tile is an exact no-op (alpha = 1 or the state stays 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;    // queries per block
constexpr int BK = 128;   // keys per tile (the Pallas block_kv)
constexpr int WARPS = 4;  // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

template <int DP>
struct Smem {
  static constexpr int LD = DP + 8;  // Q, K and V rows, bf16: ldmatrix rows hit distinct banks
  static constexpr size_t BYTES =
      sizeof(__nv_bfloat16) * (size_t)(BQ + 2 * BK) * LD + sizeof(int) * 2 * BK;
};

// Starts the copy of keys [k0, k0 + BK) of one (rows, heads, D) tensor into a
// (BK, DP) tile of row stride LD; rows >= L and columns >= D are zero.
template <int DP>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                                int k0, int L, long long row_stride, int D) {
  constexpr int CHUNKS = DP / 8;
  for (int idx = threadIdx.x; idx < BK * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx - r * CHUNKS;
    const bool valid = k0 + r < L && c * 8 < D;
    const __nv_bfloat16* src = valid ? base + (size_t)(k0 + r) * row_stride + c * 8 : base;
    cp_async16(dst + r * Smem<DP>::LD + c * 8, src, valid);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ mask,
                       const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int S,
                       int L, int H, int KVH, int D, long long q_bs, long long q_rs,
                       long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                       float q_scale, float s_scale, int causal, int q_offset) {
  constexpr int LD = Smem<DP>::LD;
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks per padded row
  constexpr int NT = BK / 8;      // 8-key score tiles per key tile
  constexpr int DT = DP / 8;      // 8-wide output tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // BQ x DP
  __nv_bfloat16* Ks = Qs + BQ * LD;                             // BK x DP
  __nv_bfloat16* Vs = Ks + BK * LD;                             // BK x DP
  int* keep = reinterpret_cast<int*>(Vs + BK * LD);             // 2 x BK, by tile parity

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  // ldmatrix: this lane's row within its 8x8 matrix, and which matrix
  const int lr = lane & 7;
  const int lm = lane >> 3;

  const __nv_bfloat16* qb = q + (size_t)b * q_bs + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * k_bs + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * v_bs + (size_t)kvh * D;
  const int32_t* mb = mask ? mask + (size_t)b * L : nullptr;

  int n_tiles = (L + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, S) - 1 + q_offset) / BK + 1);

  // first tile in flight while Q is scaled and stored
  load_tile_async<DP>(Ks, kb, 0, L, k_rs, D);
  cp_async_commit();
  load_tile_async<DP>(Vs, vb, 0, L, v_rs, D);
  cp_async_commit();
  for (int c = threadIdx.x; c < BK; c += THREADS) keep[c] = c < L && (mb == nullptr || mb[c] != 0);
  for (int idx = threadIdx.x; idx < BQ * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx - r * CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S && c * 8 < D) {
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * q_rs + c * 8);
      if (q_scale != 1.0f) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * q_scale);
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + c * 8) = val;
  }

  // this thread's two rows (g and g + 8 of the warp's 16), as absolute query
  // indices; the causal frontier of a row is q + q_offset
  const int qw = q0 + warp * 16;
  const int row_a = qw + g;
  const int row_b = qw + g + 8;
  const bool warp_live = qw < S;
  const int warp_frontier = min(qw + 15, S - 1) + q_offset;

  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    const int* keep_t = keep + (tile & 1) * BK;
    const bool more = tile + 1 < n_tiles;
    const bool live = warp_live && !(causal && k0 > warp_frontier);
    cp_async_wait<1>();  // K of this tile is in (its V may still be in flight)
    __syncthreads();

    // scores: 16 rows x 128 keys, fp32, in the mma accumulator layout
    float s[NT][4];
    if (live) {
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, Qs + (warp * 16 + lr + (lm & 1) * 8) * LD + kk * 16 + (lm >> 1) * 8);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bb[4];  // b0, b1 of key tile j, then of key tile j + 1
          ldmatrix_x4(bb, Ks + (j * 8 + (lm >> 1) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
          mma_bf16_16816(s[j], a, bb);
          mma_bf16_16816(s[j + 1], a, bb + 2);
        }
      }
    }
    __syncthreads();  // every warp is done with Ks
    if (more) {
      load_tile_async<DP>(Ks, kb, k0 + BK, L, k_rs, D);
      cp_async_commit();
    }

    if (live) {
      // scale, bias, masks; then this tile's row maxima
      float mx_a = NEG, mx_b = NEG;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + t * 2 + (e & 1);
          const int key = k0 + col;
          const int row = e < 2 ? row_a : row_b;
          float x = s[j][e] * s_scale;
          if (bias != nullptr && row < S && key < L) x += bias[((size_t)h * S + row) * L + key];
          const bool masked = !keep_t[col] || (causal && key > row + q_offset);
          x = masked ? NEG : x;
          s[j][e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float ref_a = mn_a == NEG ? 0.f : mn_a;
      const float ref_b = mn_b == NEG ? 0.f : mn_b;
      const float alpha_a = m_a == NEG ? 0.f : expf(m_a - ref_a);
      const float alpha_b = m_b == NEG ? 0.f : expf(m_b - ref_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score is exactly NEG; an unmasked one never is
          const float p = s[j][e] == NEG ? 0.f : expf(s[j][e] - (e < 2 ? ref_a : ref_b));
          s[j][e] = p;
          if (e < 2) sum_a += p; else sum_b += p;
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
      }
      l_a = alpha_a * l_a + sum_a;
      l_b = alpha_b * l_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][0] *= alpha_a;
        o[j][1] *= alpha_a;
        o[j][2] *= alpha_b;
        o[j][3] *= alpha_b;
      }
    }

    if (more) cp_async_wait<1>(); else cp_async_wait<0>();  // V of this tile is in
    __syncthreads();
    if (live) {
      // O += bf16(p) V: two 8-key score tiles form one 16-key A operand
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t bb[4];  // b0, b1 of output tile j, then of output tile j + 1
          ldmatrix_x4_trans(bb, Vs + (kk * 16 + (lm & 1) * 8 + lr) * LD + j * 8 + (lm >> 1) * 8);
          mma_bf16_16816(o[j], a, bb);
          mma_bf16_16816(o[j + 1], a, bb + 2);
        }
      }
    }
    __syncthreads();  // every warp is done with Vs and with this tile's keep
    if (more) {
      load_tile_async<DP>(Vs, vb, k0 + BK, L, v_rs, D);
      cp_async_commit();
      int* keep_n = keep + ((tile + 1) & 1) * BK;
      for (int c = threadIdx.x; c < BK; c += THREADS) {
        const int key = k0 + BK + c;
        keep_n[c] = key < L && (mb == nullptr || mb[key] != 0);
      }
    }
  }

  if (!warp_live) return;
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + t * 2;
    if (col >= D) continue;
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * S + row_a) * H + h) * D + col) =
          __floats2bfloat162_rn(o[j][0] * inv_a, o[j][1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * S + row_b) * H + h) * D + col) =
          __floats2bfloat162_rn(o[j][2] * inv_b, o[j][3] * inv_b);
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* bias,
           void* out, int B, int S, int L, int H, int KVH, int D, long long q_bs, long long q_rs,
           long long k_bs, long long k_rs, long long v_bs, long long v_rs, float q_scale,
           float s_scale, int causal, int q_offset, cudaStream_t stream) {
  const size_t smem = Smem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(mask),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), S, L, H, KVH, D, q_bs,
      q_rs, k_bs, k_rs, v_bs, v_rs, q_scale, s_scale, causal, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, S, H, D), k/v: (B, L, KVH, D) bf16, each with packed (heads, D) rows
// and the given batch/row strides in elements (multiples of 8; 16-byte
// aligned bases); mask: (B, L) int32 or NULL; bias: (H, S, L) fp32 or NULL;
// out: (B, S, H, D) bf16, contiguous. Requires D % 8 == 0, D <= 128 and
// H % KVH == 0. q_scale is bf16(scale) for a q-side scale (else 1); s_scale
// the fp32 score-side scale (else 1). Returns the launch's cudaError_t (0 on
// success); launches on `stream`, no synchronise.
extern "C" int eilev_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* mask, const void* bias, void* out, int B,
                                          int S, int L, int H, int KVH, int D, long long q_bs,
                                          long long q_rs, long long k_bs, long long k_rs,
                                          long long v_bs, long long v_rs, float q_scale,
                                          float s_scale, int causal, int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0 || D % 8 != 0 || D > 128 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const int dp = (D + 15) / 16 * 16;
#define EILEV_FLASH_CASE(DP)                                                                 \
  case DP:                                                                                   \
    return launch<DP>(q, k, v, mask, bias, out, B, S, L, H, KVH, D, q_bs, q_rs, k_bs, k_rs, \
                      v_bs, v_rs, q_scale, s_scale, causal, q_offset, st);
  switch (dp) {
    EILEV_FLASH_CASE(16)
    EILEV_FLASH_CASE(32)
    EILEV_FLASH_CASE(48)
    EILEV_FLASH_CASE(64)
    EILEV_FLASH_CASE(80)
    EILEV_FLASH_CASE(96)
    EILEV_FLASH_CASE(112)
    EILEV_FLASH_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef EILEV_FLASH_CASE
}
