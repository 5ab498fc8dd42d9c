// Attention with an fp32 model for Hopper (sm_90a): the fp32 body of K1, K2
// and K5.
//
// Replaces, for fp32 inputs, the Pallas kernels
//   K1 eilev_tpu/ops/fused_attention.py:81 packed_qkv_attention (the EVA-ViT
//      attention: bidirectional, no mask, score-side scale);
//   K2 eilev_tpu/ops/fused_attention.py:187 packed_qkv_causal_attention (the
//      OPT prefill: causal + (B, S) key-padding mask, query-side scale);
//   K5 eilev_tpu/ops/flash_attention.py:157 flash_attention (causal with a
//      query offset, (B, L) padding, an optional (H, S, L) fp32 bias, q-side
//      or score-side scale, grouped-query heads).
// q (B, S, H, D), k and v (B, L, KVH, D), each read through its batch and row
// strides with heads and D packed (the packed (B, S, 3*H*D) QKV of K1/K2 is
// three such views); out (B, S, H, D) through its own strides. Head h reads
// kv head h / (H / KVH).
//
// What it computes with an fp32 model, where every "round to the model
// dtype" of the bf16 kernels is the identity: s = (q * q_scale) . k in fp32,
// times s_scale, plus the bias; masked keys take finfo(float32).min, which is
// finite, so
//   * K1/K2 (uniform = 1): a masked key counts in the softmax with that
//     score: exp(min - max) = 0 beside any kept key, and a row whose every
//     key is masked is the uniform average of all L value rows, as the
//     reference's softmax gives it (exp(0) = 1 for every key);
//   * K5 (uniform = 0): p = 0 for a masked key, and a row with no kept key
//     is exactly 0 (the reference divides by l = 0 replaced by 1).
// In fp32 the reference's normalise-then-multiply (K1/K2) and K5's
// un-normalised recurrence over 128-key blocks equal an online softmax with
// one division at the end, to fp32 rounding: this body runs that.
//
// What bounds it on the H100: fp32 operations on the CUDA cores (67 TFLOP/s;
// the tensor cores take no fp32, and TF32 keeps 10 mantissa bits, too few for
// the 1e-4 the fp32 reference is held to). The design is the plain one of a
// tiled fp32 product, correct first: one block of 256 threads per (64-query
// tile, head, batch row) streams 64-key tiles of K and V through shared
// memory; Q and K are stored transposed (d-major), so each thread forms a 4 x
// 4 block of scores from two 16-byte shared-memory loads per d; the row
// statistics are reduced over the 16 threads that share the rows; p goes
// through shared memory (key-major) to the PV product, where each thread
// accumulates 4 rows x DP / 16 columns. Causal key tiles past the block's
// last query are skipped; with uniform = 1 they are read after all if a row
// of the block has seen only masked keys (its average runs over every key).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int LDT = 68;  // row stride of the transposed tiles: 16-byte aligned, 4-way store conflicts
constexpr int THREADS = 256;

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DP * LDT + BK * DP + BK * LDT);
}

// row r (< rows) of a strided (rows, D) slice into a d-major tile dst[d * LDT
// + r], times `mul`; rows >= rows and d >= D are zero
template <int DP>
__device__ __forceinline__ void load_t(float* dst, const float* src, long long rs, int r0, int rows,
                                       int D, float mul) {
  for (int idx = threadIdx.x; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP, d = idx % DP;
    const bool in = r0 + r < rows && d < D;
    dst[d * LDT + r] = in ? src[(r0 + r) * rs + d] * mul : 0.f;
  }
}

template <int DP, bool UNIFORM>
__global__ void __launch_bounds__(THREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int32_t* __restrict__ mask,
                     const float* __restrict__ bias, float* __restrict__ out, int S, int L, int H,
                     int KVH, int D, long long q_bs, long long q_rs, long long k_bs,
                     long long k_rs, long long v_bs, long long v_rs, long long o_bs,
                     long long o_rs, float q_scale, float s_scale, int causal, int q_offset) {
  constexpr int NCOL = DP / 16;  // output columns a thread: tx, tx + 16, ...
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;             // DP x LDT, d-major
  float* Kt = Qt + DP * LDT;    // DP x LDT, d-major
  float* Vs = Kt + DP * LDT;    // BK x DP, key-major
  float* Pt = Vs + BK * DP;     // BK x LDT, key-major

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tx = threadIdx.x % 16;  // keys 4tx .. 4tx + 3; output columns tx + 16c
  const int ty = threadIdx.x / 16;  // rows 4ty .. 4ty + 3
  const float* qb = q + b * q_bs + (long long)h * D;
  const float* kb = k + b * k_bs + (long long)kvh * D;
  const float* vb = v + b * v_bs + (long long)kvh * D;
  const int32_t* mb = mask ? mask + (long long)b * L : nullptr;
  const float* biash = bias ? bias + (long long)h * S * L : nullptr;
  const float masked = UNIFORM ? -FLT_MAX : -INFINITY;

  load_t<DP>(Qt, qb, q_rs, q0, S, D, q_scale);

  float m[4], l[4], o[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) o[i][c] = 0.f;
  }

  const int n_tiles = (L + BK - 1) / BK;
  const int q_last = min(q0 + BQ, S) - 1;
  const int n_needed = causal ? min(n_tiles, max(0, (q_last + q_offset) / BK + 1)) : n_tiles;
  for (int t = 0; t < n_tiles; ++t) {
    if (t == n_needed) {
      // past every causal frontier of the block: a tile there is wholly
      // masked. With uniform = 1 it still counts for a row that has seen
      // only masked keys (its average runs over every key).
      bool dead = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) dead |= UNIFORM && q0 + 4 * ty + i < S && m[i] == -FLT_MAX;
      if (!__syncthreads_or(dead)) break;
    }
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done with Kt, Vs, Pt
    load_t<DP>(Kt, kb, k_rs, k0, L, D, 1.f);
    for (int idx = threadIdx.x; idx < BK * DP; idx += THREADS) {
      const int j = idx / DP, d = idx % DP;
      Vs[idx] = k0 + j < L && d < D ? vb[(k0 + j) * v_rs + d] : 0.f;
    }
    __syncthreads();

    // scores: rows 4ty + i, keys 4tx + j, summed over d in order
    float s[4][4] = {};
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * LDT + 4 * ty);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + d * LDT + 4 * tx);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * tx + j;
        float x = s[i][j] * s_scale;
        if (biash && row < S && key < L) x += biash[(long long)row * L + key];
        const bool keep = (mb == nullptr || (key < L && mb[key] != 0)) &&
                          !(causal && key > row + q_offset);
        s[i][j] = key >= L ? -INFINITY : keep ? x : masked;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      // no kept (or, uniform, existing) key yet: the state stays 0
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = m_new == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        psum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (4 * tx + j) * LDT + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // o += p v over the tile's keys, in key order
    const int n_keys = min(BK, L - k0);
    for (int j = 0; j < n_keys; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + j * LDT + 4 * ty);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const float x = Vs[j * DP + c * 16 + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], x, o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    float* orow = out + b * o_bs + row * o_rs + (long long)h * D;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = c * 16 + tx;
      if (col < D) orow[col] = o[i][c] * inv;
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* bias, void* out,
           int B, int S, int L, int H, int KVH, int D, long long q_bs, long long q_rs, long long k_bs,
           long long k_rs, long long v_bs, long long v_rs, long long o_bs, long long o_rs,
           float q_scale, float s_scale, int causal, int q_offset, int uniform, cudaStream_t st) {
  auto kernel = uniform ? attention_f32_kernel<DP, true> : attention_f32_kernel<DP, false>;
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(mask), static_cast<const float*>(bias), static_cast<float*>(out), S,
      L, H, KVH, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, q_scale, s_scale, causal,
      q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: fp32, strided as above (element strides), 4-byte aligned;
// mask: (B, L) int32 or NULL; bias: (H, S, L) fp32 contiguous or NULL.
// Requires 0 < D <= 128, H % KVH == 0, B and H under 65,536, q_offset >= 0.
// uniform = 1: K1/K2's fully masked rows (uniform average); 0: K5's (zero).
// Returns the launch's cudaError_t (0 on success); launches on `stream`, no
// synchronise.
extern "C" int eilev_attention_f32(const void* q, const void* k, const void* v, const void* mask,
                                   const void* bias, void* out, int B, int S, int L, int H, int KVH,
                                   int D, long long q_bs, long long q_rs, long long k_bs,
                                   long long k_rs, long long v_bs, long long v_rs, long long o_bs,
                                   long long o_rs, float q_scale, float s_scale, int causal,
                                   int q_offset, int uniform, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || L <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 || D > 128 ||
      B > 65535 || H > 65535 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const int dp = (D + 15) / 16 * 16;
#define EILEV_F32_CASE(DP)                                                                    \
  case DP:                                                                                    \
    return launch<DP>(q, k, v, mask, bias, out, B, S, L, H, KVH, D, q_bs, q_rs, k_bs, k_rs, \
                      v_bs, v_rs, o_bs, o_rs, q_scale, s_scale, causal, q_offset, uniform, st);
  switch (dp) {
    EILEV_F32_CASE(16)
    EILEV_F32_CASE(32)
    EILEV_F32_CASE(48)
    EILEV_F32_CASE(64)
    EILEV_F32_CASE(80)
    EILEV_F32_CASE(96)
    EILEV_F32_CASE(112)
    EILEV_F32_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef EILEV_F32_CASE
}
