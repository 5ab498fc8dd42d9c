// Packed-QKV attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces the two Pallas kernels of eilev_tpu/ops/fused_attention.py:
//   K1 packed_qkv_attention         (_packed_kernel)         - the EVA-ViT
//      attention, bidirectional, no mask, score-side scale;
//   K2 packed_qkv_causal_attention  (_packed_causal_kernel)  - the OPT
//      prefill, causal + (B, S) key-padding mask, query-side scale.
// Both read the packed (B, S, 3*H*D) QKV projection output laid out as
// [q heads | k heads | v heads] and write (B, S, H*D).
//
// What bounds it on the H100: the plain version writes the (B, H, S, S)
// scores and probabilities to device memory and reads them back several
// times (~0.9 GB per ViT layer at B=136 in bf16 + fp32), so it is bound by
// memory traffic. This kernel keeps scores and probabilities in shared memory
// and reads Q once and K/V twice per query tile. What bounds the kernel
// itself is not the tensor cores (under 3% of their peak at the flagship shapes)
// but the fp32 softmax between the two matmuls: rounding every score twice
// and one exp per score in each pass, plus tile loads that do not overlap
// compute. Ablations on an H100 (PERF.md) put most of its time there, so the
// softmax is laid out for throughput (two lanes per row, 16-byte shared
// reads, one shuffle per row reduction).
//
// Design:
//   * One block of 4 warps per (64-query tile, head, batch row). Each warp
//     owns 16 query rows. QK^T and PV run on tensor cores through WMMA
//     (16x16x16 bf16, fp32 accumulate). Head dims that are not a multiple of
//     16 (D=88) are zero-padded to DP in shared memory; ragged sequence edges
//     (S=257, S=766) are zero-filled and excluded from the softmax.
//   * Two passes over 64-key tiles instead of an online-softmax rescale. The
//     reference rounds the NORMALISED probabilities to bf16 before PV, which
//     an online rescale of the output cannot reproduce. Pass 1 finds the row
//     max and row sum in fp32; pass 2 recomputes the rounded scores, forms
//     p = exp(s - max) / sum, rounds p to bf16 and accumulates PV in fp32.
//     K and V of one head never need to fit in shared memory whole (at S=766,
//     D=80 they would take 245 KB).
//   * Rounding points follow the JAX reference exactly: the query is scaled
//     and rounded to bf16 on load (q_scale, 1 for K1); QK^T is rounded to
//     bf16, then scaled and rounded again (s_scale, 1 for K2); masked scores
//     are finfo(float32).min cast to bf16, which is -inf, so a fully masked
//     row is NaN as in the reference. Multiplying a bf16 value by 1 and
//     rounding is exact, so one code path serves both kernels.
//   * 16-byte vector loads: every head's column offset is a multiple of
//     8 elements when D % 8 == 0, which the Python wrapper checks.
//   * Work that cannot change the result is skipped: key tiles above the
//     causal diagonal, 16-key fragments past S or above the diagonal of all
//     of a warp's rows, and warps past the last query. Their probabilities
//     are exactly 0 in the reference too.
//   * Each warp keeps its Q fragments in registers for both passes, and
//     shared-memory rows are padded so fragment loads avoid bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = 4;      // 16 query rows per warp
constexpr int THREADS = WARPS * 32;

// Shared-memory layout. Row strides are padded past the tile width so that
// the 8 rows one tensor-core fragment load touches fall in distinct banks,
// and so that the softmax's 16-byte score reads (8 lanes: 4 rows x 2 column
// groups per phase) do too: SF_LD is the first stride >= the width that is
// 8 (mod 32) words.
template <int DP>
struct Smem {
  static constexpr int LD = DP + 8;                                     // Q/K/V, bf16
  static constexpr int SF_LD = ((BK > DP ? BK : DP) + 23) / 32 * 32 + 8;  // scores/out, fp32
  static constexpr int PB_LD = BK + 8;                    // probabilities, bf16
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * ((BQ + 2 * BK) * LD + BQ * PB_LD) +
                                  sizeof(float) * BQ * SF_LD + sizeof(int) * BK;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Copies rows [row0, row0 + BQ|BK) of one head's slice (column offset col) of
// the packed tensor into a (rows, DP) shared tile of row stride Smem<DP>::LD;
// rows >= S and columns >= D are zero. With scale != 1 every element is
// scaled and rounded to bf16.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* qkv_b,
                                          int row0, int S, int D, int row_stride, int col,
                                          float scale) {
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx - r * CHUNKS;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S && c * 8 < D) {
      val = *reinterpret_cast<const uint4*>(qkv_b + (size_t)row * row_stride + col + c * 8);
      if (scale != 1.0f) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<DP>::LD + c * 8) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
packed_attention_kernel(const __nv_bfloat16* __restrict__ qkv, const int32_t* __restrict__ mask,
                        __nv_bfloat16* __restrict__ out, int S, int H, int D, float q_scale,
                        float s_scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = Smem<DP>::LD;
  constexpr int SF_LD = Smem<DP>::SF_LD;
  constexpr int PB_LD = Smem<DP>::PB_LD;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);             // BQ x DP
  __nv_bfloat16* Ks = Qs + BQ * LD;                                        // BK x DP
  __nv_bfloat16* Vs = Ks + BK * LD;                                        // BK x DP
  float* Sf = reinterpret_cast<float*>(Vs + BK * LD);                      // BQ x max(BK, DP)
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(Sf + BQ * SF_LD);   // BQ x BK
  int* keep_s = reinterpret_cast<int*>(Pb + BQ * PB_LD);                   // BK

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int HD = H * D;
  const int row_stride = 3 * HD;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * S * row_stride;
  const int32_t* mask_b = mask ? mask + (size_t)b * S : nullptr;

  load_tile<DP, BQ>(Qs, qkv_b, q0, S, D, row_stride, h * D, q_scale);

  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    const int last_q = min(q0 + BQ, S) - 1;
    n_tiles = min(n_tiles, last_q / BK + 1);
  }

  float* Sw = Sf + warp * 16 * SF_LD;  // this warp's 16 score rows
  __nv_bfloat16* Pw = Pb + warp * 16 * PB_LD;
  const int qw = q0 + warp * 16;       // first query row of this warp
  // In the softmax each pair of lanes owns one of the warp's 16 rows; a lane
  // takes the row's columns 8m + 4*half .. +3 for m = 0..7, and the row's
  // statistics live in both lanes' registers.
  const int row = lane >> 1;
  const int half = lane & 1;
  const int q = qw + row;
  float row_max = -INFINITY, row_sum = 0.f;
  // A warp past the last query (S=257 leaves 3 of the last tile's 4 warps
  // idle) only joins the block's loads and barriers.
  const bool active = qw < S;
  // Key fragment [kf, kf + 16) can change this warp's rows only if it holds
  // a real key that is not above the causal diagonal of every row.
  auto key_frag_live = [&](int kf) { return kf < S && !(causal && kf > qw + 15); };

  // the warp's Q rows stay in registers for every tile of both passes
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[DP / 16];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * LD + kk * 16, LD);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(acc_o[j], 0.f);

  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * BK;
      __syncthreads();  // every warp is done with the previous tile
      load_tile<DP, BK>(Ks, qkv_b, k0, S, D, row_stride, HD + h * D, 1.0f);
      if (pass == 1) load_tile<DP, BK>(Vs, qkv_b, k0, S, D, row_stride, 2 * HD + h * D, 1.0f);
      for (int c = threadIdx.x; c < BK; c += THREADS) {
        const int key = k0 + c;
        keep_s[c] = key < S && (mask_b == nullptr || mask_b[key] != 0);
      }
      __syncthreads();
      if (!active) continue;

      // scores of this warp's 16 rows against the 64 keys, fp32 accumulate;
      // a skipped fragment's columns are never read (no key, or masked below)
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        if (!key_frag_live(k0 + n * 16)) continue;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Ks + n * 16 * LD + kk * 16, LD);
          wmma::mma_sync(acc, qf[kk], fb, acc);
        }
        wmma::store_matrix_sync(Sw + n * 16, acc, SF_LD, wmma::mem_row_major);
      }
      __syncwarp();

      float sc[BK / 2];  // this lane's 32 scores, rounded as the reference rounds them
#pragma unroll
      for (int m = 0; m < BK / 8; ++m) {
        const int c0 = 8 * m + 4 * half;
        const float4 v4 = *reinterpret_cast<const float4*>(Sw + row * SF_LD + c0);
        const int4 k4 = *reinterpret_cast<const int4*>(keep_s + c0);
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        const int kp[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = kp[e] && !(causal && k0 + c0 + e > q);
          sc[4 * m + e] = live ? round_bf16(round_bf16(v[e]) * s_scale) : -INFINITY;
        }
      }
      if (pass == 0) {
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) tile_max = fmaxf(tile_max, sc[j]);
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        const float m_new = fmaxf(row_max, tile_max);
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          if (sc[j] != -INFINITY) e += expf(sc[j] - m_new);
        e += __shfl_xor_sync(0xffffffffu, e, 1);
        const float alpha = row_max == -INFINITY ? 0.f : expf(row_max - m_new);
        row_sum = row_sum * alpha + e;
        row_max = m_new;
      } else {
        // a fully masked row has max -inf: exp(NaN) makes it NaN, as in the
        // reference
#pragma unroll
        for (int m = 0; m < BK / 8; ++m) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = expf(sc[4 * m + e] - row_max) / row_sum;
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(Pw + row * PB_LD + 8 * m + 4 * half);
          dst[0] = __floats2bfloat162_rn(p[0], p[1]);
          dst[1] = __floats2bfloat162_rn(p[2], p[3]);
        }
      }

      if (pass == 1) {
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // p is 0 over a dead fragment (or NaN on a row that is NaN anyway)
          if (!key_frag_live(k0 + kk * 16)) continue;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp;
          wmma::load_matrix_sync(fp, Pw + kk * 16, PB_LD);
#pragma unroll
          for (int j = 0; j < DP / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
            wmma::load_matrix_sync(fv, Vs + kk * 16 * LD + j * 16, LD);
            wmma::mma_sync(acc_o[j], fp, fv, acc_o[j]);
          }
        }
      }
    }
  }

  // fp32 output tile of this warp -> bf16, 8 elements per 16-byte store
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, acc_o[j], SF_LD, wmma::mem_row_major);
  __syncwarp();
  const int chunks = D / 8;
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int i = idx / chunks;
    const int c = idx - i * chunks;
    const int q = qw + i;
    if (q >= S) continue;
    uint4 val;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(Sw[i * SF_LD + c * 8 + j]);
    *reinterpret_cast<uint4*>(out + ((size_t)b * S + q) * HD + h * D + c * 8) = val;
  }
}

template <int DP>
int launch(const void* qkv, const void* mask, void* out, int B, int S, int H, int D,
           float q_scale, float s_scale, int causal, cudaStream_t stream) {
  const size_t smem = Smem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(packed_attention_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  packed_attention_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int32_t*>(mask),
      static_cast<__nv_bfloat16*>(out), S, H, D, q_scale, s_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (B, S, 3*H*D) bf16, contiguous, 16-byte aligned; mask: (B, S) int32 or
// NULL; out: (B, S, H*D) bf16. Requires D % 8 == 0 and D <= 128. Returns the
// launch's cudaError_t (0 on success); launches on `stream`, no synchronise.
extern "C" int eilev_packed_attention_bf16(const void* qkv, const void* mask, void* out, int B,
                                           int S, int H, int D, float q_scale, float s_scale,
                                           int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dp = (D + 15) / 16 * 16;
  switch (dp) {
    case 16: return launch<16>(qkv, mask, out, B, S, H, D, q_scale, s_scale, causal, st);
    case 32: return launch<32>(qkv, mask, out, B, S, H, D, q_scale, s_scale, causal, st);
    case 48: return launch<48>(qkv, mask, out, B, S, H, D, q_scale, s_scale, causal, st);
    case 64: return launch<64>(qkv, mask, out, B, S, H, D, q_scale, s_scale, causal, st);
    case 80: return launch<80>(qkv, mask, out, B, S, H, D, q_scale, s_scale, causal, st);
    case 96: return launch<96>(qkv, mask, out, B, S, H, D, q_scale, s_scale, causal, st);
    case 112: return launch<112>(qkv, mask, out, B, S, H, D, q_scale, s_scale, causal, st);
    case 128: return launch<128>(qkv, mask, out, B, S, H, D, q_scale, s_scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
