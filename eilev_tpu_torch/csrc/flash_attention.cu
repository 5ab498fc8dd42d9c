// Flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas kernel eilev_tpu/ops/flash_attention.py:157
// flash_attention (body _flash_kernel :52, call :273): K5. q (B, S, H, D)
// attends over k, v (B, L, KVH, D) with an optional (B, L) keep-mask, an
// optional (H, S, L) bias (bf16 or fp32, read through its strides), causal
// masking with a query offset, and a q-side or score-side scale. Head h reads
// kv head h / (H / KVH). Output (B, S, H, D).
//
// What bounds it on the H100: operations where many queries share a key
// (the LLaMA prefill: ~32 GFLOP of tensor-core work a layer against ~33 MB,
// 33 us against 10 us), bytes where few do (a one-query decoder step reads
// every K and V row once for 4 flops an element). Scores, probabilities and
// the output accumulator stay in registers or shared memory.
//
// Three bodies behind one entry point, eilev_flash_attention_bf16, which says
// which one it launched. The rule (choose_body; ops/flash_attention.py:
// k5_body states it for the tests), first match wins:
//   * "decode" (decode::decode_kernel): at most decode::MAX_Q query rows,
//     and the scores of every key tile fit in shared memory;
//   * "sm90" (hopper::flash_attention_sm90_kernel<D, BIAS>): D = 128 with no
//     bias, or D = 64 with no bias or a bf16 bias whose keys are contiguous
//     and whose rows and heads start on 16-byte boundaries; every operand's
//     rows and batches do not overlap (row stride >= heads * D, batch stride
//     >= rows * row stride) and the shared memory fits;
//   * "mma" (flash_attention_kernel<DP>): the rest (other head dims, D = 128
//     with a bias, an fp32 bias past the decode rule, overlapping strides).
// No body falls back to another at run time.
//
// The keep-mask is read in place through its batch stride (0 for a (1, L)
// mask expanded to (B, L)) as 1-, 4- or 8-byte integers, and the bias through
// its head, row and key strides in its own dtype: no per-call copy.
//
// The decode body, for one-query steps (the T5 decoder's self and cross
// steps, the serving engine's):
//   * What held the mma.sync body back there: one block per (head, row) of
//     4 warps, 3 of them with no row, a 16-row mma for one row, and the key
//     tiles streamed one after another through one buffer (a 766-key cross
//     step ran at ~15% of the card's bandwidth).
//   * It is a GEMV, so no tensor cores. One block per (query row, head,
//     batch row) of up to 16 warps. The keys split into segments of 8 to 128
//     keys (a power of 2, about one a warp; a segment lies in one 128-key
//     tile); warp w takes segments w, w + 16, ... It reads each K row as
//     16-byte chunks, LPK lanes a row (LPK = 4, 8 or 16 by head dim), 8 loads
//     a lane in flight; the dot's partial sums meet by shuffles. Bias and
//     mask are read for the segment's keys before its K rows. Whole
//     128-key tiles a warp left one warp a block at 64 slots, so a step's
//     time was that warp's instruction latency, not bytes.
//   * The recurrence of the twin, without its sequence: every segment's fp32
//     scores (scaled, biased, masked) and its max go to shared memory; each
//     tile's max over its segments, then an inclusive prefix max over the
//     tiles, gives each tile m_t, the running max the twin has after it; p =
//     exp(s - m_t) is rounded to bf16 against it (the twin's rounding
//     point), PV and the sum of p are taken per segment and added as
//     exp(m_t - m_last) * (PV, l). A tile with m_t = the mask value
//     contributes nothing (every key so far masked), and a row whose every
//     key is masked has l = 0 and is exactly 0.
//   * V rows whose bf16(p) is 0 (masked keys) are not read. No tensor map and
//     no host work beyond the launch: it runs ~1,500 times a T5 request.
//
// The Hopper body (hopper::flash_attention_sm90_kernel<D, BIAS, WG>), for the
// LLaMA prefill (D = 128) and the T5 encoder, VideoMAE and the Q-Former (D =
// 64, T5 with its relative bias):
//   * What held the mma.sync body back: mma.sync instead of wgmma; 4 warps a
//     block, each re-reading every K/V fragment with ldmatrix; one K and one
//     V buffer, so copies barely overlapped compute; light query tiles
//     first, so the heaviest ran in the last wave; wholly masked key tiles
//     (left padding) still loaded and multiplied; each score's bias a scalar
//     fp32 load from device memory with nothing prefetched.
//   * One block of WG warpgroups per (64 WG-query tile, head, batch row),
//     each owning 64 query rows: WG = 2 at D = 128, 1 at D = 64 (the Q-Former
//     has 32 queries, and with 64 queries a block 2 or 3 blocks share an SM,
//     so one block's softmax overlaps another's products). TMA loads Q
//     once, then K and V
//     tiles of 128 keys into a 2-stage ring with a full and an empty
//     mbarrier per stage and operand. With a bias, the (64 WG queries x 128
//     keys) bias tile rides in K's stage, on K's barriers. Shared memory: D =
//     128, Q 32 KB + K 2 x 32 KB + V 2 x 32 KB; D = 64, Q 8 KB + 2 x 16 + 2 x
//     16, and 2 x 16 KB of bias tiles with a bias (104 KB).
//   * No producer warpgroup: with 12 warps an SM partition holds 3 of them,
//     so ptxas compiles every thread at 168 registers (setmaxnreg did not
//     raise that), spills and serializes the wgmma (C7512). Thread 0 issues
//     the TMA loads in order, never blocking on an empty barrier (it issues
//     what the free stages allow each time it would wait for a full one).
//   * Tiles are stored as 64-column halves (one at D = 64, two at D = 128)
//     in the 128-byte swizzle TMA writes; the wgmma descriptors read that
//     swizzle directly. A bias tile is two 64-key halves in the same swizzle,
//     so the score fragment's 8 rows g of one 8-key column group read 8
//     different 16-byte chunks: no bank conflict.
//   * S = Q K^T: wgmma m64n128k16, both operands in shared memory (K-major),
//     64 fp32 scores a thread. O += P V: wgmma m64nDk16 with P as the register
//     A operand (the score fragment packed to bf16 pairs) and V read through
//     a transposed (MN-major) descriptor.
//   * At D = 64 the softmax's exp is __expf (hopper_exp): the products are
//     half those of D = 128 for the same softmax, which then sets the pace.
//   * The tensor maps are built per call by the host launcher with
//     cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so no
//     -lcuda) over (D, heads, rows, batch) with the caller's strides (and
//     the bias over (keys, rows, heads)): a layer slice of the stacked cache
//     is read in place, rows past S or L come in as zeros.
//   * Scheduling: a 1-d grid whose first blocks take the last (heaviest
//     causal) query tiles, batch rows of one (head, query tile) adjacent, so
//     a bias tile comes from device memory once and from L2 for the other
//     batch rows. Before the roles split, the block packs its keep-mask into
//     bits and lists the key tiles it needs: past its causal frontier, or
//     with every keep flag 0, a tile is neither loaded nor multiplied (exact:
//     in the recurrence a wholly masked tile is a no-op, alpha = 1 or the
//     state stays 0). Every warpgroup runs every listed tile: where one's
//     rows are all before a tile's causal frontier, its masks make the tile
//     that no-op (skipping it in a branch around the wgmma made ptxas
//     serialize them). Per-score masking runs only on tiles that straddle a
//     causal frontier or hold a masked key.
//
// The mma.sync body (flash_attention_kernel), for the other calls:
//   * One block of 4 warps per (64-query tile, head, batch row); each warp
//     owns 16 query rows. D is padded to DP, a multiple of 16.
//   * K and V tiles of 128 keys copied with cp.async from the caller's
//     strides (zero past L and D); the next K is copied during this tile's
//     softmax and PV, the next V during the next QK^T.
//   * ldmatrix feeds mma.sync m16n8k16: Q and K as stored, V transposed on
//     the fly; the score accumulator's layout is the PV A operand's.
//   * Key tiles wholly past the block's causal frontier are not loaded, and
//     a warp skips a tile past its own rows' frontier.
//
// Numerics, the same in every body and in the twin: key tiles of 128 from
// key 0 (the Pallas block); q * bf16(scale) rounded to bf16 (q side, applied
// once); fp32 scores times the fp32 scale (score side), plus the bias in
// fp32 (a bf16 bias is exact in fp32); masked scores finfo(float32).min; the
// online softmax of the Pallas body row by row: m_new = max(m, max s); p =
// exp(s - m_new) (0 where masked); alpha = exp(m - m_new) (0 while m is still
// the mask value); l = alpha * l + sum p; O = alpha * O + bf16(p) V, p rounded
// un-normalised; the output O / l with l = 0 replaced by 1, so a fully masked
// row is 0. The exps are the accurate expf, as torch.exp in the twin, but in
// the Hopper body at D = 64 (hopper_exp).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"
#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr int BK = 128;   // keys per tile (the Pallas block_kv)
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory one block may use

// One call's operands and options. Strides in elements.
struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const void* mask;  // (B, L) keep-mask of m_bytes-wide integers, or NULL
  const void* bias;  // (H, S, L) bias, bf16 (bias_bf16) or fp32, or NULL
  __nv_bfloat16* out;
  int B, S, L, H, KVH, D;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  long long m_bs;
  int m_bytes;
  long long b_hs, b_rs, b_ks;
  int bias_bf16;
  float q_scale, s_scale;
  int causal, q_offset;
};

// Whether element `idx` of a keep-mask of `bytes`-wide integers is nonzero.
__device__ __forceinline__ bool mask_keeps(const void* m, int bytes, size_t idx) {
  if (bytes == 4) return static_cast<const int32_t*>(m)[idx] != 0;
  if (bytes == 8) return static_cast<const long long*>(m)[idx] != 0;
  return static_cast<const uint8_t*>(m)[idx] != 0;
}

// Whether key `key` of batch row b is kept by the mask (keys past L are not).
__device__ __forceinline__ bool key_kept(const Args& a, int b, int key) {
  return key < a.L && (a.mask == nullptr || mask_keeps(a.mask, a.m_bytes, (size_t)b * a.m_bs + key));
}

// The bias of (head h, query row, key) in fp32.
__device__ __forceinline__ float bias_at(const Args& a, int h, int row, int key) {
  const size_t idx = (size_t)h * a.b_hs + (size_t)row * a.b_rs + (size_t)key * a.b_ks;
  return a.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[idx])
                     : static_cast<const float*>(a.bias)[idx];
}

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16(x)); }

// ---- the mma.sync body ----------------------------------------------------

constexpr int BQ = 64;    // queries per block
constexpr int WARPS = 4;  // 16 query rows per warp
constexpr int THREADS = WARPS * 32;

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
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(const Args a) {
  constexpr int LD = Smem<DP>::LD;
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks per padded row
  constexpr int NT = BK / 8;      // 8-key score tiles per key tile
  constexpr int DT = DP / 8;      // 8-wide output tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // BQ x DP
  __nv_bfloat16* Ks = Qs + BQ * LD;                             // BK x DP
  __nv_bfloat16* Vs = Ks + BK * LD;                             // BK x DP
  int* keep = reinterpret_cast<int*>(Vs + BK * LD);             // 2 x BK, by tile parity

  const int S = a.S, L = a.L, H = a.H, D = a.D;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / a.KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  // ldmatrix: this lane's row within its 8x8 matrix, and which matrix
  const int lr = lane & 7;
  const int lm = lane >> 3;

  const __nv_bfloat16* qb = a.q + (size_t)b * a.q_bs + (size_t)h * D;
  const __nv_bfloat16* kb = a.k + (size_t)b * a.k_bs + (size_t)kvh * D;
  const __nv_bfloat16* vb = a.v + (size_t)b * a.v_bs + (size_t)kvh * D;

  int n_tiles = (L + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + BQ, S) - 1 + a.q_offset) / BK + 1);

  // first tile in flight while Q is scaled and stored
  load_tile_async<DP>(Ks, kb, 0, L, a.k_rs, D);
  cp_async_commit();
  load_tile_async<DP>(Vs, vb, 0, L, a.v_rs, D);
  cp_async_commit();
  for (int c = threadIdx.x; c < BK; c += THREADS) keep[c] = key_kept(a, b, c);
  for (int idx = threadIdx.x; idx < BQ * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx - r * CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S && c * 8 < D) {
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * a.q_rs + c * 8);
      if (a.q_scale != 1.0f) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * a.q_scale);
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
  const int warp_frontier = min(qw + 15, S - 1) + a.q_offset;

  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    const int* keep_t = keep + (tile & 1) * BK;
    const bool more = tile + 1 < n_tiles;
    const bool live = warp_live && !(a.causal && k0 > warp_frontier);
    cp_async_wait<1>();  // K of this tile is in (its V may still be in flight)
    __syncthreads();

    // scores: 16 rows x 128 keys, fp32, in the mma accumulator layout
    float s[NT][4];
    if (live) {
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, Qs + (warp * 16 + lr + (lm & 1) * 8) * LD + kk * 16 + (lm >> 1) * 8);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bb[4];  // b0, b1 of key tile j, then of key tile j + 1
          ldmatrix_x4(bb, Ks + (j * 8 + (lm >> 1) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
          mma_bf16_16816(s[j], af, bb);
          mma_bf16_16816(s[j + 1], af, bb + 2);
        }
      }
    }
    __syncthreads();  // every warp is done with Ks
    if (more) {
      load_tile_async<DP>(Ks, kb, k0 + BK, L, a.k_rs, D);
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
          float x = s[j][e] * a.s_scale;
          if (a.bias != nullptr && row < S && key < L) x += bias_at(a, h, row, key);
          const bool masked = !keep_t[col] || (a.causal && key > row + a.q_offset);
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
        const uint32_t af[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t bb[4];  // b0, b1 of output tile j, then of output tile j + 1
          ldmatrix_x4_trans(bb, Vs + (kk * 16 + (lm & 1) * 8 + lr) * LD + j * 8 + (lm >> 1) * 8);
          mma_bf16_16816(o[j], af, bb);
          mma_bf16_16816(o[j + 1], af, bb + 2);
        }
      }
    }
    __syncthreads();  // every warp is done with Vs and with this tile's keep
    if (more) {
      load_tile_async<DP>(Vs, vb, k0 + BK, L, a.v_rs, D);
      cp_async_commit();
      int* keep_n = keep + ((tile + 1) & 1) * BK;
      for (int c = threadIdx.x; c < BK; c += THREADS) keep_n[c] = key_kept(a, b, k0 + BK + c);
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
      *reinterpret_cast<__nv_bfloat162*>(a.out + (((size_t)b * S + row_a) * H + h) * D + col) =
          __floats2bfloat162_rn(o[j][0] * inv_a, o[j][1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(a.out + (((size_t)b * S + row_b) * H + h) * D + col) =
          __floats2bfloat162_rn(o[j][2] * inv_b, o[j][3] * inv_b);
  }
}

template <int DP>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Smem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  flash_attention_kernel<DP><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- the decode body: one-query steps, split over the key tiles ------------

namespace decode {

constexpr int MAX_Q = 4;        // query rows a call may have to take this body
constexpr int MAX_WARPS = 16;   // a block's warps
constexpr int BATCH = 8;        // 16-byte loads a lane keeps in flight

// Keys a warp takes at a time (a segment): the power of 2 from 8 to 128 at
// or above L / MAX_WARPS, so the keys split into about one segment a warp
// and a segment lies in one 128-key tile.
int segment_keys(int L) {
  const int per_warp = (L + MAX_WARPS - 1) / MAX_WARPS;
  int seg = 8;
  while (seg < per_warp && seg < BK) seg *= 2;
  return seg;
}

// Dynamic shared memory at L keys: each key tile's 128 scores (fp32), the
// maxima of its segments (16 at most) and its running max, then each warp's
// partial output row (128 floats) and sum of p.
size_t smem_bytes(int L) {
  const size_t tiles = (size_t)(L + BK - 1) / BK;
  return tiles * BK * 4 + tiles * 16 * 4 + tiles * 4 + MAX_WARPS * (128 + 1) * 4;
}

// The rule of the decode body: few query rows, every tile's scores in
// shared memory.
bool takes(const Args& a) { return a.S <= MAX_Q && smem_bytes(a.L) <= SMEM_LIMIT; }

// fp32 dot of 8 query values with the 8 bf16 of a 16-byte chunk.
__device__ __forceinline__ float dot8(const float* qf, uint4 kr) {
  const uint32_t w[4] = {kr.x, kr.y, kr.z, kr.w};
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) d = fmaf(qf[2 * e + 1], bf16_hi(w[e]), fmaf(qf[2 * e], bf16_lo(w[e]), d));
  return d;
}

// LPK lanes read one 16-byte-chunked row (LPK = 4, 8 or 16: head dims up to
// 32, 64 or 128), so a warp reads 32 / LPK rows a pass; `seg` keys a
// segment (segment_keys).
template <int LPK>
__global__ void __launch_bounds__(MAX_WARPS * 32) decode_kernel(const Args a, int seg) {
  constexpr int KPP = 32 / LPK;  // rows a pass
  extern __shared__ float dsm[];
  const int n_kt = (a.L + BK - 1) / BK;
  float* sc = dsm;                        // n_kt * BK scores, then bf16(p)
  float* smax = sc + (size_t)n_kt * BK;   // segment maxima, at most 16 a tile
  float* tmax = smax + (size_t)n_kt * 16; // tile maxima, then their prefix maxima
  float* red = tmax + n_kt;               // MAX_WARPS partial output rows
  float* red_l = red + MAX_WARPS * 128;   // MAX_WARPS partial sums of p

  const int S = a.S, L = a.L, H = a.H, D = a.D;
  const int row = blockIdx.x % S;
  const int h = (blockIdx.x / S) % H;
  const int b = blockIdx.x / (S * H);
  const int kvh = h / (H / a.KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  const int c = lane % LPK;   // this lane's 8-column chunk of a row
  const int kq = lane / LPK;  // its row within a pass
  const bool c_live = c * 8 < D;
  const int passes = seg / KPP;  // passes a segment
  const int per_tile = BK / seg;  // segments a tile
  int n_tiles = n_kt;
  if (a.causal) n_tiles = min(n_tiles, (row + a.q_offset) / BK + 1);
  const int n_seg = min((L + seg - 1) / seg, n_tiles * per_tile);

  const __nv_bfloat16* kb = a.k + (size_t)b * a.k_bs + (size_t)kvh * D + c * 8;
  const __nv_bfloat16* vb = a.v + (size_t)b * a.v_bs + (size_t)kvh * D + c * 8;

  // this lane's chunk of q, q-side scaled and rounded as in the other bodies
  float qf[8];
  {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (c_live)
      raw = *reinterpret_cast<const uint4*>(a.q + (size_t)b * a.q_bs + (size_t)row * a.q_rs + (size_t)h * D + c * 8);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qf[2 * e] = bf16_lo(w[e]);
      qf[2 * e + 1] = bf16_hi(w[e]);
    }
    if (a.q_scale != 1.0f) {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[e] = bf16_round(qf[e] * a.q_scale);
    }
  }

  // pass 1: each warp's segments' scores (scaled, biased, masked) and maxima
  for (int sg = warp; sg < n_seg; sg += nw) {
    const int k0 = sg * seg;
    bool kept[4];
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + lane + 32 * j;
      const bool mine = lane + 32 * j < seg;
      kept[j] = mine && key_kept(a, b, key) && !(a.causal && key > row + a.q_offset);
      bv[j] = (mine && a.bias != nullptr && key < L) ? bias_at(a, h, row, key) : 0.f;
    }
    for (int p0 = 0; p0 < passes; p0 += BATCH) {
      uint4 kr[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int key = k0 + (p0 + i) * KPP + kq;
        kr[i] = (c_live && p0 + i < passes && key < L)
                    ? *reinterpret_cast<const uint4*>(kb + (size_t)key * a.k_rs)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        float d = dot8(qf, kr[i]);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (c == 0 && p0 + i < passes) sc[k0 + (p0 + i) * KPP + kq] = d;
      }
    }
    __syncwarp();
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (lane + 32 * j < seg) {
        const int idx = k0 + lane + 32 * j;
        float x = sc[idx] * a.s_scale;
        x += bv[j];
        x = kept[j] ? x : NEG;
        sc[idx] = x;
        mx = fmaxf(mx, x);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) smax[sg] = mx;
  }
  __syncthreads();

  // each tile's max over its segments, then the running max after each
  // tile: an inclusive prefix max, 32 tiles a step
  if (warp == 0) {
    float carry = NEG;
    for (int base = 0; base < n_tiles; base += 32) {
      const int t = base + lane;
      float x = NEG;
      for (int sg = t * per_tile; t < n_tiles && sg < min((t + 1) * per_tile, n_seg); ++sg) x = fmaxf(x, smax[sg]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x = fmaxf(x, y);
      }
      x = fmaxf(x, carry);
      if (t < n_tiles) tmax[t] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();

  // pass 2: p against its tile's running max, bf16(p) V and the sum of p a
  // segment, added with exp(m_t - m_last)
  const float m_last = tmax[n_tiles - 1];
  float acc[8], lsum = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int sg = warp; sg < n_seg; sg += nw) {
    const float mt = tmax[sg / per_tile];
    if (mt == NEG) continue;  // every key up to this tile is masked: p = 0
    const int k0 = sg * seg;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (lane + 32 * j < seg) {
        const int idx = k0 + lane + 32 * j;
        const float x = sc[idx];
        // a masked score is exactly NEG; an unmasked one never is
        const float p = x == NEG ? 0.f : expf(x - mt);
        ls += p;
        sc[idx] = bf16_round(p);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    __syncwarp();
    float pv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) pv[e] = 0.f;
    for (int p0 = 0; p0 < passes; p0 += BATCH) {
      uint4 vr[BATCH];
      float pb[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int r = (p0 + i) * KPP + kq;
        pb[i] = p0 + i < passes ? sc[k0 + r] : 0.f;
        vr[i] = (c_live && pb[i] != 0.f) ? *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * a.v_rs)
                                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const uint32_t w[4] = {vr[i].x, vr[i].y, vr[i].z, vr[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[2 * e] = fmaf(pb[i], bf16_lo(w[e]), pv[2 * e]);
          pv[2 * e + 1] = fmaf(pb[i], bf16_hi(w[e]), pv[2 * e + 1]);
        }
      }
    }
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) pv[e] += __shfl_xor_sync(0xffffffffu, pv[e], off);
    }
    const float w = expf(mt - m_last);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += w * pv[e];
    lsum += w * ls;
  }
  if (kq == 0 && c_live) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp * 128 + c * 8 + e] = acc[e];
  }
  if (lane == 0) red_l[warp] = lsum;
  __syncthreads();
  float l = 0.f;
  for (int w = 0; w < nw; ++w) l += red_l[w];
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int w = 0; w < nw; ++w) o += red[w * 128 + d];
    a.out[(((size_t)b * S + row) * H + h) * D + d] = __float2bfloat16(o * inv);
  }
}

template <int LPK>
int launch_lpk(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.L);
  if (smem > 48 * 1024) {  // only past the default: no host call on a T5 step
    cudaError_t err = cudaFuncSetAttribute(decode_kernel<LPK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int seg = segment_keys(a.L);
  const int warps = min(MAX_WARPS, (a.L + seg - 1) / seg);
  const long long blocks = (long long)a.S * a.H * a.B;
  decode_kernel<LPK><<<(unsigned)blocks, warps * 32, smem, stream>>>(a, seg);
  return (int)cudaGetLastError();
}

int launch(const Args& a, cudaStream_t stream) {
  if (a.D <= 32) return launch_lpk<4>(a, stream);
  if (a.D <= 64) return launch_lpk<8>(a, stream);
  return launch_lpk<16>(a, stream);
}

}  // namespace decode

// ---- the Hopper body: wgmma + TMA, D = 64 or 128, an optional bias --------

namespace hopper {

constexpr int HALF = 64;  // bf16 columns of one 128-byte swizzled row
constexpr uint32_t HALF_BYTES = BK * HALF * 2;     // one 64-column half of a 128-key K or V tile: 16 KB
constexpr uint32_t WG_ROWS_BYTES = 64 * HALF * 2;  // a consumer's 64 rows of one half
constexpr uint32_t FULL_TILE = 1u << 31;           // list flag: every keep bit of the tile set

// A block of WG consumer warpgroups (64 query rows each). Byte offsets in
// dynamic shared memory (from a 1024-byte aligned base): Q, 2 K stages, 2 V
// stages, 2 bias stages (with a bias; a stage is the block's rows x 128 keys
// in two 64-key halves), 9 mbarriers and the live-tile count, then 4
// keep-bit words and one list entry a key tile.
template <int D, bool BIAS, int WG>
struct Layout {
  static constexpr int BQ = 64 * WG;  // queries a block
  static constexpr int THREADS = 128 * WG;
  static constexpr uint32_t Q_HALF = BQ * HALF * 2;
  static constexpr uint32_t Q_TILE = (D / HALF) * Q_HALF;
  static constexpr uint32_t KV_TILE = (D / HALF) * HALF_BYTES;
  static constexpr uint32_t BIAS_HALF = BQ * HALF * 2;
  static constexpr uint32_t BIAS_TILE = 2 * BIAS_HALF;
  static constexpr uint32_t OFF_Q = 0;
  static constexpr uint32_t OFF_K = OFF_Q + Q_TILE;
  static constexpr uint32_t OFF_V = OFF_K + 2 * KV_TILE;
  static constexpr uint32_t OFF_BIAS = OFF_V + 2 * KV_TILE;
  static constexpr uint32_t OFF_BAR = OFF_BIAS + (BIAS ? 2 * BIAS_TILE : 0);
  static constexpr uint32_t OFF_BITS = OFF_BAR + 128;
};

// exp of a score minus its running max (x <= 0). Head dim 128: the accurate
// expf, as torch.exp in the twin. Head dim 64: ex2.approx of x log2(e)
// (__expf), 2 instructions for ~10: relative error ~1e-6 for x > -20 (the
// p that bf16 keeps), which moves a bf16 rounding of p in a few scores in
// 10,000 and the output far less than the 2e-2 bar; at head dim 64 the
// softmax, not the tensor cores, sets the pace (PERF.md).
template <int D>
__device__ __forceinline__ float hopper_exp(float x) {
  if constexpr (D == 64) return __expf(x);
  else return expf(x);
}

struct Barriers {
  uint64_t q_full, k_full[2], k_empty[2], v_full[2], v_empty[2];
  int n_live;
};

// Bytes of dynamic shared memory at L keys with wg consumer warpgroups: the
// fixed part, 4 keep-bit words and one list entry per key tile, and 1 KB to
// align the base.
size_t smem_bytes(int D, bool bias, int L, int wg) {
  const size_t tiles = (size_t)(L + BK - 1) / BK;
  const size_t rows = 64 * (size_t)wg;
  const size_t fixed = (size_t)(D / HALF) * (rows + 4 * BK) * HALF * 2 + (bias ? 2 * rows * BK * 2 : 0) + 128;
  return fixed + tiles * 4 * sizeof(uint32_t) + tiles * sizeof(uint32_t) + 1024;
}

template <int D, bool BIAS, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_bias, const Args a) {
  using Lay = Layout<D, BIAS, WG>;
  constexpr int BQ = Lay::BQ;
  constexpr int THREADS = Lay::THREADS;
  constexpr int HALVES = D / HALF;
  constexpr int OUT = D / 2;  // output accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::OFF_Q);
  Barriers* bar = reinterpret_cast<Barriers*>(smem + Lay::OFF_BAR);
  const int S = a.S, L = a.L, H = a.H, B = a.B;
  const int n_kt = (L + BK - 1) / BK;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + Lay::OFF_BITS);  // 4 * n_kt words
  uint32_t* list = bits + 4 * n_kt;                                    // n_kt entries

  // heaviest first: block i takes query tile n_qt - 1 - i / (H * B); the
  // batch rows of one (head, query tile) are adjacent
  const int n_qt = (S + BQ - 1) / BQ;
  const int hb = blockIdx.x % (H * B);
  const int q0 = (n_qt - 1 - (int)blockIdx.x / (H * B)) * BQ;
  const int b = hb % B;
  const int h = hb / B;
  const int kvh = h / (H / a.KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // key tiles the block may need: up to its causal frontier
  int n_tiles = n_kt;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + BQ, S) - 1 + a.q_offset) / BK + 1);

  // the keep-mask as bits (0 past L), 32 keys a word
  for (int w = warp; w < 4 * n_tiles; w += THREADS / 32) {
    const uint32_t word = __ballot_sync(0xffffffffu, key_kept(a, b, w * 32 + lane));
    if (lane == 0) bits[w] = word;
  }
  if (threadIdx.x == 0) {
    mbar_init(&bar->q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar->k_full[s], 1);
      mbar_init(&bar->v_full[s], 1);
      mbar_init(&bar->k_empty[s], THREADS);  // every consumer thread releases
      mbar_init(&bar->v_empty[s], THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the live key tiles, in order: those with a keep bit set
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int j = t0 + lane;
      bool live = false, full = false;
      if (j < n_tiles) {
        const uint32_t w0 = bits[4 * j], w1 = bits[4 * j + 1], w2 = bits[4 * j + 2], w3 = bits[4 * j + 3];
        live = (w0 | w1 | w2 | w3) != 0u;
        full = (w0 & w1 & w2 & w3) == 0xffffffffu;
      }
      const uint32_t ballot = __ballot_sync(0xffffffffu, live);
      if (live) list[n + __popc(ballot & ((1u << lane) - 1u))] = (uint32_t)j | (full ? FULL_TILE : 0u);
      n += __popc(ballot);
    }
    if (lane == 0) bar->n_live = n;
  }
  __syncthreads();
  const int n_live = bar->n_live;

  // The TMA issuer, thread 0: Q once, then K (with its bias tile) and V of
  // the live tiles into the 2-stage ring, in order. It never blocks on an
  // empty barrier: pump() issues what the ring's free stages allow, and the
  // issuer calls it each time it would wait for a full barrier.
  const bool issuer = threadIdx.x == 0;
  int issued = 0;       // live tiles whose K and V are both issued
  bool k_sent = false;  // K of tile `issued` is issued, its V is not
  auto pump = [&]() {
    while (issued < n_live) {
      const int st = issued & 1;
      const uint32_t free_parity = ((issued >> 1) & 1) ^ 1;
      const int k0 = (int)(list[issued] & ~FULL_TILE) * BK;
      if (!k_sent) {
        if (!mbar_try_wait(&bar->k_empty[st], free_parity)) return;
        __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::OFF_K + st * Lay::KV_TILE);
        mbar_arrive_expect_tx(&bar->k_full[st], Lay::KV_TILE + (BIAS ? Lay::BIAS_TILE : 0u));
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh)
          tma_load_4d(k_s + hh * BK * HALF, &tm_k, &bar->k_full[st], hh * HALF, kvh, k0, b);
        if constexpr (BIAS) {
          __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::OFF_BIAS + st * Lay::BIAS_TILE);
          tma_load_3d(b_s, &tm_bias, &bar->k_full[st], k0, q0, h);
          tma_load_3d(b_s + BQ * HALF, &tm_bias, &bar->k_full[st], k0 + HALF, q0, h);
        }
        k_sent = true;
      }
      if (!mbar_try_wait(&bar->v_empty[st], free_parity)) return;
      __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::OFF_V + st * Lay::KV_TILE);
      mbar_arrive_expect_tx(&bar->v_full[st], Lay::KV_TILE);
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh)
        tma_load_4d(v_s + hh * BK * HALF, &tm_v, &bar->v_full[st], hh * HALF, kvh, k0, b);
      k_sent = false;
      ++issued;
    }
  };
  // Waits for a full barrier (the issuer pumps meanwhile), then reconverges
  // the warp for the warpgroup-wide wgmma.
  auto wait_full = [&](uint64_t* full, uint32_t parity) {
    if (issuer) {
      pump();
      const long long start = clock64();
      while (!mbar_try_wait(full, parity)) {
        pump();
        if (clock64() - start > (1ll << 35)) __trap();  // a broken ring: fail, do not hang
      }
    } else {
      mbar_wait(full, parity);
    }
    __syncwarp();
  };
  if (issuer) {
    mbar_arrive_expect_tx(&bar->q_full, Lay::Q_TILE);
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) tma_load_4d(q_s + hh * BQ * HALF, &tm_q, &bar->q_full, hh * HALF, h, q0, b);
  }

  {
    // ---- WG warpgroups of 64 query rows each ----
    const int cw = warp / 4;  // this thread's warpgroup
    const int ct = threadIdx.x - 128 * cw;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = q0 + 64 * cw;          // this warpgroup's first row
    const int row_a = r0 + 16 * (warp % 4) + g;
    const int row_b = row_a + 8;
    const bool wg_live = r0 < S;
    // this thread's row a within a bias tile (row b is 8 rows on); its
    // 16-byte chunk j of a 64-key half sits at chunk j ^ g (row % 8 == g)
    const uint32_t bias_row = (uint32_t)(64 * cw + 16 * (warp % 4) + g) * 128;

    wait_full(&bar->q_full, 0);
    if (a.q_scale != 1.0f) {
      // q * bf16(scale) rounded, once, on this warpgroup's rows of every half
      for (int idx = ct; idx < HALVES * (int)(WG_ROWS_BYTES / 16); idx += 128) {
        const int half = idx / (WG_ROWS_BYTES / 16);
        const int c = idx % (WG_ROWS_BYTES / 16);
        uint4* p = reinterpret_cast<uint4*>(smem + Lay::OFF_Q + half * Lay::Q_HALF + cw * WG_ROWS_BYTES) + c;
        uint4 val = *p;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * a.q_scale);
        *p = val;
      }
      fence_proxy_async();
      named_barrier(1 + cw, 128);
    }

    float o[OUT];
#pragma unroll
    for (int i = 0; i < OUT; ++i) o[i] = 0.f;
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

    for (int i = 0; i < n_live; ++i) {
      const int st = i & 1;
      const uint32_t parity = (i >> 1) & 1;
      const uint32_t entry = list[i];
      const int kt = (int)(entry & ~FULL_TILE);
      const int k0 = kt * BK;
      const unsigned char* k_s = smem + Lay::OFF_K + st * Lay::KV_TILE;
      const unsigned char* v_s = smem + Lay::OFF_V + st * Lay::KV_TILE;
      const unsigned char* b_s = smem + Lay::OFF_BIAS + st * Lay::BIAS_TILE;

      // S = Q K^T: 64 rows x 128 keys, fp32
      float s[64];
      wait_full(&bar->k_full[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // 16 columns, in the 128-byte row of half kk / 4
        const uint64_t da = wgmma_desc(smem + Lay::OFF_Q + (kk / 4) * Lay::Q_HALF + col + cw * WG_ROWS_BYTES, 16, 1024);
        const uint64_t db = wgmma_desc(k_s + (kk / 4) * HALF_BYTES + col, 16, 1024);
        wgmma_m64n128k16_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operand(s);
      if constexpr (!BIAS) mbar_arrive(&bar->k_empty[st]);

      // scale, bias and masks (masks only where a tile straddles a frontier
      // or holds a masked key), then this tile's row maxima
      if constexpr (BIAS) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t off = (j / 8) * Lay::BIAS_HALF + (uint32_t)(((j % 8) ^ g) * 16 + t * 4);
          const uint32_t pa = *reinterpret_cast<const uint32_t*>(b_s + bias_row + off);
          const uint32_t pb = *reinterpret_cast<const uint32_t*>(b_s + bias_row + 8 * 128 + off);
          s[4 * j] = s[4 * j] * a.s_scale + bf16_lo(pa);
          s[4 * j + 1] = s[4 * j + 1] * a.s_scale + bf16_hi(pa);
          s[4 * j + 2] = s[4 * j + 2] * a.s_scale + bf16_lo(pb);
          s[4 * j + 3] = s[4 * j + 3] * a.s_scale + bf16_hi(pb);
        }
        mbar_arrive(&bar->k_empty[st]);
      } else {
#pragma unroll
        for (int j = 0; j < 64; ++j) s[j] *= a.s_scale;
      }
      const bool need_mask = !(entry & FULL_TILE) || (a.causal && k0 + BK - 1 > r0 + a.q_offset);
      float mx_a = NEG, mx_b = NEG;
      if (need_mask) {
        const uint32_t wb[4] = {bits[4 * kt], bits[4 * kt + 1], bits[4 * kt + 2], bits[4 * kt + 3]};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + t * 2 + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            const bool keep = (wb[j / 4] >> (col & 31)) & 1u;
            const bool masked = !keep || (a.causal && k0 + col > row + a.q_offset);
            const float x = masked ? NEG : s[4 * j + e];
            s[4 * j + e] = x;
            if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
      const float alpha_a = m_a == NEG ? 0.f : hopper_exp<D>(m_a - ref_a);
      const float alpha_b = m_b == NEG ? 0.f : hopper_exp<D>(m_b - ref_b);
      float sum_a = 0.f, sum_b = 0.f;
      uint32_t pa[32];  // bf16(p) pairs: the A fragments of the 8 PV steps
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score is exactly NEG; an unmasked one never is
          const float x = s[4 * j + e];
          p[e] = x == NEG ? 0.f : hopper_exp<D>(x - (e < 2 ? ref_a : ref_b));
        }
        sum_a += p[0] + p[1];
        sum_b += p[2] + p[3];
        pa[2 * j] = pack_bf16(p[0], p[1]);
        pa[2 * j + 1] = pack_bf16(p[2], p[3]);
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
      for (int j = 0; j < OUT / 4; ++j) {
        o[4 * j] *= alpha_a;
        o[4 * j + 1] *= alpha_a;
        o[4 * j + 2] *= alpha_b;
        o[4 * j + 3] *= alpha_b;
      }

      // O += bf16(p) V: step kk takes keys 16 kk.. (score tiles 2 kk, 2 kk + 1)
      wait_full(&bar->v_full[st], parity);
      wgmma_pin<OUT>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = wgmma_desc(v_s + kk * 16 * HALF * 2, HALF_BYTES, 1024);
        wgmma_rs_tb<D>(o, pa + 4 * kk, dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin<OUT>(o);
      mbar_arrive(&bar->v_empty[st]);
    }

    if (wg_live) {
      const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
      const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
      for (int j = 0; j < OUT / 4; ++j) {
        const int col = j * 8 + t * 2;
        if (row_a < S)
          *reinterpret_cast<__nv_bfloat162*>(a.out + (((size_t)b * S + row_a) * H + h) * D + col) =
              __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        if (row_b < S)
          *reinterpret_cast<__nv_bfloat162*>(a.out + (((size_t)b * S + row_b) * H + h) * D + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
      }
    }
  }
}

// A (keys, rows, heads) map of the bf16 bias in 128-byte-swizzled (64 x
// box_rows x 1) boxes: 64 keys of box_rows query rows of one head. Keys past
// L and rows past S read as zeros.
bool make_bias_map(CUtensorMap* map, EncodeTiled fn, const Args& a, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)a.L, (cuuint64_t)a.S, (cuuint64_t)a.H};
  const cuuint64_t strides[2] = {(cuuint64_t)a.b_rs * 2, (cuuint64_t)a.b_hs * 2};
  const cuuint32_t box[3] = {HALF, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(a.bias), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The rule of the Hopper body (also ops/flash_attention.py:k5_body): D = 128
// with no bias, or D = 64 with no bias or a bf16 bias of contiguous keys
// whose rows and heads start on 16-byte boundaries; every operand's rows and
// batches do not overlap; its shared memory fits at L.
bool takes(const Args& a) {
  const bool bias = a.bias != nullptr;
  const bool bias_ok = !bias || (a.D == 64 && a.bias_bf16 && a.b_ks == 1 && a.b_rs % 8 == 0 &&
                                 a.b_hs % 8 == 0 && reinterpret_cast<uintptr_t>(a.bias) % 16 == 0);
  return (a.D == 64 || a.D == 128) && bias_ok && a.q_rs >= (long long)a.H * a.D &&
         a.k_rs >= (long long)a.KVH * a.D && a.v_rs >= (long long)a.KVH * a.D &&
         (a.B == 1 || (a.q_bs >= a.S * a.q_rs && a.k_bs >= a.L * a.k_rs && a.v_bs >= a.L * a.v_rs)) &&
         smem_bytes(a.D, bias, a.L, a.D == 128 ? 2 : 1) <= SMEM_LIMIT;
}

template <int D, bool BIAS, int WG>
int launch_d(const Args& a, cudaStream_t stream) {
  using Lay = Layout<D, BIAS, WG>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_bias;
  if (!make_head_map(&tm_q, fn, a.q, D, a.H, a.S, a.B, a.q_rs, a.q_bs, Lay::BQ) ||
      !make_head_map(&tm_k, fn, a.k, D, a.KVH, a.L, a.B, a.k_rs, a.k_bs, BK) ||
      !make_head_map(&tm_v, fn, a.v, D, a.KVH, a.L, a.B, a.v_rs, a.v_bs, BK))
    return (int)cudaErrorInvalidValue;
  if constexpr (BIAS) {
    if (!make_bias_map(&tm_bias, fn, a, Lay::BQ)) return (int)cudaErrorInvalidValue;
  } else {
    tm_bias = tm_q;  // not read
  }
  const size_t smem = smem_bytes(D, BIAS, a.L, WG);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_sm90_kernel<D, BIAS, WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((a.S + Lay::BQ - 1) / Lay::BQ) * a.H * a.B;
  flash_attention_sm90_kernel<D, BIAS, WG><<<(unsigned)blocks, Lay::THREADS, smem, stream>>>(tm_q, tm_k, tm_v,
                                                                                          tm_bias, a);
  return (int)cudaGetLastError();
}

// Head dim 128: two warpgroups (128 queries) a block; head dim 64: one (64
// queries), so two or three blocks share an SM.
int launch(const Args& a, cudaStream_t stream) {
  if (a.D == 128) return launch_d<128, false, 2>(a, stream);
  return a.bias != nullptr ? launch_d<64, true, 1>(a, stream) : launch_d<64, false, 1>(a, stream);
}

}  // namespace hopper

// Which body takes a call: 2 the decode body, 1 the Hopper body, 0 the
// mma.sync body (ops/flash_attention.py:k5_body states the same rule).
int choose_body(const Args& a) {
  if (decode::takes(a)) return 2;
  if (hopper::takes(a)) return 1;
  return 0;
}

}  // namespace

// q: (B, S, H, D), k/v: (B, L, KVH, D) bf16, each with packed (heads, D) rows
// and the given batch/row strides in elements (multiples of 8; 16-byte
// aligned bases); mask: (B, L) integers of m_bytes (1, 4 or 8) with batch
// stride m_bs and contiguous keys, or NULL; bias: (H, S, L) bf16 (bias_bf16)
// or fp32 with head, row and key strides b_hs, b_rs, b_ks, or NULL; out: (B,
// S, H, D) bf16, contiguous. Requires D % 8 == 0, D <= 128 and H % KVH == 0.
// q_scale is bf16(scale) for a q-side scale (else 1); s_scale the fp32
// score-side scale (else 1). Launches the body choose_body picks and sets
// *body to say which (0 mma.sync, 1 Hopper, 2 decode). Returns the launch's
// cudaError_t (0 on success); launches on `stream`, no synchronise.
extern "C" int eilev_flash_attention_bf16(const void* q, const void* k, const void* v, const void* mask,
                                          long long m_bs, int m_bytes, const void* bias, long long b_hs,
                                          long long b_rs, long long b_ks, int bias_bf16, void* out, int B,
                                          int S, int L, int H, int KVH, int D, long long q_bs,
                                          long long q_rs, long long k_bs, long long k_rs,
                                          long long v_bs, long long v_rs, float q_scale,
                                          float s_scale, int causal, int q_offset, void* stream,
                                          int* body) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *body = 0;
  if (B <= 0 || S <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0 || D % 8 != 0 || D > 128 ||
      q_offset < 0 || (mask != nullptr && m_bytes != 1 && m_bytes != 4 && m_bytes != 8))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.mask = mask;
  a.bias = bias;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.S = S, a.L = L, a.H = H, a.KVH = KVH, a.D = D;
  a.q_bs = q_bs, a.q_rs = q_rs, a.k_bs = k_bs, a.k_rs = k_rs, a.v_bs = v_bs, a.v_rs = v_rs;
  a.m_bs = m_bs, a.m_bytes = m_bytes;
  a.b_hs = b_hs, a.b_rs = b_rs, a.b_ks = b_ks, a.bias_bf16 = bias_bf16;
  a.q_scale = q_scale, a.s_scale = s_scale, a.causal = causal, a.q_offset = q_offset;
  const int which = choose_body(a);
  *body = which;
  if (which == 2) return decode::launch(a, st);
  if (which == 1) return hopper::launch(a, st);
  const int dp = (D + 15) / 16 * 16;
#define EILEV_FLASH_CASE(DP) \
  case DP:                   \
    return launch<DP>(a, st);
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
