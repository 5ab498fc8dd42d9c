// Flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas kernel eilev_tpu/ops/flash_attention.py:157
// flash_attention (body _flash_kernel :52, call :273): K5. q (B, S, H, D)
// attends over k, v (B, L, KVH, D) with an optional (B, L) keep-mask, an
// optional (H, S, L) fp32 bias, causal masking with a query offset, and a
// q-side or score-side scale. Head h reads kv head h / (H / KVH). Output
// (B, S, H, D).
//
// What bounds it on the H100: operations. At the LLaMA prefill (q 1,984 over
// a 2,048-slot cache, 32 heads x 128, causal) one layer needs ~32 GFLOP of
// tensor-core work and ~33 MB of traffic: 33 us against 10 us at the card's
// peaks. Scores, probabilities and the output accumulator stay in registers.
//
// Two bodies behind one entry point, eilev_flash_attention_bf16, which says
// which one it launched. The rule (hopper::takes; ops/flash_attention.py:
// uses_sm90_body states it for the tests): the Hopper body takes D == 128
// with no bias, where every operand's rows and batches do not overlap (row
// stride >= heads * D, batch stride >= rows * row stride) and its shared
// memory fits; everything else (D != 128, an (H, S, L) bias, other strides)
// takes the mma.sync body.
//
// The Hopper body (hopper::flash_attention_sm90_kernel), for the LLaMA prefill:
//   * What held the mma.sync body back: mma.sync instead of wgmma; 4 warps a
//     block, each re-reading every K/V fragment with ldmatrix; one K and one
//     V buffer, so copies barely overlapped compute; light query tiles
//     first, so the heaviest ran in the last wave; wholly masked key tiles
//     (left padding) still loaded and multiplied.
//   * One block of two warpgroups per (128-query tile, head, batch row),
//     each owning 64 query rows. TMA loads Q once, then K and V tiles of 128
//     keys into a 2-stage ring with a full and an empty mbarrier per stage
//     and operand. Shared memory: Q 32 KB + K 2 x 32 KB + V 2 x 32 KB, one
//     block an SM.
//   * No producer warpgroup: with 12 warps an SM partition holds 3 of them,
//     so ptxas compiles every thread at 168 registers (setmaxnreg did not
//     raise that), spills and serializes the wgmma (C7512). With 8 warps a
//     thread has 255 registers: no spill. Thread 0 issues the TMA loads in
//     order, never blocking on an empty barrier (it issues what the free
//     stages allow each time it would wait for a full one).
//   * Tiles are stored as two 64-column halves in the 128-byte swizzle TMA
//     writes; the wgmma descriptors read that swizzle directly.
//   * S = Q K^T: wgmma m64n128k16, both operands in shared memory (K-major),
//     64 fp32 scores a thread. O += P V: wgmma with P as the register A
//     operand (the score fragment packed to bf16 pairs) and V read through
//     a transposed (MN-major) descriptor.
//   * The tensor maps are built per call by the host launcher with
//     cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so no
//     -lcuda) over (D, heads, rows, batch) with the caller's strides: a layer
//     slice of the stacked cache is read in place, rows past S or L come in
//     as zeros.
//   * Scheduling: a 1-d grid whose first blocks take the last (heaviest
//     causal) query tiles of every head. Before the roles split, the block
//     packs its keep-mask into bits and lists the key tiles it needs: past
//     its causal frontier, or with every keep flag 0, a tile is neither
//     loaded nor multiplied (exact: in the recurrence a wholly masked tile is
//     a no-op, alpha = 1 or the state stays 0). Both warpgroups run every
//     listed tile: where one's rows are all before a tile's causal frontier,
//     its masks make the tile that no-op (skipping it in a branch around the
//     wgmma made ptxas serialize them). Per-score masking runs only on tiles
//     that straddle a causal frontier or hold a masked key.
//
// Numerics, the same in both bodies and in the twin: key tiles of 128 from
// key 0 (the Pallas block); q * bf16(scale) rounded to bf16 (q side, applied
// once in shared memory); fp32 scores times the fp32 scale (score side),
// plus the bias; masked scores finfo(float32).min; the online softmax of the
// Pallas body row by row: m_new = max(m, max s); p = exp(s - m_new) (0 where
// masked); alpha = exp(m - m_new) (0 while m is still the mask value);
// l = alpha * l + sum p; O = alpha * O + bf16(p) V, p rounded un-normalised;
// the output O / l with l = 0 replaced by 1, so a fully masked row is 0.
// Both exps are the accurate expf, as torch.exp in the twin.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"
#include "sm90_wgmma.cuh"

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

// ---- the Hopper body: wgmma + TMA, warp-specialised, D = 128 ----------------

namespace hopper {

constexpr int D = 128;
constexpr int BQ = 128;     // queries per block: two consumer warpgroups of 64 rows
constexpr int HALF = 64;    // bf16 columns of one 128-byte swizzled row
constexpr int THREADS = 256;  // two warpgroups
constexpr uint32_t TILE_BYTES = BK * D * 2;       // one Q, K or V tile: 32 KB
constexpr uint32_t HALF_BYTES = TILE_BYTES / 2;   // one 64-column half: 16 KB
constexpr uint32_t WG_ROWS_BYTES = 64 * HALF * 2; // a consumer's 64 rows of one half
constexpr uint32_t FULL_TILE = 1u << 31;          // list flag: every keep bit of the tile set
// byte offsets in dynamic shared memory (from a 1024-byte aligned base)
constexpr uint32_t OFF_Q = 0;
constexpr uint32_t OFF_K = OFF_Q + TILE_BYTES;        // 2 stages
constexpr uint32_t OFF_V = OFF_K + 2 * TILE_BYTES;    // 2 stages
constexpr uint32_t OFF_BAR = OFF_V + 2 * TILE_BYTES;  // 9 mbarriers + the live-tile count
constexpr uint32_t OFF_BITS = OFF_BAR + 128;          // keep bits: 4 words a key tile

struct Barriers {
  uint64_t q_full, k_full[2], k_empty[2], v_full[2], v_empty[2];
  int n_live;
};

// Bytes of dynamic shared memory at L keys: the fixed part, 4 keep-bit words
// and one list entry per key tile, and 1 KB to align the base.
size_t smem_bytes(int L) {
  const size_t tiles = (size_t)(L + BK - 1) / BK;
  return OFF_BITS + tiles * 4 * sizeof(uint32_t) + tiles * sizeof(uint32_t) + 1024;
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const int32_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                            int B, int S, int L, int H, int KVH, float q_scale, float s_scale,
                            int causal, int q_offset) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + OFF_Q);
  Barriers* bar = reinterpret_cast<Barriers*>(smem + OFF_BAR);
  const int n_kt = (L + BK - 1) / BK;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + OFF_BITS);  // 4 * n_kt words
  uint32_t* list = bits + 4 * n_kt;                               // n_kt entries

  // heaviest first: block i takes query tile n_qt - 1 - i / (H * B)
  const int n_qt = (S + BQ - 1) / BQ;
  const int hb = blockIdx.x % (H * B);
  const int q0 = (n_qt - 1 - (int)blockIdx.x / (H * B)) * BQ;
  const int h = hb % H;
  const int b = hb / H;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // key tiles the block may need: up to its causal frontier
  int n_tiles = n_kt;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, S) - 1 + q_offset) / BK + 1);

  // the keep-mask as bits (0 past L), 32 keys a word
  const int32_t* mb = mask ? mask + (size_t)b * L : nullptr;
  for (int w = warp; w < 4 * n_tiles; w += THREADS / 32) {
    const int key = w * 32 + lane;
    const bool keep = key < L && (mb == nullptr || mb[key] != 0);
    const uint32_t word = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) bits[w] = word;
  }
  if (threadIdx.x == 0) {
    mbar_init(&bar->q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar->k_full[s], 1);
      mbar_init(&bar->v_full[s], 1);
      mbar_init(&bar->k_empty[s], 256);  // every consumer thread releases
      mbar_init(&bar->v_empty[s], 256);
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

  // The TMA issuer, thread 0: Q once, then K and V of the live tiles into
  // the 2-stage ring, in order. It never blocks on an empty barrier: pump()
  // issues what the ring's free stages allow, and the issuer calls it each
  // time it would wait for a full barrier.
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
        __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + OFF_K + st * TILE_BYTES);
        mbar_arrive_expect_tx(&bar->k_full[st], TILE_BYTES);
        tma_load_4d(k_s, &tm_k, &bar->k_full[st], 0, kvh, k0, b);
        tma_load_4d(k_s + BK * HALF, &tm_k, &bar->k_full[st], HALF, kvh, k0, b);
        k_sent = true;
      }
      if (!mbar_try_wait(&bar->v_empty[st], free_parity)) return;
      __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + OFF_V + st * TILE_BYTES);
      mbar_arrive_expect_tx(&bar->v_full[st], TILE_BYTES);
      tma_load_4d(v_s, &tm_v, &bar->v_full[st], 0, kvh, k0, b);
      tma_load_4d(v_s + BK * HALF, &tm_v, &bar->v_full[st], HALF, kvh, k0, b);
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
    mbar_arrive_expect_tx(&bar->q_full, TILE_BYTES);
    tma_load_4d(q_s, &tm_q, &bar->q_full, 0, h, q0, b);
    tma_load_4d(q_s + BQ * HALF, &tm_q, &bar->q_full, HALF, h, q0, b);
  }

  {
    // ---- two warpgroups of 64 query rows each ----
    const int cw = warp / 4;  // 0 or 1
    const int ct = threadIdx.x - 128 * cw;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = q0 + 64 * cw;          // this warpgroup's first row
    const int row_a = r0 + 16 * (warp % 4) + g;
    const int row_b = row_a + 8;
    const bool wg_live = r0 < S;

    wait_full(&bar->q_full, 0);
    if (q_scale != 1.0f) {
      // q * bf16(scale) rounded, once, on this warpgroup's rows of both halves
      for (int idx = ct; idx < 2 * (int)(WG_ROWS_BYTES / 16); idx += 128) {
        const int half = idx / (WG_ROWS_BYTES / 16);
        const int c = idx % (WG_ROWS_BYTES / 16);
        uint4* p = reinterpret_cast<uint4*>(smem + OFF_Q + half * HALF_BYTES + cw * WG_ROWS_BYTES) + c;
        uint4 val = *p;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * q_scale);
        *p = val;
      }
      fence_proxy_async();
      named_barrier(1 + cw, 128);
    }

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

    for (int i = 0; i < n_live; ++i) {
      const int st = i & 1;
      const uint32_t parity = (i >> 1) & 1;
      const uint32_t entry = list[i];
      const int kt = (int)(entry & ~FULL_TILE);
      const int k0 = kt * BK;
      const unsigned char* k_s = smem + OFF_K + st * TILE_BYTES;
      const unsigned char* v_s = smem + OFF_V + st * TILE_BYTES;

      // S = Q K^T: 64 rows x 128 keys, fp32
      float s[64];
      wait_full(&bar->k_full[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
        const uint64_t da = wgmma_desc(smem + OFF_Q + off + cw * WG_ROWS_BYTES, 16, 1024);
        const uint64_t db = wgmma_desc(k_s + off, 16, 1024);
        wgmma_m64n128k16_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operand(s);
      mbar_arrive(&bar->k_empty[st]);

      // scale and masks (only where a tile straddles a frontier or holds a
      // masked key), then this tile's row maxima
      const bool need_mask = !(entry & FULL_TILE) || (causal && k0 + BK - 1 > r0 + q_offset);
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
            const bool masked = !keep || (causal && k0 + col > row + q_offset);
            const float x = masked ? NEG : s[4 * j + e] * s_scale;
            s[4 * j + e] = x;
            if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[4 * j + e] * s_scale;
            s[4 * j + e] = x;
            if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
          }
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
      uint32_t pa[32];  // bf16(p) pairs: the A fragments of the 8 PV steps
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score is exactly NEG; an unmasked one never is
          const float x = s[4 * j + e];
          p[e] = x == NEG ? 0.f : expf(x - (e < 2 ? ref_a : ref_b));
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
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= alpha_a;
        o[4 * j + 1] *= alpha_a;
        o[4 * j + 2] *= alpha_b;
        o[4 * j + 3] *= alpha_b;
      }

      // O += bf16(p) V: step kk takes keys 16 kk.. (score tiles 2 kk, 2 kk + 1)
      wait_full(&bar->v_full[st], parity);
      wgmma_fence_operand(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = wgmma_desc(v_s + kk * 16 * HALF * 2, HALF_BYTES, 1024);
        wgmma_m64n128k16_rs_tb(o, pa + 4 * kk, dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operand(o);
      mbar_arrive(&bar->v_empty[st]);
    }

    if (wg_live) {
      const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
      const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = j * 8 + t * 2;
        if (row_a < S)
          *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * S + row_a) * H + h) * D + col) =
              __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        if (row_b < S)
          *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * S + row_b) * H + h) * D + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime.
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

// A (D, heads, rows, batch) map of 128-byte-swizzled (64 x 1 x 128 x 1)
// boxes: one 64-column half of 128 rows of one head. Out-of-range rows read
// as zeros.
bool make_map(CUtensorMap* map, EncodeTiled fn, const void* base, int heads, int rows, int batch,
              long long rs, long long bs) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)rs * 2,
                                 (cuuint64_t)(batch > 1 ? bs : (long long)rows * rs) * 2};
  const cuuint32_t box[4] = {HALF, 1, BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The rule of the Hopper body (also ops/flash_attention.py:uses_sm90_body):
// D = 128, no bias, every operand's rows and batches do not overlap, and its
// shared memory fits at L.
bool takes(const void* bias, int B, int S, int L, int H, int KVH, int Dv, long long q_bs,
           long long q_rs, long long k_bs, long long k_rs, long long v_bs, long long v_rs) {
  return bias == nullptr && Dv == D && q_rs >= (long long)H * D && k_rs >= (long long)KVH * D &&
         v_rs >= (long long)KVH * D &&
         (B == 1 || (q_bs >= S * q_rs && k_bs >= L * k_rs && v_bs >= L * v_rs)) &&
         smem_bytes(L) <= 232448;
}

int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int S,
           int L, int H, int KVH, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
           long long v_bs, long long v_rs, float q_scale, float s_scale, int causal, int q_offset,
           cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, fn, q, H, S, B, q_rs, q_bs) || !make_map(&tm_k, fn, k, KVH, L, B, k_rs, k_bs) ||
      !make_map(&tm_v, fn, v, KVH, L, B, v_rs, v_bs))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((S + BQ - 1) / BQ) * H * B;
  flash_attention_sm90_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const int32_t*>(mask), static_cast<__nv_bfloat16*>(out), B, S,
      L, H, KVH, q_scale, s_scale, causal, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// q: (B, S, H, D), k/v: (B, L, KVH, D) bf16, each with packed (heads, D) rows
// and the given batch/row strides in elements (multiples of 8; 16-byte
// aligned bases); mask: (B, L) int32 or NULL; bias: (H, S, L) fp32 or NULL;
// out: (B, S, H, D) bf16, contiguous. Requires D % 8 == 0, D <= 128 and
// H % KVH == 0. q_scale is bf16(scale) for a q-side scale (else 1); s_scale
// the fp32 score-side scale (else 1). Launches the Hopper body where its rule
// takes the call, else the mma.sync body, and sets *sm90 to 1 or 0 to say
// which. Returns the launch's cudaError_t (0 on success); launches on
// `stream`, no synchronise.
extern "C" int eilev_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* mask, const void* bias, void* out, int B,
                                          int S, int L, int H, int KVH, int D, long long q_bs,
                                          long long q_rs, long long k_bs, long long k_rs,
                                          long long v_bs, long long v_rs, float q_scale,
                                          float s_scale, int causal, int q_offset, void* stream,
                                          int* sm90) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *sm90 = 0;
  if (B <= 0 || S <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0 || D % 8 != 0 || D > 128 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (hopper::takes(bias, B, S, L, H, KVH, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs)) {
    *sm90 = 1;
    return hopper::launch(q, k, v, mask, out, B, S, L, H, KVH, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                          q_scale, s_scale, causal, q_offset, st);
  }
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
