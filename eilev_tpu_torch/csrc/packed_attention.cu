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
// What bounds them on the H100: bytes. At the ViT shape (136 frames, S = 257,
// 16 heads x 88) K1 must move 394 MB (0.118 ms at 3.35 TB/s) for 58 GFLOP
// (0.059 ms at the bf16 peak); K2 at the OPT prefill (4 x 766, 32 x 80,
// causal) 63 MB (0.019 ms) for 12 GFLOP. So each (query, key) pair's product
// is computed once, K and V are read once per block, and scores and
// probabilities never reach device memory.
//
// The reference rounds the NORMALISED probabilities to bf16 before PV, which
// an online rescale of the output cannot reproduce: every row needs its exact
// max and sum before its first probability. Both kernels therefore keep a
// query row's rounded scores on chip until the row's statistics are known.
// A rounded score is an exact bf16, so it is kept as a bf16 pair, half the
// room of fp32.
//
// K1, whole rows (S <= K1_MAX_S = 384): one block of 6 warps per (96-query
// chunk, head, frame). K of the head and the block's Q rows are copied in
// with cp.async (Q parked in V's buffer); each warp takes its 16 Q rows into
// registers, then V is copied over the parked Q while the scores are formed.
// Each warp computes its rows' scores against every key with mma.sync
// m16n8k16 into registers, rounds them as the reference does and keeps them
// as bf16 pairs (16 x 272 at S = 257: 68 registers a lane). The exact row
// max and sum come from quad shuffles; p = exp(s - max) / sum is rounded to
// bf16 in place, and that register layout is the A operand of the PV mma.
// One QK^T per pair, K and V read once per block. K and V of a head, padded
// to 272 keys x 104 (D = 88), take 113,152 B, so two blocks share an SM; at
// S = 384, D = 128 they take 208,896 B of the 232,448 a block may use, and
// the scores 96 registers a lane. Past K1_MAX_S, up to K2_MAX_S, K1 runs
// K2's body (below) with no causal frontier and no mask: its rounded scores
// wait in shared memory, not registers, and it applies both scales (q_scale
// 1, s_scale the score-side scale), so the rounding points are K1's.
//
// K2, causal (S <= K2_MAX_S = 2048): one block per (head, batch row, query
// tile), the latest query tiles of every head launched first (they have
// the most keys, so the card's tail is short). The tile is the widest of
// 128, 64 or 32 queries whose scores fit: 128 at the OPT prefill (S = 766,
// D = 80: 198,656 B of scores and 33,792 B of rings, the 232,448 B a block
// may use; one block an SM). The block has two groups of 16-row warps over
// the same queries: group 0 takes key tiles 0, 2, 4, ..., group 1 tiles 1,
// 3, 5, ..., each streaming its 32-key K tiles, then its V tiles, through
// its own three-slot cp.async ring under its own barrier, so the groups run
// apart and twice as many warps hide each other's latency. Pass 1: QK^T
// once per tile; the rounded, masked bf16 scores go to shared memory (each
// lane reads back only what it wrote, so no barrier guards them) and the
// row's running max and sum stay in fp32. The groups' statistics meet in the
// score rows' spare bytes. Pass 2: p = exp(s - max) / sum from the stored
// scores, rounded to bf16, times the V tile, accumulated in fp32; group 1's
// partial output is added to group 0's through shared memory. The Q rows
// wait in the score buffer until the warps take them, so the rings start on
// the first K tiles at once; the key-padding mask becomes one bit per key
// in registers (a coalesced load and a ballot per 32 keys).
//
// Past K2_MAX_S (K2, and K1 with no causal frontier): the two-pass body. A
// query tile's scores no longer fit shared memory, so none is kept: pass 1
// streams the K tiles for each row's max and sum, pass 2 recomputes the same
// rounded scores and accumulates PV. It computes QK^T twice and is written to
// be right first (see two_pass_attention_kernel); no config reaches it today.
//
// Shared by all:
//   * Rounding points follow the JAX reference exactly: the query is scaled
//     and rounded to bf16 (q_scale, 1 for K1); QK^T is rounded to bf16, then
//     scaled and rounded again (s_scale, 1 for K2); masked scores are
//     finfo(float32).min cast to bf16, which is -inf, so a fully masked row
//     is NaN as in the reference. Multiplying a bf16 value by 1 and rounding
//     is exact, so both kernels apply both scales.
//   * D % 8 == 0 (16-byte rows), zero-padded to DP, a multiple of 16, in
//     shared memory; ragged sequence edges are zero-filled and masked;
//     padded rows are 16 bytes longer so ldmatrix rows fall in distinct banks.
//   * Work that cannot change the result is skipped: 16-key fragments past S
//     or above the causal diagonal of all of a warp's rows (their
//     probabilities are exactly 0 in the reference too), and warps past the
//     last query.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr int SM_SMEM = 233472;   // an SM's, 1 KB of it reserved per block
constexpr int K1_MAX_S = 384;
constexpr int K2_MAX_S = 2048;

// Starts the copies of rows [row0, row0 + rows) of one head's slice (column
// offset col) of the packed tensor into a (rows, DP) tile of row stride LD,
// by THREADS threads of which this one is tid; rows >= S and columns >= D
// are zero.
template <int DP, int LD, int THREADS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* qkv_b,
                                                int row0, int rows, int S, int D, int row_stride,
                                                int col, int tid) {
  constexpr int CHUNKS = DP / 8;
  for (int idx = tid; idx < rows * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx - r * CHUNKS;
    const int row = row0 + r;
    const bool valid = row < S && c * 8 < D;
    cp_async16(dst + r * LD + c * 8, valid ? qkv_b + (size_t)row * row_stride + col + c * 8 : qkv_b,
               valid);
  }
}

// A warp's 16 query rows from a (rows, DP) shared tile into mma A fragments,
// each element scaled and rounded to bf16 when q_scale != 1.
template <int DP, int LD>
__device__ __forceinline__ void load_q(uint32_t (&qf)[DP / 16][4], const __nv_bfloat16* tile,
                                       int warp, int lane, float q_scale) {
  const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ldmatrix_x4(qf[kk], tile + (warp * 16 + lr + (lm & 1) * 8) * LD + kk * 16 + (lm >> 1) * 8);
    if (q_scale != 1.0f) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qf[kk][r] = pack_bf16(bf16_lo(qf[kk][r]) * q_scale, bf16_hi(qf[kk][r]) * q_scale);
    }
  }
}

// Two neighbouring scores (fp32 mma accumulators) as the reference rounds
// them - bf16(QK^T), times s_scale, bf16 - as one bf16 pair: one paired
// conversion per rounding (conversions issue at a quarter of the fp32 rate).
__device__ __forceinline__ uint32_t score_pair(float lo, float hi, float s_scale) {
  const uint32_t p = pack_bf16(lo, hi);
  return s_scale == 1.0f ? p : pack_bf16(bf16_lo(p) * s_scale, bf16_hi(p) * s_scale);
}

// The pair with its low and high score set to bf16 -inf where not kept.
__device__ __forceinline__ uint32_t mask_pair(uint32_t p, bool keep_lo, bool keep_hi) {
  return (keep_lo ? p & 0xffffu : 0xff80u) | (keep_hi ? p & 0xffff0000u : 0xff800000u);
}

// exp(s - m) for a row max m (s - m of two bf16 values is exact in fp32).
__device__ __forceinline__ float exp_shifted(float s, float m) { return exp2f((s - m) * LOG2E); }

// This lane's two output rows (g and g + 8 of the warp's 16) of an fp32
// accumulator of DP / 8 column tiles, rounded to bf16; rows >= S and
// columns >= D are not written.
template <int DT>
__device__ __forceinline__ void store_out(const float (&o)[DT][4], __nv_bfloat16* out, int b,
                                          int row_a, int S, int HD, int h, int D, int t) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * t;
    if (col >= D) continue;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * S + row_a) * HD + h * D + col) =
          pack_bf16(o[j][0], o[j][1]);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * S + row_b) * HD + h * D + col) =
          pack_bf16(o[j][2], o[j][3]);
  }
}

// ---------------------------------------------------------------- K1

constexpr int K1_WARPS = 6;
constexpr int K1_THREADS = K1_WARPS * 32;
constexpr int K1_BQ = K1_WARPS * 16;  // queries per block

template <int DP, int NKT>  // NKT: the key capacity, in 16-key fragments
struct K1Shape {
  static constexpr int SP = NKT * 16;
  static constexpr int LD = DP + 8;
  static constexpr int V_ROWS = SP > K1_BQ ? SP : K1_BQ;  // V's buffer parks the Q rows first
  static constexpr int BYTES = 2 * (SP + V_ROWS) * LD;
  // two blocks an SM where their K/V fit and their scores leave room in 168
  // registers (up to 272 keys)
  static constexpr int MIN_BLOCKS = NKT <= 17 && 2 * (BYTES + 1024) <= SM_SMEM ? 2 : 1;
  static_assert(BYTES <= MAX_SMEM, "K and V of a head must fit a block");
};

template <int DP, int NKT>
__global__ void __launch_bounds__(K1_THREADS, K1Shape<DP, NKT>::MIN_BLOCKS)
whole_row_attention_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                           int S, int H, int D, float q_scale, float s_scale) {
  using Shape = K1Shape<DP, NKT>;
  constexpr int LD = Shape::LD;
  constexpr int NT = 2 * NKT;  // 8-key score tiles
  constexpr int DT = DP / 8;   // 8-wide output tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + Shape::SP * LD;

  const int q0 = blockIdx.x * K1_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const int HD = H * D;
  const int row_stride = 3 * HD;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * S * row_stride;

  load_rows_async<DP, LD, K1_THREADS>(Ks, qkv_b, 0, Shape::SP, S, D, row_stride, HD + h * D,
                                      threadIdx.x);
  load_rows_async<DP, LD, K1_THREADS>(Vs, qkv_b, q0, K1_BQ, S, D, row_stride, h * D, threadIdx.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DP / 16][4];
  load_q<DP, LD>(qf, Vs, warp, lane, q_scale);
  __syncthreads();  // every warp holds its Q rows: V's buffer is free
  load_rows_async<DP, LD, K1_THREADS>(Vs, qkv_b, 0, Shape::SP, S, D, row_stride, 2 * HD + h * D,
                                      threadIdx.x);
  cp_async_commit();

  const int qw = q0 + warp * 16;  // the warp's first query row
  const bool live = qw < S;
  // sc[j][0]: keys 8j + 2t, 8j + 2t + 1 of row g, sc[j][1] of row g + 8, as
  // bf16 pairs: first the rounded scores, then the probabilities
  uint32_t sc[NT][2];
  float mx_a = -INFINITY, mx_b = -INFINITY;
  if (live) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      float c[2][4] = {};
      if (j * 8 < S) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          uint32_t bb[4];  // b0, b1 of key tile j, then of key tile j + 1
          ldmatrix_x4(bb, Ks + (j * 8 + (lm >> 1) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
          mma_bf16_16816(c[0], qf[kk], bb);
          mma_bf16_16816(c[1], qf[kk], bb + 2);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int key = (j + u) * 8 + 2 * t;
        uint32_t pa = score_pair(c[u][0], c[u][1], s_scale);
        uint32_t pb = score_pair(c[u][2], c[u][3], s_scale);
        if (key + 1 >= S) {  // keys past S
          pa = mask_pair(pa, key < S, false);
          pb = mask_pair(pb, key < S, false);
        }
        sc[j + u][0] = pa;
        sc[j + u][1] = pb;
        mx_a = fmaxf(mx_a, fmaxf(bf16_lo(pa), bf16_hi(pa)));
        mx_b = fmaxf(mx_b, fmaxf(bf16_lo(pb), bf16_hi(pb)));
      }
    }
  }
  if (live) {
    // the quad 4g .. 4g + 3 holds rows g and g + 8 whole
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    // e = exp(s - max) in fp32, once per score, and the row sums
    float e[NT][4];
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 >= S) continue;
      e[j][0] = exp_shifted(bf16_lo(sc[j][0]), mx_a);
      e[j][1] = exp_shifted(bf16_hi(sc[j][0]), mx_a);
      e[j][2] = exp_shifted(bf16_lo(sc[j][1]), mx_b);
      e[j][3] = exp_shifted(bf16_hi(sc[j][1]), mx_b);
      sum_a += e[j][0] + e[j][1];
      sum_b += e[j][2] + e[j][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    const float inv_a = 1.f / sum_a, inv_b = 1.f / sum_b;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // keys past S: p = 0 (their V rows are zero too)
      sc[j][0] = j * 8 < S ? pack_bf16(e[j][0] * inv_a, e[j][1] * inv_a) : 0u;
      sc[j][1] = j * 8 < S ? pack_bf16(e[j][2] * inv_b, e[j][3] * inv_b) : 0u;
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // V has landed for every thread
  if (!live) return;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk) {
    if (kk * 16 >= S) continue;
    const uint32_t a[4] = {sc[2 * kk][0], sc[2 * kk][1], sc[2 * kk + 1][0], sc[2 * kk + 1][1]};
#pragma unroll
    for (int j = 0; j < DT; j += 2) {
      uint32_t bb[4];  // b0, b1 of output tile j, then of output tile j + 1
      ldmatrix_x4_trans(bb, Vs + (kk * 16 + (lm & 1) * 8 + lr) * LD + j * 8 + (lm >> 1) * 8);
      mma_bf16_16816(o[j], a, bb);
      mma_bf16_16816(o[j + 1], a, bb + 2);
    }
  }
  store_out<DT>(o, out, b, qw + g, S, HD, h, D, t);
}

template <int DP, int NKT>
int launch_k1(const void* qkv, void* out, int B, int S, int H, int D, float q_scale, float s_scale,
              cudaStream_t stream) {
  auto kernel = whole_row_attention_kernel<DP, NKT>;
  const int smem = K1Shape<DP, NKT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + K1_BQ - 1) / K1_BQ, H, B);
  kernel<<<grid, K1_THREADS, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv),
                                             static_cast<__nv_bfloat16*>(out), S, H, D, q_scale,
                                             s_scale);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch_k1(const void* qkv, void* out, int B, int S, int H, int D, float q_scale,
                float s_scale, cudaStream_t st) {
  if (S <= 64) return launch_k1<DP, 4>(qkv, out, B, S, H, D, q_scale, s_scale, st);
  if (S <= 128) return launch_k1<DP, 8>(qkv, out, B, S, H, D, q_scale, s_scale, st);
  if (S <= 272) return launch_k1<DP, 17>(qkv, out, B, S, H, D, q_scale, s_scale, st);
  if (S <= K1_MAX_S) return launch_k1<DP, K1_MAX_S / 16>(qkv, out, B, S, H, D, q_scale, s_scale, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- K2

constexpr int K2_BK = 32;    // keys per streamed tile: one 32-bit word of keep flags
constexpr int K2_SLOTS = 3;  // ring slots of a warp group: two tiles in flight behind the one in use
static_assert(K2_MAX_S <= 64 * 32, "each lane holds two words of keep flags");

// The row stride of K2's score buffer: S rounded up to a tile (at least DP,
// so that the buffer can hold the block's Q rows first), plus 8 so that a
// quad's stores fall in distinct banks.
__host__ __device__ constexpr int k2_score_ld(int S, int DP) {
  return ((S + K2_BK - 1) / K2_BK * K2_BK > DP ? (S + K2_BK - 1) / K2_BK * K2_BK : DP) + 8;
}

// Shared memory of one K2 block: a K/V ring for each of the two warp groups
// and the (BQ, k2_score_ld) bf16 scores.
__host__ __device__ constexpr int k2_bytes(int S, int DP, int BQ) {
  return 2 * 2 * K2_SLOTS * K2_BK * (DP + 8) + 2 * BQ * k2_score_ld(S, DP);
}
static_assert(k2_bytes(K2_MAX_S, 128, 32) <= MAX_SMEM, "K2 must take S = K2_MAX_S at D = 128");

// WARPS warps in each of two groups; warp w of either group holds query rows
// 16w .. 16w + 15 of the tile, and group grp takes key tiles grp, grp + 2, ...
// CAUSAL = false is K1 past K1_MAX_S: every key of the sequence, no causal
// frontier (with no mask, every key below S is kept).
template <int DP, int WARPS, bool CAUSAL>
__global__ void __launch_bounds__(2 * WARPS * 32)
causal_attention_kernel(const __nv_bfloat16* __restrict__ qkv, const int32_t* __restrict__ mask,
                        __nv_bfloat16* __restrict__ out, int S, int H, int D, float q_scale,
                        float s_scale) {
  constexpr int GROUP_THREADS = WARPS * 32;
  constexpr int BQ = WARPS * 16;
  constexpr int LD = DP + 8;
  constexpr int NT = K2_BK / 8;  // 8-key score tiles per key tile
  constexpr int DT = DP / 8;
  constexpr int RING = K2_SLOTS * K2_BK * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int SC = (S + K2_BK - 1) / K2_BK * K2_BK;
  const int SC_LD = k2_score_ld(S, DP);
  __nv_bfloat16* rings = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 x RING
  __nv_bfloat16* Sc = rings + 2 * RING;                           // BQ x SC_LD

  // blocks start in the order of their index, x fastest: the latest query
  // tiles (the most keys) of every head and row first, so the shortest run
  // last and the card's tail is short
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int grp = warp / WARPS;  // the warp group
  const int gw = warp % WARPS;   // the warp's rows within the tile
  const int gtid = threadIdx.x % GROUP_THREADS;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const int HD = H * D;
  const int row_stride = 3 * HD;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * S * row_stride;
  const int32_t* mask_b = mask ? mask + (size_t)b * S : nullptr;
  __nv_bfloat16* ring = rings + grp * RING;

  // key tiles up to the causal diagonal of the block's last query (all of
  // them without CAUSAL); the
  // group's stream index u < n_mine is its K tile grp + 2u, n_mine + u its
  // V tile grp + 2u, in slot u % K2_SLOTS of its ring
  const int n_tiles = ((CAUSAL ? min(q0 + BQ, S) : S) - 1) / K2_BK + 1;
  const int n_mine = (n_tiles - grp + 1) / 2;
  const int n_stream = 2 * n_mine;
  // starts the copy of stream tile u (if there is one) by the group's
  // threads, as one commit group: one group per call keeps
  // cp.async.wait_group's count uniform
  auto issue = [&](int u) {
    if (u < n_stream) {
      const bool is_k = u < n_mine;
      const int tile = grp + 2 * (is_k ? u : u - n_mine);
      load_rows_async<DP, LD, GROUP_THREADS>(ring + (u % K2_SLOTS) * K2_BK * LD, qkv_b,
                                             tile * K2_BK, K2_BK, S, D, row_stride,
                                             (is_k ? HD : 2 * HD) + h * D, gtid);
    }
    cp_async_commit();
  };
  // waits for stream tile u and frees slot (u - 1) % K2_SLOTS, then starts
  // the copy of tile u + K2_SLOTS - 1 into it; the group's own barrier, so
  // the two groups run apart
  auto advance = [&](int u) {
    cp_async_wait<K2_SLOTS - 2>();
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(GROUP_THREADS) : "memory");
    issue(u + K2_SLOTS - 1);
    return ring + (u % K2_SLOTS) * K2_BK * LD;
  };

  // the Q rows go to the score buffer, which is free until pass 1, so the
  // rings take the first K tiles at once
  load_rows_async<DP, LD, 2 * GROUP_THREADS>(Sc, qkv_b, q0, BQ, S, D, row_stride, h * D,
                                             threadIdx.x);
  cp_async_commit();
#pragma unroll
  for (int u = 0; u < K2_SLOTS - 1; ++u) issue(u);
  // keep flags, one bit per key (key < S and not padding): word w (keys
  // 32w .. 32w + 31, one coalesced load and a ballot) is held by lane w % 32
  // of every warp, in keep[0] for w < 32 and keep[1] above; a tile takes its
  // word by shuffle
  uint32_t keep[2] = {0u, 0u};
#pragma unroll 4
  for (int w = 0; w < SC / 32; ++w) {
    const int key = w * 32 + lane;
    const uint32_t bits =
        __ballot_sync(0xffffffffu, key < S && (mask_b == nullptr || mask_b[key] != 0));
    if (lane == w % 32) {
      if (w < 32)
        keep[0] = bits;
      else
        keep[1] = bits;
    }
  }
  cp_async_wait<K2_SLOTS - 1>();  // the Q rows have landed
  __syncthreads();
  uint32_t qf[DP / 16][4];
  load_q<DP, LD>(qf, Sc, gw, lane, q_scale);
  __syncthreads();  // every warp holds its Q rows: the score buffer is free

  const int qw = q0 + gw * 16;
  const int row_a = qw + g, row_b = qw + g + 8;
  const bool live = qw < S;
  const int warp_last = CAUSAL ? min(qw + 15, S - 1) : S - 1;  // no row of the warp sees a later key
  __nv_bfloat16* Sc_a = Sc + (gw * 16 + g) * SC_LD + 2 * t;
  __nv_bfloat16* Sc_b = Sc_a + 8 * SC_LD;
  // fp32 running max and sum over this lane's own scores of rows g and
  // g + 8 in the group's tiles; combined over the quad, then the groups
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  // pass 1: rounded, masked scores to shared memory; running statistics
  for (int u = 0; u < n_mine; ++u) {
    const __nv_bfloat16* tile = advance(u);
    const int i = grp + 2 * u;
    const int k0 = i * K2_BK;
    if (!live || k0 > warp_last) continue;
    const uint32_t kw = __shfl_sync(0xffffffffu, i < 32 ? keep[0] : keep[1], i % 32);
    float c[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (k0 + j * 8 > warp_last) continue;
        uint32_t bb[4];
        ldmatrix_x4(bb, tile + (j * 8 + (lm >> 1) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
        mma_bf16_16816(c[j], qf[kk], bb);
        mma_bf16_16816(c[j + 1], qf[kk], bb + 2);
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (k0 + (j & ~1) * 8 > warp_last) continue;  // a fragment pass 2 skips too
      const int col = j * 8 + 2 * t;
      const int key = k0 + col;
      const bool keep0 = (kw >> col) & 1u, keep1 = (kw >> (col + 1)) & 1u;
      const uint32_t pa = mask_pair(score_pair(c[j][0], c[j][1], s_scale),
                                    keep0 && (!CAUSAL || key <= row_a), keep1 && (!CAUSAL || key < row_a));
      const uint32_t pb = mask_pair(score_pair(c[j][2], c[j][3], s_scale),
                                    keep0 && (!CAUSAL || key <= row_b), keep1 && (!CAUSAL || key < row_b));
      *reinterpret_cast<uint32_t*>(Sc_a + k0 + j * 8) = pa;
      *reinterpret_cast<uint32_t*>(Sc_b + k0 + j * 8) = pb;
      c[j][0] = bf16_lo(pa);
      c[j][1] = bf16_hi(pa);
      c[j][2] = bf16_lo(pb);
      c[j][3] = bf16_hi(pb);
      mx_a = fmaxf(mx_a, fmaxf(c[j][0], c[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(c[j][2], c[j][3]));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a lane with no kept score yet keeps l = 0 (exp(-inf - -inf) is NaN)
    if (mn_a != -INFINITY) {
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (k0 + (j & ~1) * 8 <= warp_last)
          e += exp_shifted(c[j][0], mn_a) + exp_shifted(c[j][1], mn_a);
      l_a = l_a * exp_shifted(m_a, mn_a) + e;
    }
    if (mn_b != -INFINITY) {
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (k0 + (j & ~1) * 8 <= warp_last)
          e += exp_shifted(c[j][2], mn_b) + exp_shifted(c[j][3], mn_b);
      l_b = l_b * exp_shifted(m_b, mn_b) + e;
    }
    m_a = mn_a;
    m_b = mn_b;
  }

  // the rows' statistics: over the quad's four lanes, then over the two
  // groups through the score rows' 16 spare bytes (row r holds max, sum of
  // group 0, then of group 1). A part with no kept score adds nothing; a
  // row with none at all keeps max -inf, and exp(-inf - -inf) makes it NaN
  // in pass 2, as in the reference.
  const auto part_sum = [](float m, float l, float row_m) {
    return m == -INFINITY ? 0.f : l * exp_shifted(m, row_m);
  };
  float row_m_a = m_a, row_m_b = m_b;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    row_m_a = fmaxf(row_m_a, __shfl_xor_sync(0xffffffffu, row_m_a, off));
    row_m_b = fmaxf(row_m_b, __shfl_xor_sync(0xffffffffu, row_m_b, off));
  }
  l_a = part_sum(m_a, l_a, row_m_a);
  l_b = part_sum(m_b, l_b, row_m_b);
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  float* stat_a = reinterpret_cast<float*>(Sc + (gw * 16 + g) * SC_LD + SC);
  float* stat_b = reinterpret_cast<float*>(Sc + (gw * 16 + g + 8) * SC_LD + SC);
  if (t == 0) {
    stat_a[2 * grp] = row_m_a;
    stat_a[2 * grp + 1] = l_a;
    stat_b[2 * grp] = row_m_b;
    stat_b[2 * grp + 1] = l_b;
  }
  __syncthreads();
  m_a = fmaxf(stat_a[0], stat_a[2]);
  m_b = fmaxf(stat_b[0], stat_b[2]);
  const float inv_a = 1.f / (part_sum(stat_a[0], stat_a[1], m_a) + part_sum(stat_a[2], stat_a[3], m_a));
  const float inv_b = 1.f / (part_sum(stat_b[0], stat_b[1], m_b) + part_sum(stat_b[2], stat_b[3], m_b));
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // pass 2: p from the stored scores, times V
  for (int u = n_mine; u < n_stream; ++u) {
    const __nv_bfloat16* tile = advance(u);
    const int k0 = (grp + 2 * (u - n_mine)) * K2_BK;
    if (!live) continue;
#pragma unroll
    for (int kk = 0; kk < K2_BK / 16; ++kk) {
      const int kf = k0 + kk * 16;
      if (kf > warp_last) continue;
      const uint32_t sa0 = *reinterpret_cast<const uint32_t*>(Sc_a + kf);
      const uint32_t sb0 = *reinterpret_cast<const uint32_t*>(Sc_b + kf);
      const uint32_t sa1 = *reinterpret_cast<const uint32_t*>(Sc_a + kf + 8);
      const uint32_t sb1 = *reinterpret_cast<const uint32_t*>(Sc_b + kf + 8);
      const uint32_t a[4] = {
          pack_bf16(exp_shifted(bf16_lo(sa0), m_a) * inv_a, exp_shifted(bf16_hi(sa0), m_a) * inv_a),
          pack_bf16(exp_shifted(bf16_lo(sb0), m_b) * inv_b, exp_shifted(bf16_hi(sb0), m_b) * inv_b),
          pack_bf16(exp_shifted(bf16_lo(sa1), m_a) * inv_a, exp_shifted(bf16_hi(sa1), m_a) * inv_a),
          pack_bf16(exp_shifted(bf16_lo(sb1), m_b) * inv_b, exp_shifted(bf16_hi(sb1), m_b) * inv_b)};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, tile + (kk * 16 + (lm & 1) * 8 + lr) * LD + j * 8 + (lm >> 1) * 8);
        mma_bf16_16816(o[j], a, bb);
        mma_bf16_16816(o[j + 1], a, bb + 2);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; none outlives the block

  // the two groups' partial outputs summed: group 1 leaves its own at the
  // start of shared memory (WARPS * DP * 64 bytes, which every tile the
  // dispatch picks has), lane-minor so the stores fall in distinct banks
  __syncthreads();  // every warp is done with its ring and the scores
  float* part = reinterpret_cast<float*>(smem) + gw * DT * 4 * 32 + lane;
  if (grp == 1 && live) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[(j * 4 + e) * 32] = o[j][e];
  }
  __syncthreads();
  if (grp == 0 && live) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] += part[(j * 4 + e) * 32];
    store_out<DT>(o, out, b, row_a, S, HD, h, D, t);
  }
}

template <int DP, int WARPS, bool CAUSAL>
int launch_k2(const void* qkv, const void* mask, void* out, int B, int S, int H, int D,
              float q_scale, float s_scale, cudaStream_t stream) {
  auto kernel = causal_attention_kernel<DP, WARPS, CAUSAL>;
  const int smem = k2_bytes(S, DP, WARPS * 16);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (S + WARPS * 16 - 1) / (WARPS * 16));
  kernel<<<grid, 2 * WARPS * 32, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv),
                                                 static_cast<const int32_t*>(mask),
                                                 static_cast<__nv_bfloat16*>(out), S, H, D, q_scale,
                                                 s_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- two-pass body

constexpr int TP_WARPS = 4;
constexpr int TP_THREADS = TP_WARPS * 32;
constexpr int TP_BQ = TP_WARPS * 16;  // queries per block
constexpr int TP_BK = 32;             // keys per tile: one 32-bit word of keep flags

// Shared memory of one two-pass block: the Q tile, then two ring slots, each
// a K tile and a V tile.
template <int DP>
struct TwoPassShape {
  static constexpr int LD = DP + 8;
  static constexpr int SLOT = 2 * TP_BK * LD;  // K tile, then V tile
  static constexpr int BYTES = 2 * (TP_BQ * LD + 2 * SLOT);
};

// bf16 K2 (CAUSAL) and K1 (no causal frontier, no mask) past K2_MAX_S, where
// a query tile's scores no longer fit shared memory: no score is kept at
// all. One block of 4 warps per (head, batch row, 64-query tile), the latest
// query tiles launched first. Pass 1 streams the K tiles (a two-slot cp.async
// ring), forms each warp's rounded, masked scores exactly as K2's body does
// and keeps each row's running fp32 max and sum of exp; the quad's and the
// row's statistics are combined as in K2's body. Pass 2 streams K and V
// again, recomputes the same rounded scores, forms p = exp(s - max) / sum,
// rounds p to bf16 after normalising it (the reference's rounding point) and
// accumulates PV in fp32. So every QK^T is computed twice, and K is read
// twice a block: the price of no score buffer. The keep flags come from the
// (B, S) mask in device memory, one coalesced load and a ballot per 32-key
// tile and warp. A fully masked row keeps max -inf and is NaN, as in the
// reference.
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(TP_THREADS)
two_pass_attention_kernel(const __nv_bfloat16* __restrict__ qkv, const int32_t* __restrict__ mask,
                          __nv_bfloat16* __restrict__ out, int S, int H, int D, float q_scale,
                          float s_scale) {
  using Shape = TwoPassShape<DP>;
  constexpr int LD = Shape::LD;
  constexpr int NT = TP_BK / 8;  // 8-key score tiles per key tile
  constexpr int DT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = Qs + TP_BQ * LD;  // 2 x SLOT

  const int q0 = (gridDim.z - 1 - blockIdx.z) * TP_BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const int HD = H * D;
  const int row_stride = 3 * HD;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * S * row_stride;
  const int32_t* mask_b = mask ? mask + (size_t)b * S : nullptr;

  const int n_tiles = ((CAUSAL ? min(q0 + TP_BQ, S) : S) - 1) / TP_BK + 1;
  const int qw = q0 + warp * 16;
  const int row_a = qw + g, row_b = qw + g + 8;
  const bool live = qw < S;
  const int warp_last = CAUSAL ? min(qw + 15, S - 1) : S - 1;

  // starts the copy of key tile u (K only in pass 1, K and V in pass 2) into
  // slot u % 2, as one commit group (an empty one past the last tile, so
  // cp.async.wait_group's count stays uniform)
  auto issue = [&](int u, bool with_v) {
    if (u < n_tiles) {
      __nv_bfloat16* slot = ring + (u % 2) * Shape::SLOT;
      load_rows_async<DP, LD, TP_THREADS>(slot, qkv_b, u * TP_BK, TP_BK, S, D, row_stride,
                                          HD + h * D, threadIdx.x);
      if (with_v)
        load_rows_async<DP, LD, TP_THREADS>(slot + TP_BK * LD, qkv_b, u * TP_BK, TP_BK, S, D,
                                            row_stride, 2 * HD + h * D, threadIdx.x);
    }
    cp_async_commit();
  };
  // this warp's rounded, masked scores of key tile u against its 16 rows:
  // c[j] holds keys 8j + 2t, 8j + 2t + 1 of rows g (c[j][0..1]) and g + 8
  // (c[j][2..3]) as exact bf16 values in fp32; fragments past warp_last are
  // left at -inf (both passes skip them)
  uint32_t qf[DP / 16][4];
  auto scores = [&](float (&c)[NT][4], const __nv_bfloat16* ktile, int k0) {
    const uint32_t kw =
        __ballot_sync(0xffffffffu, k0 + lane < S && (mask_b == nullptr || mask_b[k0 + lane] != 0));
#pragma unroll
    for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (k0 + j * 8 > warp_last) continue;
        uint32_t bb[4];
        ldmatrix_x4(bb, ktile + (j * 8 + (lm >> 1) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
        mma_bf16_16816(c[j], qf[kk], bb);
        mma_bf16_16816(c[j + 1], qf[kk], bb + 2);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (k0 + (j & ~1) * 8 > warp_last) {
        c[j][0] = c[j][1] = c[j][2] = c[j][3] = -INFINITY;
        continue;
      }
      const int col = j * 8 + 2 * t;
      const int key = k0 + col;
      const bool keep0 = (kw >> col) & 1u, keep1 = (kw >> (col + 1)) & 1u;
      const uint32_t pa = mask_pair(score_pair(c[j][0], c[j][1], s_scale),
                                    keep0 && (!CAUSAL || key <= row_a), keep1 && (!CAUSAL || key < row_a));
      const uint32_t pb = mask_pair(score_pair(c[j][2], c[j][3], s_scale),
                                    keep0 && (!CAUSAL || key <= row_b), keep1 && (!CAUSAL || key < row_b));
      c[j][0] = bf16_lo(pa);
      c[j][1] = bf16_hi(pa);
      c[j][2] = bf16_lo(pb);
      c[j][3] = bf16_hi(pb);
    }
  };

  load_rows_async<DP, LD, TP_THREADS>(Qs, qkv_b, q0, TP_BQ, S, D, row_stride, h * D, threadIdx.x);
  cp_async_commit();
  issue(0, false);
  cp_async_wait<1>();  // the Q rows have landed
  __syncthreads();
  load_q<DP, LD>(qf, Qs, warp, lane, q_scale);

  // pass 1: each lane's running max and sum of exp over its own scores of
  // rows g and g + 8
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  for (int u = 0; u < n_tiles; ++u) {
    issue(u + 1, false);
    cp_async_wait<1>();
    __syncthreads();  // tile u has landed for every thread
    const int k0 = u * TP_BK;
    if (live && k0 <= warp_last) {
      float c[NT][4];
      scores(c, ring + (u % 2) * Shape::SLOT, k0);
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(c[j][0], c[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(c[j][2], c[j][3]));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // a lane with no kept score yet keeps l = 0 (exp(-inf - -inf) is NaN)
      if (mn_a != -INFINITY) {
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) e += exp_shifted(c[j][0], mn_a) + exp_shifted(c[j][1], mn_a);
        l_a = l_a * exp_shifted(m_a, mn_a) + e;
      }
      if (mn_b != -INFINITY) {
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) e += exp_shifted(c[j][2], mn_b) + exp_shifted(c[j][3], mn_b);
        l_b = l_b * exp_shifted(m_b, mn_b) + e;
      }
      m_a = mn_a;
      m_b = mn_b;
    }
    __syncthreads();  // every warp is done with slot u % 2 before it is refilled
  }

  // the rows' statistics over the quad's four lanes; a lane with no kept
  // score adds nothing, a row with none keeps max -inf and is NaN in pass 2
  const auto part_sum = [](float m, float l, float row_m) {
    return m == -INFINITY ? 0.f : l * exp_shifted(m, row_m);
  };
  float row_m_a = m_a, row_m_b = m_b;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    row_m_a = fmaxf(row_m_a, __shfl_xor_sync(0xffffffffu, row_m_a, off));
    row_m_b = fmaxf(row_m_b, __shfl_xor_sync(0xffffffffu, row_m_b, off));
  }
  l_a = part_sum(m_a, l_a, row_m_a);
  l_b = part_sum(m_b, l_b, row_m_b);
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;

  // pass 2: p from the recomputed scores, rounded after normalising, times V
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  cp_async_wait<0>();  // only the empty group past the last tile is left
  issue(0, true);
  for (int u = 0; u < n_tiles; ++u) {
    issue(u + 1, true);
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = u * TP_BK;
    if (live && k0 <= warp_last) {
      const __nv_bfloat16* slot = ring + (u % 2) * Shape::SLOT;
      float c[NT][4];
      scores(c, slot, k0);
      const __nv_bfloat16* vtile = slot + TP_BK * LD;
#pragma unroll
      for (int kk = 0; kk < TP_BK / 16; ++kk) {
        if (k0 + kk * 16 > warp_last) continue;
        const float* c0 = c[2 * kk];
        const float* c1 = c[2 * kk + 1];
        const uint32_t a[4] = {
            pack_bf16(exp_shifted(c0[0], row_m_a) * inv_a, exp_shifted(c0[1], row_m_a) * inv_a),
            pack_bf16(exp_shifted(c0[2], row_m_b) * inv_b, exp_shifted(c0[3], row_m_b) * inv_b),
            pack_bf16(exp_shifted(c1[0], row_m_a) * inv_a, exp_shifted(c1[1], row_m_a) * inv_a),
            pack_bf16(exp_shifted(c1[2], row_m_b) * inv_b, exp_shifted(c1[3], row_m_b) * inv_b)};
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, vtile + (kk * 16 + (lm & 1) * 8 + lr) * LD + j * 8 + (lm >> 1) * 8);
          mma_bf16_16816(o[j], a, bb);
          mma_bf16_16816(o[j + 1], a, bb + 2);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (live) store_out<DT>(o, out, b, row_a, S, HD, h, D, t);
}

template <int DP, bool CAUSAL>
int launch_two_pass(const void* qkv, const void* mask, void* out, int B, int S, int H, int D,
                    float q_scale, float s_scale, cudaStream_t stream) {
  auto kernel = two_pass_attention_kernel<DP, CAUSAL>;
  constexpr int smem = TwoPassShape<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (S + TP_BQ - 1) / TP_BQ);
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, TP_THREADS, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv),
                                             static_cast<const int32_t*>(mask),
                                             static_cast<__nv_bfloat16*>(out), S, H, D, q_scale,
                                             s_scale);
  return (int)cudaGetLastError();
}

// The widest query tile whose scores fit and that the sequence fills: 128
// rows at the OPT prefill (S = 766, D = 80: 232,448 B, one block of 16 warps
// an SM), down to 32.
template <int DP, bool CAUSAL>
int dispatch_k2(const void* qkv, const void* mask, void* out, int B, int S, int H, int D,
                float q_scale, float s_scale, cudaStream_t st) {
  if (S > K2_MAX_S) return launch_two_pass<DP, CAUSAL>(qkv, mask, out, B, S, H, D, q_scale, s_scale, st);
  if (S > 64 && k2_bytes(S, DP, 128) <= MAX_SMEM)
    return launch_k2<DP, 8, CAUSAL>(qkv, mask, out, B, S, H, D, q_scale, s_scale, st);
  if (S > 32 && k2_bytes(S, DP, 64) <= MAX_SMEM)
    return launch_k2<DP, 4, CAUSAL>(qkv, mask, out, B, S, H, D, q_scale, s_scale, st);
  return launch_k2<DP, 2, CAUSAL>(qkv, mask, out, B, S, H, D, q_scale, s_scale, st);
}

}  // namespace

// qkv: (B, S, 3*H*D) bf16, contiguous, 16-byte aligned; mask: (B, S) int32 or
// NULL; out: (B, S, H*D) bf16. Requires D % 8 == 0, D <= 128, B and H under
// 65,536, and ceil(S / 64) under 65,536. causal = 0 (K1, no mask): the
// whole-row body up to K1_MAX_S, K2's body with no causal frontier up to
// K2_MAX_S, the two-pass body above; causal = 1: K2's body up to K2_MAX_S,
// the two-pass body above.
// Returns the launch's cudaError_t (0 on success); launches on `stream`, no
// synchronise.
extern "C" int eilev_packed_attention_bf16(const void* qkv, const void* mask, void* out, int B,
                                           int S, int H, int D, float q_scale, float s_scale,
                                           int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535 || D % 8 != 0 || D <= 0 || D > 128)
    return (int)cudaErrorInvalidValue;
  const int dp = (D + 15) / 16 * 16;
#define EILEV_PACKED_CASE(DP)                                                        \
  case DP:                                                                           \
    return causal       ? dispatch_k2<DP, true>(qkv, mask, out, B, S, H, D, q_scale, s_scale, st)  \
           : S > K1_MAX_S ? dispatch_k2<DP, false>(qkv, mask, out, B, S, H, D, q_scale, s_scale, st) \
                          : dispatch_k1<DP>(qkv, out, B, S, H, D, q_scale, s_scale, st);
  switch (dp) {
    EILEV_PACKED_CASE(16)
    EILEV_PACKED_CASE(32)
    EILEV_PACKED_CASE(48)
    EILEV_PACKED_CASE(64)
    EILEV_PACKED_CASE(80)
    EILEV_PACKED_CASE(96)
    EILEV_PACKED_CASE(112)
    EILEV_PACKED_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef EILEV_PACKED_CASE
}
