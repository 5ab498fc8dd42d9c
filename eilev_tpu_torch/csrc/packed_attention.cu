// Packed-QKV attention for Hopper (sm_90a), bf16 in and out: wgmma + TMA.
//
// Replaces the two Pallas kernels of eilev_tpu/ops/fused_attention.py:
//   K1 packed_qkv_attention         (:81, body _packed_kernel)         - the
//      EVA-ViT attention, bidirectional, no mask, score-side scale;
//   K2 packed_qkv_causal_attention  (:187, body _packed_causal_kernel) - the
//      OPT prefill, causal + (B, S) key-padding mask, query-side scale.
// Both read the packed (B, S, 3*H*D) QKV projection output laid out as
// [q heads | k heads | v heads] and write (B, S, H*D).
//
// What bounds them on the H100: bytes, then the dependent chain of a
// warpgroup. At the ViT shape (136 frames, S = 257, 16 heads x 88) K1 must
// move 394 MB (0.118 ms at 3.35 TB/s) for 58 GFLOP (0.059 ms at the bf16
// peak); K2 at the OPT prefill (4 x 766, 32 x 80, causal) 63 MB (0.019 ms)
// for 12 GFLOP. K, V and the Q rows arrive by TMA and every product is a
// wgmma; scores and probabilities never reach device memory. With one block
// an SM (K and V of a head, or the rings, fill its shared memory), what a
// block does between its loads sets the pace: a warpgroup's QK^T, softmax
// and PV run one after another, and only the other warpgroups overlap them.
//
// The reference rounds the NORMALISED probabilities to bf16 before PV, which
// an online rescale of the output cannot reproduce: every row needs its
// exact max and sum before its first probability. The two bodies meet that
// in two ways.
//
// "sm90_rows", K1 up to K1_MAX_S = 384 keys (whole_row_attention_kernel):
// one block a (frame, head) reads that head's K and V once, by TMA (V on a
// barrier of its own, so it lands while the first scores are formed), and
// its warpgroups walk the head's 64-row query tiles, each reloading its own
// Q buffer by TMA as soon as its QK^T is done. Three warpgroups up to 272
// keys: S = 257 is five tiles, two rounds (with two warpgroups, three
// rounds; the fifth tile has one live row, and wgmma has 64). QK^T is one
// wgmma pass over the whole key range (128-key chunks, then a 16-key one:
// 257 keys take 272), issued before one wait; the rounded scores stay in
// registers as bf16 pairs (68 a thread). The exact row max (bf16x2 max,
// then quad shuffles) and sum come once a score; p = exp(s - max) / sum,
// rounded to bf16, is already the register A operand of the PV wgmma, with
// V MN-major in shared memory. At D = 88: K and V take 104,448 B, three Q
// buffers 36,864.
//
// "sm90", K2 at any S and K1 past K1_MAX_S (stream_attention_kernel): two
// passes with recomputed scores. One block a (128-query tile, head, batch
// row), the latest query tiles first (they have the most keys, so the
// card's tail is short): two consumer warpgroups of 64 rows and a producer
// warp, which loads the Q tile once, streams K tiles of 128 keys through a
// 3-stage ring (pass 1's tiles, then pass 2's again) and V tiles through a
// 2-stage one, each stage with a full and an empty mbarrier (the consumers'
// warps release a stage one arrival each). Pass 1: QK^T, rounded, masked
// from the keep bits (a ballot a 32-key word, the mask read while the
// product runs) and the causal frontier, and each row's running max (bf16x2)
// and sum. Pass 2 recomputes the same scores from the same operands in the
// same order (bit for bit pass 1's), forms p = 2^(s log2 e - c) with c =
// max log2 e + log2 sum (the normalised exp in one ex2), rounds it to bf16
// and accumulates PV by wgmma with A from registers. No score is kept, so S
// has no limit; key tiles past a block's causal frontier are never loaded;
// the diagonal tile is masked row by row. Tried and measured slower or no
// faster (PERF.md, section 6): the next tile's QK^T issued before this tile's
// softmax (2x slower), three consumer warpgroups (the
// admission 20% slower), K kept resident for pass 2 and the keep bits kept
// in shared memory (within 2%).
//
// Shared by both:
//   * Rounding points follow the JAX reference exactly: the query is scaled
//     and rounded to bf16 (q_scale, 1 for K1; the Q tile is rewritten once in
//     shared memory); QK^T is rounded to bf16, then scaled and rounded again
//     (s_scale, 1 for K2; bf16x2 mul.rn, the exact product rounded once);
//     masked scores are finfo(float32).min cast to bf16, which is -inf, so
//     a row with no kept key is NaN as in the reference. exp is ex2.approx
//     of s log2 e less the row's constant (relative error ~2^-22).
//   * A head is one or two parts (Parts): 64 columns in 128-byte swizzled
//     rows, then the rest in the narrowest swizzle that holds it: D = 80 is
//     64 + 16 (32-byte rows), D = 88 64 + 32 (64-byte rows, 8 zero
//     columns). So TMA fills no more than 8 zero columns a row, QK^T takes
//     ceil(D / 16) k-steps and PV runs at 80 or 96 columns, not 128. Q, K
//     and V of a part are (D, H, S, B) tensor maps of the packed rows at
//     element offsets 0, H*D and 2*H*D (sm90::make_head_map): columns past
//     D and rows past S arrive as zeros, never the next head's or batch
//     row's.
//   * The output leaves as 16-byte stores: a quad's four lanes trade their
//     bf16 pairs so that each lane holds 8 neighbouring columns of a row.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"
#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr int K1_MAX_S = 384;     // the whole-row body's key capacity
constexpr int BQ = 128;           // queries a streamed block: two warpgroups of 64 rows
constexpr int BK = 128;           // keys a streamed tile
constexpr int K_STAGES = 3;
constexpr int V_STAGES = 2;
constexpr int STREAM_THREADS = 288;  // two consumer warpgroups and the producer warp

struct Args {
  const int32_t* mask;  // (B, S) keep flags, or null
  __nv_bfloat16* out;   // (B, S, H * D)
  int B, S, H, D;
  float q_scale, s_scale;
};

// A head of D columns as one or two parts of W0 and W1 columns (16, 32 or
// 64: rows of 32, 64 or 128 bytes under the swizzle of that width), D16 =
// ceil(D / 16) k-steps of QK^T, STEPS0 of them in part 0. D = 80 is 64 + 16,
// D = 88 64 + 32 (the last 8 columns zeros), D = 48 one part of 64.
template <int D16>
struct Parts {
  static constexpr int W0 = D16 >= 3 ? 64 : 16 * D16;
  static constexpr int W1 = D16 <= 4 ? 0 : D16 == 5 ? 16 : D16 == 6 ? 32 : 64;
  static constexpr int STEPS0 = D16 < 4 ? D16 : 4;
  static constexpr int N = W0 + W1;  // PV's columns
  static constexpr int OUT = N / 2;  // output accumulators a thread
  // room for a rows-tall tile of each part, in whole 1 KB blocks, and the
  // bytes its TMA boxes deliver
  __host__ __device__ static constexpr uint32_t bytes0(int rows) { return (rows * 2 * W0 + 1023) / 1024 * 1024; }
  __host__ __device__ static constexpr uint32_t bytes1(int rows) { return (rows * 2 * W1 + 1023) / 1024 * 1024; }
  __host__ __device__ static constexpr uint32_t tx(int rows) { return rows * 2 * (W0 + W1); }
};

// bf16 pair arithmetic: the product rounded once from the exact one, as
// bf16(float(x) * float(y)) is; the elementwise maximum.
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
__device__ __forceinline__ uint32_t bf16x2_max(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

// Two neighbouring scores (fp32 accumulators) as the reference rounds them -
// bf16(QK^T), times s_scale (a bf16 pair), bf16 - as one bf16 pair.
__device__ __forceinline__ uint32_t score_pair(float lo, float hi, uint32_t s_pair, bool scaled) {
  const uint32_t p = pack_bf16(lo, hi);
  return scaled ? bf16x2_mul(p, s_pair) : p;
}

// The pair with its low and high score set to bf16 -inf where not kept.
__device__ __forceinline__ uint32_t mask_pair(uint32_t p, bool keep_lo, bool keep_hi) {
  return (keep_lo ? p & 0xffffu : 0xff80u) | (keep_hi ? p & 0xffff0000u : 0xff800000u);
}

// exp(s - m) as 2^(s log2 e - ml), ml = m log2 e: one FFMA and one
// ex2.approx (relative error ~2^-22; a result below 2^-126 flushes to 0).
// m = -inf gives NaN for s = -inf, as exp(-inf - -inf) does.
__device__ __forceinline__ float exp_ml(float s, float ml) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaf(s, LOG2E, -ml)));
  return y;
}

// Over the quad 4g .. 4g + 3, which holds rows g and g + 8 whole.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A 4 x 4 transpose over the quad: lane q holds x[k] = M[q][k] and ends with
// x[s] = M[s][q]. Two butterflies (lanes q ^ 2, then q ^ 1), then the kept
// and received words put in order.
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int q) {
  const bool hi = q & 2, odd = q & 1;
  // u0, u1 = M[q][c], M[q][c + 1]; r0, r1 = M[q ^ 2][c], M[q ^ 2][c + 1], c = q & 2
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? x[0] : x[2], 2);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? x[1] : x[3], 2);
  const uint32_t u0 = hi ? x[2] : x[0], u1 = hi ? x[3] : x[1];
  // w[d] = M[q ^ d][q]
  const uint32_t v0 = __shfl_xor_sync(0xffffffffu, odd ? u0 : u1, 1);
  const uint32_t v1 = __shfl_xor_sync(0xffffffffu, odd ? r0 : r1, 1);
  uint32_t w0 = odd ? u1 : u0, w1 = v0, w2 = odd ? r1 : r0, w3 = v1;
  if (odd) {
    const uint32_t t0 = w0, t2 = w2;
    w0 = w1, w1 = t0, w2 = w3, w3 = t2;
  }
  if (hi) {
    const uint32_t t0 = w0, t1 = w1;
    w0 = w2, w1 = w3, w2 = t0, w3 = t1;
  }
  x[0] = w0, x[1] = w1, x[2] = w2, x[3] = w3;
}

// Rows a and b (= a + 8) of a warpgroup's 64 x N fp32 output tile - this
// thread's o[4i], o[4i + 1] (row a) and o[4i + 2], o[4i + 3] (row b) at
// columns 8i + 2q, +1 - rounded to bf16 and written as 16-byte stores: the
// quad trades pairs so that lane q holds columns 8(4c + q) .. + 7. Columns
// past D and rows that are not live are not written. Every lane of the warp
// takes part (the shuffles).
template <int N>
__device__ __forceinline__ void store_rows(const float* o, __nv_bfloat16* out_a, __nv_bfloat16* out_b,
                                           bool live_a, bool live_b, int D, int q) {
#pragma unroll
  for (int c = 0; c < (N + 31) / 32; ++c) {
    uint32_t xa[4], xb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * c + k;
      xa[k] = i < N / 8 ? pack_bf16(o[4 * i], o[4 * i + 1]) : 0u;
      xb[k] = i < N / 8 ? pack_bf16(o[4 * i + 2], o[4 * i + 3]) : 0u;
    }
    quad_transpose(xa, q);
    quad_transpose(xb, q);
    const int col = 8 * (4 * c + q);
    if (col < D) {
      if (live_a) *reinterpret_cast<uint4*>(out_a + col) = make_uint4(xa[0], xa[1], xa[2], xa[3]);
      if (live_b) *reinterpret_cast<uint4*>(out_b + col) = make_uint4(xb[0], xb[1], xb[2], xb[3]);
    }
  }
}

// S (+)= Q K^T for 64 query rows and NKEY (128 or 16) keys: q0/k0 point at
// the rows in part 0, q1/k1 in part 1; D16 k-steps of 16 columns.
template <int D16, int NKEY>
__device__ __forceinline__ void qk_product(float* s, const unsigned char* q0, const unsigned char* q1,
                                           const unsigned char* k0, const unsigned char* k1) {
  using P = Parts<D16>;
#pragma unroll
  for (int kk = 0; kk < D16; ++kk) {
    uint64_t da, db;
    if (kk < P::STEPS0) {
      da = wgmma_desc_w<P::W0>(q0 + kk * 32, 16);
      db = wgmma_desc_w<P::W0>(k0 + kk * 32, 16);
    } else {
      da = wgmma_desc_w<(P::W1 > 0 ? P::W1 : 16)>(q1 + (kk - P::STEPS0) * 32, 16);
      db = wgmma_desc_w<(P::W1 > 0 ? P::W1 : 16)>(k1 + (kk - P::STEPS0) * 32, 16);
    }
    if constexpr (NKEY == 128) wgmma_m64n128k16_ss(s, da, db, kk > 0);
    else wgmma_m64n16k16_ss(s, da, db, kk > 0);
  }
}

// O += P V over NKEY keys (16 a step) for 64 rows: p holds the bf16(p)
// pairs in the A-fragment order, v0/v1 the key rows of each part (MN-major:
// keys are k, columns n); part 1's columns accumulate at o + W0 / 2.
template <int D16, int NKEY>
__device__ __forceinline__ void pv_product(float* o, const uint32_t* p, const unsigned char* v0,
                                           const unsigned char* v1) {
  using P = Parts<D16>;
#pragma unroll
  for (int kk = 0; kk < NKEY / 16; ++kk) {
    wgmma_rs_tb<P::W0>(o, p + 4 * kk, wgmma_desc_w<P::W0>(v0 + kk * 32 * P::W0, 16 * P::W0));
    if constexpr (P::W1 > 0)
      wgmma_rs_tb<P::W1>(o + P::W0 / 2, p + 4 * kk, wgmma_desc_w<P::W1>(v1 + kk * 32 * P::W1, 16 * P::W1));
  }
}

// Q, K and V of every head of the packed rows as (D, H, S, B) maps at
// element offsets 0, H*D and 2*H*D, row stride 3*H*D: tm[3 * part + (q, k,
// v)], each part's boxes as wide as the part.
template <int D16>
bool packed_maps(CUtensorMap (&tm)[6], const void* qkv, const Args& a, int q_box, int kv_box) {
  using P = Parts<D16>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const long long rs = 3ll * a.H * a.D;
  const long long hd = (long long)a.H * a.D;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  for (int part = 0; part < 2; ++part) {
    const int w = part == 0 ? P::W0 : (P::W1 > 0 ? P::W1 : P::W0);  // part 1's maps unused without it
    for (int m = 0; m < 3; ++m)
      if (!make_head_map(&tm[3 * part + m], fn, base + m * hd, a.D, a.H, a.S, a.B, rs, rs * a.S,
                         m == 0 ? q_box : kv_box, w))
        return false;
  }
  return true;
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------- the streamed body

template <int D16>
struct StreamLayout {
  using P = Parts<D16>;
  static constexpr uint32_t Q0 = P::bytes0(BQ), Q1 = P::bytes1(BQ);  // the Q tile's parts
  static constexpr uint32_t T0 = P::bytes0(BK), T1 = P::bytes1(BK);  // a K or V tile's parts
  static constexpr uint32_t Q_TILE = Q0 + Q1;
  static constexpr uint32_t KV_TILE = T0 + T1;
  static constexpr uint32_t OFF_K = Q_TILE;
  static constexpr uint32_t OFF_V = OFF_K + K_STAGES * KV_TILE;
  static constexpr uint32_t OFF_BAR = OFF_V + V_STAGES * KV_TILE;
  static constexpr int BYTES = OFF_BAR + 128 + 1024;  // barriers; 1 KB to align the base
  static_assert(BYTES <= MAX_SMEM, "the streamed body's rings must fit a block");
};

struct StreamBarriers {
  uint64_t q_full, k_full[K_STAGES], k_empty[K_STAGES], v_full[V_STAGES], v_empty[V_STAGES];
};
static_assert(sizeof(StreamBarriers) <= 128, "the barriers' room");

// K2 (CAUSAL) and K1 past K1_MAX_S (no causal frontier, no mask).
template <int D16, bool CAUSAL>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
stream_attention_kernel(const __grid_constant__ CUtensorMap tq0, const __grid_constant__ CUtensorMap tk0,
                        const __grid_constant__ CUtensorMap tv0, const __grid_constant__ CUtensorMap tq1,
                        const __grid_constant__ CUtensorMap tk1, const __grid_constant__ CUtensorMap tv1,
                        const Args a) {
  using P = Parts<D16>;
  using Lay = StreamLayout<D16>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  StreamBarriers* bar = reinterpret_cast<StreamBarriers*>(smem + Lay::OFF_BAR);
  const int S = a.S, H = a.H, B = a.B;

  // heaviest first: block i takes query tile n_qt - 1 - i / (H * B)
  const int n_qt = (S + BQ - 1) / BQ;
  const int hb = blockIdx.x % (H * B);
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / (H * B))) * BQ;
  const int b = hb % B;
  const int h = hb / B;
  // key tiles up to the causal frontier of the block's last query
  const int n_tiles = ((CAUSAL ? min(q0 + BQ, S) : S) - 1) / BK + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&bar->q_full, 1);
    for (int s = 0; s < K_STAGES; ++s) {
      mbar_init(&bar->k_full[s], 1);
      mbar_init(&bar->k_empty[s], 8);  // one arrival a consumer warp
    }
    for (int s = 0; s < V_STAGES; ++s) {
      mbar_init(&bar->v_full[s], 1);
      mbar_init(&bar->v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // The producer: the Q tile, then the K stream (the block's key tiles
    // for pass 1, again for pass 2) and the V stream (once, for pass 2),
    // each in order into its ring: the first V_STAGES V tiles after K item
    // 0, V tile i >= V_STAGES right after K item n_tiles + i.
    if (lane == 0) {
      prefetch_map(&tq0), prefetch_map(&tk0), prefetch_map(&tv0);
      if constexpr (P::W1 > 0) prefetch_map(&tq1), prefetch_map(&tk1), prefetch_map(&tv1);
      mbar_arrive_expect_tx(&bar->q_full, P::tx(BQ));
      tma_load_4d(smem, &tq0, &bar->q_full, 0, h, q0, b);
      if constexpr (P::W1 > 0) tma_load_4d(smem + Lay::Q0, &tq1, &bar->q_full, 64, h, q0, b);
      int v_issued = 0;
      auto issue_v = [&](int upto) {
        for (; v_issued < min(upto, n_tiles); ++v_issued) {
          const int st = v_issued % V_STAGES;
          mbar_wait(&bar->v_empty[st], ((v_issued / V_STAGES) & 1) ^ 1);
          unsigned char* dst = smem + Lay::OFF_V + st * Lay::KV_TILE;
          mbar_arrive_expect_tx(&bar->v_full[st], P::tx(BK));
          tma_load_4d(dst, &tv0, &bar->v_full[st], 0, h, v_issued * BK, b);
          if constexpr (P::W1 > 0) tma_load_4d(dst + Lay::T0, &tv1, &bar->v_full[st], 64, h, v_issued * BK, b);
        }
      };
      for (int j = 0; j < 2 * n_tiles; ++j) {
        const int st = j % K_STAGES;
        mbar_wait(&bar->k_empty[st], ((j / K_STAGES) & 1) ^ 1);
        const int k0 = (j < n_tiles ? j : j - n_tiles) * BK;
        unsigned char* dst = smem + Lay::OFF_K + st * Lay::KV_TILE;
        mbar_arrive_expect_tx(&bar->k_full[st], P::tx(BK));
        tma_load_4d(dst, &tk0, &bar->k_full[st], 0, h, k0, b);
        if constexpr (P::W1 > 0) tma_load_4d(dst + Lay::T0, &tk1, &bar->k_full[st], 64, h, k0, b);
        if (j == 0) issue_v(V_STAGES);
        if (j >= n_tiles) issue_v(j - n_tiles + 1);
      }
    }
    return;
  }

  const int cw = warp / 4;  // this thread's warpgroup: query rows q0 + 64 cw ..
  const int ct = threadIdx.x - 128 * cw;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + 64 * cw;
  const int row_a = r0 + 16 * (warp % 4) + g;
  const int row_b = row_a + 8;
  const bool wg_live = r0 < S;  // a warpgroup past S only keeps the rings turning
  const unsigned char* q_p0 = smem + cw * 64 * 2 * P::W0;
  const unsigned char* q_p1 = smem + Lay::Q0 + cw * 64 * 2 * P::W1;
  const int32_t* mask_b = a.mask ? a.mask + (size_t)b * S : nullptr;
  const uint32_t s_pair = pack_bf16(a.s_scale, a.s_scale);
  const bool scaled = a.s_scale != 1.0f;
  auto release = [&](uint64_t* empty) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  };

  mbar_wait(&bar->q_full, 0);
  if (a.q_scale != 1.0f) {
    // q * bf16(scale) rounded, once, on this warpgroup's rows of each part
    const uint32_t q_pair = pack_bf16(a.q_scale, a.q_scale);
    constexpr int C0 = 64 * 2 * P::W0 / 16, C1 = 64 * 2 * P::W1 / 16;  // 16-byte chunks
    for (int idx = ct; idx < C0 + C1; idx += 128) {
      uint4* p = idx < C0 ? reinterpret_cast<uint4*>(const_cast<unsigned char*>(q_p0)) + idx
                          : reinterpret_cast<uint4*>(const_cast<unsigned char*>(q_p1)) + (idx - C0);
      uint4 val = *p;
      val.x = bf16x2_mul(val.x, q_pair), val.y = bf16x2_mul(val.y, q_pair);
      val.z = bf16x2_mul(val.z, q_pair), val.w = bf16x2_mul(val.w, q_pair);
      *p = val;
    }
    fence_proxy_async();
    named_barrier(1 + cw, 128);
  }
  __syncwarp();

  // The warpgroup's rounded, masked scores of the key tile in stage st
  // (keys k0 ..): s[4j], s[4j + 1] are row a's keys k0 + 8j + 2t, +1 and
  // s[4j + 2], s[4j + 3] row b's, each an exact bf16 in fp32; mx2 gets this
  // lane's maxima of rows a and b as bf16 pairs. Releases the stage. The
  // same operands in the same order give the same bits in both passes.
  auto scores = [&](float (&s)[64], int st, int k0, uint32_t (&mx2)[2]) {
    const unsigned char* k_s = smem + Lay::OFF_K + st * Lay::KV_TILE;
    // keep flags of the tile's keys, 32 a word (key < S and kept), loaded
    // while the product runs
    bool mk[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int key = k0 + 32 * w + lane;
      mk[w] = key < S && (mask_b == nullptr || mask_b[key] != 0);
    }
    wgmma_fence();
    qk_product<D16, 128>(s, q_p0, q_p1, k_s, k_s + Lay::T0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(s);
    release(&bar->k_empty[st]);
    uint32_t wb[4];
    bool full = true;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      wb[w] = __ballot_sync(0xffffffffu, mk[w]);
      full = full && wb[w] == 0xffffffffu;
    }
    const bool need_mask = !full || (CAUSAL && k0 + BK - 1 > r0);
    mx2[0] = mx2[1] = 0xff80ff80u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t pa = score_pair(s[4 * j], s[4 * j + 1], s_pair, scaled);
      uint32_t pb = score_pair(s[4 * j + 2], s[4 * j + 3], s_pair, scaled);
      if (need_mask) {
        const int col = 8 * j + 2 * t;
        const int key = k0 + col;
        const bool keep0 = (wb[j / 4] >> (col & 31)) & 1u;
        const bool keep1 = (wb[j / 4] >> ((col + 1) & 31)) & 1u;
        pa = mask_pair(pa, keep0 && (!CAUSAL || key <= row_a), keep1 && (!CAUSAL || key < row_a));
        pb = mask_pair(pb, keep0 && (!CAUSAL || key <= row_b), keep1 && (!CAUSAL || key < row_b));
      }
      mx2[0] = bf16x2_max(mx2[0], pa);
      mx2[1] = bf16x2_max(mx2[1], pb);
      s[4 * j] = bf16_lo(pa);
      s[4 * j + 1] = bf16_hi(pa);
      s[4 * j + 2] = bf16_lo(pb);
      s[4 * j + 3] = bf16_hi(pb);
    }
  };

  // pass 1: each row's running max (the same in the quad's four lanes) and
  // each lane's share of the row's sum of exp(s - max)
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % K_STAGES;
    mbar_wait(&bar->k_full[st], (i / K_STAGES) & 1);
    __syncwarp();
    if (!wg_live) {
      release(&bar->k_empty[st]);
      continue;
    }
    float s[64];
    uint32_t mx2[2];
    scores(s, st, i * BK, mx2);
    const float mn_a = fmaxf(m_a, quad_max(fmaxf(bf16_lo(mx2[0]), bf16_hi(mx2[0]))));
    const float mn_b = fmaxf(m_b, quad_max(fmaxf(bf16_lo(mx2[1]), bf16_hi(mx2[1]))));
    // no kept score yet: l stays 0 (exp(-inf - -inf) is NaN)
    if (mn_a != -INFINITY) {
      const float ml = mn_a * LOG2E;
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) e += exp_ml(s[4 * j], ml) + exp_ml(s[4 * j + 1], ml);
      l_a = l_a * exp_ml(m_a, ml) + e;
    }
    if (mn_b != -INFINITY) {
      const float ml = mn_b * LOG2E;
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) e += exp_ml(s[4 * j + 2], ml) + exp_ml(s[4 * j + 3], ml);
      l_b = l_b * exp_ml(m_b, ml) + e;
    }
    m_a = mn_a;
    m_b = mn_b;
  }
  // p = exp(s - max) / sum as one exponential, 2^(s log2 e - c) with c =
  // max log2 e + log2 sum. A row with no kept key keeps max -inf, so c =
  // -inf, and exp(-inf - -inf) makes its p, and so its output, NaN in pass
  // 2, as in the reference.
  const float c_a = m_a * LOG2E + log2f(quad_sum(l_a));
  const float c_b = m_b * LOG2E + log2f(quad_sum(l_b));

  // pass 2: the same scores again; p rounded after normalising, times V
  float o[P::OUT];
#pragma unroll
  for (int i = 0; i < P::OUT; ++i) o[i] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = (n_tiles + i) % K_STAGES;
    const int vst = i % V_STAGES;
    mbar_wait(&bar->k_full[st], ((n_tiles + i) / K_STAGES) & 1);
    __syncwarp();
    if (!wg_live) {
      release(&bar->k_empty[st]);
      mbar_wait(&bar->v_full[vst], (i / V_STAGES) & 1);
      release(&bar->v_empty[vst]);
      continue;
    }
    float s[64];
    uint32_t mx2[2];
    scores(s, st, i * BK, mx2);
    uint32_t pa[32];  // bf16(p) pairs: the A fragments of the 8 PV steps
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      pa[2 * j] = pack_bf16(exp_ml(s[4 * j], c_a), exp_ml(s[4 * j + 1], c_a));
      pa[2 * j + 1] = pack_bf16(exp_ml(s[4 * j + 2], c_b), exp_ml(s[4 * j + 3], c_b));
    }
    const unsigned char* v_s = smem + Lay::OFF_V + vst * Lay::KV_TILE;
    mbar_wait(&bar->v_full[vst], (i / V_STAGES) & 1);
    __syncwarp();
    wgmma_pin<P::OUT>(o);
    wgmma_fence();
    pv_product<D16, BK>(o, pa, v_s, v_s + Lay::T0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin<P::OUT>(o);
    release(&bar->v_empty[vst]);
  }

  if (wg_live) {
    const size_t row_elems = (size_t)H * a.D;
    __nv_bfloat16* out_h = a.out + (size_t)b * S * row_elems + (size_t)h * a.D;
    store_rows<P::N>(o, out_h + (size_t)min(row_a, S - 1) * row_elems, out_h + (size_t)min(row_b, S - 1) * row_elems,
                     row_a < S, row_b < S, a.D, t);
  }
}

// ---------------------------------------------------------------- the whole-row body

// K and V of one head at a capacity of NK = 128 NC + 16 NR keys, each part
// NK rows; one Q buffer of 64 rows a consumer warpgroup: three warpgroups
// up to 272 keys (S = 257 takes two rounds of tiles, not three), two at 384
// (where a thread's 384-key row needs more than the 168 registers of a
// 384-thread block).
template <int D16, int NC, int NR>
struct RowsLayout {
  using P = Parts<D16>;
  static constexpr int NK = 128 * NC + 16 * NR;
  static constexpr int KV_BOX = NK <= 256 ? NK : NK / 2;  // TMA box rows: at most 256
  static constexpr uint32_t T0 = P::bytes0(NK), T1 = P::bytes1(NK);
  static constexpr uint32_t KV_TILE = T0 + T1;
  static constexpr uint32_t Q0 = P::bytes0(64), Q1 = P::bytes1(64);
  static constexpr uint32_t Q_TILE = Q0 + Q1;
  static constexpr uint32_t OFF_V = KV_TILE;
  static constexpr uint32_t OFF_Q = 2 * KV_TILE;
  static constexpr int WGS = NC <= 2 ? 3 : 2;
  static constexpr int THREADS = 128 * WGS;
  static constexpr uint32_t OFF_BAR = OFF_Q + WGS * Q_TILE;
  static constexpr int BYTES = OFF_BAR + 64 + 1024;  // barriers; 1 KB to align the base
  static_assert(NK % KV_BOX == 0 && KV_BOX % 8 == 0 && KV_BOX <= 256, "K/V boxes");
  static_assert(BYTES <= MAX_SMEM, "K, V and the Q buffers must fit a block");
};

struct RowsBarriers {
  uint64_t k_full, v_full, q_full[3];
};

// K1 up to K1_MAX_S keys (q_scale 1, no mask): one block a (head, frame).
template <int D16, int NC, int NR>
__global__ void __launch_bounds__(RowsLayout<D16, NC, NR>::THREADS, 1)
whole_row_attention_kernel(const __grid_constant__ CUtensorMap tq0, const __grid_constant__ CUtensorMap tk0,
                           const __grid_constant__ CUtensorMap tv0, const __grid_constant__ CUtensorMap tq1,
                           const __grid_constant__ CUtensorMap tk1, const __grid_constant__ CUtensorMap tv1,
                           const Args a) {
  using P = Parts<D16>;
  using Lay = RowsLayout<D16, NC, NR>;
  constexpr int NK = Lay::NK;
  constexpr int NG = NK / 8;  // 8-key groups
  constexpr int WGS = Lay::WGS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  RowsBarriers* bar = reinterpret_cast<RowsBarriers*>(smem + Lay::OFF_BAR);
  const int S = a.S;
  const int h = blockIdx.x % a.H;
  const int b = blockIdx.x / a.H;
  const int n_qt = (S + 63) / 64;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cw = warp / 4;
  const int ct = threadIdx.x - 128 * cw;
  const int g = lane >> 2;
  const int t = lane & 3;

  if (threadIdx.x == 0) {
    mbar_init(&bar->k_full, 1);
    mbar_init(&bar->v_full, 1);
    for (int w = 0; w < WGS; ++w) mbar_init(&bar->q_full[w], 1);
    mbar_fence_init();
  }
  __syncthreads();

  unsigned char* q_p0 = smem + Lay::OFF_Q + cw * Lay::Q_TILE;
  unsigned char* q_p1 = q_p0 + Lay::Q0;
  // query tile `tile` into this warpgroup's Q buffer, by its first thread
  auto load_q = [&](int tile) {
    mbar_arrive_expect_tx(&bar->q_full[cw], P::tx(64));
    tma_load_4d(q_p0, &tq0, &bar->q_full[cw], 0, h, tile * 64, b);
    if constexpr (P::W1 > 0) tma_load_4d(q_p1, &tq1, &bar->q_full[cw], 64, h, tile * 64, b);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&tq0), prefetch_map(&tk0), prefetch_map(&tv0);
    if constexpr (P::W1 > 0) prefetch_map(&tq1), prefetch_map(&tk1), prefetch_map(&tv1);
  }
  if (ct == 0 && cw < n_qt) load_q(cw);
  if (threadIdx.x == 0) {
    // K, then V on its own barrier: V lands while the first scores are formed
    mbar_arrive_expect_tx(&bar->k_full, P::tx(NK));
#pragma unroll
    for (int i = 0; i < NK / Lay::KV_BOX; ++i) {
      tma_load_4d(smem + i * Lay::KV_BOX * 2 * P::W0, &tk0, &bar->k_full, 0, h, i * Lay::KV_BOX, b);
      if constexpr (P::W1 > 0)
        tma_load_4d(smem + Lay::T0 + i * Lay::KV_BOX * 2 * P::W1, &tk1, &bar->k_full, 64, h, i * Lay::KV_BOX, b);
    }
    mbar_arrive_expect_tx(&bar->v_full, P::tx(NK));
#pragma unroll
    for (int i = 0; i < NK / Lay::KV_BOX; ++i) {
      tma_load_4d(smem + Lay::OFF_V + i * Lay::KV_BOX * 2 * P::W0, &tv0, &bar->v_full, 0, h, i * Lay::KV_BOX, b);
      if constexpr (P::W1 > 0)
        tma_load_4d(smem + Lay::OFF_V + Lay::T0 + i * Lay::KV_BOX * 2 * P::W1, &tv1, &bar->v_full, 64, h,
                    i * Lay::KV_BOX, b);
    }
  }

  const size_t row_elems = (size_t)a.H * a.D;
  __nv_bfloat16* out_h = a.out + (size_t)b * S * row_elems + (size_t)h * a.D;
  const uint32_t s_pair = pack_bf16(a.s_scale, a.s_scale);
  const bool scaled = a.s_scale != 1.0f;
  uint32_t q_parity = 0;
  for (int tile = cw; tile < n_qt; tile += WGS) {
    mbar_wait(&bar->q_full[cw], q_parity);
    q_parity ^= 1;
    mbar_wait(&bar->k_full, 0);
    __syncwarp();

    // sc[2j], sc[2j + 1]: rows a and b at keys 8j + 2t, +1, as bf16 pairs:
    // first the rounded scores, then the probabilities
    uint32_t sc[2 * NG];
    uint32_t mx2_a = 0xff80ff80u, mx2_b = 0xff80ff80u;  // running maxima, as bf16 pairs
    auto keep = [&](int j, float a0, float a1, float b0, float b1) {
      uint32_t pa = score_pair(a0, a1, s_pair, scaled), pb = score_pair(b0, b1, s_pair, scaled);
      if (8 * j + 8 > S) {  // keys past S
        const int key = 8 * j + 2 * t;
        pa = mask_pair(pa, key < S, key + 1 < S);
        pb = mask_pair(pb, key < S, key + 1 < S);
      }
      sc[2 * j] = pa;
      sc[2 * j + 1] = pb;
      mx2_a = bf16x2_max(mx2_a, pa);
      mx2_b = bf16x2_max(mx2_b, pb);
    };
    // QK^T over the whole key range: 128-key chunks, then 16-key ones, all
    // issued before one wait up to 256 + 16 keys (136 accumulators)
    if constexpr (NC <= 2) {
      float acc[NC][64];
      float accr[NR > 0 ? NR : 1][8];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
        qk_product<D16, 128>(acc[c], q_p0, q_p1, smem + c * 128 * 2 * P::W0, smem + Lay::T0 + c * 128 * 2 * P::W1);
#pragma unroll
      for (int r = 0; r < NR; ++r)
        qk_product<D16, 16>(accr[r], q_p0, q_p1, smem + (128 * NC + 16 * r) * 2 * P::W0,
                            smem + Lay::T0 + (128 * NC + 16 * r) * 2 * P::W1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) wgmma_pin<64>(acc[c]);
#pragma unroll
      for (int r = 0; r < NR; ++r) wgmma_pin<8>(accr[r]);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          keep(16 * c + jj, acc[c][4 * jj], acc[c][4 * jj + 1], acc[c][4 * jj + 2], acc[c][4 * jj + 3]);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          keep(16 * NC + 2 * r + jj, accr[r][4 * jj], accr[r][4 * jj + 1], accr[r][4 * jj + 2],
               accr[r][4 * jj + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float acc[64];
        wgmma_fence();
        qk_product<D16, 128>(acc, q_p0, q_p1, smem + c * 128 * 2 * P::W0, smem + Lay::T0 + c * 128 * 2 * P::W1);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_pin<64>(acc);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          keep(16 * c + jj, acc[4 * jj], acc[4 * jj + 1], acc[4 * jj + 2], acc[4 * jj + 3]);
      }
    }
    // every warp's product is done with the Q buffer: its next tile goes in
    named_barrier(1 + cw, 128);
    if (ct == 0 && tile + WGS < n_qt) load_q(tile + WGS);

    // the exact row max and sum; e = exp(s - max) once a score
    const float ml_a = quad_max(fmaxf(bf16_lo(mx2_a), bf16_hi(mx2_a))) * LOG2E;
    const float ml_b = quad_max(fmaxf(bf16_lo(mx2_b), bf16_hi(mx2_b))) * LOG2E;
    float e[4 * NG];
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      e[4 * j] = exp_ml(bf16_lo(sc[2 * j]), ml_a);
      e[4 * j + 1] = exp_ml(bf16_hi(sc[2 * j]), ml_a);
      e[4 * j + 2] = exp_ml(bf16_lo(sc[2 * j + 1]), ml_b);
      e[4 * j + 3] = exp_ml(bf16_hi(sc[2 * j + 1]), ml_b);
      sum_a += e[4 * j] + e[4 * j + 1];
      sum_b += e[4 * j + 2] + e[4 * j + 3];
    }
    const float inv_a = 1.f / quad_sum(sum_a);
    const float inv_b = 1.f / quad_sum(sum_b);
#pragma unroll
    for (int j = 0; j < NG; ++j) {  // keys past S: e = 0, and their V rows are zeros
      sc[2 * j] = pack_bf16(e[4 * j] * inv_a, e[4 * j + 1] * inv_a);
      sc[2 * j + 1] = pack_bf16(e[4 * j + 2] * inv_b, e[4 * j + 3] * inv_b);
    }

    // O = bf16(p) V: step kk takes keys 16 kk .. (groups 2 kk, 2 kk + 1)
    float o[P::OUT];
#pragma unroll
    for (int i = 0; i < P::OUT; ++i) o[i] = 0.f;
    mbar_wait(&bar->v_full, 0);
    __syncwarp();
    wgmma_pin<P::OUT>(o);
    wgmma_fence();
    pv_product<D16, NK>(o, sc, smem + Lay::OFF_V, smem + Lay::OFF_V + Lay::T0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin<P::OUT>(o);

    const int row_a = tile * 64 + 16 * (warp % 4) + g;
    const int row_b = row_a + 8;
    store_rows<P::N>(o, out_h + (size_t)min(row_a, S - 1) * row_elems, out_h + (size_t)min(row_b, S - 1) * row_elems,
                     row_a < S, row_b < S, a.D, t);
  }
}

// ---------------------------------------------------------------- launches

template <typename Kernel>
int launch(Kernel kernel, const CUtensorMap (&tm)[6], const Args& a, long long blocks, int threads, int smem,
           cudaStream_t stream) {
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], a);
  return (int)cudaGetLastError();
}

template <int D16, bool CAUSAL>
int launch_stream(const void* qkv, const Args& a, cudaStream_t stream) {
  CUtensorMap tm[6];
  if (!packed_maps<D16>(tm, qkv, a, BQ, BK)) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((a.S + BQ - 1) / BQ) * a.H * a.B;
  return launch(stream_attention_kernel<D16, CAUSAL>, tm, a, blocks, STREAM_THREADS, StreamLayout<D16>::BYTES,
                stream);
}

template <int D16, int NC, int NR>
int launch_rows(const void* qkv, const Args& a, cudaStream_t stream) {
  using Lay = RowsLayout<D16, NC, NR>;
  CUtensorMap tm[6];
  if (!packed_maps<D16>(tm, qkv, a, 64, Lay::KV_BOX)) return (int)cudaErrorInvalidValue;
  return launch(whole_row_attention_kernel<D16, NC, NR>, tm, a, (long long)a.H * a.B, Lay::THREADS, Lay::BYTES,
                stream);
}

// The rule (ops/fused_attention.py:packed_body states it for the tests): K2
// and K1 past K1_MAX_S the streamed body; K1 up to it whole rows at the
// smallest capacity that holds S (128, 272 or 384 keys).
template <int D16>
int dispatch(const void* qkv, const Args& a, bool causal, cudaStream_t st) {
  if (causal) return launch_stream<D16, true>(qkv, a, st);
  if (a.S > K1_MAX_S) return launch_stream<D16, false>(qkv, a, st);
  if (a.S <= 128) return launch_rows<D16, 1, 0>(qkv, a, st);
  if (a.S <= 272) return launch_rows<D16, 2, 1>(qkv, a, st);
  return launch_rows<D16, 3, 0>(qkv, a, st);
}

}  // namespace

// qkv: (B, S, 3*H*D) bf16, contiguous, 16-byte aligned; mask: (B, S) int32 or
// NULL; out: (B, S, H*D) bf16, contiguous. Requires D % 8 == 0, D <= 128, B
// and H under 65,536, and ceil(S / 128) * H * B blocks (H * B for K1 up to
// K1_MAX_S) at most INT_MAX. causal = 0 is K1 (no mask, q_scale 1): the
// whole-row body up to K1_MAX_S keys, the streamed body with no causal
// frontier above; causal = 1 is K2: the streamed body. q_scale is bf16(scale)
// for a query-side scale (else 1), s_scale bf16(scale) for a score-side one
// (else 1). Returns the launch's cudaError_t (0 on success); launches on
// `stream`, no synchronise.
extern "C" int eilev_packed_attention_bf16(const void* qkv, const void* mask, void* out, int B,
                                           int S, int H, int D, float q_scale, float s_scale,
                                           int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535 || D % 8 != 0 || D <= 0 || D > 128 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 || (!causal && (mask != nullptr || q_scale != 1.0f)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.mask = static_cast<const int32_t*>(mask);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.S = S, a.H = H, a.D = D;
  a.q_scale = q_scale, a.s_scale = s_scale;
  switch ((D + 15) / 16) {  // QK^T's k-steps
    case 1: return dispatch<1>(qkv, a, causal, st);
    case 2: return dispatch<2>(qkv, a, causal, st);
    case 3: return dispatch<3>(qkv, a, causal, st);
    case 4: return dispatch<4>(qkv, a, causal, st);
    case 5: return dispatch<5>(qkv, a, causal, st);
    case 6: return dispatch<6>(qkv, a, causal, st);
    case 7: return dispatch<7>(qkv, a, causal, st);
    case 8: return dispatch<8>(qkv, a, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
