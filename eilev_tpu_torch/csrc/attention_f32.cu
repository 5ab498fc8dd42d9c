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
// What bounds it on the H100: operations. The work is 4 S L D flops a head
// (less under a causal mask) against 4 (S + L) D bytes a head, far past the
// machine balance even at S = 257. The CUDA cores give fp32 67 TFLOP/s; the
// TF32 tensor cores 495, but one TF32 product keeps 10 mantissa bits, too
// few for the 1e-4 the fp32 reference is held to. Both products here run as
// 3xTF32: every operand x is split as hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi), and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b (lo lo,
// ~2^-22 of the product, dropped), each an mma.sync m16n8k8 tf32 with fp32
// accumulation, the small terms first. Three tensor-core products for one:
// the bound is 3 x flops / 495 TFLOP/s, 2.5x under the CUDA-core one. The
// split is not free: cvt.rna is four instructions (add, |x| < inf test,
// select, mask), so splitting a K/V tile in every warp costs more issue
// slots than the products it feeds.
//
// The design:
//   * a block is 8 warps and 128 queries, each warp 16 query rows, one
//     block an SM: Q is read once, scaled and split in the mma's A layout,
//     hi kept in registers and lo in shared memory as each lane's own
//     records (read back by that lane only: no barrier, and 64 registers
//     fewer at D = 128); the scores, the online-softmax state (base 2) and
//     the output stay in registers. The scores' C layout is PV's A layout
//     once key 2t + e of an 8-key block is paired with k index t + 4e (and
//     V's rows are read in that order), so P is split in registers and
//     never goes through shared memory;
//   * K and V stream in 32-key tiles: cp.async copies each thread's share of
//     tile t + 2 into the raw stage (8-byte K and 16-byte V copies where the
//     pointers and strides allow, 4-byte ones otherwise, as for a packed QKV
//     with an odd H D; keys past L and d past D zero-filled), and the same
//     thread splits that share once it has landed into records of the
//     mma's B fragments, {hi b0, hi b1, lo b0, lo b1}, in lane order: the
//     block splits each value once and a warp reads one 16-byte record per
//     three mma, conflict-free (lanes' slots swizzled, see `slot`). No
//     thread reads another's raw values, so one raw stage and one barrier a
//     tile suffice;
//   * the split of tile t + 1, and the copy of tile t + 2 behind it, are
//     emitted right after tile t's QK products, so their work runs while
//     those are in flight, not between phases;
//   * the softmax, a serial chain between the two products, is kept short:
//     a warp's tile that needs no mask (no bias, every key kept, none past
//     a row's causal frontier: most tiles) skips the per-score mask
//     arithmetic, and p is ex2.approx;
//   * ragged edges cost 8 keys and 16 queries, not a tile: the last key tile
//     runs only its 8-key blocks that hold a key, and a warp whose 16 rows
//     are all past S computes nothing (S = 257: 17 row groups in 3 blocks,
//     the third with one warp at work);
//   * the grid is (H, B, query tiles), the last query tiles first, so the
//     longest blocks of a causal mask start first; key tiles past the
//     block's causal frontier are skipped, and with uniform = 1 read after
//     all if a row of the block has seen only masked keys (its average runs
//     over every key).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"
#include "sm90_tf32.cuh"

namespace {

using sm90::mma_3xtf32;
using sm90::record;
using sm90::split;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;          // queries a block
constexpr int BK = 32;                  // keys a tile
constexpr int NB = BK / 8;              // 8-key blocks a tile: QK's n blocks, PV's k steps
constexpr int MAX_QUERY_TILES = 65535;  // grid z

// 2^x (ex2.approx, 2 ulp; results below 2^-126 flush to 0, far under what
// an fp32 output at 1e-4 can show)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sm90::smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(sm90::smem_addr(dst)), "l"(src),
               "r"(valid ? 8 : 0));
}

// The slot of lane (g, t) in a 32-record block: g is swizzled to g ^ (g >>
// 2), so that both the warps' reads (8 lanes: g = 2k, 2k + 1, t = 0..3) and
// the conversion's V stores (g = e, 4 + e, t = 0..3) hit 8 distinct 16-byte
// bank groups.
__device__ __forceinline__ int slot(int g, int t) { return 4 * (g ^ (g >> 2)) + t; }

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int32_t* mask;
  const float* bias;
  float* out;
  int S, L, H, KVH, D;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  float q_scale, s_scale;
  int causal, q_offset, uniform, vec;
};

// The staging of one key tile by padded head dim DP (a multiple of 8), by
// unit. A K unit is one record: K[key 8j + g][d 8c + 2t, + 1], units in
// record order (j, c, g, t). A V unit is 4 records: V[keys 8j + 2t, +
// 1][d 4u..4u + 3], units ordered (j, u, t). Each thread copies its units
// into a raw stage (copy) and, once they have landed, splits the same units
// into records (convert): no thread reads another's raw values. Keys >= L
// and d >= D are zero-filled. One raw and two split stages and Q's lo
// records take 224 KB at DP = 128: one block of 8 warps an SM.
template <int DP>
struct Stage {
  static constexpr int NC = DP / 8;  // 8-wide chunks of d: QK's k steps, PV's n blocks
  static constexpr int K_UNITS = BK * DP / 2;
  static constexpr int V_UNITS = BK * DP / 8;
  static constexpr int RAW = 2 * BK * DP;    // floats a stage: K, then V's even and odd rows
  static constexpr int SPLIT = 4 * BK * DP;  // floats a stage: K's records, then V's
  // one raw stage, two split stages, and Q's lo half: a 16-byte record a
  // thread and 8-wide chunk, each read back only by the thread that wrote it
  static constexpr size_t SMEM = sizeof(float) * (RAW + 2 * SPLIT + 4 * THREADS * NC);

  __device__ static void copy(const Args& a, const float* kb, const float* vb, float* raw, int k0) {
    float* rk = raw;
    float* rv = raw + BK * DP;  // even rows, then odd rows at + BK * DP / 2
    for (int u = threadIdx.x; u < K_UNITS; u += THREADS) {
      const int t = u & 3, g = (u >> 2) & 7, c = (u >> 5) % NC, j = (u >> 5) / NC;
      const int key = k0 + 8 * j + g, d = 8 * c + 2 * t;
      const float* src = kb + (long long)(key < a.L ? key : 0) * a.k_rs + d;
      if (a.vec) {
        cp_async8(rk + 2 * u, key < a.L && d < a.D ? src : kb, key < a.L && d < a.D);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cp_async4(rk + 2 * u + e, key < a.L && d + e < a.D ? src + e : kb, key < a.L && d + e < a.D);
      }
    }
    for (int v = threadIdx.x; v < V_UNITS; v += THREADS) {
      const int t = v & 3, un = (v >> 2) % (DP / 4), j = (v >> 2) / (DP / 4);
      const int d = 4 * un;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + 8 * j + 2 * t + r;
        const float* src = vb + (long long)(key < a.L ? key : 0) * a.v_rs + d;
        float* dst = rv + r * (BK * DP / 2) + 4 * v;
        if (a.vec) {
          sm90::cp_async16(dst, key < a.L && d < a.D ? src : vb, key < a.L && d < a.D);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cp_async4(dst + e, key < a.L && d + e < a.D ? src + e : vb, key < a.L && d + e < a.D);
        }
      }
    }
  }

  __device__ static void convert(const float* raw, float* split_kv) {
    const float* rk = raw;
    const float* rv = raw + BK * DP;
    float4* sk = reinterpret_cast<float4*>(split_kv);
    float4* sv = sk + NB * NC * 32;
    // rolled: the split runs beside the products in flight, and at D = 128
    // an unrolled one crowds the registers those need
#pragma unroll 1
    for (int u = threadIdx.x; u < K_UNITS; u += THREADS) {
      const float2 x = *reinterpret_cast<const float2*>(rk + 2 * u);
      sk[(u & ~31) + slot((u >> 2) & 7, u & 3)] = record(x.x, x.y);
    }
#pragma unroll 1
    for (int v = threadIdx.x; v < V_UNITS; v += THREADS) {
      const int t = v & 3, un = (v >> 2) % (DP / 4), j = (v >> 2) / (DP / 4);
      const float4 r0 = *reinterpret_cast<const float4*>(rv + 4 * v);
      const float4 r1 = *reinterpret_cast<const float4*>(rv + BK * DP / 2 + 4 * v);
      const int base = (j * NC + un / 2) * 32, g0 = 4 * (un & 1);
      sv[base + slot(g0, t)] = record(r0.x, r1.x);
      sv[base + slot(g0 + 1, t)] = record(r0.y, r1.y);
      sv[base + slot(g0 + 2, t)] = record(r0.z, r1.z);
      sv[base + slot(g0 + 3, t)] = record(r0.w, r1.w);
    }
  }
};

// One key tile for one warp's 16 rows (r0 = row g, r1 = row g + 8): scores,
// masks, the online-softmax update and PV, from the tile's split records.
// FULL: all BK keys are < L; otherwise only the nb 8-key blocks that hold a
// key run.
template <int DP, bool FULL, class Between>
__device__ __forceinline__ void tile_step(const Args& a, const float* split_kv, int k0, int nb,
                                          const uint32_t (&q_hi)[DP / 8][4], const float4* q_lo,
                                          float (&o)[DP / 8][4],
                                          float (&m)[2], float (&l)[2], int r0, int r1, int warp_row0,
                                          const int32_t* mb, const float* biash, int lane_slot, int t,
                                          Between between) {
  constexpr int NC = DP / 8;
  constexpr float LOG2E = 1.4426950408889634f;
  const float masked = a.uniform ? -FLT_MAX : -INFINITY;
  const float4* sk = reinterpret_cast<const float4*>(split_kv) + lane_slot;
  const float4* sv = sk + NB * NC * 32;

  // the padding mask of this thread's keys k0 + 8j + 2t + e, read before
  // the product so that its latency hides behind it
  bool kept[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + 2 * t + e;
      kept[j][e] = mb == nullptr || ((FULL || key < a.L) && __ldg(mb + key) != 0);
    }

  float s[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float4 lo = q_lo[c * THREADS];
    const uint32_t q_lo_c[4] = {__float_as_uint(lo.x), __float_as_uint(lo.y), __float_as_uint(lo.z),
                                __float_as_uint(lo.w)};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      // b0 = K[key 8j + g][d 8c + 2t], b1 = [.. + 1]: Q's a0/a2 hold the same d
      if (FULL || j < nb) mma_3xtf32(s[j], q_hi[c], q_lo_c, sk[(j * NC + c) * 32]);
    }
  }
  between();  // work that needs no score, while the products are in flight

  // scale, bias, masks, in the base-2 domain (x log2 e, so p = 2^(x - m));
  // element e of block j: row e < 2 ? r0 : r1, key k0 + 8j + 2t + (e & 1)
  const float scale2 = a.s_scale * LOG2E;
  float mx[2] = {-INFINITY, -INFINITY};
  // a tile this warp needs no mask on: every key < L and kept, none past a
  // row's causal frontier, no bias
  bool all_kept = true;
#pragma unroll
  for (int j = 0; j < NB; ++j) all_kept = all_kept && kept[j][0] && kept[j][1];
  const bool unmasked = FULL && biash == nullptr && (!a.causal || k0 + BK - 1 <= warp_row0 + a.q_offset) &&
                        __all_sync(0xffffffffu, all_kept);
  if (unmasked) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale2;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (!FULL && j >= nb) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale2;
        if (biash && row < a.S && key < a.L) x += __ldg(biash + (long long)row * a.L + key) * LOG2E;
        const bool keep = kept[j][e & 1] && !(a.causal && key > row + a.q_offset);
        x = keep ? x : masked;
        if (!FULL && key >= a.L) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    // no kept (or, uniform, existing) key yet: the state stays 0
    alpha[i] = m_new == -INFINITY ? 1.f : exp2_ftz(m[i] - m_new);
    m[i] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (!FULL && j >= nb) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mi = m[e >> 1];
      s[j][e] = mi == -INFINITY ? 0.f : exp2_ftz(s[j][e] - mi);
      psum[e >> 1] += s[j][e];
    }
  }
  // l stays this thread's partial sum (its quad's sum at the end)
  l[0] = l[0] * alpha[0] + psum[0];
  l[1] = l[1] * alpha[1] + psum[1];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    o[c][0] *= alpha[0];
    o[c][1] *= alpha[0];
    o[c][2] *= alpha[1];
    o[c][3] *= alpha[1];
  }

  // o += p v: k index t + 4e of block j is key 8j + 2t + e, the C layout of
  // the scores, so a0 = p(r0, 2t), a1 = p(r1, 2t), a2 = p(r0, 2t + 1), a3 =
  // p(r1, 2t + 1); the V records hold b0 = V[key 8j + 2t][d 8c + g], b1 =
  // V[key 8j + 2t + 1][d 8c + g]
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (!FULL && j >= nb) continue;
    uint32_t p_hi[4], p_lo[4];
    split(s[j][0], p_hi[0], p_lo[0]);
    split(s[j][2], p_hi[1], p_lo[1]);
    split(s[j][1], p_hi[2], p_lo[2]);
    split(s[j][3], p_hi[3], p_lo[3]);
#pragma unroll
    for (int c = 0; c < NC; ++c) mma_3xtf32(o[c], p_hi, p_lo, sv[(j * NC + c) * 32]);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) attention_f32_kernel(const Args a) {
  using St = Stage<DP>;
  constexpr int NC = St::NC;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                                          // RAW
  float* splits = smem + St::RAW;                             // 2 x SPLIT
  float4* q_lo = reinterpret_cast<float4*>(splits + 2 * St::SPLIT) + threadIdx.x;  // NC x THREADS

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the last query tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kvh = h / (a.H / a.KVH);
  const float* kb = a.k + b * a.k_bs + (long long)kvh * a.D;
  const float* vb = a.v + b * a.v_bs + (long long)kvh * a.D;
  const int32_t* mb = a.mask ? a.mask + (long long)b * a.L : nullptr;
  const float* biash = a.bias ? a.bias + (long long)h * a.S * a.L : nullptr;

  const int n_tiles = (a.L + BK - 1) / BK;
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int n_needed = a.causal ? min(n_tiles, (q_last + a.q_offset) / BK + 1) : n_tiles;
  int load_limit = n_needed;
  St::copy(a, kb, vb, raw, 0);
  sm90::cp_async_commit();

  // Q rows r0, r1 of this warp, times q_scale, split into the A layout:
  // a0/a1 hold d 8c + 2t, a2/a3 d 8c + 2t + 1 of rows r0/r1; hi in
  // registers, lo in this thread's records
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  const bool active = q0 + 16 * warp < a.S;
  uint32_t q_hi[NC][4];
  {
    const float* qb = a.q + b * a.q_bs + (long long)h * a.D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i & 1 ? r1 : r0, d = 8 * c + 2 * t + (i >> 1);
        const float x = row < a.S && d < a.D ? __ldg(qb + row * a.q_rs + d) * a.q_scale : 0.f;
        split(x, q_hi[c][i], lo[i]);
      }
      q_lo[c * THREADS] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]), __uint_as_float(lo[2]),
                                      __uint_as_float(lo[3]));
    }
  }
  // tile 0 split, tile 1 in flight
  sm90::cp_async_wait<0>();
  St::convert(raw, splits);
  if (1 < load_limit) St::copy(a, kb, vb, raw, BK);
  sm90::cp_async_commit();
  __syncthreads();

  float o[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int lane_slot = slot(g, t);

  // Each tile: compute it and, while its QK products are in flight, split
  // tile + 1 (landed) and copy tile + 2 into the raw stage this thread has
  // just read; one barrier.
  for (int tile = 0; tile < n_tiles; ++tile) {
    float* split_now = splits + (tile & 1) * St::SPLIT;
    if (tile == load_limit) {
      // past every causal frontier of the block: a tile there is wholly
      // masked. With uniform = 1 it still counts for a row that has seen
      // only masked keys (its average runs over every key).
      const bool dead = a.uniform && ((r0 < a.S && m[0] == -FLT_MAX) || (r1 < a.S && m[1] == -FLT_MAX));
      if (!__syncthreads_or(dead)) break;
      load_limit = n_tiles;
      St::copy(a, kb, vb, raw, tile * BK);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      St::convert(raw, split_now);
      if (tile + 1 < n_tiles) St::copy(a, kb, vb, raw, (tile + 1) * BK);
      sm90::cp_async_commit();
      __syncthreads();
    }
    auto split_next = [&]() {
      if (tile + 1 >= load_limit) return;
      sm90::cp_async_wait<0>();  // this thread's copies of tile + 1 have landed
      St::convert(raw, splits + ((tile + 1) & 1) * St::SPLIT);
      if (tile + 2 < load_limit) St::copy(a, kb, vb, raw, (tile + 2) * BK);
      sm90::cp_async_commit();
    };
    const int k0 = tile * BK;
    if (!active)
      split_next();
    else if (k0 + BK <= a.L)
      tile_step<DP, true>(a, split_now, k0, NB, q_hi, q_lo, o, m, l, r0, r1, q0 + 16 * warp, mb, biash, lane_slot, t, split_next);
    else
      tile_step<DP, false>(a, split_now, k0, (a.L - k0 + 7) / 8, q_hi, q_lo, o, m, l, r0, r1, q0 + 16 * warp, mb, biash,
                           lane_slot, t, split_next);
    __syncthreads();  // tile + 1's records are in; every warp is done with this tile's
  }
  sm90::cp_async_wait<0>();  // nothing in flight at exit
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    if (row >= a.S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    float* orow = a.out + b * a.o_bs + row * a.o_rs + (long long)h * a.D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * c + 2 * t + e;
        if (d < a.D) orow[d] = o[c][2 * i + e] * inv;
      }
  }
}

template <int DP>
int launch(const Args& a, int B, cudaStream_t st) {
  constexpr size_t smem = Stage<DP>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(attention_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, B, (a.S + BQ - 1) / BQ);
  attention_f32_kernel<DP><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: fp32, strided as above (element strides), 4-byte aligned;
// mask: (B, L) int32 or NULL; bias: (H, S, L) fp32 contiguous or NULL.
// Requires 0 < D <= 128, H % KVH == 0, B under 65,536, S under 65,536 * 128,
// q_offset >= 0. uniform = 1: K1/K2's fully masked rows (uniform average);
// 0: K5's (zero). Returns the launch's cudaError_t (0 on success); launches
// on `stream`, no synchronise.
extern "C" int eilev_attention_f32(const void* q, const void* k, const void* v, const void* mask,
                                   const void* bias, void* out, int B, int S, int L, int H, int KVH,
                                   int D, long long q_bs, long long q_rs, long long k_bs,
                                   long long k_rs, long long v_bs, long long v_rs, long long o_bs,
                                   long long o_rs, float q_scale, float s_scale, int causal,
                                   int q_offset, int uniform, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || L <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 || D > 128 ||
      B > 65535 || (S + BQ - 1) / BQ > MAX_QUERY_TILES || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  // 8-byte K and 16-byte V copies where every row of every (batch, kv head)
  // starts 16-byte aligned and holds whole 16-byte chunks; 4-byte otherwise
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0 && k_bs % 4 == 0 && k_rs % 4 == 0 &&
                     v_bs % 4 == 0 && v_rs % 4 == 0;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
               static_cast<const int32_t*>(mask), static_cast<const float*>(bias), static_cast<float*>(out),
               S, L, H, KVH, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, q_scale, s_scale,
               causal, q_offset, uniform, vec ? 1 : 0};
  switch ((D + 7) / 8 * 8) {
#define EILEV_F32_CASE(DP) \
  case DP:                 \
    return launch<DP>(a, B, st);
    EILEV_F32_CASE(8)
    EILEV_F32_CASE(16)
    EILEV_F32_CASE(24)
    EILEV_F32_CASE(32)
    EILEV_F32_CASE(40)
    EILEV_F32_CASE(48)
    EILEV_F32_CASE(56)
    EILEV_F32_CASE(64)
    EILEV_F32_CASE(72)
    EILEV_F32_CASE(80)
    EILEV_F32_CASE(88)
    EILEV_F32_CASE(96)
    EILEV_F32_CASE(104)
    EILEV_F32_CASE(112)
    EILEV_F32_CASE(120)
    EILEV_F32_CASE(128)
#undef EILEV_F32_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
