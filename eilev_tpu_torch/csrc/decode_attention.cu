// Decode-step attention over the stacked KV cache for Hopper (sm_90a).
//
// Replaces the Pallas kernel eilev_tpu/ops/decode_attention.py:117
// decode_attention_stacked, both of its bodies:
//   K3 _kernel_bf16 (:42) - a model-dtype cache;
//   K4 _kernel_int8 (:75) - an int8 cache with bf16 per-(position, kv-head)
//      scales, dequantized to the model dtype before each dot.
// One new query token (B, H*D) attends against layer `layer` of the stacked
// (L, B, S, KVH*D) cache under a (B, S) keep-mask; head h reads kv head
// h / (H / KVH) (grouped-query attention); the query is scaled on the q side
// (HF OPT) or the scores on the score side (HF LLaMA). Output (B, H*D) in the
// model dtype, bf16 or fp32.
//
// What bounds it on the H100: bytes. A decode step reads every cache row once
// and does 2 flops per element read, far below the ~295 flops per byte where
// the tensor cores would matter. At the narration shape (B=4, S=798, 32
// heads x 80) one call reads 32.7 MB of bf16 K+V (16.3 MB int8 + 0.2 MB
// scales): ~10 us (~5 us int8) at 3.35 TB/s; at the text LM's (B=1, 2,016
// of 2,048 slots filled, 32 x 128) 33 MB of bf16 K+V, ~10 us. So no tensor
// cores, and every byte is read once; `layer` is a run-time pointer offset
// into the stacked buffers, so no per-layer slice is materialized.
//
// Rounding points follow the reference exactly. With a bf16 model: q *
// bf16(scale) rounded to bf16 (q side) or the bf16 scores times bf16(scale)
// rounded (score side); QK^T in fp32 rounded to bf16; masked scores -inf
// (what finfo(float32).min becomes in bf16); fp32 softmax; p rounded to bf16
// after normalising; PV in fp32. int8: k = bf16(f32(k8) * f32(scale)), the
// same for v. A fully masked row has max -inf, so exp gives NaN and the
// output row is NaN, as in the reference; slots with p == 0 are skipped in
// PV, a NaN p is not. With an fp32 model every rounding to the model dtype is
// the identity, the scale is the fp32 one, int8 dequantizes to f32(k8) *
// f32(scale) (exact in fp32), and a masked score is finfo(float32).min,
// which is finite: a fully masked row is the uniform average of every slot's
// V row, as in the reference (exp(0) = 1 for every slot, so every p = 1 / S
// and every V row is read).
//
// Three bodies:
//   * The split (decode_attention_split_kernel): a bf16 model over an int8
//     cache, and over a bf16 cache where the written rule k3_split says so.
//   * One block of 256 threads per (head, batch row) (decode_attention_kernel),
//     bf16 cache only, for the bf16 calls the rule does not split.
//   * The fp32 body (decode_attention_f32_kernel): every call with an fp32
//     model, over an fp32 cache (K3) or an int8 cache (K4). Notes below.
//
// The split: S over a thread-block cluster, in one launch.
//   * What held the one-block body back: at B = 1 it ran 32 blocks on 132
//     SMs; its pass 1 gave each thread a whole row (5-8 16-byte loads at a
//     4-8 KB stride) and dequantized one value at a time.
//   * Why not the usual flash-decoding split with a second launch: the
//     reference rounds the NORMALISED probabilities before PV, so every block
//     needs the row's global max and sum before its PV, and the decode loop
//     is host-bound (2,016 more launches a text-LM request would cost more
//     than they save).
//   * So C blocks (a cluster, C <= 8, portable) share one (head, row), each
//     over a contiguous chunk of ceil(S / C) slots. The written rule for C
//     (cluster_size, the same in ops/decode_attention.py): the smallest C with
//     B * H * C >= 2 x 132 SMs, capped at 8 and at the number of 32-slot
//     chunks; it depends on (B, H, S) only, so a shape always sums in the
//     same order.
//   * Occupancy decides its time: at most 64 registers a thread, so 4 blocks
//     share an SM and the 256 (text LM) or 384 (narration) blocks run in one
//     wave. Versions that kept 8 rows a lane in flight (~99 registers) or
//     staged K and V in shared memory (up to 77 KB a block) ran 25-33 us:
//     a second wave.
//   * The block first packs its slots' keep-mask into shared-memory bits (one
//     round of loads). Pass 1: NC = D / E lanes cover one row's contiguous
//     16-byte chunks of E values (32 / NC rows a warp; bf16 at D = 80: NC =
//     10, 30 of 32 lanes busy; int8 at D = 80: NC = 5), four rows a lane in
//     flight; the chunk type C dots a chunk with the lane's slice of the
//     query in index order (int8: dequantized first, see Int8Cache::dequant);
//     the row's first lane sums the NC partial dots in chunk order. Masked
//     slots are not read.
//   * Cluster exchange through distributed shared memory, each a store into
//     every block's (or rank 0's) shared memory, then a cluster barrier: the
//     blocks' maxima; their fp32 sums of exp(s - M), added in rank order.
//     Each block then rounds p = exp(s - M) / sum to the model dtype and runs
//     PV over its own chunk with the same lanes (p == 0 slots not read); the
//     row groups of a warp add by a fixed shuffle tree, then the warps in
//     order; rank 0 adds the C partial outputs in rank order and writes the
//     row. A barrier arrival at the start, waited before the first store,
//     makes sure every block of the cluster runs before any writes into it.
//   * The kernel is a template over the chunk type: the model dtype (its
//     rounding, its mask value, q and out), the cache element, E values a
//     16-byte chunk, whether a row has a scale, dot and axpy: Bf16Cache (K3)
//     and Int8Cache (K4).
//
// The fp32 body. In fp32 the reference's rounding of p to the model dtype is
// the identity, so the split need not know the row's max and sum before PV:
// each block reduces its slots to a flash-decoding state (its max m_r, l_r =
// the sum of exp(s - m_r) and o_r = the sum of exp(s - m_r) v), and one
// exchange through distributed shared memory combines them in rank order,
// out = sum_r exp(m_r - M) o_r / sum_r exp(m_r - M) l_r. The same up to the
// order of fp32 rounding (a few ulps); held to the twin at 1e-4.
//   * What held the split's fp32 chunk types back, before this body:
//     4 values a 16-byte chunk, so D = 80 took 20 lanes a row and D = 128 a
//     whole warp (12 lanes idle at 80, half the bytes in flight of the bf16
//     body); the row's dot added by NC - 1 shuffles in a chain; V's loads
//     started only after pass 1, three cluster barriers, an exp pass; and at
//     batch 4 (C = 3) a fourth block an SM waited for a second wave.
//   * Lanes: 8 values a lane, NC = D / 8 lanes a row, 32 / NC rows a warp
//     (D = 80: 3 rows and 30 busy lanes; 128: 2 rows; 64: 4), fp32 as two
//     16-byte loads (chunks c and c + NC of the row), int8 as one 8-byte
//     load. A row's partial dots add by a fixed tree over its lanes.
//   * Cluster (f32_cluster_size): cluster_size's C, lowered while B x H
//     clusters would not fit one wave (F32_WAVE_CLUSTERS, the card's own
//     count: at 3 blocks an SM it holds 124 clusters of 3, not 132), so the
//     narration's batch 4 takes C = 2. Block rank r takes every C-th group
//     of 8 slots from the r-th: a serving cache's live window (one row 773
//     live slots of 2,048, another 49) spreads evenly over the blocks, which
//     contiguous chunks left to one block; a group's 8 mask words are one
//     32-byte sector.
//   * Staged (f32_staged: where a block's K and V fit 76,800 bytes, an
//     SM's shared memory over the 3 blocks its registers allow): every kept
//     K and V row is copied into shared memory at once (cp.async, 16 bytes
//     a copy over all threads; K rows at an odd number of 16-byte chunks);
//     pass A gives a thread a slot's whole dot, then the block's max and e =
//     exp(s - max) in place; pass B runs PV with NC lanes a row. The
//     narration's batch 1 (fp32 and int8), the int8 cache at batch 4.
//   * Streamed (everything else: the text LM, fp32 at batch 4, the serving
//     cache): the kept slots are compacted into a list; each lane keeps U
//     rows of K and V in flight (fp32 2, int8 4) and an online-softmax
//     state over its row group's rows, rescaled once a round; the row
//     groups merge by a fixed tree, then the warps in order.
//   * One exchange: every block stores (m_r, l_r) into every block and o_r
//     into rank 0, then one cluster barrier (the split takes three).
//   * The rare path: a row with no kept slot is the uniform average of all S
//     V rows (finfo(float32).min is finite); every block sees that from the
//     exchanged sums (all zero), reads its slots' V rows from global memory
//     with p = 1 / S, and rank 0 adds the blocks' sums after a second
//     barrier. Int8: the scale multiplies the row's dot and its PV weight
//     instead of each value.
//
// The one-block body (bf16 cache): two passes. Pass 1 gives each thread
// whole key rows (16-byte loads), the S fp32 scores stay in shared memory;
// block-wide max and sum; pass 2 (PV) gives thread t 16-byte chunk t % NC of
// every G-th row (G = 256 / NC), 8 rows in flight, partial sums added through
// shared memory in a fixed order.
//
// The bf16 body rule (k3_split, the same in ops/decode_attention.py): split
// when one block per (head, row) would leave at least half of the SMs idle,
// 2 * B * H <= 132. Timed in one call on an H100 (both bodies, 32 launches a
// step, per launch): at the text LM's decode (B = 1, 32 heads, 2,048 slots)
// 46.9 us one block vs 21.2 us split; the narration's batch 1 (798 slots, 32
// x 80) 16.0 vs 13.1; its batch 4 (B * H = 128) 19.7 vs 20.4, where the one
// block per (head, row) already nearly fills the card and a split adds its
// cluster barriers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PV_ROWS = 8;  // rows of V each thread loads before using them
constexpr int SMS = 132;    // H100 SXM
constexpr int MAX_CLUSTER = 8;
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory one block may use
constexpr int SM_SMEM = 233472;        // shared memory of one SM
constexpr int BLOCK_RESERVED = 1024;   // what the card reserves of it for each block
constexpr int F32_BLOCKS = 3;          // the fp32 body's blocks an SM (its registers)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The two bf16 of a packed pair, exactly, as floats.
__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The model dtype: how a query element is read, how a value is rounded to
// the dtype, how the output is written, and the masked score (finfo(float32)
// .min in the dtype: -inf in bf16).
struct Bf16Model {
  using Q = __nv_bfloat16;
  __device__ __forceinline__ static float load(Q x) { return __bfloat162float(x); }
  __device__ __forceinline__ static float round(float x) { return round_bf16(x); }
  __device__ __forceinline__ static Q store(float x) { return __float2bfloat16(x); }
  __device__ __forceinline__ static float masked() { return -INFINITY; }
};

// One 16-byte chunk of a bf16 cache row: 8 values, no scale.
struct Bf16Cache : Bf16Model {
  using T = __nv_bfloat16;
  static constexpr int E = 8;
  static constexpr bool SCALED = false;
  // the chunk as fp32 values (the one-block body)
  __device__ __forceinline__ static void unpack(const uint4& raw, float, float* out) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < E; ++j) out[j] = __bfloat162float(e[j]);
  }
  // acc + sum_j q[j] * k[j] in fp32, in index order
  __device__ __forceinline__ static float dot(const uint4& raw, float, const float* q, float acc) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(q[2 * i], lo(w[i]), acc);
      acc = fmaf(q[2 * i + 1], hi(w[i]), acc);
    }
    return acc;
  }
  // acc[j] += p * v[j]
  __device__ __forceinline__ static void axpy(const uint4& raw, float, float p, float* acc) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(p, lo(w[i]), acc[2 * i]);
      acc[2 * i + 1] = fmaf(p, hi(w[i]), acc[2 * i + 1]);
    }
  }
};

// byte I of w (an int8 biased by 128) as an exact fp32: (x + 128) placed in
// the low mantissa of 2^23, minus 2^23 + 128
template <int I>
__device__ __forceinline__ float byte_f32(uint32_t w_biased) {
  return __uint_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7540u | I)) - 8388736.0f;
}

__device__ __forceinline__ void unbias(const uint4& raw, uint32_t* w) {
  w[0] = raw.x ^ 0x80808080u;
  w[1] = raw.y ^ 0x80808080u;
  w[2] = raw.z ^ 0x80808080u;
  w[3] = raw.w ^ 0x80808080u;
}

// An int8 chunk with a bf16 model: 16 values, dequantized as
// bf16(f32(k8) * f32(scale)).
struct Int8Cache : Bf16Model {
  using T = int8_t;
  static constexpr int E = 16;
  static constexpr bool SCALED = true;
  // The 16 dequantized values as 8 packed bf16 pairs. An int8 is exact in
  // bf16 and f32(k8) * f32(scale) is exact in fp32 (8 x 8 significant bits),
  // so one packed bf16 multiply rounds exactly as bf16(f32(k8) * f32(scale)).
  __device__ __forceinline__ static void dequant(const uint4& raw, float scale, uint32_t* pairs) {
    uint32_t w[4];
    unbias(raw, w);
    const __nv_bfloat162 s2 = __float2bfloat162_rn(scale);  // a bf16 value: exact
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 l = __hmul2(__floats2bfloat162_rn(byte_f32<0>(w[i]), byte_f32<1>(w[i])), s2);
      const __nv_bfloat162 h = __hmul2(__floats2bfloat162_rn(byte_f32<2>(w[i]), byte_f32<3>(w[i])), s2);
      pairs[2 * i] = *reinterpret_cast<const uint32_t*>(&l);
      pairs[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  __device__ __forceinline__ static float dot(const uint4& raw, float scale, const float* q, float acc) {
    uint32_t k[8];
    dequant(raw, scale, k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc = fmaf(q[2 * i], lo(k[i]), acc);
      acc = fmaf(q[2 * i + 1], hi(k[i]), acc);
    }
    return acc;
  }
  __device__ __forceinline__ static void axpy(const uint4& raw, float scale, float p, float* acc) {
    uint32_t v[8];
    dequant(raw, scale, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[2 * i] = fmaf(p, lo(v[i]), acc[2 * i]);
      acc[2 * i + 1] = fmaf(p, hi(v[i]), acc[2 * i + 1]);
    }
  }
};

// Block-wide max (MAX) or sum of one value per thread; every thread gets it.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  __syncthreads();  // the previous reduction's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v = MAX ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// The one-block body's shared memory, the same in ops/decode_attention.py
// (smem_bytes): scores, scaled query, PV partial sums (THREADS * E),
// reduction scratch.
size_t smem_bytes(int S, int D, int E) {
  return sizeof(float) * ((size_t)S + D + (size_t)THREADS * E + 32);
}

// The bf16 body rule: the split when one block per (head, row) would leave
// at least half of the SMs idle. It depends on the shape only.
bool k3_split(int B, int H, int) { return 2LL * B * H <= SMS; }

// The cluster split's written rule: the smallest C with B * H * C >= 2 x the
// SMs, capped at MAX_CLUSTER and at the number of 32-slot chunks.
int cluster_size(int B, int H, int S) {
  const int bh = B * H;
  int c = (2 * SMS + bh - 1) / bh;
  c = c < MAX_CLUSTER ? c : MAX_CLUSTER;
  const int chunks = (S + 31) / 32;
  c = c < chunks ? c : chunks;
  return c > 1 ? c : 1;
}

// The shared memory of one block of the split, the same in
// ops/decode_attention.py (split_smem_bytes): its n = ceil(S / C) fp32
// scores and keep bits, each warp's PV partial sums, the partial outputs
// rank 0 gathers, reduction scratch, and the max and sum every rank receives.
size_t split_smem_bytes(int S, int D, int C) {
  const size_t n = ((size_t)S + C - 1) / C;
  return sizeof(float) * (n + (n + 31) / 32 + (size_t)WARPS * D + (size_t)MAX_CLUSTER * D + WARPS +
                          2 * MAX_CLUSTER);
}

// The fp32 body's blocks take the cache's slots in groups of F32_GROUP, block
// rank r every C-th group from the r-th (a group's mask words are one
// 32-byte sector): f32_slots is the most a block takes, f32_slots_of rank
// r's.
constexpr int F32_GROUP = 8;
__host__ __device__ inline int f32_slots(int S, int C) {
  return F32_GROUP * (((S + F32_GROUP - 1) / F32_GROUP + C - 1) / C);
}
__host__ __device__ inline int f32_slots_of(int S, int C, int r) {
  const int groups = (S + F32_GROUP - 1) / F32_GROUP;
  const int mine = groups > r ? (groups - r + C - 1) / C : 0;
  const bool last = mine > 0 && (groups - 1) % C == r && S % F32_GROUP != 0;
  return mine * F32_GROUP - (last ? F32_GROUP - S % F32_GROUP : 0);
}

// A staged K row's stride in elements: the row's 16-byte chunks rounded up
// to an odd number, so threads that read consecutive rows 16 bytes at a time
// hit distinct banks.
__host__ __device__ constexpr int f32_k_stride(int D, int elem) { return (D * elem / 16 | 1) * 16 / elem; }

// The fp32 body's written rule, the same in ops/decode_attention.py
// (f32_smem_bytes, f32_staged). Its cluster is cluster_size's. A block's
// shared memory: the (max, sum) pairs of its warps and of the cluster's
// ranks; staged, its n = f32_slots(S, C) slots of K (at f32_k_stride) and of V,
// the query and their scores, else the kept slots' indices and their counts
// before each 32-slot word; reduction scratch, each warp's partial output,
// the partial outputs rank 0 gathers, the keep bits and (int8) the slots'
// scales.
size_t f32_smem_bytes(int S, int D, int C, bool int8, bool staged) {
  const size_t n = f32_slots(S, C);
  const size_t elem = int8 ? 1 : 4;
  const size_t words = (n + 31) / 32;
  const size_t rows = staged ? n * (f32_k_stride(D, elem) + D) * elem + 4 * (n + D) : 4 * (words + n);
  return 8 * (WARPS + MAX_CLUSTER) + rows +
         4 * (WARPS + (size_t)(WARPS + MAX_CLUSTER) * D + words + (int8 ? 2 * n : 0));
}

// The clusters of C blocks of the fp32 body that one wave of an H100 SXM
// holds (cudaOccupancyMaxActiveClusters at F32_BLOCKS blocks an SM): fewer
// than F32_BLOCKS x 132 / C, since a cluster's blocks share a GPC.
constexpr int F32_WAVE_CLUSTERS[MAX_CLUSTER + 1] = {0, 396, 198, 124, 92, 69, 62, 47, 45};

// The fp32 body's cluster: cluster_size's, lowered while the B x H clusters
// would not fit one wave.
int f32_cluster_size(int B, int H, int S) {
  int c = cluster_size(B, H, S);
  while (c > 1 && B * H > F32_WAVE_CLUSTERS[c]) --c;
  return c;
}

// Staged where it costs no occupancy: where a block's shared memory with K
// and V staged stays within the share of an SM that each of the F32_BLOCKS
// blocks its registers allow may take (the SM's 228 KB over F32_BLOCKS, less
// the 1 KB the card reserves for a block). It depends on the shape only.
bool f32_staged(int B, int H, int S, int D, bool int8) {
  return f32_smem_bytes(S, D, f32_cluster_size(B, H, S), int8, true) <=
         (size_t)(SM_SMEM / F32_BLOCKS - BLOCK_RESERVED);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

template <class C, int NC>  // NC 16-byte chunks per row: D = NC * C::E
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const typename C::T* __restrict__ k_buf,
                        const typename C::T* __restrict__ v_buf,
                        const __nv_bfloat16* __restrict__ k_scale,
                        const __nv_bfloat16* __restrict__ v_scale,
                        const int32_t* __restrict__ mask, __nv_bfloat16* __restrict__ out, int B,
                        int S, int H, int KVH, int layer, float scale, int scale_query) {
  constexpr int E = C::E;
  constexpr int D = NC * E;
  constexpr int G = THREADS / NC;  // row groups of pass 2
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);  // S scores, then probabilities
  float* qs = sc + S;                          // D
  float* part = qs + D;                        // G x D
  float* red = part + G * D;                   // WARPS

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KVH);
  const size_t row = (size_t)KVH * D;  // elements from one slot to the next
  const size_t slab = ((size_t)layer * B + b) * S;  // first slot of (layer, b)
  const typename C::T* kb = k_buf + slab * row + (size_t)kvh * D;
  const typename C::T* vb = v_buf + slab * row + (size_t)kvh * D;
  const __nv_bfloat16* ksb = k_scale ? k_scale + slab * KVH + kvh : nullptr;
  const __nv_bfloat16* vsb = v_scale ? v_scale + slab * KVH + kvh : nullptr;
  const int32_t* mb = mask + (size_t)b * S;

  for (int i = threadIdx.x; i < D; i += THREADS) {
    const float x = __bfloat162float(q[((size_t)b * H + h) * D + i]);
    qs[i] = scale_query ? round_bf16(x * scale) : x;
  }
  __syncthreads();

  // pass 1: one key row per thread
  float mx = -INFINITY;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    float score = -INFINITY;
    if (mb[s] != 0) {
      const uint4* src = reinterpret_cast<const uint4*>(kb + (size_t)s * row);
      uint4 raw[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) raw[c] = src[c];
      const float ksc = ksb ? __bfloat162float(ksb[(size_t)s * KVH]) : 1.f;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float kf[E];
        C::unpack(raw[c], ksc, kf);
#pragma unroll
        for (int j = 0; j < E; ++j) acc = fmaf(qs[c * E + j], kf[j], acc);
      }
      score = round_bf16(acc);
      if (!scale_query) score = round_bf16(score * scale);
    }
    sc[s] = score;
    mx = fmaxf(mx, score);
  }
  mx = block_reduce<true>(mx, red);

  // fp32 softmax; probabilities rounded to bf16
  float sum = 0.f;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const float e = expf(sc[s] - mx);
    sc[s] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int s = threadIdx.x; s < S; s += THREADS) sc[s] = round_bf16(sc[s] / sum);
  __syncthreads();

  // pass 2: PV
  const int c = threadIdx.x % NC;
  const int r0 = threadIdx.x / NC;
  if (r0 < G) {
    float acc[E];
#pragma unroll
    for (int j = 0; j < E; ++j) acc[j] = 0.f;
    for (int s0 = r0; s0 < S; s0 += G * PV_ROWS) {
      float p[PV_ROWS], vsc[PV_ROWS];
      uint4 raw[PV_ROWS];
#pragma unroll
      for (int u = 0; u < PV_ROWS; ++u) {
        const int s = s0 + u * G;
        p[u] = s < S ? sc[s] : 0.f;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        vsc[u] = 1.f;
        if (p[u] != 0.f) {
          raw[u] = reinterpret_cast<const uint4*>(vb + (size_t)s * row)[c];
          if (vsb) vsc[u] = __bfloat162float(vsb[(size_t)s * KVH]);
        }
      }
#pragma unroll
      for (int u = 0; u < PV_ROWS; ++u) {
        if (p[u] == 0.f) continue;  // NaN is not skipped
        float vf[E];
        C::unpack(raw[u], vsc[u], vf);
#pragma unroll
        for (int j = 0; j < E; ++j) acc[j] = fmaf(p[u], vf[j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) part[r0 * D + c * E + j] = acc[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += THREADS) {
    float o = 0.f;
    for (int r = 0; r < G; ++r) o += part[r * D + i];
    out[((size_t)b * H + h) * D + i] = __float2bfloat16(o);
  }
}

// The cluster split. Grid (C, H, B), cluster (C, 1, 1); block rank r takes
// slots [r * n, min(S, (r + 1) * n)), n = ceil(S / C). At most 64 registers a
// thread, so 4 blocks share an SM and the shapes the models run (256 and 384
// blocks) fit one wave.
template <class C, int NC>  // NC 16-byte chunks per row: D = NC * C::E
__global__ void __launch_bounds__(THREADS, 4)
decode_attention_split_kernel(const typename C::Q* __restrict__ q,
                              const typename C::T* __restrict__ k_buf,
                              const typename C::T* __restrict__ v_buf,
                              const __nv_bfloat16* __restrict__ k_scale,
                              const __nv_bfloat16* __restrict__ v_scale,
                              const int32_t* __restrict__ mask, typename C::Q* __restrict__ out,
                              int B, int S, int H, int KVH, int layer, float scale,
                              int scale_query) {
  constexpr int E = C::E;
  constexpr int D = NC * E;
  constexpr int RPW = 32 / NC;     // rows a warp takes at once: NC lanes each
  constexpr int WR = WARPS * RPW;  // rows the block's warps take at once
  constexpr int U = 4;             // rows a lane has in flight
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int n = (S + n_ranks - 1) / n_ranks;
  const int s_begin = rank * n;
  const int cnt = max(0, min(S, s_begin + n) - s_begin);
  cluster_arrive();  // every block runs before any DSMEM store: waited below

  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                     // n scores, then probabilities
  uint32_t* keep = reinterpret_cast<uint32_t*>(sc + n);           // n keep bits
  float* wpart = reinterpret_cast<float*>(keep + (n + 31) / 32);  // WARPS x D
  float* part_in = wpart + WARPS * D;                             // MAX_CLUSTER x D (rank 0's)
  float* red = part_in + MAX_CLUSTER * D;                         // WARPS
  float* mx_in = red + WARPS;                                     // MAX_CLUSTER
  float* sum_in = mx_in + MAX_CLUSTER;                            // MAX_CLUSTER

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = lane % NC;   // this lane's 16-byte chunk of a row
  const int rw = lane / NC;  // this lane's row of the warp's RPW (RPW: an idle lane)
  const bool has_chunk = rw < RPW;
  const size_t row = (size_t)KVH * D;
  const size_t slab = ((size_t)layer * B + b) * S + s_begin;  // this block's first slot
  const typename C::T* kb = k_buf + slab * row + (size_t)kvh * D + (size_t)c * E;
  const typename C::T* vb = v_buf + slab * row + (size_t)kvh * D + (size_t)c * E;
  // the rows' scales (int8 only: a bf16 or fp32 cache has none and reads none)
  const __nv_bfloat16* ksb = C::SCALED ? k_scale + slab * KVH + kvh : nullptr;
  const __nv_bfloat16* vsb = C::SCALED ? v_scale + slab * KVH + kvh : nullptr;
  const int32_t* mb = mask + (size_t)b * S + s_begin;

  // the block's keep-mask as bits, in one round of loads
  for (int w = warp; w < (cnt + 31) / 32; w += WARPS) {
    const int i = w * 32 + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, i < cnt && mb[i] != 0);
    if (lane == 0) keep[w] = bits;
  }
  // this lane's chunk of the query, in registers
  float qv[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const float x = has_chunk ? C::load(q[((size_t)b * H + h) * D + c * E + j]) : 0.f;
    qv[j] = scale_query ? C::round(x * scale) : x;
  }
  __syncthreads();

  // pass 1: scores of this block's slots. NC lanes a row, U rows a lane in
  // flight; the row's first lane sums the chunks in order. Masked slots are
  // not read.
  float mx = -INFINITY;
  for (int i0 = warp * RPW + rw; i0 - rw < cnt; i0 += U * WR) {
    bool kept[U];
    uint4 raw[U];
    float ksc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * WR;
      kept[u] = has_chunk && i < cnt && ((keep[i / 32] >> (i % 32)) & 1u);
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = 0.f;
      if (kept[u]) {
        raw[u] = *reinterpret_cast<const uint4*>(kb + (size_t)i * row);
        if constexpr (C::SCALED) ksc[u] = __bfloat162float(ksb[(size_t)i * KVH]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * WR;
      const float part = kept[u] ? C::dot(raw[u], ksc[u], qv, 0.f) : 0.f;
      float acc = part;
#pragma unroll
      for (int k = 1; k < NC; ++k) acc += __shfl_down_sync(0xffffffffu, part, k);
      if (has_chunk && c == 0 && i < cnt) {
        float score = C::masked();
        if (kept[u]) {
          score = C::round(acc);
          if (!scale_query) score = C::round(score * scale);
        }
        sc[i] = score;
        mx = fmaxf(mx, score);
      }
    }
  }

  // the cluster's max: every block stores its own into every block
  mx = block_reduce<true>(mx, red);
  cluster_wait();
  if (threadIdx.x < n_ranks) cluster.map_shared_rank(mx_in, (int)threadIdx.x)[rank] = mx;
  cluster_sync();
  float m_all = -INFINITY;
  for (int r = 0; r < n_ranks; ++r) m_all = fmaxf(m_all, mx_in[r]);

  // fp32 exp; the cluster's sum, added in rank order
  float sum = 0.f;
  for (int i = threadIdx.x; i < cnt; i += THREADS) {
    const float e = expf(sc[i] - m_all);
    sc[i] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  if (threadIdx.x < n_ranks) cluster.map_shared_rank(sum_in, (int)threadIdx.x)[rank] = sum;
  cluster_sync();
  float sum_all = 0.f;
  for (int r = 0; r < n_ranks; ++r) sum_all += sum_in[r];
  for (int i = threadIdx.x; i < cnt; i += THREADS) sc[i] = C::round(sc[i] / sum_all);
  __syncthreads();

  // pass 2: PV over this block's slots, the same lanes and rows; a slot with
  // p == 0 is not read, a NaN p is
  float acc[E];
#pragma unroll
  for (int j = 0; j < E; ++j) acc[j] = 0.f;
  for (int i0 = warp * RPW + rw; i0 - rw < cnt; i0 += U * WR) {
    float p[U], vsc[U];
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * WR;
      p[u] = has_chunk && i < cnt ? sc[i] : 0.f;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      vsc[u] = 0.f;
      if (p[u] != 0.f) {
        raw[u] = *reinterpret_cast<const uint4*>(vb + (size_t)i * row);
        if constexpr (C::SCALED) vsc[u] = __bfloat162float(vsb[(size_t)i * KVH]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (p[u] != 0.f) C::axpy(raw[u], vsc[u], p[u], acc);
  }
  // the warp's row groups by a fixed tree (row group rw takes rw + st), then
  // the warps in order; each block's partial output goes to rank 0, which
  // adds them in rank order
#pragma unroll
  for (int st = 1; st < RPW; st <<= 1) {
    const int src = lane + st * NC < 32 ? lane + st * NC : lane;
    const bool take = rw % (2 * st) == 0 && rw + st < RPW;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float o = __shfl_sync(0xffffffffu, acc[j], src);
      if (take) acc[j] += o;
    }
  }
  if (rw == 0) {
#pragma unroll
    for (int j = 0; j < E; ++j) wpart[warp * D + c * E + j] = acc[j];
  }
  __syncthreads();
  float* part0 = cluster.map_shared_rank(part_in, 0) + rank * D;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += wpart[w * D + i];
    part0[i] = o;
  }
  cluster_sync();
  if (rank == 0) {
    for (int i = threadIdx.x; i < D; i += THREADS) {
      float o = 0.f;
      for (int r = 0; r < n_ranks; ++r) o += part_in[r * D + i];
      out[((size_t)b * H + h) * D + i] = C::store(o);
    }
  }
}

// ---- The fp32 body --------------------------------------------------------
//
// A lane's 8 values of a row (NC = D / 8 lanes a row). F32Lanes: the fp32
// cache's 16-byte chunks c and c + NC of the row's 2 NC, so each of a lane's
// two loads is contiguous over the row's lanes. Int8F32Lanes: the int8
// cache's 8 bytes at 8c as exact fp32 values; the kernel applies the row's
// scale to the row's dot and to its weight in PV (the reference multiplies
// each value, f32(k8) * f32(scale), exact in fp32: the same up to the order
// of fp32 rounding).
struct F32Lanes {
  using T = float;
  static constexpr bool SCALED = false;
  static constexpr int U = 2;   // rows a lane has in flight (K and V)
  static constexpr int UV = 4;  // the same, V alone (the rare path)
  struct Raw {
    uint4 a, b;
  };
  template <int NC>
  __device__ __forceinline__ static int col(int c, int j) {
    return j < 4 ? 4 * c + j : 4 * (c + NC) + j - 4;
  }
  template <int NC>
  __device__ __forceinline__ static Raw load(const float* row, int c) {
    const uint4* p = reinterpret_cast<const uint4*>(row);
    return Raw{p[c], p[c + NC]};
  }
  // q . k over a whole row (q and k in shared memory), in four interleaved
  // fp32 sums over the row's values in order
  template <int D>
  __device__ __forceinline__ static float dot_row(const float* q, const float* k) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 kk = reinterpret_cast<const float4*>(k)[i];
      const float4 qq = reinterpret_cast<const float4*>(q)[i];
      a[0] = fmaf(qq.x, kk.x, a[0]);
      a[1] = fmaf(qq.y, kk.y, a[1]);
      a[2] = fmaf(qq.z, kk.z, a[2]);
      a[3] = fmaf(qq.w, kk.w, a[3]);
    }
    return (a[0] + a[1]) + (a[2] + a[3]);
  }
  __device__ __forceinline__ static void values(const Raw& r, float* x) {
    x[0] = __uint_as_float(r.a.x);
    x[1] = __uint_as_float(r.a.y);
    x[2] = __uint_as_float(r.a.z);
    x[3] = __uint_as_float(r.a.w);
    x[4] = __uint_as_float(r.b.x);
    x[5] = __uint_as_float(r.b.y);
    x[6] = __uint_as_float(r.b.z);
    x[7] = __uint_as_float(r.b.w);
  }
};

struct Int8F32Lanes {
  using T = int8_t;
  static constexpr bool SCALED = true;
  static constexpr int U = 4;
  static constexpr int UV = 16;
  using Raw = uint2;
  template <int NC>
  __device__ __forceinline__ static int col(int c, int j) {
    return 8 * c + j;
  }
  template <int NC>
  __device__ __forceinline__ static Raw load(const int8_t* row, int c) {
    return reinterpret_cast<const uint2*>(row)[c];
  }
  template <int D>
  __device__ __forceinline__ static float dot_row(const float* q, const int8_t* k) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(k)[i];
      const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                             raw.w ^ 0x80808080u};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 qq = reinterpret_cast<const float4*>(q)[4 * i + t];
        a[0] = fmaf(qq.x, byte_f32<0>(w[t]), a[0]);
        a[1] = fmaf(qq.y, byte_f32<1>(w[t]), a[1]);
        a[2] = fmaf(qq.z, byte_f32<2>(w[t]), a[2]);
        a[3] = fmaf(qq.w, byte_f32<3>(w[t]), a[3]);
      }
    }
    return (a[0] + a[1]) + (a[2] + a[3]);
  }
  __device__ __forceinline__ static void values(const Raw& r, float* x) {
    const uint32_t w0 = r.x ^ 0x80808080u, w1 = r.y ^ 0x80808080u;
    x[0] = byte_f32<0>(w0);
    x[1] = byte_f32<1>(w0);
    x[2] = byte_f32<2>(w0);
    x[3] = byte_f32<3>(w0);
    x[4] = byte_f32<0>(w1);
    x[5] = byte_f32<1>(w1);
    x[6] = byte_f32<2>(w1);
    x[7] = byte_f32<3>(w1);
  }
};

// (m, l, acc) <- the state of both: the max m of the kept scores, l = the
// sum of exp(s - m) over them and acc = the sum of exp(s - m) v; an empty
// state (l == 0) adds nothing.
__device__ __forceinline__ void merge(float& m, float& l, float* acc, float m2, float l2, const float* acc2) {
  const float mm = fmaxf(m, m2);
  const float wa = l > 0.f ? expf(m - mm) : 0.f;
  const float wb = l2 > 0.f ? expf(m2 - mm) : 0.f;
  l = l * wa + l2 * wb;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = acc[j] * wa + acc2[j] * wb;
  m = mm;
}

// Grid (C, H, B), cluster (C, 1, 1), C = f32_cluster_size; block rank r
// takes the slot groups r, r + C, r + 2C, ... of F32_GROUP slots (at most n =
// f32_slots(S, C) slots), so a cache's live window spreads over the
// cluster's blocks. With `staged` (f32_staged)
// its kept K and V rows are first copied into shared memory. See the notes
// at the top.
template <class L, int NC>  // NC lanes a row: D = 8 * NC
__global__ void __launch_bounds__(THREADS, F32_BLOCKS)
decode_attention_f32_kernel(const float* __restrict__ q, const typename L::T* __restrict__ k_buf,
                            const typename L::T* __restrict__ v_buf,
                            const __nv_bfloat16* __restrict__ k_scale,
                            const __nv_bfloat16* __restrict__ v_scale,
                            const int32_t* __restrict__ mask, float* __restrict__ out, int B, int S,
                            int H, int KVH, int layer, float scale, int scale_query, int staged) {
  using T = typename L::T;
  using Raw = typename L::Raw;
  constexpr int D = 8 * NC;
  constexpr int RPW = 32 / NC;     // rows a warp takes at once
  constexpr int WR = WARPS * RPW;  // rows the block takes at once
  constexpr int U = L::U;
  constexpr int CH = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int KS = f32_k_stride(D, sizeof(T));  // a staged K row's elements
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int n = f32_slots(S, n_ranks);
  const int cnt = f32_slots_of(S, n_ranks, rank);
  cluster_arrive();  // every block runs before any DSMEM store: waited below

  extern __shared__ __align__(16) unsigned char smem[];
  float2* ml_w = reinterpret_cast<float2*>(smem);                           // WARPS
  float2* ml_in = ml_w + WARPS;                                             // MAX_CLUSTER
  T* k_rows = reinterpret_cast<T*>(ml_in + MAX_CLUSTER);                    // n x KS if staged
  T* v_rows = k_rows + (staged ? (size_t)n * KS : 0);                       // n x D if staged
  float* qs = reinterpret_cast<float*>(v_rows + (staged ? (size_t)n * D : 0));  // D if staged
  float* sc = qs + (staged ? D : 0);                                        // n if staged
  float* red = sc + (staged ? n : 0);                                       // WARPS
  float* wpart = red + WARPS;                                               // WARPS x D
  float* part_in = wpart + WARPS * D;                                       // MAX_CLUSTER x D (rank 0's)
  uint32_t* keep = reinterpret_cast<uint32_t*>(part_in + MAX_CLUSTER * D);  // n keep bits
  int* first = reinterpret_cast<int*>(keep + (n + 31) / 32);                // kept slots before a word, if streamed
  int* idx = first + (staged ? 0 : (n + 31) / 32);                          // the kept slots, if streamed
  float* kss = reinterpret_cast<float*>(idx + (staged ? 0 : n));            // n (int8 only)
  float* vss = kss + n;                                                     // n (int8 only)

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = lane % NC;   // this lane's 8 values of a row
  const int rw = lane / NC;  // this lane's row of the warp's RPW (RPW: an idle lane)
  const bool has_row = rw < RPW;
  const int g = warp * RPW + rw;  // this lane's row group: rows g, g + WR, ...
  const size_t row = (size_t)KVH * D;
  const size_t slab = ((size_t)layer * B + b) * S;  // slot 0 of (layer, b)
  // the cache slot of this block's i-th: groups of F32_GROUP slots, every C-th from rank's
  auto slot = [&](int i) { return (size_t)((i / F32_GROUP) * n_ranks + rank) * F32_GROUP + i % F32_GROUP; };
  const T* kb = k_buf + slab * row + (size_t)kvh * D;
  const T* vb = v_buf + slab * row + (size_t)kvh * D;
  const int32_t* mb = mask + (size_t)b * S;

  // one round of loads (KW words a warp in flight): the keep bits, then
  // (int8) the kept slots' scales
  constexpr int KW = 4;
  bool dense = true;  // every slot this thread loaded is kept
  for (int w0 = warp; w0 < (cnt + 31) / 32; w0 += KW * WARPS) {
    int32_t mv[KW];
#pragma unroll
    for (int t = 0; t < KW; ++t) {
      const int i = (w0 + t * WARPS) * 32 + lane;
      mv[t] = i < cnt ? mb[slot(i)] : 0;
      dense = dense && (i >= cnt || mv[t] != 0);
    }
#pragma unroll
    for (int t = 0; t < KW; ++t) {
      const int w = w0 + t * WARPS;
      const uint32_t bits = __ballot_sync(0xffffffffu, mv[t] != 0);
      if (lane == 0 && w < (cnt + 31) / 32) keep[w] = bits;
    }
    if constexpr (L::SCALED) {  // the kept slots' scales (a second round)
      __nv_bfloat16 ks[KW], vs[KW];
#pragma unroll
      for (int t = 0; t < KW; ++t) {
        const int i = (w0 + t * WARPS) * 32 + lane;
        if (mv[t] != 0) {
          ks[t] = k_scale[(slab + slot(i)) * KVH + kvh];
          vs[t] = v_scale[(slab + slot(i)) * KVH + kvh];
        }
      }
#pragma unroll
      for (int t = 0; t < KW; ++t) {
        const int i = (w0 + t * WARPS) * 32 + lane;
        if (mv[t] != 0) {
          kss[i] = __bfloat162float(ks[t]);
          vss[i] = __bfloat162float(vs[t]);
        }
      }
    }
  }
  float qv[8];  // this lane's query values, scaled on the q side
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x = has_row ? q[((size_t)b * H + h) * D + L::template col<NC>(c, j)] : 0.f;
    qv[j] = scale_query ? x * scale : x;
  }
  if (staged) {
    for (int i = threadIdx.x; i < D; i += THREADS) {
      const float x = q[((size_t)b * H + h) * D + i];
      qs[i] = scale_query ? x * scale : x;
    }
  }
  dense = __syncthreads_and(dense);  // the block keeps every one of its slots

  float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  if (staged) {
    // every kept row of K and V in flight at once, 16 bytes a copy over all
    // threads (K rows at a stride of an odd number of 16-byte chunks: pass
    // A's threads read them without bank conflicts)
    for (int t = threadIdx.x; t < cnt * CH; t += THREADS) {
      const int i = t / CH, ch = t % CH;
      if ((keep[i / 32] >> (i % 32)) & 1u) {
        sm90::cp_async16(reinterpret_cast<unsigned char*>(k_rows + (size_t)i * KS) + 16 * ch,
                         reinterpret_cast<const unsigned char*>(kb + slot(i) * row) + 16 * ch, true);
        sm90::cp_async16(reinterpret_cast<unsigned char*>(v_rows + (size_t)i * D) + 16 * ch,
                         reinterpret_cast<const unsigned char*>(vb + slot(i) * row) + 16 * ch, true);
      }
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    __syncthreads();
    // pass A: a thread a slot, its whole dot in four interleaved fp32 sums;
    // the block's max, then e = exp(s - max) in place and their sum
    float mt = -INFINITY;
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      if (!((keep[i / 32] >> (i % 32)) & 1u)) continue;
      float d = L::template dot_row<D>(qs, k_rows + (size_t)i * KS);
      if constexpr (L::SCALED) d *= kss[i];
      const float score = scale_query ? d : d * scale;
      sc[i] = score;
      mt = fmaxf(mt, score);
    }
    m = block_reduce<true>(mt, red);
    float lt = 0.f;
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      const float e = (keep[i / 32] >> (i % 32)) & 1u ? expf(sc[i] - m) : 0.f;
      sc[i] = e;
      lt += e;
    }
    l = block_reduce<false>(lt, red);
    // pass B: PV with NC lanes a row, every row weighted by its e
    for (int i = g; has_row && i < cnt; i += WR) {
      float w = sc[i];
      if (w == 0.f) continue;
      if constexpr (L::SCALED) w *= vss[i];
      float x[8];
      L::values(L::template load<NC>(v_rows + (size_t)i * D, c), x);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(w, x[j], acc[j]);
    }
    // the warp's row groups by a fixed tree (one max: plain sums)
#pragma unroll
    for (int st = 1; st < RPW; st <<= 1) {
      const int src = lane + st * NC < 32 ? lane + st * NC : lane;
      const bool take = rw % (2 * st) == 0 && rw + st < RPW;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float o = __shfl_sync(0xffffffffu, acc[j], src);
        if (take) acc[j] += o;
      }
    }
  } else {
    // streamed: one pass over the block's kept slots (compacted, so a round
    // holds U kept rows a lane, K and V in flight); the row's lanes add their
    // partial dots by a fixed tree and share the score; each lane keeps an
    // online softmax state (m, l, acc) for its 8 columns, rescaled once a
    // round. Masked slots are not read (their exp(finfo.min - M) is 0 unless
    // the whole row is masked: the rare path below).
    // the kept slots in order (unless the block keeps all of them): warp 0
    // counts them before each word, then every word's lanes place theirs
    const int words = (cnt + 31) / 32;
    if (!dense && warp == 0) {
      int base = 0;
      for (int w0 = 0; w0 < words; w0 += 32) {
        const int k = w0 + lane < words ? __popc(keep[w0 + lane]) : 0;
        int incl = k;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += o;
        }
        if (w0 + lane < words) first[w0 + lane] = base + incl - k;
        base += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    if (!dense) {
      __syncthreads();
      for (int w = warp; w < words; w += WARPS) {
        const uint32_t bits = keep[w];
        if ((bits >> lane) & 1u) idx[first[w] + __popc(bits & ((1u << lane) - 1u))] = w * 32 + lane;
      }
      __syncthreads();
    }
    const int n_kept = dense ? cnt : words > 0 ? first[words - 1] + __popc(keep[words - 1]) : 0;
    for (int k0 = 0; k0 * WR < n_kept; k0 += U) {
      Raw kr[U], vr[U];
      int ix[U];  // the round's slots (-1: none)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = g + (k0 + u) * WR;
        ix[u] = has_row && j < n_kept ? (dense ? j : idx[j]) : -1;
        kr[u] = {};
        vr[u] = {};
        if (ix[u] >= 0) {
          kr[u] = L::template load<NC>(kb + slot(ix[u]) * row, c);
          vr[u] = L::template load<NC>(vb + slot(ix[u]) * row, c);
        }
      }
      float s[U];
      float mm = m;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x[8], d = 0.f;
        L::values(kr[u], x);
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(qv[j], x[j], d);
#pragma unroll
        for (int st = 1; st < NC; st <<= 1) {
          const float o = __shfl_down_sync(0xffffffffu, d, st);
          if ((c & (2 * st - 1)) == 0 && c + st < NC) d += o;
        }
        d = __shfl_sync(0xffffffffu, d, lane - c);  // the row's lane 0 holds its dot
        if (ix[u] < 0) continue;
        if constexpr (L::SCALED) d *= kss[ix[u]];
        s[u] = scale_query ? d : d * scale;
        mm = fmaxf(mm, s[u]);
      }
      // the round's rows under one new max: one rescale a round
      const float a = l > 0.f ? expf(m - mm) : 0.f;
      l *= a;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] *= a;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ix[u] < 0) continue;
        const float e = expf(s[u] - mm);
        float w = e;
        if constexpr (L::SCALED) w *= vss[ix[u]];
        float x[8];
        L::values(vr[u], x);
        l += e;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(w, x[j], acc[j]);
      }
      m = mm;
    }
    // the warp's row groups by a fixed tree
#pragma unroll
    for (int st = 1; st < RPW; st <<= 1) {
      const int src = lane + st * NC < 32 ? lane + st * NC : lane;
      const float m2 = __shfl_sync(0xffffffffu, m, src);
      const float l2 = __shfl_sync(0xffffffffu, l, src);
      float acc2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc2[j] = __shfl_sync(0xffffffffu, acc[j], src);
      if (rw % (2 * st) == 0 && rw + st < RPW) merge(m, l, acc, m2, l2, acc2);
    }
  }
  // then the warps in order, each weighted to the block's max (staged: one
  // max already)
  if (rw == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) wpart[warp * D + L::template col<NC>(c, j)] = acc[j];
    if (c == 0) ml_w[warp] = make_float2(m, l);
  }
  __syncthreads();
  float m_blk = m, l_blk = l, wgt[WARPS];
#pragma unroll
  for (int w = 0; w < WARPS; ++w) wgt[w] = 1.f;
  if (!staged) {
    m_blk = -INFINITY;
    l_blk = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (ml_w[w].y > 0.f) m_blk = fmaxf(m_blk, ml_w[w].x);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      wgt[w] = ml_w[w].y > 0.f ? expf(ml_w[w].x - m_blk) : 0.f;
      l_blk += ml_w[w].y * wgt[w];
    }
  }

  // one exchange: every block's (m, l) into every block, its partial output
  // (weighted to its own max) into rank 0
  cluster_wait();
  if (threadIdx.x < n_ranks)
    cluster.map_shared_rank(ml_in, (int)threadIdx.x)[rank] = make_float2(m_blk, l_blk);
  float* part0 = cluster.map_shared_rank(part_in, 0) + rank * D;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += wpart[w * D + i] * wgt[w];
    part0[i] = o;
  }
  cluster_sync();
  bool none = true;  // no slot of the row is kept
  for (int r = 0; r < n_ranks; ++r) none = none && !(ml_in[r].y > 0.f);
  if (!none) {
    // rank 0: the cluster's max M and sum L in rank order; out = the ranks'
    // outputs weighted by exp(m_r - M), added in rank order, over L
    if (rank == 0) {
      float m_all = -INFINITY;
      for (int r = 0; r < n_ranks; ++r)
        if (ml_in[r].y > 0.f) m_all = fmaxf(m_all, ml_in[r].x);
      float l_all = 0.f;
      for (int r = 0; r < n_ranks; ++r)
        if (ml_in[r].y > 0.f) l_all += ml_in[r].y * expf(ml_in[r].x - m_all);
      for (int i = threadIdx.x; i < D; i += THREADS) {
        float o = 0.f;
        for (int r = 0; r < n_ranks; ++r)
          if (ml_in[r].y > 0.f) o += part_in[r * D + i] * expf(ml_in[r].x - m_all);
        out[((size_t)b * H + h) * D + i] = o / l_all;
      }
    }
    return;
  }

  // the rare path, a row with no kept slot: every score is finfo.min, so p =
  // 1 / S for every slot and the output is the uniform average of all S V
  // rows, read from global memory; the same lanes, trees and rank order
  const float p = 1.f / (float)S;
  constexpr int UV = L::UV;
  if constexpr (L::SCALED) {  // int8: every slot's V scale first, in one round
    for (int i = threadIdx.x; i < cnt; i += THREADS)
      vss[i] = __bfloat162float(v_scale[(slab + slot(i)) * KVH + kvh]);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 * WR < cnt; k0 += UV) {
    Raw vr[UV];
    float vsc[UV];
#pragma unroll
    for (int u = 0; u < UV; ++u) {
      const int i = g + (k0 + u) * WR;
      vr[u] = {};
      vsc[u] = 0.f;
      if (has_row && i < cnt) {
        vr[u] = L::template load<NC>(vb + slot(i) * row, c);
        if constexpr (L::SCALED) vsc[u] = vss[i];
      }
    }
#pragma unroll
    for (int u = 0; u < UV; ++u) {
      if (!(has_row && g + (k0 + u) * WR < cnt)) continue;
      const float w = L::SCALED ? p * vsc[u] : p;
      float x[8];
      L::values(vr[u], x);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(w, x[j], acc[j]);
    }
  }
#pragma unroll
  for (int st = 1; st < RPW; st <<= 1) {
    const int src = lane + st * NC < 32 ? lane + st * NC : lane;
    const bool take = rw % (2 * st) == 0 && rw + st < RPW;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float o = __shfl_sync(0xffffffffu, acc[j], src);
      if (take) acc[j] += o;
    }
  }
  if (rw == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) wpart[warp * D + L::template col<NC>(c, j)] = acc[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += THREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += wpart[w * D + i];
    part0[i] = o;
  }
  cluster_sync();
  if (rank == 0) {
    for (int i = threadIdx.x; i < D; i += THREADS) {
      float o = 0.f;
      for (int r = 0; r < n_ranks; ++r) o += part_in[r * D + i];
      out[((size_t)b * H + h) * D + i] = o;
    }
  }
}

template <class C, int NC>
int launch(const void* q, const void* k_buf, const void* v_buf, const void* k_scale,
           const void* v_scale, const void* mask, void* out, int B, int S, int H, int KVH,
           int layer, float scale, int scale_query, cudaStream_t stream) {
  const size_t smem = smem_bytes(S, NC * C::E, C::E);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<C, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  decode_attention_kernel<C, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const typename C::T*>(k_buf),
      static_cast<const typename C::T*>(v_buf), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int32_t*>(mask),
      static_cast<__nv_bfloat16*>(out), B, S, H, KVH, layer, scale, scale_query);
  return (int)cudaGetLastError();
}

template <class C, int NC>
int launch_split(const void* q, const void* k_buf, const void* v_buf, const void* k_scale,
                 const void* v_scale, const void* mask, void* out, int B, int S, int H, int KVH,
                 int layer, float scale, int scale_query, cudaStream_t stream) {
  const int cl = cluster_size(B, H, S);
  const size_t smem = split_smem_bytes(S, NC * C::E, cl);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_split_kernel<C, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attention_split_kernel<C, NC>,
                           static_cast<const typename C::Q*>(q),
                           static_cast<const typename C::T*>(k_buf),
                           static_cast<const typename C::T*>(v_buf),
                           static_cast<const __nv_bfloat16*>(k_scale),
                           static_cast<const __nv_bfloat16*>(v_scale),
                           static_cast<const int32_t*>(mask), static_cast<typename C::Q*>(out), B,
                           S, H, KVH, layer, scale, scale_query);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class L, int NC>
int launch_f32(const void* q, const void* k_buf, const void* v_buf, const void* k_scale,
               const void* v_scale, const void* mask, void* out, int B, int S, int H, int KVH,
               int layer, float scale, int scale_query, cudaStream_t stream) {
  constexpr int D = 8 * NC;
  const int cl = f32_cluster_size(B, H, S);
  const bool staged = f32_staged(B, H, S, D, L::SCALED);
  const size_t smem = f32_smem_bytes(S, D, cl, L::SCALED, staged);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_f32_kernel<L, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(decode_attention_f32_kernel<L, NC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attention_f32_kernel<L, NC>, static_cast<const float*>(q),
                           static_cast<const typename L::T*>(k_buf),
                           static_cast<const typename L::T*>(v_buf),
                           static_cast<const __nv_bfloat16*>(k_scale),
                           static_cast<const __nv_bfloat16*>(v_scale),
                           static_cast<const int32_t*>(mask), static_cast<float*>(out), B, S, H,
                           KVH, layer, scale, scale_query, (int)staged);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#define EILEV_CASE(C, NC)                                                                    \
  case NC:                                                                                   \
    return launch<C, NC>(q, k_buf, v_buf, k_scale, v_scale, mask, out, B, S, H, KVH, layer, \
                         scale, scale_query, st);
#define EILEV_SPLIT_CASE(C, NC)                                                                    \
  case NC:                                                                                         \
    return launch_split<C, NC>(q, k_buf, v_buf, k_scale, v_scale, mask, out, B, S, H, KVH, layer, \
                               scale, scale_query, st);

#define EILEV_F32_CASE(L, NC)                                                                    \
  case NC:                                                                                       \
    return launch_f32<L, NC>(q, k_buf, v_buf, k_scale, v_scale, mask, out, B, S, H, KVH, layer, \
                             scale, scale_query, st);

}  // namespace

// q: (B, H*D) in the model dtype, bf16 or fp32 (f32 = 1); k_buf/v_buf: (L,
// B, S, KVH*D) in the model dtype, or int8 (int8 = 1) with k_scale/v_scale
// (L, B, S, KVH) bf16 (NULL for a model-dtype cache); mask: (B, S) int32;
// out: (B, H*D) in the model dtype. All contiguous, q and the cache 16-byte
// aligned. Requires H % KVH == 0, D <= 128 and D % 8 == 0 (a model-dtype
// cache) or D % 16 == 0 (int8). `scale` is already rounded to the model
// dtype. Returns the launch's cudaError_t (0 on success); launches on
// `stream`, no synchronise.
extern "C" int eilev_decode_attention(const void* q, const void* k_buf, const void* v_buf,
                                      const void* k_scale, const void* v_scale, const void* mask,
                                      void* out, int B, int S, int H, int KVH, int D, int layer,
                                      float scale, int scale_query, int int8, int f32,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH != 0 || D % (int8 ? 16 : 8) != 0 || D > 128 || S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  if (int8 && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (f32) {  // the fp32 body: 8 values a lane, D / 8 lanes a row
    if (f32_smem_bytes(S, D, f32_cluster_size(B, H, S), int8, false) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    if (int8) {
      switch (D / 8) {
        EILEV_F32_CASE(Int8F32Lanes, 2)
        EILEV_F32_CASE(Int8F32Lanes, 4)
        EILEV_F32_CASE(Int8F32Lanes, 6)
        EILEV_F32_CASE(Int8F32Lanes, 8)
        EILEV_F32_CASE(Int8F32Lanes, 10)
        EILEV_F32_CASE(Int8F32Lanes, 12)
        EILEV_F32_CASE(Int8F32Lanes, 14)
        EILEV_F32_CASE(Int8F32Lanes, 16)
        default: return (int)cudaErrorInvalidValue;
      }
    }
    switch (D / 8) {
      EILEV_F32_CASE(F32Lanes, 1)
      EILEV_F32_CASE(F32Lanes, 2)
      EILEV_F32_CASE(F32Lanes, 3)
      EILEV_F32_CASE(F32Lanes, 4)
      EILEV_F32_CASE(F32Lanes, 5)
      EILEV_F32_CASE(F32Lanes, 6)
      EILEV_F32_CASE(F32Lanes, 7)
      EILEV_F32_CASE(F32Lanes, 8)
      EILEV_F32_CASE(F32Lanes, 9)
      EILEV_F32_CASE(F32Lanes, 10)
      EILEV_F32_CASE(F32Lanes, 11)
      EILEV_F32_CASE(F32Lanes, 12)
      EILEV_F32_CASE(F32Lanes, 13)
      EILEV_F32_CASE(F32Lanes, 14)
      EILEV_F32_CASE(F32Lanes, 15)
      EILEV_F32_CASE(F32Lanes, 16)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const bool split = int8 || k3_split(B, H, S);
  if (split ? split_smem_bytes(S, D, cluster_size(B, H, S)) > SMEM_LIMIT
            : smem_bytes(S, D, Bf16Cache::E) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (int8) {
    switch (D / Int8Cache::E) {
      EILEV_SPLIT_CASE(Int8Cache, 1)
      EILEV_SPLIT_CASE(Int8Cache, 2)
      EILEV_SPLIT_CASE(Int8Cache, 3)
      EILEV_SPLIT_CASE(Int8Cache, 4)
      EILEV_SPLIT_CASE(Int8Cache, 5)
      EILEV_SPLIT_CASE(Int8Cache, 6)
      EILEV_SPLIT_CASE(Int8Cache, 7)
      EILEV_SPLIT_CASE(Int8Cache, 8)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  k_scale = v_scale = nullptr;
  if (split) {
    switch (D / Bf16Cache::E) {
      EILEV_SPLIT_CASE(Bf16Cache, 1)
      EILEV_SPLIT_CASE(Bf16Cache, 2)
      EILEV_SPLIT_CASE(Bf16Cache, 3)
      EILEV_SPLIT_CASE(Bf16Cache, 4)
      EILEV_SPLIT_CASE(Bf16Cache, 5)
      EILEV_SPLIT_CASE(Bf16Cache, 6)
      EILEV_SPLIT_CASE(Bf16Cache, 7)
      EILEV_SPLIT_CASE(Bf16Cache, 8)
      EILEV_SPLIT_CASE(Bf16Cache, 9)
      EILEV_SPLIT_CASE(Bf16Cache, 10)
      EILEV_SPLIT_CASE(Bf16Cache, 11)
      EILEV_SPLIT_CASE(Bf16Cache, 12)
      EILEV_SPLIT_CASE(Bf16Cache, 13)
      EILEV_SPLIT_CASE(Bf16Cache, 14)
      EILEV_SPLIT_CASE(Bf16Cache, 15)
      EILEV_SPLIT_CASE(Bf16Cache, 16)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D / Bf16Cache::E) {
    EILEV_CASE(Bf16Cache, 1)
    EILEV_CASE(Bf16Cache, 2)
    EILEV_CASE(Bf16Cache, 3)
    EILEV_CASE(Bf16Cache, 4)
    EILEV_CASE(Bf16Cache, 5)
    EILEV_CASE(Bf16Cache, 6)
    EILEV_CASE(Bf16Cache, 7)
    EILEV_CASE(Bf16Cache, 8)
    EILEV_CASE(Bf16Cache, 9)
    EILEV_CASE(Bf16Cache, 10)
    EILEV_CASE(Bf16Cache, 11)
    EILEV_CASE(Bf16Cache, 12)
    EILEV_CASE(Bf16Cache, 13)
    EILEV_CASE(Bf16Cache, 14)
    EILEV_CASE(Bf16Cache, 15)
    EILEV_CASE(Bf16Cache, 16)
    default: return (int)cudaErrorInvalidValue;
  }
}
