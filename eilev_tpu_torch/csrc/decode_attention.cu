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
// Two bodies:
//   * The split (decode_attention_split_kernel): every int8 call, every fp32
//     call, and the bf16 calls the written rule k3_split gives it.
//   * One block of 256 threads per (head, batch row) (decode_attention_kernel),
//     bf16 cache only, for the bf16 calls the rule does not split.
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
//     16-byte chunk, whether a row has a scale, dot and axpy. Four types:
//     Bf16Cache (K3), F32Cache (K3 with an fp32 model, E = 4, NC <= 32),
//     Int8Cache (K4) and Int8F32Cache (K4 with an fp32 model).
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

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PV_ROWS = 8;  // rows of V each thread loads before using them
constexpr int SMS = 132;    // H100 SXM
constexpr int MAX_CLUSTER = 8;

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

struct F32Model {
  using Q = float;
  __device__ __forceinline__ static float load(Q x) { return x; }
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static Q store(float x) { return x; }
  __device__ __forceinline__ static float masked() { return -FLT_MAX; }
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

// An fp32 cache (an fp32 model): 4 values a chunk, no scale.
struct F32Cache : F32Model {
  using T = float;
  static constexpr int E = 4;
  static constexpr bool SCALED = false;
  __device__ __forceinline__ static float dot(const uint4& raw, float, const float* q, float acc) {
    acc = fmaf(q[0], __uint_as_float(raw.x), acc);
    acc = fmaf(q[1], __uint_as_float(raw.y), acc);
    acc = fmaf(q[2], __uint_as_float(raw.z), acc);
    return fmaf(q[3], __uint_as_float(raw.w), acc);
  }
  __device__ __forceinline__ static void axpy(const uint4& raw, float, float p, float* acc) {
    acc[0] = fmaf(p, __uint_as_float(raw.x), acc[0]);
    acc[1] = fmaf(p, __uint_as_float(raw.y), acc[1]);
    acc[2] = fmaf(p, __uint_as_float(raw.z), acc[2]);
    acc[3] = fmaf(p, __uint_as_float(raw.w), acc[3]);
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

// An int8 chunk with an fp32 model: f32(k8) * f32(scale), exact in fp32 and
// not rounded further (astype(float32) is the identity).
struct Int8F32Cache : F32Model {
  using T = int8_t;
  static constexpr int E = 16;
  static constexpr bool SCALED = true;
  __device__ __forceinline__ static void dequant(const uint4& raw, float scale, float* out) {
    uint32_t w[4];
    unbias(raw, w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[4 * i] = byte_f32<0>(w[i]) * scale;
      out[4 * i + 1] = byte_f32<1>(w[i]) * scale;
      out[4 * i + 2] = byte_f32<2>(w[i]) * scale;
      out[4 * i + 3] = byte_f32<3>(w[i]) * scale;
    }
  }
  __device__ __forceinline__ static float dot(const uint4& raw, float scale, const float* q, float acc) {
    float k[E];
    dequant(raw, scale, k);
#pragma unroll
    for (int j = 0; j < E; ++j) acc = fmaf(q[j], k[j], acc);
    return acc;
  }
  __device__ __forceinline__ static void axpy(const uint4& raw, float scale, float p, float* acc) {
    float v[E];
    dequant(raw, scale, v);
#pragma unroll
    for (int j = 0; j < E; ++j) acc[j] = fmaf(p, v[j], acc[j]);
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

#define EILEV_CASE(C, NC)                                                                    \
  case NC:                                                                                   \
    return launch<C, NC>(q, k_buf, v_buf, k_scale, v_scale, mask, out, B, S, H, KVH, layer, \
                         scale, scale_query, st);
#define EILEV_SPLIT_CASE(C, NC)                                                                    \
  case NC:                                                                                         \
    return launch_split<C, NC>(q, k_buf, v_buf, k_scale, v_scale, mask, out, B, S, H, KVH, layer, \
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
  const bool split = int8 || f32 || k3_split(B, H, S);
  if (split ? split_smem_bytes(S, D, cluster_size(B, H, S)) > 232448
            : smem_bytes(S, D, Bf16Cache::E) > 232448)
    return (int)cudaErrorInvalidValue;
  if (int8 && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (int8 && f32) {
    switch (D / Int8F32Cache::E) {
      EILEV_SPLIT_CASE(Int8F32Cache, 1)
      EILEV_SPLIT_CASE(Int8F32Cache, 2)
      EILEV_SPLIT_CASE(Int8F32Cache, 3)
      EILEV_SPLIT_CASE(Int8F32Cache, 4)
      EILEV_SPLIT_CASE(Int8F32Cache, 5)
      EILEV_SPLIT_CASE(Int8F32Cache, 6)
      EILEV_SPLIT_CASE(Int8F32Cache, 7)
      EILEV_SPLIT_CASE(Int8F32Cache, 8)
      default: return (int)cudaErrorInvalidValue;
    }
  }
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
  if (f32) {  // D % 8 == 0: an even number of 4-value chunks
    switch (D / F32Cache::E) {
      EILEV_SPLIT_CASE(F32Cache, 2)
      EILEV_SPLIT_CASE(F32Cache, 4)
      EILEV_SPLIT_CASE(F32Cache, 6)
      EILEV_SPLIT_CASE(F32Cache, 8)
      EILEV_SPLIT_CASE(F32Cache, 10)
      EILEV_SPLIT_CASE(F32Cache, 12)
      EILEV_SPLIT_CASE(F32Cache, 14)
      EILEV_SPLIT_CASE(F32Cache, 16)
      EILEV_SPLIT_CASE(F32Cache, 18)
      EILEV_SPLIT_CASE(F32Cache, 20)
      EILEV_SPLIT_CASE(F32Cache, 22)
      EILEV_SPLIT_CASE(F32Cache, 24)
      EILEV_SPLIT_CASE(F32Cache, 26)
      EILEV_SPLIT_CASE(F32Cache, 28)
      EILEV_SPLIT_CASE(F32Cache, 30)
      EILEV_SPLIT_CASE(F32Cache, 32)
      default: return (int)cudaErrorInvalidValue;
    }
  }
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
