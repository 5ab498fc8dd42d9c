// Decode-step attention over the stacked KV cache for Hopper (sm_90a).
//
// Replaces the Pallas kernel eilev_tpu/ops/decode_attention.py:117
// decode_attention_stacked, both of its bodies:
//   K3 _kernel_bf16 (:42) - a bf16 cache;
//   K4 _kernel_int8 (:75) - an int8 cache with bf16 per-(position, kv-head)
//      scales, dequantized to bf16 before each dot.
// One new query token (B, H*D) attends against layer `layer` of the stacked
// (L, B, S, KVH*D) cache under a (B, S) keep-mask; head h reads kv head
// h / (H / KVH) (grouped-query attention); the query is scaled on the q side
// (HF OPT) or the scores on the score side (HF LLaMA). Output (B, H*D) bf16.
//
// What bounds it on the H100: bytes. A decode step reads every cache row once
// and does 2 flops per element read, far below the ~295 flops per byte where
// the tensor cores would matter. At the flagship shape (B=4, S=798, 32 heads
// x 80) one call reads 32.7 MB of bf16 K+V (16.3 MB int8 + 0.2 MB scales):
// ~10 us at 3.35 TB/s. So no tensor cores, and every byte is read once.
//
// Design (first version, right before fast):
//   * One block of 256 threads per (head, batch row). Each head of a GQA
//     group re-reads its kv head's rows; for OPT the groups are 1.
//   * `layer` is a run-time pointer offset into the stacked buffers, so no
//     per-layer slice is materialized (the Pallas kernel's static block index).
//   * Pass 1: one key row per thread, read with 16-byte loads (8 bf16 or 16
//     int8 values each; every head's offset is a multiple of 16 bytes when
//     D % 8 == 0, or D % 16 == 0 for int8, which the Python wrapper checks),
//     dotted in fp32 with the query kept in shared memory. The S fp32 scores
//     stay in shared memory (3.2 KB at S=798; the wrapper refuses an S whose
//     scores do not fit in 227 KB). Masked slots are not read.
//   * Block-wide max and sum, then the probabilities rounded to bf16 in place.
//     The reference rounds the NORMALISED probabilities before PV, which an
//     online-softmax rescale of the output cannot reproduce: hence two passes.
//   * Pass 2 (PV): thread t owns 16-byte chunk t % NC of every G-th row
//     (G = 256 / NC), so a warp reads whole rows; 8 rows (and their int8
//     scales) are loaded before any is used, to keep loads in flight. Partial sums go through shared
//     memory and are added in a fixed order.
//   * Rounding points follow the reference exactly: q * bf16(scale) rounded
//     to bf16 (q side) or the bf16 scores times bf16(scale) rounded (score
//     side); QK^T in fp32 rounded to bf16; masked scores -inf (what
//     finfo(float32).min becomes in bf16); fp32 softmax; p rounded to bf16;
//     PV in fp32. int8: k = bf16(f32(k8) * f32(scale)), the same for v.
//   * A fully masked row has max -inf, so exp gives NaN and the output row is
//     NaN, as in the reference. Slots with p == 0 are skipped in PV; a NaN p
//     is not, so the NaN reaches the output.
//   * At B=1 this launches only H=32 blocks on 132 SMs. Splitting S over
//     several blocks per head (flash-decoding) is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PV_ROWS = 8;  // rows of V each thread loads before using them

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One 16-byte chunk of a cache row as model-dtype values in fp32.
struct Bf16Cache {
  using T = __nv_bfloat16;
  static constexpr int E = 8;  // elements per chunk
  __device__ __forceinline__ static void unpack(const uint4& raw, float, float* out) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < E; ++j) out[j] = __bfloat162float(e[j]);
  }
};

struct Int8Cache {
  using T = int8_t;
  static constexpr int E = 16;
  __device__ __forceinline__ static void unpack(const uint4& raw, float scale, float* out) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < E; ++j) out[j] = round_bf16(static_cast<float>(e[j]) * scale);
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

size_t smem_bytes(int S, int D, int E) {
  // scores, scaled query, PV partial sums (at most THREADS * E), reduction
  return sizeof(float) * ((size_t)S + D + (size_t)THREADS * E + 32);
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

#define EILEV_CASE(C, NC)                                                                    \
  case NC:                                                                                   \
    return launch<C, NC>(q, k_buf, v_buf, k_scale, v_scale, mask, out, B, S, H, KVH, layer, \
                         scale, scale_query, st);

}  // namespace

// q: (B, H*D) bf16; k_buf/v_buf: (L, B, S, KVH*D) bf16, or int8 with
// k_scale/v_scale (L, B, S, KVH) bf16 (NULL for a bf16 cache); mask: (B, S)
// int32; out: (B, H*D) bf16. All contiguous, q and the cache 16-byte aligned.
// Requires H % KVH == 0, D <= 128 and D % 8 == 0 (bf16) or D % 16 == 0
// (int8). `scale` is already rounded to bf16. Returns the launch's
// cudaError_t (0 on success); launches on `stream`, no synchronise.
extern "C" int eilev_decode_attention(const void* q, const void* k_buf, const void* v_buf,
                                      const void* k_scale, const void* v_scale, const void* mask,
                                      void* out, int B, int S, int H, int KVH, int D, int layer,
                                      float scale, int scale_query, int int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int E = int8 ? Int8Cache::E : Bf16Cache::E;
  if (KVH <= 0 || H % KVH != 0 || D % E != 0 || D > 128 || S <= 0 ||
      smem_bytes(S, D, E) > 232448 || (int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (int8) {
    switch (D / E) {
      EILEV_CASE(Int8Cache, 1)
      EILEV_CASE(Int8Cache, 2)
      EILEV_CASE(Int8Cache, 3)
      EILEV_CASE(Int8Cache, 4)
      EILEV_CASE(Int8Cache, 5)
      EILEV_CASE(Int8Cache, 6)
      EILEV_CASE(Int8Cache, 7)
      EILEV_CASE(Int8Cache, 8)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  k_scale = v_scale = nullptr;
  switch (D / E) {
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
