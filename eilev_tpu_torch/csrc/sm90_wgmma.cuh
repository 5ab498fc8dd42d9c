// Hopper-only helpers (sm_90a): TMA tile loads, mbarriers, wgmma with
// 128-byte-swizzled shared-memory operands, and on the host the tensor maps
// of heads cut into 64-column halves. Used by flash_attention.cu,
// packed_attention.cu and fused_mlp.cu.
//
// Shared-memory tiles are written by TMA with CU_TENSOR_MAP_SWIZZLE_128B: a
// tile of R rows x 64 bf16 (128 bytes a row) whose 16-byte chunk c of row r
// lands at chunk c ^ (r % 8). Tiles start on 1024-byte boundaries, so the
// pattern's phase is the same for TMA and for the wgmma descriptors below
// (base offset 0).
//
// wgmma m64nNk16 register layouts (PTX ISA, "Matrix Fragments for
// wgmma.mma_async"), thread t of the warpgroup, warp w = t / 32, lane
// l = 4g + q:
//   D (fp32): d[4i + 0, 1] = (row 16w + g, cols 8i + 2q, +1),
//             d[4i + 2, 3] = (row 16w + g + 8, the same cols);
//   A (bf16, registers, 64 x 16): a0 = (16w + g, k 2q..2q+1),
//             a1 = (16w + g + 8, k 2q..), a2 = (16w + g, k 2q+8..),
//             a3 = (16w + g + 8, k 2q+8..).
// So the D fragment of two neighbouring 8-column tiles, packed to bf16
// pairs, is the A fragment of one 16-deep step: scores become the A operand
// of the next product without leaving registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace sm90 {

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic on this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Spins until the barrier's phase with parity `parity` has completed. A wait
// that lasts ~2^35 cycles (over 10 s) can only be a broken pipeline: it traps,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// ---- TMA --------------------------------------------------------------------

// A 4-d tile of `map` at coordinates (c0 innermost .. c3) into shared memory;
// completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 3-d tile of `map` at coordinates (c0 innermost, c1, c2) into shared
// memory; completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A 2-d tile of `map` at coordinates (c0 innermost, c1) into shared memory;
// completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4), layout type 1 (B128).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// The same for a tile whose rows are W bf16 wide (128, 64 or 32 bytes)
// under the swizzle of that width (layout types 1, 2 and 3: B128, B64,
// B32), as TMA writes it (make_head_map with box_cols W): 8-row groups
// 16 W bytes apart.
template <int W>
__device__ __forceinline__ uint64_t wgmma_desc_w(const void* p, uint32_t lbo_bytes) {
  static_assert(W == 64 || W == 32 || W == 16, "rows of 128, 64 or 32 bytes");
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(((16 * W) >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)(W == 64 ? 1 : W == 32 ? 2 : 3) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define EILEV_WG_REGS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define EILEV_WG_D8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define EILEV_WG_D64                                                                         \
  EILEV_WG_D8(0), EILEV_WG_D8(8), EILEV_WG_D8(16), EILEV_WG_D8(24), EILEV_WG_D8(32),         \
      EILEV_WG_D8(40), EILEV_WG_D8(48), EILEV_WG_D8(56)

// d (64 x 128, fp32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x 128,
// bf16, shared, K-major: 128 rows of k). accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " EILEV_WG_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : EILEV_WG_D64
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 16, fp32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x 16,
// bf16, shared, K-major: 16 rows of k). accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n16k16_ss(float* d, uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : EILEV_WG_D8(0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, fp32) += A (64 x 16, bf16, registers) * B (16 x 128, bf16,
// shared, MN-major: k rows of 128 n, the transposed operand).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " EILEV_WG_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : EILEV_WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16,
// shared, MN-major: k rows of 64 n, the transposed operand).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : EILEV_WG_D8(0), EILEV_WG_D8(8), EILEV_WG_D8(16), EILEV_WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16, registers) * B (16 x 32, bf16,
// shared, MN-major).
__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : EILEV_WG_D8(0), EILEV_WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 16, fp32) += A (64 x 16, bf16, registers) * B (16 x 16, bf16,
// shared, MN-major).
__device__ __forceinline__ void wgmma_m64n16k16_rs_tb(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : EILEV_WG_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x N, fp32) += A (64 x 16, registers) * B (16 x N, shared, MN-major)
// for N = 16, 32, 64 or 128 (flash_attention.cu's PV at head dim N,
// packed_attention.cu's at each part of a head).
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float* d, const uint32_t* a, uint64_t desc_b) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_rs_tb: N is 16, 32, 64 or 128");
  if constexpr (N == 128) wgmma_m64n128k16_rs_tb(d, a, desc_b);
  else if constexpr (N == 64) wgmma_m64n64k16_rs_tb(d, a, desc_b);
  else if constexpr (N == 32) wgmma_m64n32k16_rs_tb(d, a, desc_b);
  else wgmma_m64n16k16_rs_tb(d, a, desc_b);
}

// d (64 x N, fp32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x N,
// bf16, shared, MN-major: k rows of N, the transposed operand, as a
// row-major (K, N) weight is stored). accumulate == 0 overwrites d. One
// instance per N used (fused_mlp.cu: 128), N / 2 accumulators a thread.
template <int N>
__device__ __forceinline__ void wgmma_ss_tb(float* d, uint64_t desc_a, uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss_tb<128>(float* d, uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x N, fp32) (+)= A (64 x 8, tf32, shared, K-major) * B (8 x N, tf32,
// shared, K-major: N rows of 8 k; tf32 has no transposed form).
// accumulate == 0 overwrites d. One instance per N used (fused_mlp.cu: 128).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t desc_a, uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Pins R accumulator registers at this point of the program: reads and
// writes of d are not moved across it (around wgmma issue and wait).
template <int R>
__device__ __forceinline__ void wgmma_pin(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence_operand(float* d) { wgmma_pin<64>(d); }

#undef EILEV_WG_REGS64
#undef EILEV_WG_D8
#undef EILEV_WG_D64

// ---- host: tensor maps ---------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, found once through the runtime (no
// -lcuda at link time).
inline EncodeTiled encode_tiled() {
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

// A (D, heads, rows, batch) map of bf16 rows that hold `heads` heads of D
// columns each (row stride rs and batch stride bs in elements), in swizzled
// (box_cols x 1 x box_rows x 1) boxes: box_cols columns of box_rows rows of
// one head, under the swizzle as wide as a box row (64 columns: 128 bytes,
// 32: 64, 16: 32). Columns past D and rows past `rows` read as zeros: a head
// of D = 80 is a 64-column part and a 16-column one (or, in 64-column boxes,
// 16 columns and 48 zeros), and a box that runs past the last row never
// reads the next batch row's.
inline bool make_head_map(CUtensorMap* map, EncodeTiled fn, const void* base, int D, int heads, int rows,
                          int batch, long long rs, long long bs, int box_rows, int box_cols = 64) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)rs * 2,
                                 (cuuint64_t)(batch > 1 ? bs : (long long)rows * rs) * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
