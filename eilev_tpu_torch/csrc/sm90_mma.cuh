// Warp-level tensor-core and async-copy helpers shared by the port's kernels
// (flash_attention.cu, packed_attention.cu, fused_mlp.cu; decode_attention.cu's
// fp32 body the async copies), for sm_90a.
//
// mma.sync m16n8k16 with bf16 operands and fp32 accumulation. Fragment
// layout (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with lane = 4g + t:
//   A (16 x 16, row): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                     a3 = (g+8, 2t+8..), two bf16 per register;
//   B (16 x 8, col):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g);
//   C (16 x 8, fp32): c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// So the C layout of two neighbouring 8-column tiles, packed to bf16 pairs,
// is the A layout of one 16-deep operand: scores become probabilities for a
// second product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without staging in registers; zero-filled when
// !valid (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Four 8x8 b16 matrices from the mma C layout (thread 4g + t holds row g,
// columns 2t..2t+1 of each) to shared memory; lane l gives the row address
// of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(void* p, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_addr(p)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to nearest bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two bf16 of a packed pair, exactly, as floats.
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

}  // namespace sm90
