// 3xTF32: fp32-accurate products on Hopper's TF32 tensor cores (sm_90a),
// shared by attention_f32.cu (the fp32 attention body) and fused_mlp.cu (K6's
// fp32 body).
//
// One TF32 product keeps 10 explicit mantissa bits an operand, too few for
// the 1e-4 an fp32 model's reference is held to. Every operand x is split as
// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (x = hi + lo to ~2^-22),
// and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b with fp32 sums, each an
// mma.sync m16n8k8 tf32, the small terms first; lo lo (~2^-22 of the
// product) is dropped. cvt.rna is four instructions (add, |x| < inf test,
// select, mask): a kernel splits each value once, where it lands in shared
// memory, into records in the mma's fragment order, not in every warp that
// reads it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative, hi and lo each a tf32 rounded to nearest
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// A record: the two B values of one lane for one (8-wide n block, 8-deep k
// step), split: {hi(b0), hi(b1), lo(b0), lo(b1)}
__device__ __forceinline__ float4 record(float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0), __uint_as_float(l1));
}

// c (16 x 8) += a (16 x 8, row) b (8 x 8, col), tf32 operands, fp32 sums.
// Layout, lane = 4g + t: a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
// a3 = (g + 8, t + 4); b0 = (k t, n g), b1 = (k t + 4, n g); c0, c1 = (g,
// 2t..2t + 1), c2, c3 = (g + 8, 2t..2t + 1).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// c += a b to fp32 accuracy (3xTF32), b a split record: the two cross terms,
// then hi x hi
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_hi, const uint32_t* a_lo, float4 b) {
  mma_tf32(c, a_lo, b.x, b.y);
  mma_tf32(c, a_hi, b.z, b.w);
  mma_tf32(c, a_hi, b.x, b.y);
}

}  // namespace sm90
