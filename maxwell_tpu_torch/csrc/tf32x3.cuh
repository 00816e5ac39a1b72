// 3xTF32 products on the tensor cores (mma.sync m16n8k8, f32 accumulation):
// the operand split and the mma shared by the blocked-ELL body
// (bsr_spmm.cu: K8, K9, K10) and the BELLPairs body (bellpairs_spmm.cu: K11
// to K14). A product a*b at f32 grade is lo_a hi_b + hi_a lo_b + hi_a hi_b,
// small terms first, each operand split in registers into two TF32 words
// (about 2^-22 relative error per product; the counterpart of the TPU's
// multi-pass HIGHEST on its matrix unit, never single-pass TF32).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a rounded to TF32 (10 mantissa bits), nearest with ties away from zero,
// the value cvt.rna.tf32.f32 gives, with the low 13 bits (which the mma
// does not read) cleared; by an integer add of half a TF32 ulp and a mask,
// two full-rate integer operations where cvt goes through the slower
// conversion pipe
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo to about 2^-22 relative, both TF32 (a - hi is exact in f32)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// D (16 x 8, f32) += A (16 x 8, tf32, row) @ B (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
