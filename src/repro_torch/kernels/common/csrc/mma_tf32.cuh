// Tensor-core helpers shared by the port's kernels (flash_attention.cu,
// ssd_scan.cu): the 3xTF32 split of an fp32 operand and the mma.sync
// products it feeds.
//
// fp32 products run as mma.sync.m16n8k8 TF32 in the split form: each
// operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
// each k step accumulates hi*lo, then lo*hi, then hi*hi into one fp32
// accumulator (lo*lo is dropped). Its error is fp32's; one TF32 pass is
// not (tests/test_torch_flash_attention.py and tests/test_torch_ssd.py
// emulate both).
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and m16n8k16 .bf16), for
// lane = 4 g + t: A holds (row g, k t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); B holds (k t, col g), (k t + 4, col g); the accumulator holds
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// x = hi + lo, both TF32 (10 mantissa bits) rounded to nearest, ties away
// from zero: the rounding of cvt.rna.tf32.f32, bit for bit on finite values,
// done by an integer add and mask, which issue at the full ALU rate where the
// conversion does not. hi's low 13 bits are zero, so x - hi is exact.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(h)) + 0x1000u) & 0xffffe000u;
  hi = h;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
