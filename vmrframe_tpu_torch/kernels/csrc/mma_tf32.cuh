// TF32 tensor-core fragment helpers for Hopper (sm_90a), shared by the f32
// bodies that run mma.sync m16n8k8 in the 3xTF32 split: attention.cu
// (attention_tf32, kernels #1/#2), window_attention.cu (banded_tf32,
// dq_tf32, dkv_tf32, kernels #5-#7) and dual_stack.cu (attention, kernel
// #4).  Each source is its own library, so every function here is inline.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32): lane = 4 g + t; the
// A tile (16 x 8, row) is a[0] = row g, col t; a[1] = row g + 8, col t;
// a[2] = row g, col t + 4; a[3] = row g + 8, col t + 4; the B tile (8 x 8,
// col) is b[0] = row t, col g; b[1] = row t + 4, col g; the C tile as in
// mma_bf16.cuh (c[0..1] = row g, cols 2t, 2t + 1; c[2..3] = row g + 8).  A
// C tile {c0, c1, c2, c3} goes in as the A tile {c0, c2, c1, c3} as it
// stands: its k index t is column 2t and t + 4 is column 2t + 1, so the B
// operand's rows are read from those two (the product sums over them).

#pragma once

#include <stdint.h>

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away from
// zero) for every finite x: half of the 13 dropped bits added to the
// magnitude's bits, then cleared.  Two integer operations, with which the
// whole kernel ran faster on an H100 than with the cvt.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as big + small, both TF32: big = tf32(x), small = tf32(x - big) (x - big
// is exact in f32), so big + small keeps 22 of x's 24 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate.  Not volatile:
// the compiler may interleave the products of independent accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[off + i] += a * b[i] for the first n of N independent accumulators in
// 3xTF32: big.small of each, then small.big of each, then big.big of each
// (small.small, ~2^-22 of each product, is dropped).  Each accumulator
// takes the small terms first; n products stand between two that feed the
// same one.
template <int N, int M>
__device__ __forceinline__ void mma_3xtf32(float (&d)[M][4], int off, const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[N][2],
                                           const uint32_t (&bs)[N][2], int n) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) mma_tf32(d[off + i], ab, bs[i][0], bs[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) mma_tf32(d[off + i], as, bb[i][0], bb[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) mma_tf32(d[off + i], ab, bb[i][0], bb[i][1]);
}
