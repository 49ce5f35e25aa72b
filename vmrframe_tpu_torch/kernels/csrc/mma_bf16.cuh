// bf16 tensor-core fragment helpers for Hopper (sm_90a), shared by the
// bodies that run mma.sync m16n8k16: attention.cu (attention_mma, kernels
// #1/#2; cq_kernel, #3), window_attention.cu (banded_mma, dq_mma, dkv_mma, kernels #5-#7)
// and dual_stack.cu (gemm_mma and attention, kernel #4).  Each source is its own library, so every
// function here is inline.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t; the
// A tile (16 x 16, row) is a[0] = rows g, cols 2t..2t+1; a[1] = row g + 8;
// a[2] = row g, cols 2t+8..; a[3] = row g + 8, cols 2t+8..; the C tile
// (16 x 8) is c[0..1] = row g, cols 2t, 2t+1 and c[2..3] = row g + 8.  So
// the C tiles of two adjacent 8-key score tiles, rounded to bf16 and packed
// in pairs, are the A tile of one 16-key step of P.V.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

// max and sum over the 4 lanes of a quad: the lanes that share an mma row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// waits until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the first two matrices of ldmatrix_x4_trans (threads 0-15 give the rows)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copies rows [0, rows) x cols [0, hd) of a strided bf16 matrix into a
// (rows_pad, HDP) tile of row stride RS elements, zero beyond; threads
// tid, tid + nthr, ... each take 16-byte pieces.  cp.async where source
// rows are 16-byte aligned, element loads otherwise.  The caller waits.
template <int HDP, int RS>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long sl, int rows,
                                      int rows_pad, int hd, int tid, int nthr) {
  const bool aligned = hd % 8 == 0 && sl % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  constexpr int kPieces = HDP / 8;
  for (int idx = tid; idx < rows_pad * kPieces; idx += nthr) {
    const int r = idx / kPieces, c = (idx % kPieces) * 8;
    bf16* d = dst + r * RS + c;
    if (r < rows && c < hd && aligned) {
      cp_async16(d, src + r * sl + c);
    } else {
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        tmp[e] = (r < rows && c + e < hd) ? src[r * sl + c + e] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}
