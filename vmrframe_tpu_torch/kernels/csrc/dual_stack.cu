// Hopper (sm_90a) kernel for the SeqPAN family's whole 2-layer dual-attention
// stack in one launch.
//
//   vmr_dual_stack  <- vmrframe_tpu/kernels/dual_stack.py::dual_attention_stack
//                      (_stack_kernel)
//
// It computes v1 = dab1(v, t); t1 = dab1(t, v); v2 = dab2(v1, t1);
// t2 = dab2(t1, v1), where one dab call is: LN of both sides, the shared query
// and two key/value pairs, H-head self and cross attention, the cross gates,
// the BiLinear sigmoid gate, dense + residual, LN, dense + residual.  It is
// the same function as the TPU kernel, not the same blocking: no two samples
// stacked per program, no lane-masked heads, no transposed K.
//
// What bounds it on an H100: operations.  At the Charades shapes (B 128,
// Lv 64, Lt 30, D 128) one sample needs ~47.6 M multiply-adds and ~56 KB of
// inputs and outputs, and all samples share 0.9 MB of weights; ~90% of the
// multiply-adds are the D x D projections (14 products over the from-rows
// and 2 over the to-rows a call), the rest attention.  So the products go
// to the tensor cores: the projections in bf16, attention in both types.
//
// Design.  One block of 512 threads per sample (128 samples on 132 SMs: one
// wave; a sample's four calls depend on each other, so there is nothing to
// split without exchanging activations between blocks).  Any Lv, Lt >= 1:
// a call first projects the keys and values of both sides for all their
// rows, 64 rows at a time, into a per-sample scratch in device memory in T
// (it stays in L2: self attention needs every from-row's keys before any
// row's context), then walks its from-rows in tiles of 64 through five
// (64, 128) f32 buffers in shared memory (rows padded to 132 floats, so that
// 16-byte reads along a row are free of bank conflicts both for one row per
// lane and for one row per warp); the schedule at dab_call reuses them so
// that five are enough in f32 too.
//
// Projections, bf16 (gemm_mma): mma.sync m16n8k16 with f32 accumulation;
// warp w owns a 16-row band and 32 columns of the 64-row tile; A fragments
// come from the f32 buffers, rounded to bf16 as they are read; each weight
// matrix streams from L2 in two 64-row halves through two bf16 slots with
// cp.async, and the next product's first half is prefetched behind the
// current product's second half (every block reads the same 28 matrices).
// f32 (gemm_f32): FMA on the CUDA cores (TF32 would keep ~3 digits), the
// weight in 32-row chunks through a double buffer, each warp 4 rows and each
// lane 4 columns, 16 accumulators a thread.
//
// Attention (attention<T, HD>, the head dim a template argument): a warp
// task is (16 query rows, one head), S = Q K^T and P.V on mma.sync, bf16 on
// m16n8k16 with f32 accumulation, f32 on m16n8k8 in 3xTF32 (mma_tf32.cuh;
// each operand split as it is read: split copies of K and V do not fit
// beside the five buffers); k past the head dim and n past it are zero in
// registers, and a task stores only its own columns.  Q's A fragments come
// from its f32 buffer; K and V are staged in the buffers Bf and C: in f32 as
// f32 rows, in bf16 as the bf16 rows of the scratch, copied as they are (K's
// B fragments are 32-bit loads, V's ldmatrix.trans: no conversion, which on
// an H100 was the conversion unit's work that bound the task).  The row max
// and sum are reduced over the quad, p's C fragments are P.V's A fragments
// as they stand, and p = e (1 / sum) with e = 2^((s - max) log2 e) by
// ex2.approx in bf16 (p is rounded to 8 bits after), expf in f32.  A side of
// at most 64 keys is staged once (32 or 64 keys) and walked once with the
// scores in registers; self attention then writes its context over the
// query in place.  A longer side is staged 32 keys at a time, K and V in one
// buffer, each (row, head)'s max and sum in shared memory between chunks:
// bf16 walks twice, max and sum first (K alone, 64 keys a chunk), then p
// rounded to T and P.V (an online softmax would round p before the final
// max is known, not where the TPU kernel and the plain version round it);
// f32 walks once with the max and sum rescaled as they grow (p rounded to
// f32 is p).  The first layer's results go to an f32 scratch in device
// memory that the same block reads back, so nothing is rounded between the
// layers, as on the TPU.
//
// Numerics follow the TPU kernel body: fn, tn, k, v, the probabilities and
// every matmul operand are rounded to T (the weights' type); LN, softmax,
// the sigmoid and all sums are f32; additive -1e30 key masks per sample; the
// BiLinear is two products, over fn and over gc, accumulated into the same
// sums.  Ragged lengths are loop bounds and row guards; rows of a tile
// beyond its length are computed on and never stored, and no row's values
// reach another's (bf16 staging leaves bit patterns in such rows of Bf and
// C that need not be finite as f32).
//
// Takes D = 128, H dividing 128 with a head dim that is a multiple of 4, and
// any Lv, Lt >= 1.  Interface: plain C, loaded with ctypes; the entry
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"  // bf16, cp.async, ldmatrix, mma_bf16, pack_bf16, quad_max, quad_sum
#include "mma_tf32.cuh"  // split_tf32, mma_3xtf32

namespace {

constexpr int kD = 128;
constexpr int kTile = 64;    // rows per tile: from-rows, and to- and from-rows for k, v
constexpr int kLD = kD + 4;  // padded row stride of the activation buffers
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;  // gemm_f32: weight rows per staged chunk
constexpr int kChunks = kD / kKC;
constexpr int kHalf = kD / 2;  // gemm_mma: weight rows per bf16 slot (two slots)
constexpr int kWS = kD + 8;    // gemm_mma: slot row stride, ldmatrix rows on distinct banks
constexpr int kKS = kD + 8;    // attention, bf16: staged K and V row stride, the same way
constexpr int kStage = 64;  // attention: the most keys of a side staged at once (one walk)
constexpr int kKeys = 32;   // attention: keys of a longer side's chunk, K and V in one buffer
constexpr int kRows = 16;   // attention: query rows per warp task, one mma row tile
constexpr int kMaxH = kD / 4;  // heads of at least 4 dims
constexpr int kBuf = kTile * kLD;
// the weight staging buffer: gemm_f32's two f32 chunks or gemm_mma's two
// bf16 slots
constexpr int kWFloats = 2 * kKC * kD > kHalf * kWS ? 2 * kKC * kD : kHalf * kWS;
// attention over a longer side: each (row, head)'s max and sum between chunks
constexpr int kStatFloats = 2 * kTile * kMaxH;
constexpr int kSmemFloats = 5 * kBuf + kWFloats + kStatFloats + kTile + kStage;
constexpr float kMask = -1e30f;
constexpr float kLnEps = 1e-6f;

// order of the weight stack, as layers/attention.py collects it
enum { W_Q, W_FK, W_FV, W_TK, W_TV, W_SD, W_XD, W_SG, W_XG, W_GD, W_BL1, W_BL2, W_D1, W_D2, kNumW };
enum { LN1_S, LN1_B, LNT_S, LNT_B, LN2_S, LN2_B, kNumLn };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A value rounded to the weights' type, kept as f32: a matmul operand.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// sum over a warp
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Activations in device memory: the inputs and outputs in T, the first
// layer's results in f32.
struct Act {
  const void* p;
  bool f32;
};

template <typename T> __device__ __forceinline__ float4 act_load4(Act a, int idx) {
  return a.f32 ? load4(static_cast<const float*>(a.p) + idx)
               : load4(static_cast<const T*>(a.p) + idx);
}

template <typename T> __device__ __forceinline__ float act_load(Act a, int idx) {
  return a.f32 ? static_cast<const float*>(a.p)[idx] : to_f(static_cast<const T*>(a.p)[idx]);
}

// a's rows from row0 on
template <typename T> __device__ __forceinline__ Act act_rows(Act a, int row0) {
  const long long n = (long long)row0 * kD;
  return a.f32 ? Act{static_cast<const float*>(a.p) + n, true}
               : Act{static_cast<const T*>(a.p) + n, false};
}

template <typename T> __device__ __forceinline__ void act_store(Act a, int idx, float x) {
  if (a.f32)
    static_cast<float*>(const_cast<void*>(a.p))[idx] = x;
  else
    static_cast<T*>(const_cast<void*>(a.p))[idx] = from_f<T>(x);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ float* smem_base() {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4);
}

// The block's shared memory: five (kTile, kLD) f32 activation buffers, the
// weight staging buffer, attention's max and sum, and the tile rows' and
// staged keys' validity.  Built from smem_base() in the function that uses
// it, so that the compiler sees shared-memory addresses (LDS/STS, not
// generic loads).
struct Smem {
  float *A, *Bf, *C, *Dq, *E, *wbuf, *stat, *fm, *km;
  __device__ explicit Smem(float* s) {
    A = s, Bf = A + kBuf, C = Bf + kBuf, Dq = C + kBuf, E = Dq + kBuf, wbuf = E + kBuf;
    stat = wbuf + kWFloats, fm = stat + kStatFloats, km = fm + kTile;
  }
};

// A thread's 8 consecutive elements of one (32, 128) weight chunk.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* W, int chunk, float (&r)[8]) {
  const T* src = W + chunk * kKC * kD + threadIdx.x * 8;
  const float4 a = load4(src), b = load4(src + 4);
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w, r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

__device__ __forceinline__ void store_chunk(const float (&r)[8], float* wb) {
  float4* dst = reinterpret_cast<float4*>(wb + threadIdx.x * 8);
  dst[0] = make_float4(r[0], r[1], r[2], r[3]);
  dst[1] = make_float4(r[4], r[5], r[6], r[7]);
}

__device__ __forceinline__ float pick(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// out(r, c) = sum_k A0[r][k] W[k][c] (+ sum_k A1[r][k] W[k][c] when NA is 2)
// for r < M, handed to epi(r, c, sum).  A0/A1: activation buffers in shared
// memory; W: one (128, 128) matrix, (in, out), in device memory; wbuf: the
// two-chunk staging buffer.  Warp w owns rows 4w..4w+3, lane l columns
// 4l..4l+3.  With RoundA the operand is rounded to T as it is read (the
// buffer keeps the f32 value for a later use).  Ends with a block barrier.
template <typename T, int NA, bool RoundA, typename Epi>
__device__ __forceinline__ void gemm_f32(const float* A0, const float* A1, int M, const T* W,
                                         float* wbuf, Epi epi) {
  const int tx = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 4;
  const bool active = r0 < M;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float wr[8];
  load_chunk(W, 0, wr);
  store_chunk(wr, wbuf);
  __syncthreads();
  constexpr int nchunk = NA * kChunks;
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) load_chunk(W, (c + 1) % kChunks, wr);
    const float* wb = wbuf + (c & 1) * kKC * kD + tx * 4;
    if (active) {
      const float* A = (c < kChunks ? A0 : A1) + r0 * kLD + (c % kChunks) * kKC;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = load4(A + i * kLD + kk);
          if (RoundA) {
            a[i].x = round_to<T>(a[i].x), a[i].y = round_to<T>(a[i].y);
            a[i].z = round_to<T>(a[i].z), a[i].w = round_to<T>(a[i].w);
          }
        }
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const float4 w = load4(wb + (kk + k4) * kD);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av = pick(a[i], k4);
            acc[i][0] = fmaf(av, w.x, acc[i][0]);
            acc[i][1] = fmaf(av, w.y, acc[i][1]);
            acc[i][2] = fmaf(av, w.z, acc[i][2]);
            acc[i][3] = fmaf(av, w.w, acc[i][3]);
          }
        }
      }
    }
    if (c + 1 < nchunk) store_chunk(wr, wbuf + ((c + 1) & 1) * kKC * kD);
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(r0 + i, tx * 4 + j, acc[i][j]);
    }
  }
  __syncthreads();
}

// Rows [64 half, 64 half + 64) of W, bf16, into slot `slot` of the weight
// buffer with 16-byte cp.async copies; one commit group.
__device__ __forceinline__ void stage_half(bf16* ws, int slot, const bf16* W, int half) {
  bf16* dst = ws + slot * kHalf * kWS;
  const bf16* src = W + half * kHalf * kD;
  for (int p = threadIdx.x; p < kHalf * kD / 8; p += kThreads) {
    const int r = p / (kD / 8), c = p % (kD / 8) * 8;
    cp_async16(dst + r * kWS + c, src + r * kD + c);
  }
  cp_async_commit();
}

// Two adjacent f32 activations rounded to bf16 and packed: half an A
// fragment register.
__device__ __forceinline__ uint32_t pack_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}

// gemm_f32's product in bf16 on the tensor cores: mma.sync m16n8k16, bf16
// operands, f32 accumulation.  Warp w owns rows 16 (w / 4).. and columns
// 32 (w % 4).. (four n8 tiles, 16 accumulators a thread); warps whose rows
// start at or beyond M skip the products.  A fragments are read from the f32
// activation buffers and rounded to bf16 as they are read (the TPU's operand
// rounding; a buffer that already holds rounded values is unchanged by it);
// NA = 2 accumulates A1 W into the same fragments.  W streams in two halves
// of 64 rows through two slots: the first half was staged by the product
// before (pending == W) or is staged now, the second is staged on entry,
// and once every warp is done with the first slot Wnext's first half goes
// there, so that it loads behind this product's second half, its epilogue
// and whatever runs before the next product.  Ends with a block barrier.
template <int NA, typename Epi>
__device__ __forceinline__ void gemm_mma(const float* A0, const float* A1, int M, const bf16* W,
                                         const bf16* Wnext, bf16* ws, const bf16*& pending,
                                         Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int r0 = warp / 4 * 16, c0 = warp % 4 * 32;
  const bool active = r0 < M;
  if (pending != W) {
    if (pending) cp_async_wait<0>();  // a prefetch of another matrix lands before slot 0 is reused
    stage_half(ws, 0, W, 0);
  }
  stage_half(ws, 1, W, 1);
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (half == 1) {
      pending = Wnext;
      if (Wnext) stage_half(ws, 0, Wnext, 0);
    }
    if (active) {
      const bf16* slot = ws + half * kHalf * kWS;
#pragma unroll
      for (int kk = 0; kk < kHalf / 16; ++kk) {
        const int k0 = half * kHalf + 16 * kk;
        uint32_t a[NA][4];
#pragma unroll
        for (int n = 0; n < NA; ++n) {
          const float* ap = (n ? A1 : A0) + (r0 + g) * kLD + k0 + 2 * t;
          a[n][0] = pack_pair(ap), a[n][1] = pack_pair(ap + 8 * kLD);
          a[n][2] = pack_pair(ap + 8), a[n][3] = pack_pair(ap + 8 * kLD + 8);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, slot + (16 * kk + r8 + ((mi & 1) << 3)) * kWS + c0 + 16 * np + ((mi >> 1) << 3));
#pragma unroll
          for (int n = 0; n < NA; ++n) {
            mma_bf16(acc[2 * np], a[n], b[0], b[1]);
            mma_bf16(acc[2 * np + 1], a[n], b[2], b[3]);
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + 8 * j + 2 * t, ra = r0 + g, rb = ra + 8;
      if (ra < M) epi(ra, col, acc[j][0]), epi(ra, col + 1, acc[j][1]);
      if (rb < M) epi(rb, col, acc[j][2]), epi(rb, col + 1, acc[j][3]);
    }
  }
  __syncthreads();
}

// out = A0 W (+ A1 W) for the tile's first M rows, handed to epi(r, c,
// sum): bf16 on the tensor cores (gemm_mma), f32 on the CUDA cores
// (gemm_f32).  Wnext is the matrix of the next product, pending the matrix
// whose first half gemm_mma has in flight.
template <typename T, int NA, bool RoundA, typename Epi>
__device__ __forceinline__ void gemm(const float* A0, const float* A1, int M, const T* W,
                                     const T* Wnext, const Smem& sm, const T*& pending,
                                     Epi epi) {
  if constexpr (std::is_same<T, bf16>::value)
    gemm_mma<NA>(A0, A1, M, W, Wnext, reinterpret_cast<bf16*>(sm.wbuf), pending, epi);
  else
    gemm_f32<T, NA, RoundA>(A0, A1, M, W, sm.wbuf, epi);
}

// LayerNorm of M rows, one warp per row, a lane on 4 columns; the result is
// rounded to T (it is only ever a matmul operand).  row4(r, c) gives the
// row's 4 values from column c.
template <typename T, typename Row4>
__device__ __forceinline__ void layer_norm(int M, Row4 row4, const float* scale,
                                           const float* bias, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = lane * 4;
  const float4 s = load4(scale + c), b = load4(bias + c);
  for (int r = warp; r < M; r += kWarps) {
    const float4 x = row4(r, c);
    const float mu = warp_sum(x.x + x.y + x.z + x.w) * (1.f / kD);
    const float dx = x.x - mu, dy = x.y - mu, dz = x.z - mu, dw = x.w - mu;
    const float var = warp_sum(dx * dx + dy * dy + dz * dz + dw * dw) * (1.f / kD);
    const float inv = rsqrtf(var + kLnEps);
    *reinterpret_cast<float4*>(out + r * kLD + c) =
        make_float4(round_to<T>(dx * inv * s.x + b.x), round_to<T>(dy * inv * s.y + b.y),
                    round_to<T>(dz * inv * s.z + b.z), round_to<T>(dw * inv * s.w + b.w));
  }
}

// Copies keys [c0, c0 + NK) of K (and, with V, of V) from device memory
// ((Tn, D) in T, already rounded) into the rows of kb (and vb), zero beyond
// Tn; their validity into km.  f32 rows of kLD floats; bf16 rows of kKS
// bf16, copied as they are (no conversion).  Every thread issues its loads
// (ld.global.cg: the scratch was written in this launch) before its first
// store, so that a stage waits on one round trip to L2.
template <typename T, int NK, bool V>
__device__ __forceinline__ void stage_keys(float* kb, float* vb, float* km, const T* kg,
                                           const T* vg, const float* km_g, int c0, int Tn) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kRow = kD * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  constexpr int kPieces = NK * kRow, kPer = (V ? 2 : 1) * kPieces / kThreads;
  static_assert(kPer * kThreads == (V ? 2 : 1) * kPieces, "a stage is whole pieces a thread");
  const int n = min(NK, Tn - c0);
  const int j0 = threadIdx.x;  // this thread's key validity, read with K and V
  const float kmv = j0 < n ? __ldcg(km_g + c0 + j0) : 0.f;
  uint4 x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads, m = idx / kPieces;
    const int j = idx % kPieces / kRow, c = idx % kRow * (16 / (int)sizeof(T));
    const T* src = (m ? vg : kg) + (long long)(c0 + j) * kD + c;
    x[i] = j < n ? __ldcg(reinterpret_cast<const uint4*>(src)) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads, m = idx / kPieces;
    const int j = idx % kPieces / kRow, c = idx % kRow * (16 / (int)sizeof(T));
    float* dst = m ? vb : kb;
    if constexpr (kBf16)
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(dst) + j * kKS + c) = x[i];
    else
      *reinterpret_cast<uint4*>(dst + j * kLD + c) = x[i];
  }
  if (j0 < NK) km[j0] = kmv;
}

// s[j] += Q K^T for the task's 16 rows (ra = r0 + g and ra + 8 of q) and the
// NT n-tiles of 8 staged keys (bf16 rows 8 j + g of ks), over the head's HD
// columns from c0, on mma.sync m16n8k16.  A fragments are read from the f32
// buffer and rounded to bf16 as they are read (pack_pair; q holds values
// already rounded, so this is exact), B fragments as pairs of staged bf16
// (rows of 68 words: the 32 lanes on 32 banks); k past HD is zero in
// registers: no neighbouring head's column enters a product.
template <int HD, int NT>
__device__ __forceinline__ void scores_bf16(float (&s)[NT][4], const float* q, const bf16* ks,
                                            int ra, int c0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < (HD + 15) / 16; ++kk) {
    const int c = c0 + 16 * kk + 2 * t;
    const bool lo = 16 * kk + 2 * t < HD, hi = 16 * kk + 2 * t + 8 < HD;
    const float* qa = q + ra * kLD + c;
    uint32_t a[4];
    a[0] = lo ? pack_pair(qa) : 0u;
    a[1] = lo ? pack_pair(qa + 8 * kLD) : 0u;
    a[2] = hi ? pack_pair(qa + 8) : 0u;
    a[3] = hi ? pack_pair(qa + 8 * kLD + 8) : 0u;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* kp = ks + (8 * j + g) * kKS + c;
      mma_bf16(s[j], a, lo ? *reinterpret_cast<const uint32_t*>(kp) : 0u,
               hi ? *reinterpret_cast<const uint32_t*>(kp + 8) : 0u);
    }
  }
}

// scores_bf16's product in f32 on mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh):
// each operand split into big and small TF32 parts as it is read.
template <int HD, int NT>
__device__ __forceinline__ void scores_tf32(float (&s)[NT][4], const float* q, const float* kb,
                                            int ra, int c0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < (HD + 7) / 8; ++kk) {
    const int c = c0 + 8 * kk + t;
    const bool lo = 8 * kk + t < HD, hi = 8 * kk + t + 4 < HD;
    const float* qa = q + ra * kLD + c;
    uint32_t ab[4], as[4];
    split_tf32(lo ? qa[0] : 0.f, ab[0], as[0]);
    split_tf32(lo ? qa[8 * kLD] : 0.f, ab[1], as[1]);
    split_tf32(hi ? qa[4] : 0.f, ab[2], as[2]);
    split_tf32(hi ? qa[8 * kLD + 4] : 0.f, ab[3], as[3]);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += 4) {  // 4 n-tiles a round: 16 B registers live
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* kp = kb + (8 * (j0 + u) + g) * kLD + c;
        split_tf32(lo ? kp[0] : 0.f, bb[u][0], bs[u][0]);
        split_tf32(hi ? kp[4] : 0.f, bb[u][1], bs[u][1]);
      }
      mma_3xtf32<4>(s, j0, ab, as, bb, bs, 4);
    }
  }
}

// e^x for the softmax (x <= 0, or -inf): in bf16 ex2.approx, its p being
// rounded to 8 bits after (the approximation's ~2^-22 relative error moves a
// p across a rounding boundary about once in 2^14); expf in f32.
template <typename T> __device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (std::is_same<T, bf16>::value) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.44269504f));
    return y;
  } else {
    return expf(x);
  }
}

// What one warp task does with a stage of keys.
enum Walk {
  kOne,     // the whole side in one stage: softmax, p rounded to T, out = p v
  kStats,   // bf16, a longer side's first walk: the running max and sum into stat
  kProbs,   // bf16, its second walk: p = exp(s - max) / sum rounded, out += p v
  kOnline,  // f32, a longer side's one walk: max and sum rescaled, out = out f + e v
};

// One warp task: the tile rows r0 .. r0 + 15 of q (rounded to T) for head h
// against the NT n-tiles of 8 keys staged in kb (and values in vb), of which
// the first n are keys of the side.  The scores take the additive mask
// (1 - fm km) kMask and -inf past n; their row max and sum are reduced over
// the quad (the 4 lanes that hold one mma row); p's C fragments are P.V's A
// fragments as they stand.  out (f32 rows of stride kLD) gets the task's own
// rows and head columns only; stat holds each (row, head)'s max and sum
// between the stages of a longer side.  first / last: the stage is the
// side's first / last.
template <typename T, int HD, int NT, Walk W>
__device__ __forceinline__ void attend_task(const float* q, float* out, const float* kb,
                                            const float* vb, const float* fm, const float* km,
                                            float* stat, int r0, int h, int n, float scale,
                                            bool first, bool last) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int H = kD / HD, ND = (HD + 7) / 8, G = ND < 4 ? ND : 4;
  static_assert(!kBf16 || NT % 2 == 0, "bf16 P.V takes keys 16 at a time");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = h * HD, ra = r0 + g, rb = ra + 8;

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if constexpr (kBf16)
    scores_bf16<HD, NT>(s, q, reinterpret_cast<const bf16*>(kb), ra, c0, g, t);
  else
    scores_tf32<HD, NT>(s, q, kb, ra, c0, g, t);
  __syncwarp();  // every lane has read its q before out (q itself in place) is written

  const float fa = fm[ra], fb = fm[rb];
  float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 kv = *reinterpret_cast<const float2*>(km + 8 * j + 2 * t);  // 0 from n on
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + (e & 1);
      const float valid = (e & 2 ? fb : fa) * (e & 1 ? kv.y : kv.x);
      s[j][e] = key < n ? s[j][e] * scale + (1.f - valid) * kMask : -INFINITY;
      if (e & 2)
        xb = fmaxf(xb, s[j][e]);
      else
        xa = fmaxf(xa, s[j][e]);
    }
  }
  xa = quad_max(xa), xb = quad_max(xb);

  // each row's max m and sum l; f: the online walk's rescale of out
  float* sa = stat + 2 * (ra * H + h);
  float* sb = stat + 2 * (rb * H + h);
  float ma = xa, mb = xb, la = 0.f, lb = 0.f, fa_ = 1.f, fb_ = 1.f;
  if constexpr (W == kProbs) {
    ma = sa[0], la = sa[1], mb = sb[0], lb = sb[1];
  } else if constexpr (W == kStats || W == kOnline) {
    const float moa = first ? -INFINITY : sa[0], mob = first ? -INFINITY : sb[0];
    la = first ? 0.f : sa[1], lb = first ? 0.f : sb[1];
    ma = fmaxf(moa, xa), mb = fmaxf(mob, xb);
    fa_ = softmax_exp<T>(moa - ma), fb_ = softmax_exp<T>(mob - mb);  // 0 on the first stage
  }
  float ea = 0.f, eb = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = softmax_exp<T>(s[j][e] - (e & 2 ? mb : ma));  // 0 past n
      if (e & 2)
        eb += s[j][e];
      else
        ea += s[j][e];
    }
  if constexpr (W != kProbs) {
    ea = quad_sum(ea), eb = quad_sum(eb);
    la = la * fa_ + ea, lb = lb * fb_ + eb;
  }
  if constexpr (W == kStats || W == kOnline) {
    __syncwarp();  // every lane has read stat
    if (t == 0) sa[0] = ma, sa[1] = la, sb[0] = mb, sb[1] = lb;
  }
  if constexpr (W == kStats) return;
  // p = e / l as e (1 / l): rounded to T where P.V reads it (bf16: packed
  // from f32, one rounding, as the plain version's p.to(bf16))
  const float ia = 1.f / la, ib = 1.f / lb;
  if constexpr (W == kOne || W == kProbs) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= e & 2 ? ib : ia;
  }

  // out (+)= P V, in groups of G n-tiles of 8 head columns; past HD the
  // values are zero in registers and nothing is stored
  uint32_t pa[kBf16 ? NT / 2 : 1][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  }
#pragma unroll
  for (int d0 = 0; d0 < ND; d0 += G) {
    float o[G][4];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int col = 8 * (d0 + u) + 2 * t;
      if (W == kOne || first || col >= HD) {
        o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(out + ra * kLD + c0 + col);
        const float2 b = *reinterpret_cast<const float2*>(out + rb * kLD + c0 + col);
        o[u][0] = a.x * fa_, o[u][1] = a.y * fa_, o[u][2] = b.x * fb_, o[u][3] = b.y * fb_;
      }
    }
    if constexpr (kBf16) {
      // B from the staged bf16 V: ldmatrix.trans, two n-tiles an x4 (one an
      // x2 at head dim 8); at head dim 4 pairs of elements, zero past HD
      const bf16* vs = reinterpret_cast<const bf16*>(vb);
      const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const bf16* vr = vs + (16 * kk + r8 + ((mi & 1) << 3)) * kKS + c0 + 8 * d0;
        if constexpr (HD >= 16) {
#pragma unroll
          for (int u = 0; u < G; u += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vr + 8 * u + ((mi >> 1) << 3));
            mma_bf16(o[u], pa[kk], b[0], b[1]);
            mma_bf16(o[u + 1], pa[kk], b[2], b[3]);
          }
        } else if constexpr (HD == 8) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, vr);
          mma_bf16(o[0], pa[kk], b[0], b[1]);
        } else {
          const unsigned short* v16 = reinterpret_cast<const unsigned short*>(vs) + c0 + g;
          const int k0 = 16 * kk + 2 * t;
          auto pair = [&](int k) {
            return g < HD ? (uint32_t)v16[k * kKS] | (uint32_t)v16[(k + 1) * kKS] << 16 : 0u;
          };
          mma_bf16(o[0], pa[kk], pair(k0), pair(k0 + 8));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ab[4], as[4], bb[G][2], bs[G][2];
        split_tf32(s[j][0], ab[0], as[0]);
        split_tf32(s[j][2], ab[1], as[1]);
        split_tf32(s[j][1], ab[2], as[2]);
        split_tf32(s[j][3], ab[3], as[3]);
        const float* vr = vb + (8 * j + 2 * t) * kLD + c0 + g;
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const int d = 8 * (d0 + u);
          const bool ok = d + g < HD;
          split_tf32(ok ? vr[d] : 0.f, bb[u][0], bs[u][0]);
          split_tf32(ok ? vr[kLD + d] : 0.f, bb[u][1], bs[u][1]);
        }
        mma_3xtf32<G>(o, 0, ab, as, bb, bs, G);
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int col = 8 * (d0 + u) + 2 * t;
      if (col >= HD) continue;
      float2 a = make_float2(o[u][0], o[u][1]), b = make_float2(o[u][2], o[u][3]);
      if (W == kOne || last) {
        if constexpr (W == kOnline)
          a.x *= ia, a.y *= ia, b.x *= ib, b.y *= ib;
        a.x = round_to<T>(a.x), a.y = round_to<T>(a.y), b.x = round_to<T>(b.x);
        b.y = round_to<T>(b.y);
      }
      *reinterpret_cast<float2*>(out + ra * kLD + c0 + col) = a;
      *reinterpret_cast<float2*>(out + rb * kLD + c0 + col) = b;
    }
  }
}

// The tasks of one stage: (16 rows, one head) for every row group below M,
// warps round-robin.  Ends with a block barrier.
template <typename T, int HD, int NT, Walk W>
__device__ __forceinline__ void attend_stage(const float* q, float* out, int M, const float* kb,
                                             const float* vb, const float* fm, const float* km,
                                             float* stat, int n, bool first, bool last) {
  constexpr int H = kD / HD;
  const float scale = 1.f / sqrtf((float)HD);
  const int ntask = (M + kRows - 1) / kRows * H;
  for (int task = threadIdx.x >> 5; task < ntask; task += kWarps)
    attend_task<T, HD, NT, W>(q, out, kb, vb, fm, km, stat, task / H * kRows, task % H, n, scale,
                              first, last);
  __syncthreads();
}

// H-head attention of a tile's M query rows (q, rounded to T; the buffer at
// q_at floats into the shared memory) over Tn keys whose K and V ((Tn, D) in
// T, rounded) are in device memory; the context, rounded to T, goes to the
// buffer at out_at.  K and V are staged in Bf and C, sm.fm holds the tile
// rows' validity (0 beyond M), km_g (Tn,) the keys'.  Rows of the last row
// group beyond M are computed on finite values and never read.
//
// Tn <= kStage: K and V staged once (kKeys or kStage keys, into kb and vb),
// one walk, the scores in registers (4 or 8 n-tiles); out may be q (a task
// reads only its own slice of q, and has read it before it writes).
// Longer sides: chunks of kKeys keys with K in kb's first rows and V in the
// next kKeys rows (vb unused), out != q.  bf16 walks twice, p being rounded
// where the plain version rounds it, after the final max and sum: the max
// and sum first over chunks of kStage keys (K alone), then p and P.V.  f32
// walks once, max and sum rescaled as they grow (rounding p to f32 is the
// identity, so this is exact up to the order of the sums).
template <typename T, int HD>
__device__ __noinline__ void attention(int q_at, int out_at, int M, const T* kg, const T* vg,
                                       const float* km_g, int Tn) {
  // the buffers rebuilt from smem_base(): shared-memory accesses (a pointer
  // argument of a call that is not inlined would make every one generic)
  const Smem sm(smem_base());
  const float* q = smem_base() + q_at;
  float* out = smem_base() + out_at;
  float *kb = sm.Bf, *vb = sm.C, *km = sm.km, *stat = sm.stat;
  const float* fm = sm.fm;
  if (Tn <= kStage) {
    if (Tn <= kKeys) {
      stage_keys<T, kKeys, true>(kb, vb, km, kg, vg, km_g, 0, Tn);
      __syncthreads();
      attend_stage<T, HD, kKeys / 8, kOne>(q, out, M, kb, vb, fm, km, stat, Tn, true, true);
    } else {
      stage_keys<T, kStage, true>(kb, vb, km, kg, vg, km_g, 0, Tn);
      __syncthreads();
      attend_stage<T, HD, kStage / 8, kOne>(q, out, M, kb, vb, fm, km, stat, Tn, true, true);
    }
    return;
  }
  float* vc = kb + kKeys * (std::is_same<T, bf16>::value ? kKS / 2 : kLD);  // V after K's rows
  if constexpr (std::is_same<T, bf16>::value) {
    for (int c0 = 0; c0 < Tn; c0 += kStage) {
      stage_keys<T, kStage, false>(kb, nullptr, km, kg, vg, km_g, c0, Tn);
      __syncthreads();
      attend_stage<T, HD, kStage / 8, kStats>(q, out, M, kb, nullptr, fm, km, stat,
                                              min(kStage, Tn - c0), c0 == 0, false);
    }
    for (int c0 = 0; c0 < Tn; c0 += kKeys) {
      stage_keys<T, kKeys, true>(kb, vc, km, kg, vg, km_g, c0, Tn);
      __syncthreads();
      attend_stage<T, HD, kKeys / 8, kProbs>(q, out, M, kb, vc, fm, km, stat,
                                             min(kKeys, Tn - c0), c0 == 0, c0 + kKeys >= Tn);
    }
  } else {
    for (int c0 = 0; c0 < Tn; c0 += kKeys) {
      stage_keys<T, kKeys, true>(kb, vc, km, kg, vg, km_g, c0, Tn);
      __syncthreads();
      attend_stage<T, HD, kKeys / 8, kOnline>(q, out, M, kb, vc, fm, km, stat,
                                              min(kKeys, Tn - c0), c0 == 0, c0 + kKeys >= Tn);
    }
  }
}

// attention<T, HD>, or with HD 0 attention<T, kD / H>; q and out are
// activation buffers of sm.
template <typename T, int HD>
__device__ __forceinline__ void attend(const float* q, float* out, int M, const T* kg, const T* vg,
                                       const float* km_g, int Tn, int H, const Smem& sm) {
  const int q_at = (int)(q - sm.A), out_at = (int)(out - sm.A);  // sm.A is smem_base()
  if constexpr (HD != 0) {
    attention<T, HD>(q_at, out_at, M, kg, vg, km_g, Tn);
  } else {
    switch (H) {
      case 1: return attention<T, 128>(q_at, out_at, M, kg, vg, km_g, Tn);
      case 2: return attention<T, 64>(q_at, out_at, M, kg, vg, km_g, Tn);
      case 4: return attention<T, 32>(q_at, out_at, M, kg, vg, km_g, Tn);
      case 8: return attention<T, 16>(q_at, out_at, M, kg, vg, km_g, Tn);
      case 16: return attention<T, 8>(q_at, out_at, M, kg, vg, km_g, Tn);
      default: return attention<T, 4>(q_at, out_at, M, kg, vg, km_g, Tn);
    }
  }
}

// Writes rows [0, M) of two activation buffers (values already rounded) to
// device memory in T: a tile's keys and values.
template <typename T>
__device__ __forceinline__ void store_rows(const float* k, const float* v, int M, T* kg, T* vg) {
  for (int idx = threadIdx.x; idx < 2 * M * (kD / 4); idx += kThreads) {
    const int m = idx / (M * (kD / 4)), r = idx % (M * (kD / 4)) / (kD / 4);
    const int c = idx % (kD / 4) * 4;
    store4((m ? vg : kg) + (long long)r * kD + c, load4((m ? v : k) + r * kLD + c));
  }
}

// One DualAttentionBlock call for one sample.  x (F, D) is the from-side, y
// (Tn, D) the to-side, both in device memory; fm_g (F,), tm_g (Tn,) their
// validities; W (14, D, D), b (14, D), ln (6, D), xb (2, D) one layer's
// stacks; kvg: this sample's (2 (F + Tn), D) scratch in T for both sides'
// keys and values.  First the to-side's and then the from-side's keys and
// values for all their rows, tile by tile (LN -> A; k -> Bf; v -> C; both
// to kvg).  Then each tile of up to kTile from-rows, buffers A..E, with
// (S, R) = (Dq, C) when the from-side has at most kStage rows (self
// attention in place over q) and (C, Dq) otherwise:
//   fn -> A; q -> Dq; x_att = attn(Dq; to-side) -> E;
//   s_att = attn(Dq; from-side) -> S;
//   x_value = E Wxd -> Bf; s_value = S Wsd -> R; x_score = Bf Wxg -> S;
//   s_score = R Wsg -> E; R = s_score x_value + x_score s_value;
//   gc = R Wgd -> Bf; scores = (A, Bf) Wbl1 -> S; gate * values -> R;
//   residual = R Wd1 + b + x -> E; z = LN2(E) -> A; out = A Wd2 + b + E.
// Wafter: the first matrix of the next call, or null.  HD: the head dim, or
// 0 for any (kD / H, dispatched at each attention).
template <typename T, int HD>
__device__ __noinline__ void dab_call(Act x, Act y, Act out, const float* fm_g,
                                      const float* tm_g, int F, int Tn, int H, const T* W,
                                      const float* b, const float* ln, const float* xb, T* kvg,
                                      const T* Wafter, const T*& pending) {
  const Smem sm(smem_base());
  float *A = sm.A, *Bf = sm.Bf, *C = sm.C, *Dq = sm.Dq, *E = sm.E, *fm = sm.fm;
  const T* Wm[kNumW];
#pragma unroll
  for (int i = 0; i < kNumW; ++i) Wm[i] = W + i * kD * kD;
  T* tk = kvg;
  T* tv = tk + (long long)Tn * kD;
  T* fk = tv + (long long)Tn * kD;
  T* fv = fk + (long long)F * kD;
  auto biased_rounded = [&](float* dst, int w) {
    return [=](int r, int c, float acc) { dst[r * kLD + c] = round_to<T>(acc + b[w * kD + c]); };
  };
  auto biased = [&](float* dst, int w) {
    return [=](int r, int c, float acc) { dst[r * kLD + c] = acc + b[w * kD + c]; };
  };

  // both sides' keys and values, every row
  for (int side = 0; side < 2; ++side) {
    const Act src = side ? x : y;
    const int L = side ? F : Tn, wk = side ? W_FK : W_TK, wv = side ? W_FV : W_TV;
    const int lns = side ? LN1_S : LNT_S, lnb = side ? LN1_B : LNT_B;
    for (int r0 = 0; r0 < L; r0 += kTile) {
      const int M = min(kTile, L - r0);
      const bool more = r0 + kTile < L;
      layer_norm<T>(M, [&](int r, int c) { return act_load4<T>(src, (r0 + r) * kD + c); },
                    ln + lns * kD, ln + lnb * kD, A);
      __syncthreads();
      gemm<T, 1, false>(A, nullptr, M, Wm[wk], Wm[wv], sm, pending, biased_rounded(Bf, wk));
      gemm<T, 1, false>(A, nullptr, M, Wm[wv], more ? Wm[wk] : side ? Wm[W_Q] : Wm[W_FK], sm,
                        pending, biased_rounded(C, wv));
      store_rows<T>(Bf, C, M, (side ? fk : tk) + (long long)r0 * kD,
                    (side ? fv : tv) + (long long)r0 * kD);
      __syncthreads();
    }
  }

  // the from-rows, tile by tile
  for (int r0 = 0; r0 < F; r0 += kTile) {
    const int M = min(kTile, F - r0);
    const Act xr = act_rows<T>(x, r0), outr = act_rows<T>(out, r0);
    for (int i = threadIdx.x; i < kTile; i += kThreads) fm[i] = i < M ? fm_g[r0 + i] : 0.f;
    layer_norm<T>(M, [&](int r, int c) { return act_load4<T>(xr, r * kD + c); },
                  ln + LN1_S * kD, ln + LN1_B * kD, A);
    __syncthreads();
    gemm<T, 1, false>(A, nullptr, M, Wm[W_Q], Wm[W_XD], sm, pending, biased_rounded(Dq, W_Q));
    // cross attention -> E; self attention -> S, in place over q when one
    // stage holds the from-side's keys; R: the buffer that stays free
    attend<T, HD>(Dq, E, M, tk, tv, tm_g, Tn, H, sm);
    float* S = F <= kStage ? Dq : C;
    float* R = F <= kStage ? C : Dq;
    attend<T, HD>(Dq, S, M, fk, fv, fm_g, F, H, sm);
    // values and cross gates
    gemm<T, 1, false>(E, nullptr, M, Wm[W_XD], Wm[W_SD], sm, pending, biased(Bf, W_XD));
    gemm<T, 1, false>(S, nullptr, M, Wm[W_SD], Wm[W_XG], sm, pending, biased(R, W_SD));
    gemm<T, 1, true>(Bf, nullptr, M, Wm[W_XG], Wm[W_SG], sm, pending, biased(S, W_XG));
    gemm<T, 1, true>(R, nullptr, M, Wm[W_SG], Wm[W_GD], sm, pending, biased(E, W_SG));
    for (int idx = threadIdx.x; idx < M * kD; idx += kThreads) {
      const int o = (idx / kD) * kLD + idx % kD;
      R[o] = round_to<T>(E[o] * Bf[o] + S[o] * R[o]);
    }
    __syncthreads();
    gemm<T, 1, false>(R, nullptr, M, Wm[W_GD], Wm[W_BL1], sm, pending, biased_rounded(Bf, W_GD));
    // BiLinear gate: fn W + gc W + 2 b + xb, twice; sigmoid(scores masked) * values
    gemm<T, 2, false>(A, Bf, M, Wm[W_BL1], Wm[W_BL2], sm, pending, [=](int r, int c, float acc) {
      S[r * kLD + c] = acc + 2.f * b[W_BL1 * kD + c] + xb[c];
    });
    gemm<T, 2, false>(A, Bf, M, Wm[W_BL2], Wm[W_D1], sm, pending, [=](int r, int c, float acc) {
      const float values = acc + 2.f * b[W_BL2 * kD + c] + xb[kD + c];
      const float z = S[r * kLD + c] + kMask * (1.f - fm[r]);
      R[r * kLD + c] = round_to<T>(values / (1.f + expf(-z)));
    });
    // dense + residual, LN, dense + residual
    gemm<T, 1, false>(R, nullptr, M, Wm[W_D1], Wm[W_D2], sm, pending, [=](int r, int c, float acc) {
      E[r * kLD + c] = acc + b[W_D1 * kD + c] + act_load<T>(xr, r * kD + c);
    });
    layer_norm<T>(M, [&](int r, int c) { return load4(E + r * kLD + c); }, ln + LN2_S * kD,
                  ln + LN2_B * kD, A);
    __syncthreads();
    gemm<T, 1, false>(A, nullptr, M, Wm[W_D2], r0 + kTile < F ? Wm[W_Q] : Wafter, sm, pending,
                      [=](int r, int c, float acc) {
                        act_store<T>(outr, r * kD + c, acc + b[W_D2 * kD + c] + E[r * kLD + c]);
                      });
  }
}

// HD as in dab_call: each kernel's code holds the functions it calls, so a
// kernel for one head dim holds one attention body beside its products (on
// an H100 ~5% faster at 4 heads than one holding all six).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    stack_kernel(const T* v_in, const T* t_in, const float* vm, const float* tm, const T* W,
                 const float* b, const float* ln, const float* xb, T* v_out, T* t_out,
                 float* scratch, T* kv_scratch, int Lv, int Lt, int H) {
  float* smem = smem_base();
  // rows beyond a tile's length are read (never used) by the products
  for (int i = threadIdx.x; i < 5 * kBuf; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const long long s = blockIdx.x;
  const long long rows = Lv + Lt;
  const Act v0{v_in + s * Lv * kD, false}, t0{t_in + s * Lt * kD, false};
  const Act v1{scratch + s * rows * kD, true};
  const Act t1{scratch + s * rows * kD + (long long)Lv * kD, true};
  const Act v2{v_out + s * Lv * kD, false}, t2{t_out + s * Lt * kD, false};
  T* kvg = kv_scratch + s * 2 * rows * kD;
  const float* vmask = vm + s * Lv;
  const float* tmask = tm + s * Lt;
  const T* pending = nullptr;  // the matrix whose first half gemm_mma has in flight
  for (int layer = 0; layer < 2; ++layer) {
    const T* Wl = W + layer * kNumW * kD * kD;
    const float* bl = b + layer * kNumW * kD;
    const float* lnl = ln + layer * kNumLn * kD;
    const float* xbl = xb + layer * 2 * kD;
    const Act xv = layer ? v1 : v0, xt = layer ? t1 : t0;
    // each call's first product is W_TK: of this layer, then of the next
    const T* Wnext = layer ? nullptr : W + kNumW * kD * kD + W_TK * kD * kD;
    dab_call<T, HD>(xv, xt, layer ? v2 : v1, vmask, tmask, Lv, Lt, H, Wl, bl, lnl, xbl, kvg,
                    Wl + W_TK * kD * kD, pending);
    dab_call<T, HD>(xt, xv, layer ? t2 : t1, tmask, vmask, Lt, Lv, H, Wl, bl, lnl, xbl, kvg, Wnext,
                    pending);
    __syncthreads();  // the scratch rows written above are read by other threads below
  }
}

template <typename T, int HD>
int launch(const void* v, const void* t, const void* vm, const void* tm, const void* W,
           const void* b, const void* ln, const void* xb, void* v_out, void* t_out,
           void* scratch, void* kv_scratch, int B, int Lv, int Lt, int H, cudaStream_t stream) {
  const size_t bytes = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stack_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  stack_kernel<T, HD><<<B, kThreads, bytes, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(t), static_cast<const float*>(vm),
      static_cast<const float*>(tm), static_cast<const T*>(W), static_cast<const float*>(b),
      static_cast<const float*>(ln), static_cast<const float*>(xb), static_cast<T*>(v_out),
      static_cast<T*>(t_out), static_cast<float*>(scratch), static_cast<T*>(kv_scratch), Lv, Lt,
      H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features, weights, outputs and
// kv_scratch); masks, b, ln, xb and scratch are float32.  scratch: (B, Lv +
// Lt, D), the first layer's results; kv_scratch: (B, 2 (Lv + Lt), D), a
// call's keys and values.  Returns 1 (cudaErrorInvalidValue) for a shape the
// kernel does not take.
extern "C" int vmr_dual_stack(int dtype, const void* v, const void* t, const void* vm,
                              const void* tm, const void* W, const void* b, const void* ln,
                              const void* xb, void* v_out, void* t_out, void* scratch,
                              void* kv_scratch, int B, int Lv, int Lt, int H, void* stream) {
  if (B < 1 || Lv < 1 || Lt < 1 || H < 1 || kD % H || (kD / H) % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 4 heads (every config that sets the stack's flag) in a kernel of its own
  auto go = [&](auto kernel_launch) {
    return kernel_launch(v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch, kv_scratch, B, Lv, Lt,
                         H, s);
  };
  if (dtype == 1)
    return H == 4 ? go(launch<__nv_bfloat16, 32>) : go(launch<__nv_bfloat16, 0>);
  return H == 4 ? go(launch<float, 32>) : go(launch<float, 0>);
}
