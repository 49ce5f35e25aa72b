// The body of kernel #4 (the whole dual-attention stack), included by
// csrc/dual_stack.cu (D 128 and the C entry) and by dual_stack_256.cu,
// dual_stack_384.cu and dual_stack_512.cu (one wider width each), and by
// dual_stack_cluster.cu (D 640-1024, which uses its helpers), which compile
// in parallel and link into one library.  csrc/dual_stack.cu states what it
// replaces, what bounds it and its design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"  // bf16, cp.async, ldmatrix, mma_bf16, pack_bf16, quad_max, quad_sum
#include "mma_tf32.cuh"  // split_tf32, mma_3xtf32

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // attention: query rows per warp task, one mma row tile
// attention's bodies past the exact ones: kNarrowHD bounds the narrow heads
// (head dims 1, 2, 3 and 6: element reads, statistics in device memory),
// kMaxHeadDim the wide ones (192-512: loops to the head dim at run time)
constexpr int kNarrowHD = 8;
constexpr int kMaxHeadDim = 512;
// floats of one block's narrow-head statistics in device memory: a max and a
// sum for each (row, head) of a tile, 2 kTile D at most
constexpr int kNarrowStat = 16384;
constexpr int kSmemLimit = 232448;  // bytes of shared memory an H100 block may hold
constexpr float kMask = -1e30f;
constexpr float kLnEps = 1e-6f;

// The layout at each width D: kTile, the rows of a tile (from-rows, and to-
// and from-rows for k, v); kKC, gemm_f32's weight rows a staged chunk; kWK,
// gemm_mma's weight rows a bf16 slot (two slots); kStage, the most keys of a
// side staged at once (one walk); kKeys, the keys of a longer side's chunk;
// kShare, whether that chunk's K and V share one buffer.
template <int D> struct Lay;
template <> struct Lay<128> { static constexpr int kTile = 64, kKC = 32, kWK = 64, kStage = 64, kKeys = 32, kShare = 1; };
template <> struct Lay<256> { static constexpr int kTile = 32, kKC = 16, kWK = 32, kStage = 32, kKeys = 32, kShare = 0; };
template <> struct Lay<384> { static constexpr int kTile = 16, kKC = 16, kWK = 32, kStage = 16, kKeys = 16, kShare = 0; };
template <> struct Lay<512> { static constexpr int kTile = 16, kKC = 8, kWK = 16, kStage = 16, kKeys = 16, kShare = 0; };
constexpr int kWidths[] = {128, 256, 384, 512};

template <int D> struct L : Lay<D> {
  using Lay<D>::kTile, Lay<D>::kKC, Lay<D>::kWK, Lay<D>::kStage, Lay<D>::kKeys;
  static constexpr int kLD = D + 4;  // padded row stride of the activation buffers
  static constexpr int kWS = D + 8;  // gemm_mma: slot row stride, ldmatrix rows on distinct banks
  static constexpr int kKS = D + 8;  // attention, bf16: staged K and V row stride, the same way
  static constexpr int kChunks = D / kKC;
  static constexpr int kMaxH = D / 4;  // heads of at least 4 dims
  static constexpr int kBuf = kTile * kLD;
  // the weight staging buffer: gemm_f32's two f32 chunks or gemm_mma's two
  // bf16 slots
  static constexpr int kWFloats = 2 * kKC * D > kWK * kWS ? 2 * kKC * D : kWK * kWS;
  // attention over a longer side: each (row, head)'s max and sum between chunks
  static constexpr int kStatFloats = 2 * kTile * kMaxH;
  static constexpr int kSmemFloats = 5 * kBuf + kWFloats + kStatFloats + kTile + kStage;
  // gemm_mma: 16-row bands, the warps of a band side by side over D
  static constexpr int kBandWarps = kWarps / (kTile / 16);
  static constexpr int kWarpCols = D / kBandWarps;
  // gemm_f32: warps of 4 rows and 128 columns, the rest idle
  static constexpr int kF32Warps = kTile / 4 * (D / 128);
  static constexpr int kChunkPer = kKC * D / kThreads;  // gemm_f32: weights a thread stages

  static_assert(kSmemFloats * 4 <= kSmemLimit, "the layout fits a block");
  static_assert(2 * kTile * D <= kNarrowStat && D <= kMaxHeadDim, "every head count's statistics");
  static_assert(kTile % 16 == 0 && kWarps % (kTile / 16) == 0 && kWarpCols % 8 == 0, "bands");
  static_assert(D % kWK == 0 && kWK % 16 == 0 && D / kWK % 2 == 0,
                "a product streams an even number of whole chunks: the next one's first goes to slot 0");
  static_assert(D % 128 == 0 && kF32Warps <= kWarps && kChunkPer % 4 == 0 && D % kKC == 0 &&
                    kKC % 4 == 0, "gemm_f32's map");
  static_assert(kStage % 16 == 0 && kKeys % 16 == 0 && kKeys <= kStage, "bf16 P.V: 16 keys a step");
  // a stage's keys fit a buffer: f32 rows of kLD floats, bf16 rows of kKS
  static_assert(kStage * kLD <= kBuf && (Lay<D>::kShare ? 2 : 1) * kKeys * kLD <= kBuf, "f32 keys");
  static_assert(kStage * kKS / 2 <= kBuf && (Lay<D>::kShare ? 2 : 1) * kKeys * kKS / 2 <= kBuf,
                "bf16 keys");
};

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

// a's rows from row0 on, rows of D
template <typename T, int D> __device__ __forceinline__ Act act_rows(Act a, int row0) {
  const long long n = (long long)row0 * D;
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
template <int D> struct Smem {
  float *A, *Bf, *C, *Dq, *E, *wbuf, *stat, *fm, *km;
  __device__ explicit Smem(float* s) {
    constexpr int kBuf = L<D>::kBuf;
    A = s, Bf = A + kBuf, C = Bf + kBuf, Dq = C + kBuf, E = Dq + kBuf, wbuf = E + kBuf;
    stat = wbuf + L<D>::kWFloats, fm = stat + L<D>::kStatFloats, km = fm + L<D>::kTile;
  }
};

// A thread's kChunkPer consecutive elements of one (kKC, D) weight chunk.
template <typename T, int D>
__device__ __forceinline__ void load_chunk(const T* W, int chunk, float (&r)[L<D>::kChunkPer]) {
  constexpr int kPer = L<D>::kChunkPer;
  const T* src = W + chunk * L<D>::kKC * D + threadIdx.x * kPer;
#pragma unroll
  for (int i = 0; i < kPer; i += 4) {
    const float4 a = load4(src + i);
    r[i] = a.x, r[i + 1] = a.y, r[i + 2] = a.z, r[i + 3] = a.w;
  }
}

template <int D>
__device__ __forceinline__ void store_chunk(const float (&r)[L<D>::kChunkPer], float* wb) {
  constexpr int kPer = L<D>::kChunkPer;
  float4* dst = reinterpret_cast<float4*>(wb + threadIdx.x * kPer);
#pragma unroll
  for (int i = 0; i < kPer; i += 4) dst[i / 4] = make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
}

__device__ __forceinline__ float pick(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// out(r, c) = sum_k A0[r][k] W[k][c] (+ sum_k A1[r][k] W[k][c] when NA is 2)
// for r < M, handed to epi(r, c, sum).  A0/A1: activation buffers in shared
// memory; W: one (D, D) matrix, (in, out), in device memory; wbuf: the
// two-chunk staging buffer.  Warp w owns rows 4 (w / (D / 128)).. + 3 and the
// 128 columns from 128 (w % (D / 128)), lane l 4 of them from 4 l (warps
// past kF32Warps idle).  With RoundA the operand is rounded to T as it is
// read (the buffer keeps the f32 value for a later use).  Ends with a block
// barrier.
template <typename T, int D, int NA, bool RoundA, typename Epi>
__device__ __forceinline__ void gemm_f32(const float* A0, const float* A1, int M, const T* W,
                                         float* wbuf, Epi epi) {
  using Ly = L<D>;
  constexpr int kKC = Ly::kKC, kLD = Ly::kLD, kChunks = Ly::kChunks, kGroups = D / 128;
  const int warp = threadIdx.x >> 5, tx = threadIdx.x & 31;
  const int r0 = warp / kGroups * 4, col0 = warp % kGroups * 128 + tx * 4;
  const bool active = (Ly::kF32Warps == kWarps || warp < Ly::kF32Warps) && r0 < M;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float wr[Ly::kChunkPer];
  load_chunk<T, D>(W, 0, wr);
  store_chunk<D>(wr, wbuf);
  __syncthreads();
  constexpr int nchunk = NA * kChunks;
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) load_chunk<T, D>(W, (c + 1) % kChunks, wr);
    const float* wb = wbuf + (c & 1) * kKC * D + col0;
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
          const float4 w = load4(wb + (kk + k4) * D);
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
    if (c + 1 < nchunk) store_chunk<D>(wr, wbuf + ((c + 1) & 1) * kKC * D);
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(r0 + i, col0 + j, acc[i][j]);
    }
  }
  __syncthreads();
}

// Rows [kWK chunk, kWK chunk + kWK) of W, bf16, into slot `slot` of the
// weight buffer with 16-byte cp.async copies; one commit group.
template <int D>
__device__ __forceinline__ void stage_chunk(bf16* ws, int slot, const bf16* W, int chunk) {
  constexpr int kWK = L<D>::kWK, kWS = L<D>::kWS;
  bf16* dst = ws + slot * kWK * kWS;
  const bf16* src = W + chunk * kWK * D;
  for (int p = threadIdx.x; p < kWK * D / 8; p += kThreads) {
    const int r = p / (D / 8), c = p % (D / 8) * 8;
    cp_async16(dst + r * kWS + c, src + r * D + c);
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
// operands, f32 accumulation.  Warp w owns rows 16 (w / kBandWarps).. and
// kWarpCols columns from kWarpCols (w % kBandWarps) (four n8 tiles, three at
// D 384; 4 accumulators a tile and thread); warps whose rows start at or
// beyond M skip the products.  A fragments are read from the f32 activation
// buffers and rounded to bf16 as they are read (the TPU's operand rounding;
// a buffer that already holds rounded values is unchanged by it); NA = 2
// accumulates A1 W into the same fragments.  W streams in chunks of kWK rows
// through two slots, chunk c in slot c % 2: the first was staged by the
// product before (pending == W) or is staged now, the second is staged on
// entry, each later one once every warp is done with the chunk before it;
// when the last chunk is reached, Wnext's first goes to slot 0, so that it
// loads behind this product's last chunk, its epilogue and whatever runs
// before the next product.  Ends with a block barrier.
template <int D, int NA, typename Epi>
__device__ __forceinline__ void gemm_mma(const float* A0, const float* A1, int M, const bf16* W,
                                         const bf16* Wnext, bf16* ws, const bf16*& pending,
                                         Epi epi) {
  using Ly = L<D>;
  constexpr int kLD = Ly::kLD, kWK = Ly::kWK, kWS = Ly::kWS, kNC = D / kWK;
  constexpr int kNT = Ly::kWarpCols / 8;  // n8 tiles a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int r0 = warp / Ly::kBandWarps * 16, c0 = warp % Ly::kBandWarps * Ly::kWarpCols;
  const bool active = r0 < M;
  if (pending != W) {
    if (pending) cp_async_wait<0>();  // a prefetch of another matrix lands before slot 0 is reused
    stage_chunk<D>(ws, 0, W, 0);
  }
  stage_chunk<D>(ws, 1, W, 1);
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll (kNC == 2 ? 2 : 1)
  for (int chunk = 0; chunk < kNC; ++chunk) {
    if (chunk == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (chunk == kNC - 1) {
      pending = Wnext;
      if (Wnext) stage_chunk<D>(ws, 0, Wnext, 0);
    } else if (chunk >= 1) {
      stage_chunk<D>(ws, (chunk + 1) & 1, W, chunk + 1);
    }
    if (active) {
      const bf16* slot = ws + (chunk & 1) * kWK * kWS;
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        const int k0 = chunk * kWK + 16 * kk;
        uint32_t a[NA][4];
#pragma unroll
        for (int n = 0; n < NA; ++n) {
          const float* ap = (n ? A1 : A0) + (r0 + g) * kLD + k0 + 2 * t;
          a[n][0] = pack_pair(ap), a[n][1] = pack_pair(ap + 8 * kLD);
          a[n][2] = pack_pair(ap + 8), a[n][3] = pack_pair(ap + 8 * kLD + 8);
        }
        const bf16* brow = slot + (16 * kk + r8 + ((mi & 1) << 3)) * kWS + c0;
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, brow + 16 * np + ((mi >> 1) << 3));
#pragma unroll
          for (int n = 0; n < NA; ++n) {
            mma_bf16(acc[2 * np], a[n], b[0], b[1]);
            mma_bf16(acc[2 * np + 1], a[n], b[2], b[3]);
          }
        }
        if constexpr (kNT % 2) {  // the last n8 tile alone
          uint32_t b[2];
          ldmatrix_x2_trans(b, brow + 8 * (kNT - 1));
#pragma unroll
          for (int n = 0; n < NA; ++n) mma_bf16(acc[kNT - 1], a[n], b[0], b[1]);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
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
// whose first chunk gemm_mma has in flight.
template <typename T, int D, int NA, bool RoundA, typename Epi>
__device__ __forceinline__ void gemm(const float* A0, const float* A1, int M, const T* W,
                                     const T* Wnext, const Smem<D>& sm, const T*& pending,
                                     Epi epi) {
  if constexpr (std::is_same<T, bf16>::value)
    gemm_mma<D, NA>(A0, A1, M, W, Wnext, reinterpret_cast<bf16*>(sm.wbuf), pending, epi);
  else
    gemm_f32<T, D, NA, RoundA>(A0, A1, M, W, sm.wbuf, epi);
}

// LayerNorm of M rows, one warp per row, a lane on 4 columns of every 128;
// the result is rounded to T (it is only ever a matmul operand).  row4(r, c)
// gives the row's 4 values from column c.
template <typename T, int D, typename Row4>
__device__ __forceinline__ void layer_norm(int M, Row4 row4, const float* scale,
                                           const float* bias, float* out) {
  constexpr int kLD = L<D>::kLD, kGroups = D / 128;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4 s[kGroups], b[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k)
    s[k] = load4(scale + 128 * k + lane * 4), b[k] = load4(bias + 128 * k + lane * 4);
  for (int r = warp; r < M; r += kWarps) {
    float4 x[kGroups];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      x[k] = row4(r, 128 * k + lane * 4);
      sum = k ? sum + (x[k].x + x[k].y + x[k].z + x[k].w) : x[k].x + x[k].y + x[k].z + x[k].w;
    }
    const float mu = warp_sum(sum) * (1.f / D);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      x[k].x -= mu, x[k].y -= mu, x[k].z -= mu, x[k].w -= mu;
      const float q = x[k].x * x[k].x + x[k].y * x[k].y + x[k].z * x[k].z + x[k].w * x[k].w;
      sq = k ? sq + q : q;
    }
    const float var = warp_sum(sq) * (1.f / D);
    const float inv = rsqrtf(var + kLnEps);
#pragma unroll
    for (int k = 0; k < kGroups; ++k)
      *reinterpret_cast<float4*>(out + r * kLD + 128 * k + lane * 4) = make_float4(
          round_to<T>(x[k].x * inv * s[k].x + b[k].x), round_to<T>(x[k].y * inv * s[k].y + b[k].y),
          round_to<T>(x[k].z * inv * s[k].z + b[k].z), round_to<T>(x[k].w * inv * s[k].w + b[k].w));
  }
}

// Copies keys [c0, c0 + NK) of K (and, with V, of V) from device memory
// ((Tn, D) in T, already rounded) into the rows of kb (and vb), zero beyond
// Tn; their validity into km.  f32 rows of kLD floats; bf16 rows of kKS
// bf16, copied as they are (no conversion).  Every thread issues its loads
// (ld.global.cg: the scratch was written in this launch) before its first
// store, so that a stage waits on one round trip to L2.
template <typename T, int D, int NK, bool V>
__device__ __forceinline__ void stage_keys(float* kb, float* vb, float* km, const T* kg,
                                           const T* vg, const float* km_g, int c0, int Tn) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kRow = D * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  constexpr int kPieces = NK * kRow, kAll = (V ? 2 : 1) * kPieces;
  constexpr int kPer = (kAll + kThreads - 1) / kThreads;
  constexpr bool kWhole = kPer * kThreads == kAll;  // else the last round is partial
  const int n = min(NK, Tn - c0);
  const int j0 = threadIdx.x;  // this thread's key validity, read with K and V
  const float kmv = j0 < n ? __ldcg(km_g + c0 + j0) : 0.f;
  uint4 x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads, m = idx / kPieces;
    const int j = idx % kPieces / kRow, c = idx % kRow * (16 / (int)sizeof(T));
    const T* src = (m ? vg : kg) + (long long)(c0 + j) * D + c;
    x[i] = j < n && (kWhole || idx < kAll) ? __ldcg(reinterpret_cast<const uint4*>(src))
                                           : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads, m = idx / kPieces;
    const int j = idx % kPieces / kRow, c = idx % kRow * (16 / (int)sizeof(T));
    if (!kWhole && idx >= kAll) continue;
    float* dst = m ? vb : kb;
    if constexpr (kBf16)
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(dst) + j * L<D>::kKS + c) = x[i];
    else
      *reinterpret_cast<uint4*>(dst + j * L<D>::kLD + c) = x[i];
  }
  if (j0 < NK) km[j0] = kmv;
}

// The steps of a product over the head dim, step(kk) for kk < n: unrolled
// when HD bounds it (n = (HD + W - 1) / W), a loop to the head dim read at
// run time past kSliceHD (n = hd / W; the wide heads are multiples of 32),
// one step at a time (two at once spilled the f32 body's registers at D
// 384 and 512).
constexpr int kSliceHD = 128;
template <int HD, int W, typename Step>
__device__ __forceinline__ void head_steps(int hd, Step step) {
  if constexpr (HD > kSliceHD) {
#pragma unroll 1
    for (int kk = 0; kk < hd / W; ++kk) step(kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < (HD + W - 1) / W; ++kk) step(kk);
  }
}

// s[j] += Q K^T for the task's 16 rows (ra = r0 + g and ra + 8 of q) and the
// NT n-tiles of 8 staged keys (bf16 rows 8 j + g of ks), over the head's hd
// columns from c0 (HD a bound on hd), on mma.sync m16n8k16.  A fragments are
// read from the f32 buffer and rounded to bf16 as they are read (pack_pair; q
// holds values already rounded, so this is exact), B fragments as pairs of
// staged bf16 (rows of kKS / 2 words, 4 apart mod 32: the 32 lanes on 32
// banks); k past hd is zero in registers: no neighbouring head's column
// enters a product.  Narrow heads (kNarrow: hd below 8, odd ones starting on
// odd columns, where a pair would be misaligned and could take the next
// head's first column) read each element alone, held to the head.
template <int D, int HD, int NT, bool kNarrow>
__device__ __forceinline__ void scores_bf16(float (&s)[NT][4], const float* q, const bf16* ks,
                                            int ra, int c0, int g, int t, int hd) {
  constexpr int kLD = L<D>::kLD, kKS = L<D>::kKS;
  if constexpr (kNarrow) {  // one k-step, its upper half zero
    const int c = 2 * t;
    const bool e0 = c < hd, e1 = c + 1 < hd;
    const float* qa = q + ra * kLD + c0 + c;
    const uint32_t a[4] = {pack_bf16(e0 ? qa[0] : 0.f, e1 ? qa[1] : 0.f),
                           pack_bf16(e0 ? qa[8 * kLD] : 0.f, e1 ? qa[8 * kLD + 1] : 0.f), 0u, 0u};
    const unsigned short* k16 = reinterpret_cast<const unsigned short*>(ks) + c0 + c;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const unsigned short* kp = k16 + (8 * j + g) * kKS;
      mma_bf16(s[j], a, (e0 ? (uint32_t)kp[0] : 0u) | (e1 ? (uint32_t)kp[1] << 16 : 0u), 0u);
    }
  } else {
    head_steps<HD, 16>(hd, [&](int kk) {
      const int c = c0 + 16 * kk + 2 * t;
      const bool lo = 16 * kk + 2 * t < hd, hi = 16 * kk + 2 * t + 8 < hd;
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
    });
  }
}

// scores_bf16's product in f32 on mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh):
// each operand split into big and small TF32 parts as it is read, one
// element at a time (so narrow heads need nothing of their own).
template <int D, int HD, int NT>
__device__ __forceinline__ void scores_tf32(float (&s)[NT][4], const float* q, const float* kb,
                                            int ra, int c0, int g, int t, int hd) {
  constexpr int kLD = L<D>::kLD;
  head_steps<HD, 8>(hd, [&](int kk) {
    const int c = c0 + 8 * kk + t;
    const bool lo = 8 * kk + t < hd, hi = 8 * kk + t + 4 < hd;
    const float* qa = q + ra * kLD + c;
    uint32_t ab[4], as[4];
    split_tf32(lo ? qa[0] : 0.f, ab[0], as[0]);
    split_tf32(lo ? qa[8 * kLD] : 0.f, ab[1], as[1]);
    split_tf32(hi ? qa[4] : 0.f, ab[2], as[2]);
    split_tf32(hi ? qa[8 * kLD + 4] : 0.f, ab[3], as[3]);
    constexpr int kRound = NT < 4 ? NT : 4;  // n-tiles a round: 16 B registers live at most
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += kRound) {
      uint32_t bb[kRound][2], bs[kRound][2];
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const float* kp = kb + (8 * (j0 + u) + g) * kLD + c;
        split_tf32(lo ? kp[0] : 0.f, bb[u][0], bs[u][0]);
        split_tf32(hi ? kp[4] : 0.f, bb[u][1], bs[u][1]);
      }
      mma_3xtf32<kRound>(s, j0, ab, as, bb, bs, kRound);
    }
  });
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
// the first n are keys of the side.  The head dim is HD, or with !kExact
// hd_rt <= HD (products past it zero in registers, columns past it never
// stored): narrow heads (HD kNarrowHD) read and write q, K and out one
// element at a time, wide ones (HD kMaxHeadDim) loop to hd at run time.
// The scores take the additive mask (1 - fm km) kMask and -inf past
// n; their row max and sum are reduced over the quad (the 4 lanes that hold
// one mma row); p's C fragments are P.V's A fragments as they stand.  out
// (f32 rows of stride kLD) gets the task's own rows and head columns only;
// stat holds each (row, head)'s max and sum between the stages of a longer
// side.  first / last: the stage is the side's first / last.
template <typename T, int D, int HD, bool kExact, int NT, Walk W>
__device__ __forceinline__ void attend_task(const float* q, float* out, const float* kb,
                                            const float* vb, const float* fm, const float* km,
                                            float* stat, int r0, int h, int n, float scale,
                                            bool first, bool last, int hd_rt) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kLD = L<D>::kLD, kKS = L<D>::kKS;
  constexpr bool kNarrow = !kExact && HD == kNarrowHD;
  constexpr int ND = (HD + 7) / 8, G = ND < 4 ? ND : 4;
  static_assert(!kBf16 || NT % 2 == 0, "bf16 P.V takes keys 16 at a time");
  const int hd = kExact ? HD : hd_rt, H = D / hd;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = h * hd, ra = r0 + g, rb = ra + 8;

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if constexpr (kBf16)
    scores_bf16<D, HD, NT, kNarrow>(s, q, reinterpret_cast<const bf16*>(kb), ra, c0, g, t, hd);
  else
    scores_tf32<D, HD, NT>(s, q, kb, ra, c0, g, t, hd);
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

  // out (+)= P V, in rounds of G n-tiles of 8 head columns (at run time to
  // hd for wide heads: their rounds are whole); past hd the values are zero
  // in registers (f32) or their products are never stored (bf16: columns
  // past hd are the next head's, or a row's padding)
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
  float* oa = out + ra * kLD + c0;
  float* ob = out + rb * kLD + c0;
  head_steps<HD, 8 * G>(hd, [&](int step) {
    const int d0 = G * step;
    float o[G][4];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int col = 8 * (d0 + u) + 2 * t;
      if (W == kOne || first || col >= hd) {
        o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
      } else if constexpr (kNarrow) {  // the pair's second column may be the next head's
        const bool e1 = col + 1 < hd;
        o[u][0] = oa[col] * fa_, o[u][1] = e1 ? oa[col + 1] * fa_ : 0.f;
        o[u][2] = ob[col] * fb_, o[u][3] = e1 ? ob[col + 1] * fb_ : 0.f;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(oa + col);
        const float2 b = *reinterpret_cast<const float2*>(ob + col);
        o[u][0] = a.x * fa_, o[u][1] = a.y * fa_, o[u][2] = b.x * fb_, o[u][3] = b.y * fb_;
      }
    }
    if constexpr (kBf16) {
      // B from the staged bf16 V: ldmatrix.trans, two n-tiles an x4 (one an
      // x2 at head dim 8), where every head's columns start on 16 bytes (the
      // head dims past 16 of every width are multiples of 8); else pairs of
      // elements (head dims 4, the narrow ones, and up to 16 in the shared
      // kernels of the wider D), zero past hd
      const bf16* vs = reinterpret_cast<const bf16*>(vb);
      const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const bf16* vr = vs + (16 * kk + r8 + ((mi & 1) << 3)) * kKS + c0 + 8 * d0;
        if constexpr (HD >= 16 && (kExact ? HD % 8 == 0 : HD > 16)) {
#pragma unroll
          for (int u = 0; u < G; u += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vr + 8 * u + ((mi >> 1) << 3));
            mma_bf16(o[u], pa[kk], b[0], b[1]);
            mma_bf16(o[u + 1], pa[kk], b[2], b[3]);
          }
        } else if constexpr (kExact && HD == 8) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, vr);
          mma_bf16(o[0], pa[kk], b[0], b[1]);
        } else {
          const unsigned short* v16 =
              reinterpret_cast<const unsigned short*>(vs) + c0 + 8 * d0 + g;
          const int k0 = 16 * kk + 2 * t;
#pragma unroll
          for (int u = 0; u < G; ++u) {
            const bool ok = 8 * (d0 + u) + g < hd;
            auto pair = [&](int k) {
              return ok ? (uint32_t)v16[k * kKS + 8 * u] | (uint32_t)v16[(k + 1) * kKS + 8 * u] << 16
                        : 0u;
            };
            mma_bf16(o[u], pa[kk], pair(k0), pair(k0 + 8));
          }
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
          const bool ok = d + g < hd;
          split_tf32(ok ? vr[d] : 0.f, bb[u][0], bs[u][0]);
          split_tf32(ok ? vr[kLD + d] : 0.f, bb[u][1], bs[u][1]);
        }
        mma_3xtf32<G>(o, 0, ab, as, bb, bs, G);
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int col = 8 * (d0 + u) + 2 * t;
      if (col >= hd) continue;
      float2 a = make_float2(o[u][0], o[u][1]), b = make_float2(o[u][2], o[u][3]);
      if (W == kOne || last) {
        if constexpr (W == kOnline)
          a.x *= ia, a.y *= ia, b.x *= ib, b.y *= ib;
        a.x = round_to<T>(a.x), a.y = round_to<T>(a.y), b.x = round_to<T>(b.x);
        b.y = round_to<T>(b.y);
      }
      if constexpr (kNarrow) {
        oa[col] = a.x, ob[col] = b.x;
        if (col + 1 < hd) oa[col + 1] = a.y, ob[col + 1] = b.y;
      } else {
        *reinterpret_cast<float2*>(oa + col) = a;
        *reinterpret_cast<float2*>(ob + col) = b;
      }
    }
  });
}

// The tasks of one stage: (16 rows, one head) for every row group below M,
// warps round-robin.  Ends with a block barrier.
template <typename T, int D, int HD, bool kExact, int NT, Walk W>
__device__ __forceinline__ void attend_stage(const float* q, float* out, int M, const float* kb,
                                             const float* vb, const float* fm, const float* km,
                                             float* stat, int n, bool first, bool last,
                                             int hd_rt) {
  const int hd = kExact ? HD : hd_rt, H = D / hd;
  const float scale = 1.f / sqrtf((float)hd);
  const int ntask = (M + kRows - 1) / kRows * H;
  for (int task = threadIdx.x >> 5; task < ntask; task += kWarps)
    attend_task<T, D, HD, kExact, NT, W>(q, out, kb, vb, fm, km, stat, task / H * kRows,
                                         task % H, n, scale, first, last, hd);
  __syncthreads();
}

// H-head attention of a tile's M query rows (q, rounded to T; the buffer at
// q_at floats into the shared memory) over Tn keys whose K and V ((Tn, D) in
// T, rounded) are in device memory; the context, rounded to T, goes to the
// buffer at out_at.  The head dim is HD, or with !kExact hd_rt <= HD.  sm.fm
// holds the tile rows' validity (0 beyond M), km_g (Tn,) the keys'.  Rows of
// the last row group beyond M are computed on finite values and never read.
// The max and sum of each (row, head) go to sm.stat; narrow heads, up to D
// of them (more than sm.stat holds), keep theirs in stat_g: the block's
// kNarrowStat floats of device memory (L2-resident, read back by the warp
// that wrote them).
//
// Tn <= kStage: K and V staged once (kKeys or kStage keys) into Bf and C,
// one walk, the scores in registers; out may be q (a task reads only its own
// slice of q, and has read it before it writes).
// Longer sides: chunks of kKeys keys with K in Bf and V after K's rows (at
// D 128) or in the buffer at v_at (wider D), out != q.  bf16 walks twice, p
// being rounded where the plain version rounds it, after the final max and
// sum: the max and sum first over chunks of kStage keys (K alone), then p
// and P.V.  f32 walks once, max and sum rescaled as they grow (rounding p to
// f32 is the identity, so this is exact up to the order of the sums).
template <typename T, int D, int HD, bool kExact>
__device__ __noinline__ void attention(int q_at, int out_at, int v_at, int M, const T* kg,
                                       const T* vg, const float* km_g, int Tn, int hd,
                                       float* stat_g) {
  using Ly = L<D>;
  constexpr int kStage = Ly::kStage, kKeys = Ly::kKeys;
  // the buffers rebuilt from smem_base(): shared-memory accesses (a pointer
  // argument of a call that is not inlined would make every one generic)
  const Smem<D> sm(smem_base());
  const float* q = smem_base() + q_at;
  float* out = smem_base() + out_at;
  float *kb = sm.Bf, *vb = sm.C, *km = sm.km;
  float* stat = !kExact && HD == kNarrowHD ? stat_g : sm.stat;
  const float* fm = sm.fm;
  if (Tn <= kStage) {
    if (kKeys < kStage && Tn <= kKeys) {
      stage_keys<T, D, kKeys, true>(kb, vb, km, kg, vg, km_g, 0, Tn);
      __syncthreads();
      attend_stage<T, D, HD, kExact, kKeys / 8, kOne>(q, out, M, kb, vb, fm, km, stat, Tn, true,
                                                      true, hd);
    } else {
      stage_keys<T, D, kStage, true>(kb, vb, km, kg, vg, km_g, 0, Tn);
      __syncthreads();
      attend_stage<T, D, HD, kExact, kStage / 8, kOne>(q, out, M, kb, vb, fm, km, stat, Tn, true,
                                                       true, hd);
    }
    return;
  }
  // V after K's rows in one buffer, or a buffer of its own
  float* vc = Ly::kShare ? kb + kKeys * (std::is_same<T, bf16>::value ? Ly::kKS / 2 : Ly::kLD)
                         : smem_base() + v_at;
  if constexpr (std::is_same<T, bf16>::value) {
    for (int c0 = 0; c0 < Tn; c0 += kStage) {
      stage_keys<T, D, kStage, false>(kb, nullptr, km, kg, vg, km_g, c0, Tn);
      __syncthreads();
      attend_stage<T, D, HD, kExact, kStage / 8, kStats>(q, out, M, kb, nullptr, fm, km, stat,
                                                         min(kStage, Tn - c0), c0 == 0, false, hd);
    }
    for (int c0 = 0; c0 < Tn; c0 += kKeys) {
      stage_keys<T, D, kKeys, true>(kb, vc, km, kg, vg, km_g, c0, Tn);
      __syncthreads();
      attend_stage<T, D, HD, kExact, kKeys / 8, kProbs>(q, out, M, kb, vc, fm, km, stat,
                                                        min(kKeys, Tn - c0), c0 == 0,
                                                        c0 + kKeys >= Tn, hd);
    }
  } else {
    for (int c0 = 0; c0 < Tn; c0 += kKeys) {
      stage_keys<T, D, kKeys, true>(kb, vc, km, kg, vg, km_g, c0, Tn);
      __syncthreads();
      attend_stage<T, D, HD, kExact, kKeys / 8, kOnline>(q, out, M, kb, vc, fm, km, stat,
                                                         min(kKeys, Tn - c0), c0 == 0,
                                                         c0 + kKeys >= Tn, hd);
    }
  }
}

// attention<T, D, HD, true>, or with HD 0 the body for the head dim D / H:
// narrow heads (1, 2, 3, 6) their own; exact at D 128 (the other head dims,
// 4-128, are powers of two), else the next of 16, 32, 64, 128 at or above it,
// and the wide body past 128; q and out are activation buffers of sm.  A
// longer side's V goes to C, or to A when C is out (self attention whose
// context cannot go over q).
template <typename T, int D, int HD>
__device__ __forceinline__ void attend(const float* q, float* out, int M, const T* kg, const T* vg,
                                       const float* km_g, int Tn, int H, const Smem<D>& sm,
                                       float* stat_g) {
  const int q_at = (int)(q - sm.A), out_at = (int)(out - sm.A);  // sm.A is smem_base()
  const int v_at = out == sm.C ? 0 : (int)(sm.C - sm.A);
  const int hd = D / H;
#define VMR_ATTEND(HD_, EXACT_) \
  return attention<T, D, HD_, EXACT_>(q_at, out_at, v_at, M, kg, vg, km_g, Tn, hd, stat_g)
  if constexpr (HD != 0) {
    VMR_ATTEND(HD, true);
  } else if (hd % 4) {
    VMR_ATTEND(kNarrowHD, false);
  } else if constexpr (D == 128) {
    switch (hd) {
      case 128: VMR_ATTEND(128, true);
      case 64: VMR_ATTEND(64, true);
      case 32: VMR_ATTEND(32, true);
      case 16: VMR_ATTEND(16, true);
      case 8: VMR_ATTEND(8, true);
      default: VMR_ATTEND(4, true);
    }
  } else {
    if (hd <= 16) VMR_ATTEND(16, false);
    if (hd <= 32) VMR_ATTEND(32, false);
    if (hd <= 64) VMR_ATTEND(64, false);
    if (hd <= kSliceHD) VMR_ATTEND(kSliceHD, false);
    VMR_ATTEND(kMaxHeadDim, false);
  }
#undef VMR_ATTEND
}

// Writes rows [0, M) of two activation buffers (values already rounded) to
// device memory in T: a tile's keys and values.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float* k, const float* v, int M, T* kg, T* vg) {
  for (int idx = threadIdx.x; idx < 2 * M * (D / 4); idx += kThreads) {
    const int m = idx / (M * (D / 4)), r = idx % (M * (D / 4)) / (D / 4);
    const int c = idx % (D / 4) * 4;
    store4((m ? vg : kg) + (long long)r * D + c, load4((m ? v : k) + r * L<D>::kLD + c));
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
//   s_att = attn(Dq; from-side) -> S (at the wider D, with V in A when the
//   from-side is longer than kStage: fn -> A again after it);
//   x_value = E Wxd -> Bf; s_value = S Wsd -> R; x_score = Bf Wxg -> S;
//   s_score = R Wsg -> E; R = s_score x_value + x_score s_value;
//   gc = R Wgd -> Bf; scores = (A, Bf) Wbl1 -> S; gate * values -> R;
//   residual = R Wd1 + b + x -> E; z = LN2(E) -> A; out = A Wd2 + b + E.
// Wafter: the first matrix of the next call, or null.  HD: the head dim, or
// 0 for any (dispatched at each attention).
template <typename T, int D, int HD>
__device__ __noinline__ void dab_call(Act x, Act y, Act out, const float* fm_g,
                                      const float* tm_g, int F, int Tn, int H, const T* W,
                                      const float* b, const float* ln, const float* xb, T* kvg,
                                      float* stat_g, const T* Wafter, const T*& pending) {
  using Ly = L<D>;
  constexpr int kTile = Ly::kTile, kLD = Ly::kLD, kStage = Ly::kStage;
  const Smem<D> sm(smem_base());
  float *A = sm.A, *Bf = sm.Bf, *C = sm.C, *Dq = sm.Dq, *E = sm.E, *fm = sm.fm;
  const T* Wm[kNumW];
#pragma unroll
  for (int i = 0; i < kNumW; ++i) Wm[i] = W + i * D * D;
  T* tk = kvg;
  T* tv = tk + (long long)Tn * D;
  T* fk = tv + (long long)Tn * D;
  T* fv = fk + (long long)F * D;
  auto biased_rounded = [&](float* dst, int w) {
    return [=](int r, int c, float acc) { dst[r * kLD + c] = round_to<T>(acc + b[w * D + c]); };
  };
  auto biased = [&](float* dst, int w) {
    return [=](int r, int c, float acc) { dst[r * kLD + c] = acc + b[w * D + c]; };
  };

  // both sides' keys and values, every row
  for (int side = 0; side < 2; ++side) {
    const Act src = side ? x : y;
    const int Lr = side ? F : Tn, wk = side ? W_FK : W_TK, wv = side ? W_FV : W_TV;
    const int lns = side ? LN1_S : LNT_S, lnb = side ? LN1_B : LNT_B;
    for (int r0 = 0; r0 < Lr; r0 += kTile) {
      const int M = min(kTile, Lr - r0);
      const bool more = r0 + kTile < Lr;
      layer_norm<T, D>(M, [&](int r, int c) { return act_load4<T>(src, (r0 + r) * D + c); },
                       ln + lns * D, ln + lnb * D, A);
      __syncthreads();
      gemm<T, D, 1, false>(A, nullptr, M, Wm[wk], Wm[wv], sm, pending, biased_rounded(Bf, wk));
      gemm<T, D, 1, false>(A, nullptr, M, Wm[wv], more ? Wm[wk] : side ? Wm[W_Q] : Wm[W_FK], sm,
                           pending, biased_rounded(C, wv));
      store_rows<T, D>(Bf, C, M, (side ? fk : tk) + (long long)r0 * D,
                       (side ? fv : tv) + (long long)r0 * D);
      __syncthreads();
    }
  }

  // the from-rows, tile by tile
  for (int r0 = 0; r0 < F; r0 += kTile) {
    const int M = min(kTile, F - r0);
    const Act xr = act_rows<T, D>(x, r0), outr = act_rows<T, D>(out, r0);
    auto fn = [&]() {  // LN1 of the tile's rows -> A
      layer_norm<T, D>(M, [&](int r, int c) { return act_load4<T>(xr, r * D + c); },
                       ln + LN1_S * D, ln + LN1_B * D, A);
    };
    for (int i = threadIdx.x; i < kTile; i += kThreads) fm[i] = i < M ? fm_g[r0 + i] : 0.f;
    fn();
    __syncthreads();
    gemm<T, D, 1, false>(A, nullptr, M, Wm[W_Q], Wm[W_XD], sm, pending, biased_rounded(Dq, W_Q));
    // cross attention -> E; self attention -> S, in place over q when one
    // stage holds the from-side's keys; R: the buffer that stays free
    attend<T, D, HD>(Dq, E, M, tk, tv, tm_g, Tn, H, sm, stat_g);
    float* S = F <= kStage ? Dq : C;
    float* R = F <= kStage ? C : Dq;
    attend<T, D, HD>(Dq, S, M, fk, fv, fm_g, F, H, sm, stat_g);
    if (!Ly::kShare && F > kStage) fn();  // A held the self attention's values
    // values and cross gates
    gemm<T, D, 1, false>(E, nullptr, M, Wm[W_XD], Wm[W_SD], sm, pending, biased(Bf, W_XD));
    gemm<T, D, 1, false>(S, nullptr, M, Wm[W_SD], Wm[W_XG], sm, pending, biased(R, W_SD));
    gemm<T, D, 1, true>(Bf, nullptr, M, Wm[W_XG], Wm[W_SG], sm, pending, biased(S, W_XG));
    gemm<T, D, 1, true>(R, nullptr, M, Wm[W_SG], Wm[W_GD], sm, pending, biased(E, W_SG));
    for (int idx = threadIdx.x; idx < M * D; idx += kThreads) {
      const int o = (idx / D) * kLD + idx % D;
      R[o] = round_to<T>(E[o] * Bf[o] + S[o] * R[o]);
    }
    __syncthreads();
    gemm<T, D, 1, false>(R, nullptr, M, Wm[W_GD], Wm[W_BL1], sm, pending,
                         biased_rounded(Bf, W_GD));
    // BiLinear gate: fn W + gc W + 2 b + xb, twice; sigmoid(scores masked) * values
    gemm<T, D, 2, false>(A, Bf, M, Wm[W_BL1], Wm[W_BL2], sm, pending,
                         [=](int r, int c, float acc) {
                           S[r * kLD + c] = acc + 2.f * b[W_BL1 * D + c] + xb[c];
                         });
    gemm<T, D, 2, false>(A, Bf, M, Wm[W_BL2], Wm[W_D1], sm, pending,
                         [=](int r, int c, float acc) {
                           const float values = acc + 2.f * b[W_BL2 * D + c] + xb[D + c];
                           const float z = S[r * kLD + c] + kMask * (1.f - fm[r]);
                           R[r * kLD + c] = round_to<T>(values / (1.f + expf(-z)));
                         });
    // dense + residual, LN, dense + residual
    gemm<T, D, 1, false>(R, nullptr, M, Wm[W_D1], Wm[W_D2], sm, pending,
                         [=](int r, int c, float acc) {
                           E[r * kLD + c] = acc + b[W_D1 * D + c] + act_load<T>(xr, r * D + c);
                         });
    layer_norm<T, D>(M, [&](int r, int c) { return load4(E + r * kLD + c); }, ln + LN2_S * D,
                     ln + LN2_B * D, A);
    __syncthreads();
    gemm<T, D, 1, false>(A, nullptr, M, Wm[W_D2], r0 + kTile < F ? Wm[W_Q] : Wafter, sm, pending,
                         [=](int r, int c, float acc) {
                           act_store<T>(outr, r * D + c, acc + b[W_D2 * D + c] + E[r * kLD + c]);
                         });
  }
}

// HD as in dab_call: each kernel's code holds the functions it calls, so a
// kernel for one head dim holds one attention body beside its products (on
// an H100 ~5% faster at 4 heads than one holding all six).
template <typename T, int D, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    stack_kernel(const T* v_in, const T* t_in, const float* vm, const float* tm, const T* W,
                 const float* b, const float* ln, const float* xb, T* v_out, T* t_out,
                 float* scratch, T* kv_scratch, float* stat_scratch, int Lv, int Lt, int H) {
  float* smem = smem_base();
  // rows beyond a tile's length are read (never used) by the products
  for (int i = threadIdx.x; i < 5 * L<D>::kBuf; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const long long s = blockIdx.x;
  const long long rows = Lv + Lt;
  const Act v0{v_in + s * Lv * D, false}, t0{t_in + s * Lt * D, false};
  const Act v1{scratch + s * rows * D, true};
  const Act t1{scratch + s * rows * D + (long long)Lv * D, true};
  const Act v2{v_out + s * Lv * D, false}, t2{t_out + s * Lt * D, false};
  T* kvg = kv_scratch + s * 2 * rows * D;
  float* stat_g = stat_scratch ? stat_scratch + s * kNarrowStat : nullptr;  // narrow heads only
  const float* vmask = vm + s * Lv;
  const float* tmask = tm + s * Lt;
  const T* pending = nullptr;  // the matrix whose first chunk gemm_mma has in flight
  for (int layer = 0; layer < 2; ++layer) {
    const T* Wl = W + layer * kNumW * D * D;
    const float* bl = b + layer * kNumW * D;
    const float* lnl = ln + layer * kNumLn * D;
    const float* xbl = xb + layer * 2 * D;
    const Act xv = layer ? v1 : v0, xt = layer ? t1 : t0;
    // each call's first product is W_TK: of this layer, then of the next
    const T* Wnext = layer ? nullptr : W + kNumW * D * D + W_TK * D * D;
    dab_call<T, D, HD>(xv, xt, layer ? v2 : v1, vmask, tmask, Lv, Lt, H, Wl, bl, lnl, xbl, kvg,
                       stat_g, Wl + W_TK * D * D, pending);
    dab_call<T, D, HD>(xt, xv, layer ? t2 : t1, tmask, vmask, Lt, Lv, H, Wl, bl, lnl, xbl, kvg,
                       stat_g, Wnext, pending);
    __syncthreads();  // the scratch rows written above are read by other threads below
  }
}

template <typename T, int D, int HD>
int launch(const void* v, const void* t, const void* vm, const void* tm, const void* W,
           const void* b, const void* ln, const void* xb, void* v_out, void* t_out,
           void* scratch, void* kv_scratch, void* stat_scratch, int B, int Lv, int Lt, int H,
           cudaStream_t stream) {
  const size_t bytes = (size_t)L<D>::kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stack_kernel<T, D, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  stack_kernel<T, D, HD><<<B, kThreads, bytes, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(t), static_cast<const float*>(vm),
      static_cast<const float*>(tm), static_cast<const T*>(W), static_cast<const float*>(b),
      static_cast<const float*>(ln), static_cast<const float*>(xb), static_cast<T*>(v_out),
      static_cast<T*>(t_out), static_cast<float*>(scratch), static_cast<T*>(kv_scratch),
      static_cast<float*>(stat_scratch), Lv, Lt, H);
  return (int)cudaGetLastError();
}

// One width's kernels for (dtype, H): 4 heads (every config that sets the
// stack's flag) in a kernel of their own.  The arguments are the entry's.
template <int D>
int stack_width(int dtype, const void* v, const void* t, const void* vm, const void* tm,
                const void* W, const void* b, const void* ln, const void* xb, void* v_out,
                void* t_out, void* scratch, void* kv_scratch, void* stat_scratch, int B, int Lv,
                int Lt, int H, cudaStream_t s) {
  auto go = [&](auto kernel_launch) {
    return kernel_launch(v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch, kv_scratch,
                         stat_scratch, B, Lv, Lt, H, s);
  };
  if (dtype == 1)
    return H == 4 ? go(launch<bf16, D, D / 4>) : go(launch<bf16, D, 0>);
  return H == 4 ? go(launch<float, D, D / 4>) : go(launch<float, D, 0>);
}

}  // namespace

// The wider widths' parts (dual_stack_<D>.cu): stack_width<D> with C linkage.
#define VMR_DUAL_STACK_PART_ARGS                                                              \
  int dtype, const void *v, const void *t, const void *vm, const void *tm, const void *W,     \
      const void *b, const void *ln, const void *xb, void *v_out, void *t_out, void *scratch, \
      void *kv_scratch, void *stat_scratch, int B, int Lv, int Lt, int H, cudaStream_t s
extern "C" int vmr_dual_stack_256(VMR_DUAL_STACK_PART_ARGS);
extern "C" int vmr_dual_stack_384(VMR_DUAL_STACK_PART_ARGS);
extern "C" int vmr_dual_stack_512(VMR_DUAL_STACK_PART_ARGS);
