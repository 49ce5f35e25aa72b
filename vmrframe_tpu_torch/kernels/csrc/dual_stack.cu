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
// and 2 over the to-rows a call), the rest attention.  So the projections
// go to the tensor cores in bf16; attention stays on the CUDA cores.
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
// Attention, both types, on the CUDA cores: a warp task is (4 query rows,
// one head); lanes take keys for the scores and head dims for p v.  A side
// of at most 64 keys is staged once (K and V in two buffers) and walked once
// with the scores in registers; self attention then writes its context over
// the query in place.  A longer side is staged 32 keys at a time and walked
// twice: max and sum first, then p = exp(s - max) / sum rounded to T and p v
// (an online softmax would round p before the final max is known, not where
// the TPU kernel and the plain version round it).  The first layer's results
// go to an f32 scratch in device memory that the same block reads back, so
// nothing is rounded between the layers, as on the TPU.
//
// Numerics follow the TPU kernel body: fn, tn, k, v, the probabilities and
// every matmul operand are rounded to T (the weights' type); LN, softmax,
// the sigmoid and all sums are f32; additive -1e30 key masks per sample; the
// BiLinear is two products, over fn and over gc, accumulated into the same
// sums.  Ragged lengths are loop bounds and row guards; rows of a tile
// beyond its length hold finite values that are computed on and never
// stored.
//
// Takes D = 128, H dividing 128 with a head dim that is a multiple of 4, and
// any Lv, Lt >= 1.  Interface: plain C, loaded with ctypes; the entry
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"  // bf16, cp.async, ldmatrix, mma_bf16, pack_bf16

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
constexpr int kStage = 64;  // attention_one: keys staged at once, two a lane
constexpr int kKeys = 32;   // attention_chunked: keys per staged chunk, a lane each
constexpr int kRows = 4;    // attention: query rows per warp task
constexpr int kMaxH = kD / 4;  // heads of at least 4 dims
constexpr int kBuf = kTile * kLD;
// the weight staging buffer: gemm_f32's two f32 chunks or gemm_mma's two
// bf16 slots
constexpr int kWFloats = 2 * kKC * kD > kHalf * kWS ? 2 * kKC * kD : kHalf * kWS;
// attention: per-warp probabilities, and attention_chunked's per-(row, head)
// max and sum beside its shorter ones
constexpr int kAttnFloats = kWarps * kStage * kRows > kWarps * kKeys * kRows + 2 * kTile * kMaxH
                                ? kWarps * kStage * kRows
                                : kWarps * kKeys * kRows + 2 * kTile * kMaxH;
constexpr int kSmemFloats = 5 * kBuf + kWFloats + kAttnFloats + kTile + kStage;
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

// max and sum over a warp of each of N values, the N reductions interleaved
template <int N> __device__ __forceinline__ void warp_max(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
}

template <int N> __device__ __forceinline__ void warp_sum(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
}

__device__ __forceinline__ float warp_sum(float v) {
  float a[1] = {v};
  warp_sum(a);
  return a[0];
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
// weight staging buffer, attention's region, and the tile rows' and staged
// keys' validity.  Built from smem_base() in the function that uses it, so
// that the compiler sees shared-memory addresses (LDS/STS, not generic
// loads).
struct Smem {
  float *A, *Bf, *C, *Dq, *E, *wbuf, *p_s, *stat, *fm, *km;
  __device__ explicit Smem(float* s) {
    A = s, Bf = A + kBuf, C = Bf + kBuf, Dq = C + kBuf, E = Dq + kBuf, wbuf = E + kBuf;
    p_s = wbuf + kWFloats, stat = p_s + kWarps * kKeys * kRows, fm = p_s + kAttnFloats;
    km = fm + kTile;
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

// Copies keys [c0, c0 + nk) of K (and, with_v, of V) from device memory
// ((Tn, D) in T, already rounded) into the f32 rows of kb (and vb), zero
// beyond Tn; their validity into km.
template <typename T>
__device__ __forceinline__ void stage_keys(float* kb, float* vb, float* km, const T* kg,
                                           const T* vg, const float* km_g, int c0, int nk,
                                           int Tn, bool with_v) {
  const int pieces = nk * (kD / 4), n = min(nk, Tn - c0);
  for (int idx = threadIdx.x; idx < (with_v ? 2 : 1) * pieces; idx += kThreads) {
    const int m = idx / pieces, j = idx % pieces / (kD / 4), c = idx % (kD / 4) * 4;
    const float4 x = j < n ? load4((m ? vg : kg) + (long long)(c0 + j) * kD + c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>((m ? vb : kb) + j * kLD + c) = x;
  }
  for (int j = threadIdx.x; j < nk; j += kThreads) km[j] = j < n ? km_g[c0 + j] : 0.f;
}

// A warp task's scores: rows i0..i0+kRows-1 of q, head h, against the
// staged keys lane + 32 jj (jj < NK) of kb; -inf for a key at or beyond n
// (the stage's valid keys).  fm: the tile rows' validity, km: the keys'.
template <int NK>
__device__ __forceinline__ void task_scores(const float* q, const float* kb, const float* fm,
                                            const float* km, int i0, int h, int hd, int n,
                                            float scale, float (&s)[kRows][NK]) {
  const int lane = threadIdx.x & 31;
  float dot[kRows][NK];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int jj = 0; jj < NK; ++jj) dot[r][jj] = 0.f;
  for (int d = 0; d < hd; d += 4) {
    float4 b[NK];
#pragma unroll
    for (int jj = 0; jj < NK; ++jj) b[jj] = load4(kb + (lane + 32 * jj) * kLD + h * hd + d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 a = load4(q + (i0 + r) * kLD + h * hd + d);
#pragma unroll
      for (int jj = 0; jj < NK; ++jj) {
        float& t = dot[r][jj];
        t = fmaf(a.x, b[jj].x, t), t = fmaf(a.y, b[jj].y, t);
        t = fmaf(a.z, b[jj].z, t), t = fmaf(a.w, b[jj].w, t);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int jj = 0; jj < NK; ++jj) {
      const int j = lane + 32 * jj;
      s[r][jj] = j < n ? dot[r][jj] * scale + (1.f - fm[i0 + r] * km[j]) * kMask : -INFINITY;
    }
}

// out(i0 + r, head h) (+)= sum_j p_s[j].r v_j over the n staged values vb;
// lanes on head dims; rounded to T when last.  The task's own slice only.
template <typename T>
__device__ __forceinline__ void task_pv(const float4* p_s, const float* vb, float* out, int i0,
                                        int h, int hd, int n, bool first, bool last) {
  for (int d = threadIdx.x & 31; d < hd; d += 32) {
    const float* vd = vb + h * hd + d;
    float* od = out + i0 * kLD + h * hd + d;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = first ? 0.f : od[r * kLD];
    for (int j = 0; j < n; ++j) {
      const float4 pj = p_s[j];
      const float vj = vd[j * kLD];
      acc[0] = fmaf(pj.x, vj, acc[0]), acc[1] = fmaf(pj.y, vj, acc[1]);
      acc[2] = fmaf(pj.z, vj, acc[2]), acc[3] = fmaf(pj.w, vj, acc[3]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) od[r * kLD] = last ? round_to<T>(acc[r]) : acc[r];
  }
}

// H-head attention of a tile's M query rows (q, rounded to T) over Tn keys
// whose K and V ((Tn, D) in T, rounded) are in device memory; the context,
// rounded to T, goes to out.  A warp task is (kRows rows, one head); lanes
// take keys for the scores and head dims for p v; p = exp(s - max) / sum is
// rounded to T before p v, where the TPU kernel and the plain version round
// it.  fm (kTile,): the tile rows' validity (0 beyond M); km_g (Tn,): the
// keys'.  Rows of the last group beyond M are computed on finite values and
// never read.
//
// attention_one, Tn <= kStage: K and V staged once into kb and vb, one walk
// with the scores in registers; out may be q (a task reads only its own
// slice of q, and has read it before it writes).
template <typename T>
__device__ __forceinline__ void attention_one(const float* q, float* out, int M, const T* kg,
                                              const T* vg, const float* km_g, int Tn, int H,
                                              const float* fm, float* kb, float* vb, float* km,
                                              float* p_all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = kD / H, ntask = (M + kRows - 1) / kRows * H;
  const float scale = 1.f / sqrtf((float)hd);
  float4* p_s = reinterpret_cast<float4*>(p_all) + warp * kStage;
  stage_keys<T>(kb, vb, km, kg, vg, km_g, 0, kStage, Tn, true);
  __syncthreads();
  for (int task = warp; task < ntask; task += kWarps) {
    const int i0 = task / H * kRows, h = task % H;
    float s[kRows][2], m[kRows], l[kRows];
    task_scores<2>(q, kb, fm, km, i0, h, hd, Tn, scale, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) m[r] = fmaxf(s[r][0], s[r][1]);
    warp_max(m);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r][0] = expf(s[r][0] - m[r]), s[r][1] = expf(s[r][1] - m[r]);  // 0 beyond Tn
      l[r] = s[r][0] + s[r][1];
    }
    warp_sum(l);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      p_s[lane + 32 * jj] =
          make_float4(round_to<T>(s[0][jj] / l[0]), round_to<T>(s[1][jj] / l[1]),
                      round_to<T>(s[2][jj] / l[2]), round_to<T>(s[3][jj] / l[3]));
    __syncwarp();  // p_s is written and q is read by every lane
    task_pv<T>(p_s, vb, out, i0, h, hd, Tn, true, true);
    __syncwarp();
  }
  __syncthreads();
}

// attention_chunked, any Tn: keys in chunks of kKeys staged in kv (K in rows
// 0..31, V in rows 32..63), two walks: the first keeps each (row, head)'s
// running max and sum in stat, the second forms p and accumulates p v into
// out in f32.  out != q.
template <typename T>
__device__ __forceinline__ void attention_chunked(const float* q, float* out, int M,
                                                  const T* kg, const T* vg, const float* km_g,
                                                  int Tn, int H, const float* fm, float* kv,
                                                  float* km, float* stat, float* p_all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = kD / H, ntask = (M + kRows - 1) / kRows * H;
  const float scale = 1.f / sqrtf((float)hd);
  const int nchunk = (Tn + kKeys - 1) / kKeys;
  float4* p_s = reinterpret_cast<float4*>(p_all) + warp * kKeys;
  float* vb = kv + kKeys * kLD;
  // walk 1: each (row, head)'s max and sum over all keys
  for (int c = 0; c < nchunk; ++c) {
    stage_keys<T>(kv, vb, km, kg, vg, km_g, c * kKeys, kKeys, Tn, false);
    __syncthreads();
    const int n = min(kKeys, Tn - c * kKeys);
    for (int task = warp; task < ntask; task += kWarps) {
      const int i0 = task / H * kRows, h = task % H;
      float s[kRows][1], m[kRows], e[kRows], mo[kRows], lo[kRows];
      task_scores<1>(q, kv, fm, km, i0, h, hd, n, scale, s);
      float* st = stat + 2 * (i0 * H + h);  // row i0 + r at st[2 r H]
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        m[r] = s[r][0];
        mo[r] = c ? st[2 * r * H] : -INFINITY;
        lo[r] = c ? st[2 * r * H + 1] : 0.f;
      }
      warp_max(m);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        m[r] = fmaxf(mo[r], m[r]);
        e[r] = expf(s[r][0] - m[r]);  // exp(-inf) = 0 beyond Tn
      }
      warp_sum(e);
      __syncwarp();  // every lane has read st
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (lane == r) st[2 * r * H] = m[r], st[2 * r * H + 1] = lo[r] * expf(mo[r] - m[r]) + e[r];
    }
    __syncthreads();
  }
  // walk 2: p rounded to T, p v accumulated in f32
  for (int c = 0; c < nchunk; ++c) {
    stage_keys<T>(kv, vb, km, kg, vg, km_g, c * kKeys, kKeys, Tn, true);
    __syncthreads();
    const int n = min(kKeys, Tn - c * kKeys);
    for (int task = warp; task < ntask; task += kWarps) {
      const int i0 = task / H * kRows, h = task % H;
      float s[kRows][1], p[kRows];
      task_scores<1>(q, kv, fm, km, i0, h, hd, n, scale, s);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* st = stat + 2 * ((i0 + r) * H + h);
        p[r] = round_to<T>(expf(s[r][0] - st[0]) / st[1]);
      }
      p_s[lane] = make_float4(p[0], p[1], p[2], p[3]);
      __syncwarp();
      task_pv<T>(p_s, vb, out, i0, h, hd, n, c == 0, c + 1 == nchunk);
      __syncwarp();
    }
    __syncthreads();
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
// Wafter: the first matrix of the next call, or null.
template <typename T>
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
    if (Tn <= kStage)
      attention_one<T>(Dq, E, M, tk, tv, tm_g, Tn, H, fm, Bf, C, sm.km, sm.p_s);
    else
      attention_chunked<T>(Dq, E, M, tk, tv, tm_g, Tn, H, fm, Bf, sm.km, sm.stat, sm.p_s);
    float* S = F <= kStage ? Dq : C;
    float* R = F <= kStage ? C : Dq;
    if (F <= kStage)
      attention_one<T>(Dq, S, M, fk, fv, fm_g, F, H, fm, Bf, C, sm.km, sm.p_s);
    else
      attention_chunked<T>(Dq, S, M, fk, fv, fm_g, F, H, fm, Bf, sm.km, sm.stat, sm.p_s);
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

template <typename T>
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
    dab_call<T>(xv, xt, layer ? v2 : v1, vmask, tmask, Lv, Lt, H, Wl, bl, lnl, xbl, kvg,
                Wl + W_TK * kD * kD, pending);
    dab_call<T>(xt, xv, layer ? t2 : t1, tmask, vmask, Lt, Lv, H, Wl, bl, lnl, xbl, kvg, Wnext,
                pending);
    __syncthreads();  // the scratch rows written above are read by other threads below
  }
}

template <typename T>
int launch(const void* v, const void* t, const void* vm, const void* tm, const void* W,
           const void* b, const void* ln, const void* xb, void* v_out, void* t_out,
           void* scratch, void* kv_scratch, int B, int Lv, int Lt, int H, cudaStream_t stream) {
  const size_t bytes = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stack_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  stack_kernel<T><<<B, kThreads, bytes, stream>>>(
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
  return dtype == 1 ? launch<__nv_bfloat16>(v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch,
                                            kv_scratch, B, Lv, Lt, H, s)
                    : launch<float>(v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch,
                                    kv_scratch, B, Lv, Lt, H, s);
}
