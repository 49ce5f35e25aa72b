// Hopper (sm_90a) kernels for ActionFormer's banded (sliding-window) attention.
//
//   vmr_banded_attention      <- vmrframe_tpu/kernels/window_attention.py::banded_attention
//                                (_fwd_kernel, the forward)
//   vmr_banded_attention_dq   <- _banded_bwd's _dq_kernel there
//   vmr_banded_attention_dkv  <- _banded_bwd's _dkv_kernel there
//
// The two backward kernels are noted below, beside their code; this note is
// the forward's.
//
// It computes what the TPU kernel computes, not its blocking: for each query
// row i, softmax over the keys j with |i - j| <= window/2 and a valid key
// (kv_mask > 0), times V.  Like the TPU kernel, each 128-row query tile
// belongs to one K_WIN slice of the keys,
//
//   K_WIN = 128 + 2 * ceil(half / 128) * 128          (384 for window 19)
//   start = clip(128 * floor(i / 128) - (K_WIN - 128) / 2, 0, T_pad - K_WIN)
//
// with T_pad the length rounded up to 128; the TPU walks the whole slice
// with every score outside the band or on an invalid key REPLACED by -1e30.
// Positions T..T_pad-1 are zero keys and values with mask 0, which is what
// the TPU wrapper's zero padding gives, but nothing is padded in memory:
// loads are bound-checked.
//
// Which keys a row reads.  On a row with a valid key in its band, the TPU's
// out-of-band scores are -1e30, and exp(-1e30 - max) is exactly 0 in f32:
// the keys outside the band add exact zeros, so this kernel reads the band
// only (the order of the sums differs, nothing else).  The 16 query rows
// [r0, r0 + 16) read their key span, warp_key_span: the band
// [r0 - half, r0 + 15 + half] rounded out to 16-key tiles and clipped to
// the slice, 48 keys at window 19 against the slice's 384.  A row with no
// valid key in its band (a padding row: a wholly masked sample, a hole wider
// than the band, rows past T) has every slice score at -1e30 on the TPU, so
// p = 1/K_WIN on each slice key: its output is round(1/K_WIN) times the sum
// of V over the slice's keys below T.  A row whose maximum over its span is
// still -1e30 is such a row (the span holds its band); only a block that
// has one sums V over its slice, once, on the CUDA cores (slice_colsum).
//
// Numerics: scores q.k * 1/sqrt(hd) in f32 (hd the real head dim, passed
// in), a stable softmax in f32, p = e / sum rounded to the input type before
// the value product (as the TPU kernel casts p to v's type), f32
// accumulation, output in the input type.
//
// bf16, banded_mma: one block of 8 warps per (batch*head, 128-row query
// tile), a warp per 16 rows.  The block stages the union of its warps' spans
// (160 rows at window 19), K and V with 16-byte cp.async (zero past T, and in
// the head columns from hd up to the next multiple of 16), and each key's
// validity, once.  Q passes through V's space first and into registers by
// ldmatrix; V then streams in while the scores are computed.  Each warp:
// S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 out) 64 keys at a time, in
// registers; the band test and the key mask in registers (-1e30); row max
// and sum by quad shuffles; p = e / sum rounded to bf16 is the A operand of
// P.V, V's B fragments by ldmatrix.trans (the body of attention.cu's
// attention_mma; helpers in mma_bf16.cuh).  A span of at most 64 keys
// (window <= 33) is one walk (template ONE); a longer one is two, as in
// attention_mma: max and sum first, then P.V with the scores recomputed.  A
// union larger than a block's share of two blocks per SM (~113 KB: wide
// windows) is staged in parts, K alone for the first walk, K and V for the
// second.  ~94 KB at hd 128, window 19.
//
// f32, banded_f32 (the training type): exact f32 on the CUDA cores, no
// TF32.  One block of 16 warps per tile, 8 rows a warp; the Q tile in shared
// memory; the union passes through in 32-key chunks of K (rows padded to
// HDP + 1 floats: a lane per key, no bank conflicts) and V, and a warp takes
// only the chunks that meet its band (at most 2 of 5 at window 19); one walk
// with a running max and sum, since f32 rounds p nowhere.  ~121 KB at hd 128.
//
// What bounds it on an H100: at the long config (T up to 2304, hd 128,
// window 19) the band needs 2*2*T*19*hd FLOPs per (batch, head) and reads
// q, k, v once, so the least time is set by bytes (~22 us at T = 2304, batch
// 8, 4 heads, bf16).  The bf16 body reads K and V 160/128 times (the union)
// and Q once, and at window 19 issues 6 + 6 mma per 16 rows and 16 head
// columns (the scores of a 48-key span, then P.V).
//
// Layout: q, k, v are (B, H, T, hd) through their strides (unit stride on
// hd), so head-split views of (B, T, C) projections are read in place; the
// output is written through strides too, (B, T, H, hd) in memory from the
// Python wrapper, so the head merge is free.  kv_mask is (B, T) in the input
// type, read at b = bh / H.  Head dims 1 to 128.
//
// Interface: plain C, loaded with ctypes; returns cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // bf16, quad reductions, cp.async, ldmatrix, mma_bf16, stage

namespace {

constexpr float kMask = -1e30f;
constexpr int kTile = 128;                          // query rows per block (the TPU tile)
constexpr int kChunk = 32;                          // f32 bodies: keys per chunk, one per lane
constexpr int kWarps = 16;                          // f32 bodies
constexpr int kRows = kTile / kWarps;               // f32 bodies: query rows per warp
constexpr int kMmaWarps = kTile / 16;               // banded_mma: a warp per 16 rows
constexpr int kMmaChunk = 64;                       // banded_mma: keys per score chunk (8 n-tiles)
constexpr int kTwoBlockBytes = 113 * 1024;          // shared memory of one of two blocks per SM
constexpr int kColSumFloats = 2048;                 // slice_colsum: 16 bytes a thread
static_assert(kColSumFloats >= kMmaWarps * 32 * 8 && kColSumFloats >= kWarps * 32 * 4,
              "slice_colsum's partial sums");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A (B, H, T, hd) tensor addressed through its strides (the last one is 1).
struct View {
  const void* p;
  long long sb, sh, sl;
};

struct Shape {
  int H, T, T_pad, half, k_win;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* at(const View& v, int b, int h) {
  return static_cast<const T*>(v.p) + b * v.sb + h * v.sh;
}

// The first key of the K_WIN slice of the 128-row tile from q0 (the TPU's
// `start`).
__device__ __forceinline__ int slice_start(int q0, const Shape& sh) {
  return max(0, min(q0 - (sh.k_win - kTile) / 2, sh.T_pad - sh.k_win));
}

// [lo, hi) of the keys that the 16 query rows from r0 (a multiple of 16)
// read: their band [r0 - half, r0 + 15 + half] rounded out to 16-key tiles,
// clipped to their tile's K_WIN slice.  The same as
// kernels/window_attention.py::warp_key_span.
__device__ __forceinline__ int2 warp_key_span(int r0, const Shape& sh) {
  const int start = slice_start(r0 / kTile * kTile, sh);
  const int reach = (sh.half + 15) / 16 * 16;
  return make_int2(max(start, r0 - reach), min(start + sh.k_win, r0 + 16 + reach));
}

// cs_s[c] = the f32 sum of v[j][c] over the keys j in [j0, j1), for c < hd
// (0 for hd <= c < HDP): what a padding row's output is made of.  A thread
// takes 16 bytes of a row (kColVec columns) on every nparts-th row, so
// neighbouring threads read a row together and each walks ~24 rows of a
// 384-key slice; part_s holds blockDim * kColVec floats.  Ends with a barrier.
template <typename T, int HDP>
__device__ void slice_colsum(const T* v, long long sl, int j0, int j1, int hd, float* part_s,
                             float* cs_s) {
  constexpr int kColVec = 16 / sizeof(T), kGroups = HDP / kColVec;
  const int c0 = threadIdx.x % kGroups * kColVec, part = threadIdx.x / kGroups;
  const int nparts = blockDim.x / kGroups;
  const bool vec = hd % kColVec == 0 && sl % kColVec == 0 &&
                   (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  float acc[kColVec];
#pragma unroll
  for (int e = 0; e < kColVec; ++e) acc[e] = 0.f;
  if (part < nparts && c0 < hd) {
#pragma unroll 4
    for (int j = j0 + part; j < j1; j += nparts) {
      const T* row = v + j * sl + c0;
      if (vec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < kColVec; ++e) acc[e] += to_f(x[e]);
      } else {
#pragma unroll
        for (int e = 0; e < kColVec; ++e)
          if (c0 + e < hd) acc[e] += to_f(row[e]);
      }
    }
  }
  if (part < nparts) {
#pragma unroll
    for (int e = 0; e < kColVec; ++e) part_s[part * HDP + c0 + e] = acc[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < HDP; c += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < nparts; ++p) s += part_s[p * HDP + c];
    cs_s[c] = s;
  }
  __syncthreads();
}

// ------------------------------------------------------------ bf16 forward

// The scores of keys [c0, c0 + nk) (nk a multiple of 16, at most 64) for a
// warp's 16 rows, in the mma's C layout: s[j] holds keys c0 + 8j + 2t, +1 of
// rows ra = r0 + g (s[j][0..1]) and ra + 8 (s[j][2..3]); scaled, -1e30
// outside the band or on an invalid key, -inf past nk.  k_s and ok_s hold
// the staged keys from s0.
template <int HDK, int RS>
__device__ __forceinline__ void band_scores(float (&s)[8][4], const uint32_t (&qa)[HDK][4],
                                            const bf16* k_s, const float* ok_s, int s0, int c0,
                                            int nk, int ra, const Shape& sh, int lane) {
  const int t = lane & 3, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int j2 = 0; j2 < 4; ++j2) {
    if (16 * j2 < nk) {
      const bf16* krow = k_s + (c0 - s0 + 16 * j2 + r + ((mi >> 1) << 3)) * RS + ((mi & 1) << 3);
#pragma unroll
      for (int kk = 0; kk < HDK; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, krow + 16 * kk);
        mma_bf16(s[2 * j2], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * j2 + 1], qa[kk], kb[2], kb[3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1), key = c0 + col, i = ra + (e & 2) * 4;
      if (col >= nk)
        s[j][e] = -CUDART_INF_F;
      else
        s[j][e] = (ok_s[key - s0] > 0.f && abs(i - key) <= sh.half) ? s[j][e] * sh.scale : kMask;
    }
  }
}

// Kernel #5 in bf16 on the tensor cores.  HDK = head dim rounded up to 16,
// over 16; ONE: every warp's span is one chunk and the union is staged
// whole (one walk, the scores kept).  cap: rows of K (and V) staged at once.
template <int HDK, bool ONE>
__global__ void __launch_bounds__(kMmaWarps * 32, ONE ? 2 : 1)
    banded_mma(View qv, View kv, View vv, const bf16* mask, View ov, Shape sh, int hd, int cap) {
  constexpr int HDP = 16 * HDK, RS = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);              // (cap, RS)
  bf16* v_s = k_s + cap * RS;                                  // (cap, RS); the Q tile first
  float* ok_s = reinterpret_cast<float*>(v_s + cap * RS);     // (cap,) key valid
  float* cs_s = ok_s + cap;                                    // (128,) V summed over the slice
  float* part_s = cs_s + kTile;                                // (2048,) its partial sums

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r = lane & 7;
  const int q0 = tile * kTile, r0 = q0 + 16 * warp, ra = r0 + g, rb = ra + 8;
  const int start = slice_start(q0, sh);
  const int u0 = warp_key_span(q0, sh).x, u1 = warp_key_span(q0 + kTile - 16, sh).y;
  const int2 span = warp_key_span(r0, sh);
  const bool resident = u1 - u0 <= cap;
  const bf16* q = at<bf16>(qv, b, h);
  const bf16* k = at<bf16>(kv, b, h);
  const bf16* v = at<bf16>(vv, b, h);
  const bf16* m = mask + (long long)b * sh.T;

  // keys [s0, s1) into k_s (and v_s), zero past T, and their validity
  auto stage_keys = [&](int s0, int s1, bool with_v) {
    const int rows = max(0, min(s1, sh.T) - s0);
    stage<HDP, RS>(k_s, k + s0 * kv.sl, kv.sl, rows, s1 - s0, hd, threadIdx.x, blockDim.x);
    if (with_v)
      stage<HDP, RS>(v_s, v + s0 * vv.sl, vv.sl, rows, s1 - s0, hd, threadIdx.x, blockDim.x);
    for (int i = threadIdx.x; i < s1 - s0; i += blockDim.x)
      ok_s[i] = (s0 + i < sh.T && __bfloat162float(m[s0 + i]) > 0.f) ? 1.f : 0.f;
  };

  // the Q tile through V's space into registers; K meanwhile
  stage<HDP, RS>(v_s, q + q0 * qv.sl, qv.sl, min(kTile, sh.T - q0), kTile, hd, threadIdx.x,
                 blockDim.x);
  if (resident) stage_keys(u0, u1, false);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[HDK][4];
#pragma unroll
  for (int kk = 0; kk < HDK; ++kk)
    ldmatrix_x4(qa[kk], v_s + (16 * warp + r + ((mi & 1) << 3)) * RS + 16 * kk + ((mi >> 1) << 3));
  __syncthreads();  // V's space is free
  if (resident)     // V streams in during the first walk
    stage<HDP, RS>(v_s, v + u0 * vv.sl, vv.sl, max(0, min(u1, sh.T) - u0), u1 - u0, hd,
                   threadIdx.x, blockDim.x);

  // walk 1: row max and sum (rows ra and rb) over the span, part by part
  float s[8][4];
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  for (int s0 = u0; s0 < u1; s0 += cap) {
    const int s1 = min(s0 + cap, u1), c1 = min(span.y, s1);
    if (!resident) {
      __syncthreads();
      stage_keys(s0, s1, false);
      cp_async_wait_all();
      __syncthreads();
    }
    for (int c0 = max(span.x, s0); c0 < c1; c0 += kMmaChunk) {
      band_scores<HDK, RS>(s, qa, k_s, ok_s, s0, c0, min(kMmaChunk, c1 - c0), ra, sh, lane);
      float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x0 = fmaxf(x0, fmaxf(s[j][0], s[j][1]));
        x1 = fmaxf(x1, fmaxf(s[j][2], s[j][3]));
      }
      const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
      l0 *= __expf(m0 - n0);
      l1 *= __expf(m1 - n1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        l0 += __expf(s[j][0] - n0) + __expf(s[j][1] - n0);
        l1 += __expf(s[j][2] - n1) + __expf(s[j][3] - n1);
      }
      m0 = n0;
      m1 = n1;
    }
  }
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

  // padding rows (max still -1e30): V summed over the slice, by blocks that have one
  const bool pad0 = m0 == kMask, pad1 = m1 == kMask;
  cp_async_wait_all();
  if (__syncthreads_or((pad0 && ra < sh.T) || (pad1 && rb < sh.T)))
    slice_colsum<bf16, HDP>(v, vv.sl, start, min(start + sh.k_win, sh.T), hd, part_s, cs_s);

  // walk 2: the normalised p, rounded to bf16, times V
  float o[2 * HDK][4];
#pragma unroll
  for (int d = 0; d < 2 * HDK; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  for (int s0 = u0; s0 < u1; s0 += cap) {
    const int s1 = min(s0 + cap, u1), c1 = min(span.y, s1);
    if (!resident) {
      __syncthreads();
      stage_keys(s0, s1, true);
      cp_async_wait_all();
      __syncthreads();
    }
    for (int c0 = max(span.x, s0); c0 < c1; c0 += kMmaChunk) {
      const int nk = min(kMmaChunk, c1 - c0);
      if (!ONE) band_scores<HDK, RS>(s, qa, k_s, ok_s, s0, c0, nk, ra, sh, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk < nk) {
          uint32_t pa[4];
          pa[0] = pack_bf16(__expf(s[2 * kk][0] - m0) * inv0, __expf(s[2 * kk][1] - m0) * inv0);
          pa[1] = pack_bf16(__expf(s[2 * kk][2] - m1) * inv1, __expf(s[2 * kk][3] - m1) * inv1);
          pa[2] = pack_bf16(__expf(s[2 * kk + 1][0] - m0) * inv0,
                            __expf(s[2 * kk + 1][1] - m0) * inv0);
          pa[3] = pack_bf16(__expf(s[2 * kk + 1][2] - m1) * inv1,
                            __expf(s[2 * kk + 1][3] - m1) * inv1);
          const bf16* vrow = v_s + (c0 - s0 + 16 * kk + r + ((mi & 1) << 3)) * RS +
                             ((mi >> 1) << 3);
#pragma unroll
          for (int dp = 0; dp < HDK; ++dp) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vrow + 16 * dp);
            mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
            mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }
  }

  // out: p v, or on a padding row round(1/K_WIN) * (V summed over the slice)
  const float pad_p = round_to<bf16>(1.f / sh.k_win);
  bf16* out = static_cast<bf16*>(const_cast<void*>(ov.p)) + b * ov.sb + h * ov.sh;
  const bool pairs = hd % 2 == 0 && ov.sl % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
#pragma unroll
  for (int d = 0; d < 2 * HDK; ++d) {
    const int col = 8 * d + 2 * t;
    if (col < hd) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int row = e ? rb : ra;
        if (row >= sh.T) continue;
        const bool pad = e ? pad1 : pad0;
        const float x = pad ? pad_p * cs_s[col] : o[d][e];
        const float y = pad ? pad_p * cs_s[col + 1] : o[d][e + 1];
        bf16* dst = out + row * ov.sl + col;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
        } else {
          dst[0] = __float2bfloat16(x);
          if (col + 1 < hd) dst[1] = __float2bfloat16(y);
        }
      }
    }
  }
}

// ------------------------------------------------------------- f32 forward

template <int DCH>
constexpr size_t f32_smem_floats() {
  constexpr int HDP = 32 * DCH;
  return (size_t)kTile * HDP                  // Q tile
         + (size_t)kChunk * (HDP + 1)         // K chunk, padded rows
         + (size_t)kChunk * HDP               // V chunk
         + (size_t)kWarps * kRows * kChunk    // e of each warp's rows
         + kChunk                             // key validity of the chunk
         + kTile + kColSumFloats;             // V summed over the slice, and its partial sums
}

// Kernel #5 in f32 on the CUDA cores.  DCH = head dim rounded up to 32, over
// 32: the output columns a lane holds.
template <int DCH>
__global__ void __launch_bounds__(kWarps * 32)
    banded_f32(View qv, View kv, View vv, const float* mask, View ov, Shape sh, int hd) {
  constexpr int HDP = 32 * DCH;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * HDP;
  float* v_s = k_s + kChunk * (HDP + 1);
  float* p_s = v_s + kChunk * HDP;
  float* ok_s = p_s + kWarps * kRows * kChunk;
  float* cs_s = ok_s + kChunk;
  float* part_s = cs_s + kTile;

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = tile * kTile, row0 = warp * kRows, i0 = q0 + row0;
  const int start = slice_start(q0, sh);
  const int u0 = warp_key_span(q0, sh).x, u1 = warp_key_span(q0 + kTile - 16, sh).y;
  const float* q = at<float>(qv, b, h);
  const float* k = at<float>(kv, b, h);
  const float* v = at<float>(vv, b, h);
  const float* m = mask + (long long)b * sh.T;

  for (int idx = threadIdx.x; idx < kTile * HDP; idx += blockDim.x) {
    const int rr = idx / HDP, d = idx % HDP, i = q0 + rr;
    q_s[idx] = (i < sh.T && d < hd) ? q[i * qv.sl + d] : 0.f;
  }

  float mx[kRows], sum[kRows], acc[kRows][DCH];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    mx[rr] = -CUDART_INF_F;
    sum[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[rr][c] = 0.f;
  }
  float* p_w = p_s + warp * kRows * kChunk;
  for (int j0 = u0; j0 < u1; j0 += kChunk) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kChunk * HDP; idx += blockDim.x) {
      const int jj = idx / HDP, d = idx % HDP, j = j0 + jj;
      const bool in = j < sh.T && d < hd;
      k_s[jj * (HDP + 1) + d] = in ? k[j * kv.sl + d] : 0.f;
      v_s[idx] = in ? v[j * vv.sl + d] : 0.f;
    }
    if (threadIdx.x < kChunk) {
      const int j = j0 + threadIdx.x;
      ok_s[threadIdx.x] = (j < sh.T && m[j] > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
    if (j0 > i0 + kRows - 1 + sh.half || j0 + kChunk - 1 < i0 - sh.half) continue;  // off the band

    // the lane's key against the warp's rows, then a running max and sum
    const float* krow = k_s + lane * (HDP + 1);
    float s[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 4) {
      const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2], k3 = krow[d + 3];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float4 q4 = *reinterpret_cast<const float4*>(q_s + (row0 + rr) * HDP + d);
        s[rr] = fmaf(q4.x, k0, s[rr]);
        s[rr] = fmaf(q4.y, k1, s[rr]);
        s[rr] = fmaf(q4.z, k2, s[rr]);
        s[rr] = fmaf(q4.w, k3, s[rr]);
      }
    }
    const int j = j0 + lane;
    const bool key_ok = ok_s[lane] > 0.f;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float sc = (key_ok && abs(i0 + rr - j) <= sh.half) ? s[rr] * sh.scale : kMask;
      const float mn = fmaxf(mx[rr], warp_max(sc));
      const float a = expf(mx[rr] - mn), e = expf(sc - mn);
      sum[rr] = sum[rr] * a + warp_sum(e);
      mx[rr] = mn;
      p_w[rr * kChunk + lane] = e;
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[rr][c] *= a;
    }
    __syncwarp();
#pragma unroll 2
    for (int jj = 0; jj < kChunk; jj += 4) {
      float vk[4][DCH];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < DCH; ++c) vk[u][c] = v_s[(jj + u) * HDP + lane + 32 * c];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float4 p4 = *reinterpret_cast<const float4*>(p_w + rr * kChunk + jj);
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          acc[rr][c] = fmaf(p4.x, vk[0][c], acc[rr][c]);
          acc[rr][c] = fmaf(p4.y, vk[1][c], acc[rr][c]);
          acc[rr][c] = fmaf(p4.z, vk[2][c], acc[rr][c]);
          acc[rr][c] = fmaf(p4.w, vk[3][c], acc[rr][c]);
        }
      }
    }
    __syncwarp();  // p_w is read before the next chunk writes it
  }

  bool pad_any = false;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) pad_any |= mx[rr] == kMask && i0 + rr < sh.T;
  if (__syncthreads_or(pad_any))
    slice_colsum<float, HDP>(v, vv.sl, start, min(start + sh.k_win, sh.T), hd, part_s, cs_s);

  float* o = static_cast<float*>(const_cast<void*>(ov.p)) + b * ov.sb + h * ov.sh;
  const float pad_p = 1.f / sh.k_win;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int i = i0 + rr;
    if (i >= sh.T) continue;
    const bool pad = mx[rr] == kMask;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) o[i * ov.sl + d] = pad ? pad_p * cs_s[d] : acc[rr][c] / sum[rr];
    }
  }
}

template <int DCH>
int launch_f32(View q, View k, View v, const void* mask, View o, int B, int hd, Shape sh,
               cudaStream_t stream) {
  const size_t bytes = f32_smem_floats<DCH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(banded_f32<DCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.T_pad / kTile, B * sh.H);
  banded_f32<DCH><<<grid, kWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const float*>(mask), o, sh, hd);
  return (int)cudaGetLastError();
}

template <int HDK, bool ONE>
int launch_mma(View q, View k, View v, const void* mask, View o, int B, int hd, Shape sh,
               int cap, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(banded_mma<HDK, ONE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.T_pad / kTile, B * sh.H);
  banded_mma<HDK, ONE><<<grid, kMmaWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const bf16*>(mask), o, sh, hd, cap);
  return (int)cudaGetLastError();
}

template <int HDK>
int launch_mma_walks(View q, View k, View v, const void* mask, View o, int B, int hd, Shape sh,
                     cudaStream_t stream) {
  // rows of a block's key union, and of one warp's span, at most
  const int reach = (sh.half + 15) / 16 * 16;
  const int need = min(sh.k_win, kTile + 2 * reach), span = 16 + 2 * reach;
  const int row_bytes = 2 * (16 * HDK + 8) * (int)sizeof(bf16) + (int)sizeof(float);
  const int fixed = (kTile + kColSumFloats) * (int)sizeof(float);
  // >= 192 rows at every head dim up to 128, so the Q tile fits V's space
  const int cap = min((kTwoBlockBytes - fixed) / row_bytes / 16 * 16, need);
  const size_t bytes = (size_t)cap * row_bytes + fixed;
  if (need <= cap && span <= kMmaChunk)
    return launch_mma<HDK, true>(q, k, v, mask, o, B, hd, sh, cap, bytes, stream);
  return launch_mma<HDK, false>(q, k, v, mask, o, B, hd, sh, cap, bytes, stream);
}

int launch_forward(int dtype, View q, View k, View v, const void* mask, View o, int B, int hd,
                   Shape sh, cudaStream_t stream) {
  if (dtype == 0) {
    switch ((hd + 31) / 32) {
      case 1: return launch_f32<1>(q, k, v, mask, o, B, hd, sh, stream);
      case 2: return launch_f32<2>(q, k, v, mask, o, B, hd, sh, stream);
      case 3: return launch_f32<3>(q, k, v, mask, o, B, hd, sh, stream);
      case 4: return launch_f32<4>(q, k, v, mask, o, B, hd, sh, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch ((hd + 15) / 16) {
    case 1: return launch_mma_walks<1>(q, k, v, mask, o, B, hd, sh, stream);
    case 2: return launch_mma_walks<2>(q, k, v, mask, o, B, hd, sh, stream);
    case 3: return launch_mma_walks<3>(q, k, v, mask, o, B, hd, sh, stream);
    case 4: return launch_mma_walks<4>(q, k, v, mask, o, B, hd, sh, stream);
    case 5: return launch_mma_walks<5>(q, k, v, mask, o, B, hd, sh, stream);
    case 6: return launch_mma_walks<6>(q, k, v, mask, o, B, hd, sh, stream);
    case 7: return launch_mma_walks<7>(q, k, v, mask, o, B, hd, sh, stream);
    case 8: return launch_mma_walks<8>(q, k, v, mask, o, B, hd, sh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- backward
//
// What the TPU's backward computes (and so these kernels), per (batch, head):
//
//   dq  (_dq_kernel), per 128-row query tile over the forward's K_WIN slice:
//       p = softmax of the band-masked scores (masked -> -1e30), dp = g v^T,
//       ds = p (dp - sum_j dp p) * scale rounded to the input type, dq = ds k.
//   dk, dv (_dkv_kernel), per 128-KEY tile, over the K_WIN query rows that
//       can reach it (query window start = clip(k0 - (K_WIN-128)/2, ...)):
//       each row's max m, normaliser l and row = sum_j dp p are taken over a
//       K2 = min(2 K_WIN - 128, T_pad) key slice starting at
//       n_start = clip(start - (K_WIN-128)/2, 0, T_pad - K2); then for the
//       tile's own keys p = exp(s - m) / l, dv = p^T g (p rounded to the
//       input type), ds = p (dp - row) * scale, dk = ds^T q (ds rounded).
//
// On a row with a valid key in its band the K2 statistics are the forward's;
// on a padding row (no valid key) every score is -1e30, so p = 1/K2 over the
// slice (1/K_WIN in dq), and the masked positions carry ds.  That is not the
// exact gradient of the forward on those rows, but it is what the TPU
// computes, and the model's cotangent is zero there (MaskedMHCA multiplies by
// the query mask).  The gridding over key tiles means every dk/dv row has one
// owner block: no atomics, no cross-block sums, the same bits on every run.
//
// Both kernels keep each row's statistics with an online (running) max,
// sum of e and sum of e * dp per lane, merged across the warp by shuffles:
// row = (sum e dp) / (sum e), which equals sum p dp up to rounding.
//
// What bounds them on an H100: at the long config's training shapes (batch
// 2, 4 heads of 128, window 19, T = 2304, 1152, 576) the band needs
// 6*T*19*hd FLOPs per (batch, head) for dq (scores, dp, ds k) and 8*T*19*hd
// for dk/dv, and the bytes are q, k, v, g read once and the outputs written
// once: at T = 2304 ~9.4 MB for dq in f32, ~2.8 us at 3.35 TB/s, so both are
// bytes-bound in principle.  These first versions are simple and far from
// that: CUDA cores in f32, every score recomputed (twice in dq, three times
// in dk/dv: the K2 statistics walk 640 keys for each of 384 rows), and the
// whole K_WIN slice walked though only ~146 keys can fall in a tile's band.
//
// dq design: one block of 16 warps per (batch*head, 128-row query tile); Q
// and G tiles in shared memory in f32; 32-key chunks of K and V staged with
// rows padded to hd+1 floats (the 32 lanes read 32 keys without bank
// conflicts); each warp owns 8 rows, each lane one key of a chunk for the
// scores and dp, then hd/32 columns of its rows for ds k.  Pass 1 gives the
// statistics, pass 2 recomputes s and dp and accumulates dq in registers.
// ~179 KB of shared memory at hd 128: one block per SM.
//
// dk/dv design: one block of 16 warps per (batch*head, 128-key tile).  Phase
// A walks the K_WIN query rows in 128-row chunks (Q and G chunk in shared
// memory) against the K2 slice in 32-key chunks, as dq's pass 1, and keeps
// the 3*K_WIN statistics in shared memory.  Phase B holds the tile's own K
// and V (padded rows, f32) in the same shared memory, streams the query rows
// in 32-row chunks (lane = query row, warp = 8 own keys), and accumulates
// dk and dv for its 8 keys in registers (hd/32 columns per lane).  The query
// window of 384 rows and the K2 slice of 640 keys never sit in shared memory
// whole.  ~202 KB at hd 128: one block per SM.

// Stage keys [j0, j0 + kChunk): K and V rows in f32, both padded to hd+1
// floats, zero past T, and each key's validity.
template <typename T, int HD>
__device__ __forceinline__ void stage_kv(const T* k, long long k_sl, const T* v, long long v_sl,
                                         const T* mask, int j0, int T_len, float* k_s,
                                         float* v_s, float* ok_s) {
  for (int idx = threadIdx.x; idx < kChunk * HD; idx += blockDim.x) {
    const int jj = idx / HD, d = idx % HD, j = j0 + jj;
    const bool in = j < T_len;
    k_s[jj * (HD + 1) + d] = in ? to_f(k[j * k_sl + d]) : 0.f;
    v_s[jj * (HD + 1) + d] = in ? to_f(v[j * v_sl + d]) : 0.f;
  }
  if (threadIdx.x < kChunk) {
    const int j = j0 + threadIdx.x;
    ok_s[threadIdx.x] = (j < T_len && to_f(mask[j]) > 0.f) ? 1.f : 0.f;
  }
}

// Rows [r0, r0 + n) of x into x_s in f32, with rows padded to `ld` floats;
// zero past T.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(const T* x, long long sl, int r0, int n, int T_len,
                                          int ld, float* x_s) {
  for (int idx = threadIdx.x; idx < n * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD, i = r0 + r;
    x_s[r * ld + d] = i < T_len ? to_f(x[i * sl + d]) : 0.f;
  }
}

// The warp's kRows rows of rows_s (unpadded, hd floats each) against one
// key row: out[r] = rows[row0 + r] . key.
template <int HD>
__device__ __forceinline__ void rows_dot(const float* rows_s, int row0, const float* key,
                                         float (&out)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float k0 = key[d], k1 = key[d + 1], k2 = key[d + 2], k3 = key[d + 3];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 q4 = *reinterpret_cast<const float4*>(rows_s + (row0 + r) * HD + d);
      out[r] = fmaf(q4.x, k0, out[r]);
      out[r] = fmaf(q4.y, k1, out[r]);
      out[r] = fmaf(q4.z, k2, out[r]);
      out[r] = fmaf(q4.w, k3, out[r]);
    }
  }
}

// Statistics of the 128 rows [r0, r0 + 128) held in q_s/g_s over the keys
// [s0, s0 + len): the max m of the band-masked scores, the normaliser
// l = sum exp(s - m) and row = sum p dp.  Written to m_o/l_o/row_o at the
// row's index in the 128.  Starts with a barrier (q_s/g_s may just have been
// written); the caller synchronises before it reuses k_s/v_s.
template <typename T, int HD>
__device__ void row_stats(const float* q_s, const float* g_s, float* k_s, float* v_s,
                          float* ok_s, const T* k, long long k_sl, const T* v, long long v_sl,
                          const T* mask, int r0, int s0, int len, const Shape& sh, float* m_o,
                          float* l_o, float* row_o) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRows, i0 = r0 + row0;
  float mx[kRows], sum[kRows], acc[kRows], s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    mx[r] = kMask;
    sum[r] = 0.f;
    acc[r] = 0.f;
  }
  for (int c = 0; c < len; c += kChunk) {
    __syncthreads();
    stage_kv<T, HD>(k, k_sl, v, v_sl, mask, s0 + c, sh.T, k_s, v_s, ok_s);
    __syncthreads();
    rows_dot<HD>(q_s, row0, k_s + lane * (HD + 1), s);
    rows_dot<HD>(g_s, row0, v_s + lane * (HD + 1), dp);
    const int j = s0 + c + lane;
    const bool key_ok = ok_s[lane] > 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sc = (key_ok && abs(i0 + r - j) <= sh.half) ? s[r] * sh.scale : kMask;
      const float mn = fmaxf(mx[r], sc);
      const float a = expf(mx[r] - mn), e = expf(sc - mn);
      sum[r] = sum[r] * a + e;
      acc[r] = acc[r] * a + e * dp[r];
      mx[r] = mn;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float row_max = warp_max(mx[r]);
    const float f = expf(mx[r] - row_max);
    const float l = warp_sum(sum[r] * f);
    const float a = warp_sum(acc[r] * f);
    if (lane == 0) {
      m_o[row0 + r] = row_max;
      l_o[row0 + r] = l;
      row_o[row0 + r] = a / l;
    }
  }
}

template <int HD>
constexpr size_t dq_smem_floats() {
  return 2 * (size_t)kTile * HD               // Q and G tiles
         + 2 * (size_t)kChunk * (HD + 1)      // K and V chunks, padded rows
         + (size_t)kWarps * kRows * kChunk    // ds of each warp's rows
         + 3 * (size_t)kTile                  // row max, normaliser, sum dp p
         + kChunk;                            // key validity of the chunk
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
banded_dq_kernel(View qv, View kv, View vv, const T* mask, View gv, View dqv, Shape sh) {
  constexpr int kDL = HD / 32;  // dq columns per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* g_s = q_s + kTile * HD;
  float* k_s = g_s + kTile * HD;
  float* v_s = k_s + kChunk * (HD + 1);
  float* ds_s = v_s + kChunk * (HD + 1);
  float* m_s = ds_s + kWarps * kRows * kChunk;
  float* l_s = m_s + kTile;
  float* r_s = l_s + kTile;
  float* ok_s = r_s + kTile;

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = tile * kTile;
  const int start = max(0, min(q0 - (sh.k_win - kTile) / 2, sh.T_pad - sh.k_win));
  const int row0 = warp * kRows, i0 = q0 + row0;

  const T* q = static_cast<const T*>(qv.p) + b * qv.sb + h * qv.sh;
  const T* k = static_cast<const T*>(kv.p) + b * kv.sb + h * kv.sh;
  const T* v = static_cast<const T*>(vv.p) + b * vv.sb + h * vv.sh;
  const T* g = static_cast<const T*>(gv.p) + b * gv.sb + h * gv.sh;
  const T* m = mask + (long long)b * sh.T;

  load_rows<T, HD>(q, qv.sl, q0, kTile, sh.T, HD, q_s);
  load_rows<T, HD>(g, gv.sl, q0, kTile, sh.T, HD, g_s);
  row_stats<T, HD>(q_s, g_s, k_s, v_s, ok_s, k, kv.sl, v, vv.sl, m, q0, start, sh.k_win, sh,
                   m_s, l_s, r_s);

  float acc[kRows][kDL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < kDL; ++t) acc[r][t] = 0.f;
  float* ds_w = ds_s + warp * kRows * kChunk;
  float s[kRows], dp[kRows];
  for (int c = 0; c < sh.k_win; c += kChunk) {
    __syncthreads();
    stage_kv<T, HD>(k, kv.sl, v, vv.sl, m, start + c, sh.T, k_s, v_s, ok_s);
    __syncthreads();
    rows_dot<HD>(q_s, row0, k_s + lane * (HD + 1), s);
    rows_dot<HD>(g_s, row0, v_s + lane * (HD + 1), dp);
    const int j = start + c + lane;
    const bool key_ok = ok_s[lane] > 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sc = (key_ok && abs(i0 + r - j) <= sh.half) ? s[r] * sh.scale : kMask;
      const float p = expf(sc - m_s[row0 + r]) / l_s[row0 + r];
      ds_w[r * kChunk + lane] = round_to<T>(p * (dp[r] - r_s[row0 + r]) * sh.scale);
    }
    __syncwarp();
#pragma unroll 4
    for (int jj = 0; jj < kChunk; ++jj) {
      float kk[kDL];
#pragma unroll
      for (int t = 0; t < kDL; ++t) kk[t] = k_s[jj * (HD + 1) + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float d = ds_w[r * kChunk + jj];
#pragma unroll
        for (int t = 0; t < kDL; ++t) acc[r][t] = fmaf(d, kk[t], acc[r][t]);
      }
    }
  }

  T* dq = static_cast<T*>(const_cast<void*>(dqv.p)) + b * dqv.sb + h * dqv.sh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i < sh.T) {
#pragma unroll
      for (int t = 0; t < kDL; ++t) dq[i * dqv.sl + lane + 32 * t] = from_f<T>(acc[r][t]);
    }
  }
}

// dk/dv: shared memory = the 3*K_WIN statistics, then one region used by
// phase A (Q/G chunk of 128 rows, K/V chunk of 32 keys) and phase B (own K
// and V, Q/G chunk of 32 rows, each warp's p and ds, own keys' validity).
template <int HD>
constexpr size_t dkv_phase_a_floats() {
  return 2 * (size_t)kTile * HD + 2 * (size_t)kChunk * (HD + 1) + kChunk;
}

template <int HD>
constexpr size_t dkv_phase_b_floats() {
  return 2 * (size_t)kTile * (HD + 1) + 2 * (size_t)kChunk * (HD + 1)
         + 2 * (size_t)kWarps * kRows * kChunk + kTile;
}

template <int HD>
size_t dkv_smem_floats(int k_win) {
  const size_t a = dkv_phase_a_floats<HD>(), b = dkv_phase_b_floats<HD>();
  return 3 * (size_t)k_win + (a > b ? a : b);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
banded_dkv_kernel(View qv, View kv, View vv, const T* mask, View gv, View dkv, View dvv,
                  Shape sh) {
  constexpr int kDL = HD / 32;  // dk/dv columns per lane
  extern __shared__ __align__(16) float smem[];
  float* m_s = smem;
  float* l_s = m_s + sh.k_win;
  float* r_s = l_s + sh.k_win;
  float* work = r_s + sh.k_win;  // 3*K_WIN floats: a multiple of 4, float4-aligned
  // phase A
  float* q_s = work;
  float* g_s = q_s + kTile * HD;
  float* k_s = g_s + kTile * HD;
  float* v_s = k_s + kChunk * (HD + 1);
  float* ok_s = v_s + kChunk * (HD + 1);
  // phase B
  float* ko_s = work;
  float* vo_s = ko_s + kTile * (HD + 1);
  float* qc_s = vo_s + kTile * (HD + 1);
  float* gc_s = qc_s + kChunk * (HD + 1);
  float* p_s = gc_s + kChunk * (HD + 1);
  float* ds_s = p_s + kWarps * kRows * kChunk;
  float* oko_s = ds_s + kWarps * kRows * kChunk;

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = tile * kTile;
  const int k2 = min(2 * sh.k_win - kTile, sh.T_pad);
  const int start = max(0, min(k0 - (sh.k_win - kTile) / 2, sh.T_pad - sh.k_win));
  const int n_start = max(0, min(start - (sh.k_win - kTile) / 2, sh.T_pad - k2));

  const T* q = static_cast<const T*>(qv.p) + b * qv.sb + h * qv.sh;
  const T* k = static_cast<const T*>(kv.p) + b * kv.sb + h * kv.sh;
  const T* v = static_cast<const T*>(vv.p) + b * vv.sb + h * vv.sh;
  const T* g = static_cast<const T*>(gv.p) + b * gv.sb + h * gv.sh;
  const T* m = mask + (long long)b * sh.T;

  // phase A: each query row's statistics over the K2 slice
  for (int rc = 0; rc < sh.k_win; rc += kTile) {
    __syncthreads();
    load_rows<T, HD>(q, qv.sl, start + rc, kTile, sh.T, HD, q_s);
    load_rows<T, HD>(g, gv.sl, start + rc, kTile, sh.T, HD, g_s);
    row_stats<T, HD>(q_s, g_s, k_s, v_s, ok_s, k, kv.sl, v, vv.sl, m, start + rc, n_start, k2,
                     sh, m_s + rc, l_s + rc, r_s + rc);
  }
  __syncthreads();

  // phase B: the tile's own keys against the query window, 32 rows at a time
  load_rows<T, HD>(k, kv.sl, k0, kTile, sh.T, HD + 1, ko_s);
  load_rows<T, HD>(v, vv.sl, k0, kTile, sh.T, HD + 1, vo_s);
  if (threadIdx.x < kTile) {
    const int j = k0 + threadIdx.x;
    oko_s[threadIdx.x] = (j < sh.T && to_f(m[j]) > 0.f) ? 1.f : 0.f;
  }
  const int key0 = warp * kRows;  // the warp's first own key
  float dk[kRows][kDL], dv[kRows][kDL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < kDL; ++t) {
      dk[r][t] = 0.f;
      dv[r][t] = 0.f;
    }
  float* p_w = p_s + warp * kRows * kChunk;
  float* ds_w = ds_s + warp * kRows * kChunk;
  for (int rc = 0; rc < sh.k_win; rc += kChunk) {
    __syncthreads();
    load_rows<T, HD>(q, qv.sl, start + rc, kChunk, sh.T, HD + 1, qc_s);
    load_rows<T, HD>(g, gv.sl, start + rc, kChunk, sh.T, HD + 1, gc_s);
    __syncthreads();
    // lane = query row i, against the warp's kRows own keys
    const float* qrow = qc_s + lane * (HD + 1);
    const float* grow = gc_s + lane * (HD + 1);
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = 0.f;
      dp[r] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d], gd = grow[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = fmaf(qd, ko_s[(key0 + r) * (HD + 1) + d], s[r]);
        dp[r] = fmaf(gd, vo_s[(key0 + r) * (HD + 1) + d], dp[r]);
      }
    }
    const int i = start + rc + lane;
    const float mi = m_s[rc + lane], li = l_s[rc + lane], rowi = r_s[rc + lane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = k0 + key0 + r;
      const bool ok = oko_s[key0 + r] > 0.f && abs(i - j) <= sh.half;
      const float sc = ok ? s[r] * sh.scale : kMask;
      const float p = expf(sc - mi) / li;
      p_w[r * kChunk + lane] = round_to<T>(p);
      ds_w[r * kChunk + lane] = round_to<T>(p * (dp[r] - rowi) * sh.scale);
    }
    __syncwarp();
#pragma unroll 2
    for (int jj = 0; jj < kChunk; ++jj) {
      float gg[kDL], qq[kDL];
#pragma unroll
      for (int t = 0; t < kDL; ++t) {
        gg[t] = gc_s[jj * (HD + 1) + lane + 32 * t];
        qq[t] = qc_s[jj * (HD + 1) + lane + 32 * t];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = p_w[r * kChunk + jj], dr = ds_w[r * kChunk + jj];
#pragma unroll
        for (int t = 0; t < kDL; ++t) {
          dv[r][t] = fmaf(pr, gg[t], dv[r][t]);
          dk[r][t] = fmaf(dr, qq[t], dk[r][t]);
        }
      }
    }
    __syncwarp();
  }

  T* dko = static_cast<T*>(const_cast<void*>(dkv.p)) + b * dkv.sb + h * dkv.sh;
  T* dvo = static_cast<T*>(const_cast<void*>(dvv.p)) + b * dvv.sb + h * dvv.sh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = k0 + key0 + r;
    if (j < sh.T) {
#pragma unroll
      for (int t = 0; t < kDL; ++t) {
        dko[j * dkv.sl + lane + 32 * t] = from_f<T>(dk[r][t]);
        dvo[j * dvv.sl + lane + 32 * t] = from_f<T>(dv[r][t]);
      }
    }
  }
}

template <typename T, int HD>
int launch_dq(View q, View k, View v, const void* mask, View g, View dq, int B, Shape sh,
              cudaStream_t stream) {
  const size_t bytes = dq_smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(banded_dq_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.T_pad / kTile, B * sh.H);
  banded_dq_kernel<T, HD><<<grid, kWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const T*>(mask), g, dq, sh);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(View q, View k, View v, const void* mask, View g, View dk, View dv, int B,
               Shape sh, cudaStream_t stream) {
  const size_t bytes = dkv_smem_floats<HD>(sh.k_win) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(banded_dkv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.T_pad / kTile, B * sh.H);
  banded_dkv_kernel<T, HD><<<grid, kWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const T*>(mask), g, dk, dv, sh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq_hd(View q, View k, View v, const void* mask, View g, View dq, int B, int hd,
                 Shape sh, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_dq<T, 32>(q, k, v, mask, g, dq, B, sh, stream);
    case 64: return launch_dq<T, 64>(q, k, v, mask, g, dq, B, sh, stream);
    case 128: return launch_dq<T, 128>(q, k, v, mask, g, dq, B, sh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_dkv_hd(View q, View k, View v, const void* mask, View g, View dk, View dv, int B,
                  int hd, Shape sh, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_dkv<T, 32>(q, k, v, mask, g, dk, dv, B, sh, stream);
    case 64: return launch_dkv<T, 64>(q, k, v, mask, g, dk, dv, B, sh, stream);
    case 128: return launch_dkv<T, 128>(q, k, v, mask, g, dk, dv, B, sh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The shape record of a (B, H, T, hd, window) call, or false when the
// kernels do not take it.
bool make_shape(int B, int H, int T, int window, float scale, Shape* sh) {
  const int half = window / 2;
  const int k_win = kTile + 2 * ((half + kTile - 1) / kTile) * kTile;
  const int T_pad = (T + kTile - 1) / kTile * kTile;
  if (T_pad < k_win || B <= 0 || H <= 0 || window <= 0) return false;
  *sh = Shape{H, T, T_pad, half, k_win, scale};
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  hd is 32, 64
// or 128; T rounded up to 128 must hold one K_WIN slice.  g is the forward
// output's cotangent; dq (dk, dv) are written through their strides.
extern "C" int vmr_banded_attention_dq(int dtype, const void* q, long long q_sb, long long q_sh,
                                       long long q_sl, const void* k, long long k_sb,
                                       long long k_sh, long long k_sl, const void* v,
                                       long long v_sb, long long v_sh, long long v_sl,
                                       const void* mask, const void* g, long long g_sb,
                                       long long g_sh, long long g_sl, void* dq, long long dq_sb,
                                       long long dq_sh, long long dq_sl, int B, int H, int T,
                                       int hd, int window, float scale, void* stream) {
  Shape sh;
  if (!make_shape(B, H, T, window, scale, &sh)) return (int)cudaErrorInvalidValue;
  const View qv{q, q_sb, q_sh, q_sl}, kv{k, k_sb, k_sh, k_sl}, vv{v, v_sb, v_sh, v_sl};
  const View gv{g, g_sb, g_sh, g_sl}, dqv{dq, dq_sb, dq_sh, dq_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dq_hd<__nv_bfloat16>(qv, kv, vv, mask, gv, dqv, B, hd, sh, s)
                    : launch_dq_hd<float>(qv, kv, vv, mask, gv, dqv, B, hd, sh, s);
}

extern "C" int vmr_banded_attention_dkv(int dtype, const void* q, long long q_sb, long long q_sh,
                                        long long q_sl, const void* k, long long k_sb,
                                        long long k_sh, long long k_sl, const void* v,
                                        long long v_sb, long long v_sh, long long v_sl,
                                        const void* mask, const void* g, long long g_sb,
                                        long long g_sh, long long g_sl, void* dk,
                                        long long dk_sb, long long dk_sh, long long dk_sl,
                                        void* dv, long long dv_sb, long long dv_sh,
                                        long long dv_sl, int B, int H, int T, int hd,
                                        int window, float scale, void* stream) {
  Shape sh;
  if (!make_shape(B, H, T, window, scale, &sh)) return (int)cudaErrorInvalidValue;
  const View qv{q, q_sb, q_sh, q_sl}, kv{k, k_sb, k_sh, k_sl}, vv{v, v_sb, v_sh, v_sl};
  const View gv{g, g_sb, g_sh, g_sl}, dkv{dk, dk_sb, dk_sh, dk_sl}, dvv{dv, dv_sb, dv_sh, dv_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dkv_hd<__nv_bfloat16>(qv, kv, vv, mask, gv, dkv, dvv, B, hd, sh, s)
                    : launch_dkv_hd<float>(qv, kv, vv, mask, gv, dkv, dvv, B, hd, sh, s);
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  hd is 1 to
// 128; T rounded up to 128 must hold one K_WIN slice; scale is 1/sqrt(hd).
extern "C" int vmr_banded_attention(int dtype, const void* q, long long q_sb, long long q_sh,
                                    long long q_sl, const void* k, long long k_sb,
                                    long long k_sh, long long k_sl, const void* v,
                                    long long v_sb, long long v_sh, long long v_sl,
                                    const void* mask, void* out, long long o_sb, long long o_sh,
                                    long long o_sl, int B, int H, int T, int hd, int window,
                                    float scale, void* stream) {
  Shape sh;
  if (!make_shape(B, H, T, window, scale, &sh) || hd < 1 || hd > 128)
    return (int)cudaErrorInvalidValue;
  const View qv{q, q_sb, q_sh, q_sl}, kv{k, k_sb, k_sh, k_sl}, vv{v, v_sb, v_sh, v_sl};
  const View ov{out, o_sb, o_sh, o_sl};
  return launch_forward(dtype, qv, kv, vv, mask, ov, B, hd, sh, static_cast<cudaStream_t>(stream));
}
