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
// 384-key slice; part_s holds blockDim * kColVec floats.  With keep, only
// the rows j with keep[j - j0] != 0.  Ends with a barrier.
template <typename T, int HDP>
__device__ void slice_colsum(const T* v, long long sl, int j0, int j1, int hd, float* part_s,
                             float* cs_s, const float* keep = nullptr) {
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
      if (keep && keep[j - j0] == 0.f) continue;
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
// Which rows and keys these kernels read.  On a row with a valid key in its
// band, every out-of-band or invalid score is -1e30 and adds an exact 0
// (exp(-1e30 - m) in f32), so its statistics and products need its band
// only (the order of the sums differs, nothing else).  warp_key_span gives
// the band of 16 rows, rounded out to 16-key tiles and clipped to their
// slice (48 keys at window 19, against 384); the band is symmetric, so the
// same function of 16 KEYS from kk0 gives their query span, the rows whose
// band reaches them, clipped to the key tile's query window (the CPU tests
// check both readings).  A padding row (no valid key in its band: a wholly
// masked sample, a hole wider than the band, rows past T near no valid key)
// has every score at -1e30 on the TPU, so p is uniform over its whole slice:
//
//   dq:    p = 1/K_WIN on each key of the row's K_WIN slice, unrounded;
//          row = (g . sum_j v_j) / K_WIN over the slice's keys below T;
//   dk/dv: p = 1/K2 on EVERY own key of the tile, in band or not, valid or
//          not; row = (g . sum_j v_j) / K2 over the K2 slice's keys below T.
//
// Each kernel marks such rows from the mask (mark_padding_rows) and gives
// them a pass of their own, over their whole slice (dq) or every own key
// (dk/dv), only in blocks that hold one; the span walk skips them.  Their
// dv terms, the same round(1/K2) g on every own key, come from one sum of
// g over the window's padding rows.  Rows at or past T add nothing to dk/dv
// (their q and g are zero) and get no dq.
//
// What bounds them on an H100: at the long config's training shapes (batch
// 2, 4 heads of 128, window 19, T = 2304, 1152, 576) the band needs
// 6*T*19*hd FLOPs per (batch, head) for dq and 8*T*19*hd for dk/dv, and
// q, k, v, g are read once and the outputs written once: bytes bound them
// (7.0 us for dq, 8.5 for dk/dv at T = 2304 in bf16).  The bf16 grid is one
// block per 128-row (dq) or 128-key (dk/dv) tile and (batch, head): 144
// blocks at T = 2304, 72 at 1152, on 132 SMs at one block each, so a
// block's latency sets the time.
//
// bf16 (dq_mma, dkv_mma): 8 warps, one per 16 rows (dq) or 16 own keys
// (dk/dv); every product on mma.sync m16n8k16 (bf16 in, f32 out), fragments
// by ldmatrix (helpers in mma_bf16.cuh), 16 keys or rows a step:
//   dq:    Q and G fragments of the warp's rows in registers; K and V of the
//          block's key union staged with cp.async once for both walks (in
//          chunks where shared memory is short, or a padding row widens
//          walk 2 to the slice): walk 1 takes S = Q K^T and dP = G V^T over
//          the warp's span into m, l and sum(e dp) (quad shuffles); walk 2
//          recomputes them, ds = p (dp - row) scale rounded to bf16 is the A
//          operand (the C layout of two score tiles) of dq += ds K, with K's
//          B fragments by ldmatrix.trans.
//   dk/dv: phase 1, the statistics of the block's query union (160 rows at
//          window 19) over each row's key span, 128 rows a pass with Q and
//          G fragments in registers and the pass's K and V staged at once
//          (in chunks where shared memory is short), into shared memory;
//          phase 2, own K and V and the union's Q and G staged, each at
//          once: S^T = K Q^T and dP^T = V G^T
//          for the warp's 16 keys, p and ds in registers, dv += round(p) G
//          and dk += round(ds) Q with G's and Q's B fragments by
//          ldmatrix.trans.  dk and dv stay in registers (128 a thread at
//          hd 128): one block per SM.
// f32 (dq_f32, dkv_f32): exact f32 on the CUDA cores, no TF32; the same
// tiles, 16 warps of 8 rows or keys, lanes over 32-key (32-row) chunks
// whose K/V (Q/G) rows are padded to HDP + 1 floats (no bank conflicts), a
// warp skipping the chunks off its band unless a padding row needs them
// (and then the scores); dk/dv keeps the union's statistics in shared
// memory as the bf16 body does, and reads its own K and V rows as float4
// broadcasts.  One block per SM (~185 KB, ~205 KB at hd 128).  Blocks of 4
// warps and 32 rows or keys, 2-3 per SM, measured slower: 4x the padding
// rows' work and 2x the dk/dv statistics.
// Head dims 1 to 128: columns zero-filled up to HDP (16 HDK or 32 DCH).
// Every dk/dv row has one owner block: no atomics, the same bits every run.


// ok_s[i] = 1 for a valid key j0 + i below T, else 0, for i < n.
template <typename T>
__device__ void stage_valid(const T* m, int j0, int n, int T_len, float* ok_s) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    ok_s[i] = (j0 + i < T_len && to_f(m[j0 + i]) > 0.f) ? 1.f : 0.f;
}

// pad_s[i] = 1 for each row r0 + i (i < n) below T with no valid key in its
// band, else 0; ok_s holds the validity of the keys from k0, which cover
// every such band.  Returns whether the block has one (a barrier).
__device__ bool mark_padding_rows(int r0, int n, const float* ok_s, int k0, int k_len,
                                  const Shape& sh, float* pad_s) {
  bool any = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = r0 + i;
    bool pad = row < sh.T;
    const int lo = max(max(0, row - sh.half), k0);
    const int hi = min(min(sh.T, row + sh.half + 1), k0 + k_len);
    for (int j = lo; pad && j < hi; ++j) pad = ok_s[j - k0] == 0.f;
    pad_s[i] = pad ? 1.f : 0.f;
    any |= pad;
  }
  return __syncthreads_or(any);
}

// row_s[i] = coef * (g[r0 + i] . cs_s) for each padding row r0 + i (i < n),
// a warp per row: a padding row's sum of dp p.
template <typename T>
__device__ void padding_row_sums(const T* g, long long g_sl, int r0, int n, int hd,
                                 const float* pad_s, const float* cs_s, float coef,
                                 float* row_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int i = warp; i < n; i += nwarps) {
    if (pad_s[i] == 0.f) continue;
    float acc = 0.f;
    for (int c = lane; c < hd; c += 32) acc += to_f(g[(r0 + i) * g_sl + c]) * cs_s[c];
    acc = warp_sum(acc);
    if (lane == 0) row_s[i] = coef * acc;
  }
}

// ---------------------------------------------- bf16 fragment products

// c (16 x 16, two C tiles) += A B^T: A the 16 rows of a_s, B the 16 rows of
// b_s (each HDP = 16 HDK wide, row stride RS), both by ldmatrix.
template <int HDK, int RS>
__device__ __forceinline__ void mma_abt(float (&c)[2][4], const bf16* a_s, const bf16* b_s,
                                        int lane) {
  const int mi = lane >> 3, r = lane & 7;
  const bf16* arow = a_s + (r + ((mi & 1) << 3)) * RS + ((mi >> 1) << 3);
  const bf16* brow = b_s + (r + ((mi >> 1) << 3)) * RS + ((mi & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < HDK; ++kk) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, arow + 16 * kk);
    ldmatrix_x4(b, brow + 16 * kk);
    mma_bf16(c[0], a, b[0], b[1]);
    mma_bf16(c[1], a, b[2], b[3]);
  }
}

// The same with A's fragments in registers.
template <int HDK, int RS>
__device__ __forceinline__ void mma_rbt(float (&c)[2][4], const uint32_t (&a)[HDK][4],
                                        const bf16* b_s, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  const bf16* brow = b_s + (r + ((mi >> 1) << 3)) * RS + ((mi & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < HDK; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, brow + 16 * kk);
    mma_bf16(c[0], a[kk], b[0], b[1]);
    mma_bf16(c[1], a[kk], b[2], b[3]);
  }
}

// The A fragments of a warp's 16 rows of x_s (row stride RS).
template <int HDK, int RS>
__device__ __forceinline__ void load_a(uint32_t (&a)[HDK][4], const bf16* x_s, int lane) {
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < HDK; ++kk)
    ldmatrix_x4(a[kk], x_s + (r + ((mi & 1) << 3)) * RS + 16 * kk + ((mi >> 1) << 3));
}

// o (16 x HDP) += P B: P the 16 x 16 A tile pa, B the 16 rows of b_s, its
// B fragments by ldmatrix.trans (P.V's step in banded_mma).
template <int HDK, int RS>
__device__ __forceinline__ void mma_pb(float (&o)[2 * HDK][4], const uint32_t (&pa)[4],
                                       const bf16* b_s, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  const bf16* brow = b_s + (r + ((mi & 1) << 3)) * RS + ((mi >> 1) << 3);
#pragma unroll
  for (int d = 0; d < HDK; ++d) {
    uint32_t vb[4];
    ldmatrix_x4_trans(vb, brow + 16 * d);
    mma_bf16(o[2 * d], pa, vb[0], vb[1]);
    mma_bf16(o[2 * d + 1], pa, vb[2], vb[3]);
  }
}

// Two C tiles (16 x 16) rounded to bf16 as one A tile.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// One 16-key step of a running max m, sum l of e = exp(s - m) and sum a of
// e dp, for the rows of c[.][0..1] (x = 0) or c[.][2..3] (x = 2); s is
// scaled and masked (-1e30).  m is shared by the 4 lanes of a quad.
__device__ __forceinline__ void online_step(const float (&s)[2][4], const float (&dp)[2][4],
                                            int x, float& m, float& l, float& a) {
  const float n = fmaxf(m, quad_max(fmaxf(fmaxf(s[0][x], s[0][x + 1]),
                                          fmaxf(s[1][x], s[1][x + 1]))));
  const float f = __expf(m - n);
  l *= f;
  a *= f;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = x; e < x + 2; ++e) {
      const float w = __expf(s[j][e] - n);
      l += w;
      a += w * dp[j][e];
    }
  m = n;
}

// Writes a warp's 16 x hd tile in the C layout (rows r0 + g, r0 + g + 8)
// through the strides of ov, rows below T only.
template <int HDK>
__device__ __forceinline__ void store_c(const float (&o)[2 * HDK][4], const View& ov, int b,
                                        int h, int r0, int hd, int T_len, int lane) {
  const int g = lane >> 2, t = lane & 3;
  bf16* out = static_cast<bf16*>(const_cast<void*>(ov.p)) + b * ov.sb + h * ov.sh;
  const bool pairs = hd % 2 == 0 && ov.sl % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
#pragma unroll
  for (int d = 0; d < 2 * HDK; ++d) {
    const int col = 8 * d + 2 * t;
    if (col >= hd) continue;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int row = r0 + g + 4 * e;
      if (row >= T_len) continue;
      bf16* dst = out + row * ov.sl + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o[d][e], o[d][e + 1]);
      } else {
        dst[0] = __float2bfloat16(o[d][e]);
        if (col + 1 < hd) dst[1] = __float2bfloat16(o[d][e + 1]);
      }
    }
  }
}

// --------------------------------------------------------- bf16 dk/dv (#7)

// Shared memory of dkv_mma: a_s (2 x 128 rows: phase 1's Q and G pass,
// then the own K and V), b_s (2 x cap rows: phase 1's K and V key chunks,
// then phase 2's Q and G row chunks), then in floats the query window's m,
// l, row and padding flags (K_WIN each), the K2 slice's key validity, V
// summed over it and g over the padding rows (HDP each).
template <int HDK>
size_t dkv_mma_bytes(int k_win, int k2, int cap) {
  constexpr int RS = 16 * HDK + 8;
  return (size_t)(2 * kTile + 2 * cap) * RS * sizeof(bf16)
         + (size_t)(4 * k_win + k2 + 32 * HDK) * sizeof(float);
}

// Kernel #7 in bf16 on the tensor cores.  HDK = head dim rounded up to 16,
// over 16; cap: rows of a streamed chunk (a multiple of 16).
template <int HDK>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
    dkv_mma(View qv, View kv, View vv, const bf16* mask, View gv, View dkv, View dvv, Shape sh,
            int hd, int cap) {
  constexpr int HDP = 16 * HDK, RS = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* b_s = a_s + 2 * kTile * RS;
  float* m_s = reinterpret_cast<float*>(b_s + 2 * cap * RS);
  float* l_s = m_s + sh.k_win;
  float* row_s = l_s + sh.k_win;
  float* pad_s = row_s + sh.k_win;
  float* okk_s = pad_s + sh.k_win;
  const int k2 = min(2 * sh.k_win - kTile, sh.T_pad);
  float* cs_s = okk_s + k2;
  float* gp_s = cs_s + HDP;  // (HDP,) g summed over the window's padding rows
  float* part_s = reinterpret_cast<float*>(a_s);  // slice_colsum's, between the phases

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int k0 = tile * kTile, start = slice_start(k0, sh);
  const int n_start = max(0, min(start - (sh.k_win - kTile) / 2, sh.T_pad - k2));
  // the query union: the spans of the first and last 16 own keys, rows below T
  const int qu0 = warp_key_span(k0, sh).x;
  const int qu1 = min(warp_key_span(k0 + kTile - 16, sh).y, (sh.T + 15) / 16 * 16);
  const bf16* q = at<bf16>(qv, b, h);
  const bf16* k = at<bf16>(kv, b, h);
  const bf16* v = at<bf16>(vv, b, h);
  const bf16* gr = at<bf16>(gv, b, h);
  const bf16* m = mask + (long long)b * sh.T;
  const int tid = threadIdx.x, nthr = blockDim.x;

  stage_valid(m, n_start, k2, sh.T, okk_s);
  __syncthreads();
  const bool any_pad = mark_padding_rows(start, sh.k_win, okk_s, n_start, k2, sh, pad_s);

  // phase 1: each union row's m, l and row over its key span, 128 rows a pass
  for (int p0 = qu0; p0 < qu1; p0 += kTile) {
    const int p1 = min(p0 + kTile, qu1), live = max(0, min(p1, sh.T) - p0);
    __syncthreads();
    stage<HDP, RS>(a_s, q + p0 * qv.sl, qv.sl, live, kTile, hd, tid, nthr);
    stage<HDP, RS>(a_s + kTile * RS, gr + p0 * gv.sl, gv.sl, live, kTile, hd, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
    const int r0 = p0 + 16 * warp;
    // a warp takes 16 rows of the pass that are not all padding rows
    const bool active = r0 < p1 &&
                        __any_sync(0xffffffffu, lane < 16 && pad_s[r0 - start + lane] == 0.f);
    const int2 span = warp_key_span(r0, sh);
    uint32_t qa[HDK][4], ga[HDK][4];
    if (active) {
      load_a<HDK, RS>(qa, a_s + 16 * warp * RS, lane);
      load_a<HDK, RS>(ga, a_s + (kTile + 16 * warp) * RS, lane);
    }
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;
    const int kl = warp_key_span(p0, sh).x, kh = warp_key_span(p1 - 16, sh).y;
    for (int c0 = kl; c0 < kh; c0 += cap) {
      const int c1 = min(c0 + cap, kh), rows = max(0, min(c1, sh.T) - c0);
      __syncthreads();
      stage<HDP, RS>(b_s, k + c0 * kv.sl, kv.sl, rows, c1 - c0, hd, tid, nthr);
      stage<HDP, RS>(b_s + cap * RS, v + c0 * vv.sl, vv.sl, rows, c1 - c0, hd, tid, nthr);
      cp_async_wait_all();
      __syncthreads();
      if (!active) continue;
      for (int j0 = max(c0, span.x); j0 < min(c1, span.y); j0 += 16) {
        float s[2][4] = {}, dp[2][4] = {};
        mma_rbt<HDK, RS>(s, qa, b_s + (j0 - c0) * RS, lane);
        mma_rbt<HDK, RS>(dp, ga, b_s + (cap + j0 - c0) * RS, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + 8 * j + 2 * t + (e & 1), row = r0 + g + 4 * (e & 2);
            const bool ok = okk_s[key - n_start] > 0.f && abs(row - key) <= sh.half;
            s[j][e] = ok ? s[j][e] * sh.scale : kMask;
          }
        online_step(s, dp, 0, m0, l0, a0);
        online_step(s, dp, 2, m1, l1, a1);
      }
    }
    if (active) {
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      a0 = quad_sum(a0);
      a1 = quad_sum(a1);
      if (t == 0) {
        const int i0 = r0 + g - start, i1 = i0 + 8;
        m_s[i0] = m0, l_s[i0] = l0, row_s[i0] = a0 / l0;
        m_s[i1] = m1, l_s[i1] = l1, row_s[i1] = a1 / l1;
      }
    }
  }

  // padding rows: row = (g . V summed over the K2 slice) / K2; their dv
  // terms, round(1/K2) g on every own key, as one sum of g
  __syncthreads();
  if (any_pad) {
    slice_colsum<bf16, HDP>(v, vv.sl, n_start, min(n_start + k2, sh.T), hd, part_s, cs_s);
    slice_colsum<bf16, HDP>(gr, gv.sl, start, min(start + sh.k_win, sh.T), hd, part_s, gp_s,
                            pad_s);
    padding_row_sums(gr, gv.sl, start, sh.k_win, hd, pad_s, cs_s, 1.f / k2, row_s);
    __syncthreads();
  }

  // phase 2: the own keys against the rows of the union (every row of the
  // query window in a block with a padding row), cap rows a chunk
  const int live_k = max(0, min(k0 + kTile, sh.T) - k0);
  stage<HDP, RS>(a_s, k + k0 * kv.sl, kv.sl, live_k, kTile, hd, tid, nthr);
  stage<HDP, RS>(a_s + kTile * RS, v + k0 * vv.sl, vv.sl, live_k, kTile, hd, tid, nthr);
  const int kw0 = k0 + 16 * warp;  // the warp's own keys
  const int2 qspan = warp_key_span(kw0, sh);
  const float key_ok0 = okk_s[kw0 + g - n_start], key_ok1 = okk_s[kw0 + g + 8 - n_start];
  const float pad_p = round_to<bf16>(1.f / k2), inv_k2 = 1.f / k2;
  float dk[2 * HDK][4], dv[2 * HDK][4];
#pragma unroll
  for (int d = 0; d < 2 * HDK; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  const int w0 = any_pad ? start : qu0;
  const int w1 = any_pad ? min(start + sh.k_win, (sh.T + 15) / 16 * 16) : qu1;
  for (int c0 = w0; c0 < w1; c0 += cap) {
    const int c1 = min(c0 + cap, w1);
    bool need = c0 < qu1 && c1 > qu0;
    for (int i = c0; !need && i < c1; ++i) need = pad_s[i - start] != 0.f;
    if (!need) continue;  // the same answer in every thread
    const int rows = max(0, min(c1, sh.T) - c0);
    __syncthreads();
    stage<HDP, RS>(b_s, q + c0 * qv.sl, qv.sl, rows, c1 - c0, hd, tid, nthr);
    stage<HDP, RS>(b_s + cap * RS, gr + c0 * gv.sl, gv.sl, rows, c1 - c0, hd, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
    for (int r0 = c0; r0 < c1; r0 += 16) {
      const bool in_span = r0 >= qspan.x && r0 < qspan.y;
      const bool has_pad = __any_sync(0xffffffffu, lane < 16 && pad_s[r0 - start + lane] != 0.f);
      if (!in_span && !has_pad) continue;
      float s[2][4] = {}, dp[2][4] = {}, p[2][4], ds[2][4];
      if (in_span) mma_abt<HDK, RS>(s, a_s + 16 * warp * RS, b_s + (r0 - c0) * RS, lane);
      mma_abt<HDK, RS>(dp, a_s + (kTile + 16 * warp) * RS, b_s + (cap + r0 - c0) * RS, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw0 + g + 4 * (e & 2), row = r0 + 8 * j + 2 * t + (e & 1);
          const int wi = row - start;
          float pe = 0.f, de = 0.f;
          if (row < sh.T) {
            if (pad_s[wi] != 0.f) {  // its p goes to dv through gp_s
              de = inv_k2 * (dp[j][e] - row_s[wi]) * sh.scale;
            } else if (in_span && (e & 2 ? key_ok1 : key_ok0) > 0.f &&
                       abs(row - key) <= sh.half) {
              pe = __expf(s[j][e] * sh.scale - m_s[wi]) / l_s[wi];
              de = pe * (dp[j][e] - row_s[wi]) * sh.scale;
            }
          }
          p[j][e] = pe;
          ds[j][e] = de;
        }
      uint32_t pa[4], da[4];
      c_to_a(da, ds);
      if (in_span) {
        c_to_a(pa, p);
        mma_pb<HDK, RS>(dv, pa, b_s + (cap + r0 - c0) * RS, lane);
      }
      mma_pb<HDK, RS>(dk, da, b_s + (r0 - c0) * RS, lane);
    }
  }
  if (any_pad) {
#pragma unroll
    for (int d = 0; d < 2 * HDK; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[d][e] += pad_p * gp_s[8 * d + 2 * t + (e & 1)];
  }
  store_c<HDK>(dk, dkv, b, h, kw0, hd, sh.T, lane);
  store_c<HDK>(dv, dvv, b, h, kw0, hd, sh.T, lane);
}

// ------------------------------------------------------------ bf16 dq (#6)

// Shared memory of dq_mma: x_s (2 x cap rows: the Q and G tile, then K and
// V chunks of cap keys), then in floats the slice's key validity (K_WIN),
// the tile's padding flags and padding rows' sums of dp p (128 each) and V
// summed over the slice (HDP).
template <int HDK>
size_t dq_mma_bytes(int k_win, int cap) {
  constexpr int RS = 16 * HDK + 8;
  return (size_t)2 * cap * RS * sizeof(bf16) + (size_t)(k_win + 2 * kTile + 16 * HDK) * sizeof(float);
}

// Kernel #6 in bf16 on the tensor cores.  HDK = head dim rounded up to 16,
// over 16; cap: keys of a staged chunk (a multiple of 16, at least 128).
template <int HDK>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
    dq_mma(View qv, View kv, View vv, const bf16* mask, View gv, View dqv, Shape sh, int hd,
           int cap) {
  constexpr int HDP = 16 * HDK, RS = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);
  float* ok_s = reinterpret_cast<float*>(x_s + 2 * cap * RS);
  float* pad_s = ok_s + sh.k_win;
  float* rp_s = pad_s + kTile;
  float* cs_s = rp_s + kTile;
  float* part_s = reinterpret_cast<float*>(x_s);  // slice_colsum's, between the walks

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int q0 = tile * kTile, r0 = q0 + 16 * warp, ra = r0 + g, rb = ra + 8;
  const int start = slice_start(q0, sh);
  const int u0 = warp_key_span(q0, sh).x, u1 = warp_key_span(q0 + kTile - 16, sh).y;
  const int2 span = warp_key_span(r0, sh);
  const bf16* q = at<bf16>(qv, b, h);
  const bf16* k = at<bf16>(kv, b, h);
  const bf16* v = at<bf16>(vv, b, h);
  const bf16* gr = at<bf16>(gv, b, h);
  const bf16* m = mask + (long long)b * sh.T;
  const int tid = threadIdx.x, nthr = blockDim.x;

  // the Q and G tile into fragments; the slice's key validity; padding rows
  const int live = max(0, min(q0 + kTile, sh.T) - q0);
  stage<HDP, RS>(x_s, q + q0 * qv.sl, qv.sl, live, kTile, hd, tid, nthr);
  stage<HDP, RS>(x_s + cap * RS, gr + q0 * gv.sl, gv.sl, live, kTile, hd, tid, nthr);
  stage_valid(m, start, sh.k_win, sh.T, ok_s);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[HDK][4], ga[HDK][4];
  load_a<HDK, RS>(qa, x_s + 16 * warp * RS, lane);
  load_a<HDK, RS>(ga, x_s + (cap + 16 * warp) * RS, lane);
  const bool any_pad = mark_padding_rows(q0, kTile, ok_s, start, sh.k_win, sh, pad_s);
  const bool pad0 = pad_s[16 * warp + g] != 0.f, pad1 = pad_s[16 * warp + g + 8] != 0.f;
  const bool warp_pad = __any_sync(0xffffffffu, pad0 || pad1);

  // K and V of keys [c0, c1) into x_s, zero past T
  auto stage_kv = [&](int c0, int c1) {
    const int rows = max(0, min(c1, sh.T) - c0);
    __syncthreads();
    stage<HDP, RS>(x_s, k + c0 * kv.sl, kv.sl, rows, c1 - c0, hd, tid, nthr);
    stage<HDP, RS>(x_s + cap * RS, v + c0 * vv.sl, vv.sl, rows, c1 - c0, hd, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
  };
  // the warp's masked, scaled scores and dp of the 16 keys from j0 (chunk from c0)
  auto products = [&](float (&s)[2][4], float (&dp)[2][4], int j0, int c0, bool scores) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    if (scores) mma_rbt<HDK, RS>(s, qa, x_s + (j0 - c0) * RS, lane);
    mma_rbt<HDK, RS>(dp, ga, x_s + (cap + j0 - c0) * RS, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * j + 2 * t + (e & 1), row = e & 2 ? rb : ra;
        const bool ok = ok_s[key - start] > 0.f && abs(row - key) <= sh.half;
        s[j][e] = ok ? s[j][e] * sh.scale : kMask;
      }
  };

  // walk 1: m, l and sum(e dp) of rows ra and rb over the warp's span (a
  // warp of padding rows only has none to take)
  const bool stats = __any_sync(0xffffffffu, !pad0 || !pad1);
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;
  for (int c0 = u0; c0 < u1; c0 += cap) {
    const int c1 = min(c0 + cap, u1);
    stage_kv(c0, c1);
    for (int j0 = max(c0, span.x); stats && j0 < min(c1, span.y); j0 += 16) {
      float s[2][4], dp[2][4];
      products(s, dp, j0, c0, true);
      online_step(s, dp, 0, m0, l0, a0);
      online_step(s, dp, 2, m1, l1, a1);
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float row0 = quad_sum(a0) / l0, row1 = quad_sum(a1) / l1;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // padding rows: row = (g . V summed over the slice) / K_WIN
  if (any_pad) {
    __syncthreads();
    slice_colsum<bf16, HDP>(v, vv.sl, start, min(start + sh.k_win, sh.T), hd, part_s, cs_s);
    padding_row_sums(gr, gv.sl, q0, kTile, hd, pad_s, cs_s, 1.f / sh.k_win, rp_s);
    __syncthreads();
  }
  const float rp0 = pad0 ? rp_s[16 * warp + g] : 0.f, rp1 = pad1 ? rp_s[16 * warp + g + 8] : 0.f;
  const float inv_kwin = 1.f / sh.k_win;

  // walk 2: ds rounded to bf16, dq += ds K; a warp with a padding row takes
  // its whole slice.  A union staged whole in walk 1 stays.
  const bool resident = !any_pad && u1 - u0 <= cap;
  float o[2 * HDK][4];
#pragma unroll
  for (int d = 0; d < 2 * HDK; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  const int w0 = any_pad ? start : u0, w1 = any_pad ? start + sh.k_win : u1;
  const int lo = warp_pad ? start : span.x, hi = warp_pad ? start + sh.k_win : span.y;
  for (int c0 = w0; c0 < w1; c0 += cap) {
    const int c1 = min(c0 + cap, w1);
    if (!resident) stage_kv(c0, c1);
    for (int j0 = max(c0, lo); j0 < min(c1, hi); j0 += 16) {
      const bool in_span = j0 >= span.x && j0 < span.y;
      float s[2][4], dp[2][4], ds[2][4];
      products(s, dp, j0, c0, in_span);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool second = e & 2;
          if (second ? pad1 : pad0) {
            ds[j][e] = inv_kwin * (dp[j][e] - (second ? rp1 : rp0)) * sh.scale;
          } else {
            const float p = in_span ? __expf(s[j][e] - (second ? m1 : m0)) * (second ? inv1 : inv0)
                                    : 0.f;
            ds[j][e] = p * (dp[j][e] - (second ? row1 : row0)) * sh.scale;
          }
        }
      uint32_t da[4];
      c_to_a(da, ds);
      mma_pb<HDK, RS>(o, da, x_s + (j0 - c0) * RS, lane);
    }
  }
  store_c<HDK>(o, dqv, b, h, r0, hd, sh.T, lane);
}

// --------------------------------------------------- f32 dq (#6), dk/dv (#7)

// Rows [r0, r0 + n) x columns [0, HDP) of x into x_s in f32, rows padded to
// `ld` floats; zero past T and from column hd.
template <int HDP>
__device__ __forceinline__ void load_rows(const float* x, long long sl, int r0, int n, int T_len,
                                          int hd, int ld, float* x_s) {
  for (int idx = threadIdx.x; idx < n * HDP; idx += blockDim.x) {
    const int r = idx / HDP, d = idx % HDP, i = r0 + r;
    x_s[r * ld + d] = (i < T_len && d < hd) ? x[i * sl + d] : 0.f;
  }
}

// The warp's kRows rows of rows_s (HDP floats each) against one key row:
// out[r] = rows[row0 + r] . key.
template <int HDP>
__device__ __forceinline__ void rows_dot(const float* rows_s, int row0, const float* key,
                                         float (&out)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; d += 4) {
    const float k0 = key[d], k1 = key[d + 1], k2 = key[d + 2], k3 = key[d + 3];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 q4 = *reinterpret_cast<const float4*>(rows_s + (row0 + r) * HDP + d);
      out[r] = fmaf(q4.x, k0, out[r]);
      out[r] = fmaf(q4.y, k1, out[r]);
      out[r] = fmaf(q4.z, k2, out[r]);
      out[r] = fmaf(q4.w, k3, out[r]);
    }
  }
}

// Statistics of the n_rows rows from r0 held in q_s/g_s (HDP floats each):
// the max m of the band-masked scores, l = sum exp(s - m) and row = sum p dp,
// over keys [s0, s1) that pass through k_s/v_s in 32-key chunks (rows padded
// to HDP + 1); a warp takes only the chunks that meet its rows' band.  ok_s
// holds the validity of the keys from ok0.  Written to m_o/l_o/row_o at the
// row's index from r0; a warp whose rows are all padding rows (pad_o, at
// the same index) has none to take.  Starts with a barrier; ends with none.
template <int HDP>
__device__ void span_stats_f32(const float* q_s, const float* g_s, float* k_s, float* v_s,
                               const float* k, long long k_sl, const float* v, long long v_sl,
                               const float* ok_s, int ok0, int r0, int n_rows, int s0, int s1,
                               int hd, const Shape& sh, const float* pad_o, float* m_o,
                               float* l_o, float* row_o) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRows, i0 = r0 + row0;
  bool idle = true;  // no rows of the pass, or only padding rows
  for (int r = 0; r < kRows && row0 + r < n_rows; ++r) idle &= pad_o[row0 + r] != 0.f;
  float mx[kRows], sum[kRows], acc[kRows], s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    mx[r] = kMask;
    sum[r] = 0.f;
    acc[r] = 0.f;
  }
  for (int c = s0; c < s1; c += kChunk) {
    __syncthreads();
    load_rows<HDP>(k, k_sl, c, kChunk, sh.T, hd, HDP + 1, k_s);
    load_rows<HDP>(v, v_sl, c, kChunk, sh.T, hd, HDP + 1, v_s);
    __syncthreads();
    if (idle || c > i0 + kRows - 1 + sh.half || c + kChunk - 1 < i0 - sh.half)
      continue;  // off the band of the warp's rows
    rows_dot<HDP>(q_s, row0, k_s + lane * (HDP + 1), s);
    rows_dot<HDP>(g_s, row0, v_s + lane * (HDP + 1), dp);
    const int j = c + lane;
    const bool key_ok = j < s1 && ok_s[j - ok0] > 0.f;
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
  if (idle) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float row_max = warp_max(mx[r]);
    const float f = expf(mx[r] - row_max);
    const float l = warp_sum(sum[r] * f);
    const float a = warp_sum(acc[r] * f);
    if (lane == 0 && row0 + r < n_rows) {
      m_o[row0 + r] = row_max;
      l_o[row0 + r] = l;
      row_o[row0 + r] = a / l;
    }
  }
}

// x . the kRows rows of o_s (HDP floats each, read as float4 broadcasts:
// every lane reads the same row), x the lane's row (padded, read by floats).
template <int HDP>
__device__ __forceinline__ void own_dots(const float* x, const float* o_s, float (&out)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HDP; d += 4) {
    const float x0 = x[d], x1 = x[d + 1], x2 = x[d + 2], x3 = x[d + 3];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 o4 = *reinterpret_cast<const float4*>(o_s + r * HDP + d);
      out[r] = fmaf(x0, o4.x, out[r]);
      out[r] = fmaf(x1, o4.y, out[r]);
      out[r] = fmaf(x2, o4.z, out[r]);
      out[r] = fmaf(x3, o4.w, out[r]);
    }
  }
}

template <int HDP>
constexpr size_t dq_f32_floats_fixed() {
  return 2 * (size_t)kTile * HDP               // Q and G tiles
         + 2 * (size_t)kChunk * (HDP + 1)      // K and V chunks, padded rows
         + (size_t)kWarps * kRows * kChunk     // ds of each warp's rows
         + 5 * (size_t)kTile                   // m, l, row, padding flags, padding rows' row
         + HDP;                                // V summed over the slice
}

// Kernel #6 in f32 on the CUDA cores.  DCH = head dim rounded up to 32, over
// 32: the dq columns a lane holds.
template <int DCH>
__global__ void __launch_bounds__(kWarps * 32)
    dq_f32(View qv, View kv, View vv, const float* mask, View gv, View dqv, Shape sh, int hd) {
  constexpr int HDP = 32 * DCH;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* g_s = q_s + kTile * HDP;
  float* k_s = g_s + kTile * HDP;
  float* v_s = k_s + kChunk * (HDP + 1);
  float* ds_s = v_s + kChunk * (HDP + 1);
  float* m_s = ds_s + kWarps * kRows * kChunk;
  float* l_s = m_s + kTile;
  float* r_s = l_s + kTile;
  float* pad_s = r_s + kTile;
  float* rp_s = pad_s + kTile;
  float* cs_s = rp_s + kTile;
  float* ok_s = cs_s + HDP;   // (K_WIN,) the slice's key validity
  float* part_s = k_s;        // slice_colsum's, between the walks

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = tile * kTile, row0 = warp * kRows, i0 = q0 + row0;
  const int start = slice_start(q0, sh);
  const int u0 = warp_key_span(q0, sh).x, u1 = warp_key_span(q0 + kTile - 16, sh).y;
  const float* q = at<float>(qv, b, h);
  const float* k = at<float>(kv, b, h);
  const float* v = at<float>(vv, b, h);
  const float* g = at<float>(gv, b, h);
  const float* m = mask + (long long)b * sh.T;

  load_rows<HDP>(q, qv.sl, q0, kTile, sh.T, hd, HDP, q_s);
  load_rows<HDP>(g, gv.sl, q0, kTile, sh.T, hd, HDP, g_s);
  stage_valid(m, start, sh.k_win, sh.T, ok_s);
  __syncthreads();
  const bool any_pad = mark_padding_rows(q0, kTile, ok_s, start, sh.k_win, sh, pad_s);
  span_stats_f32<HDP>(q_s, g_s, k_s, v_s, k, kv.sl, v, vv.sl, ok_s, start, q0, kTile, u0, u1, hd,
                      sh, pad_s, m_s, l_s, r_s);
  if (any_pad) {
    __syncthreads();
    slice_colsum<float, HDP>(v, vv.sl, start, min(start + sh.k_win, sh.T), hd, part_s, cs_s);
    padding_row_sums(g, gv.sl, q0, kTile, hd, pad_s, cs_s, 1.f / sh.k_win, rp_s);
  }
  __syncthreads();

  bool warp_pad = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) warp_pad |= pad_s[row0 + r] != 0.f;
  const float inv_kwin = 1.f / sh.k_win;
  float acc[kRows][DCH];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;
  float* ds_w = ds_s + warp * kRows * kChunk;
  float s[kRows], dp[kRows];
  const int w0 = any_pad ? start : u0, w1 = any_pad ? start + sh.k_win : u1;
  for (int c0 = w0; c0 < w1; c0 += kChunk) {
    __syncthreads();
    load_rows<HDP>(k, kv.sl, c0, kChunk, sh.T, hd, HDP + 1, k_s);
    load_rows<HDP>(v, vv.sl, c0, kChunk, sh.T, hd, HDP + 1, v_s);
    __syncthreads();
    const bool band = !(c0 > i0 + kRows - 1 + sh.half || c0 + kChunk - 1 < i0 - sh.half);
    if (!band && !warp_pad) continue;
    if (band) rows_dot<HDP>(q_s, row0, k_s + lane * (HDP + 1), s);  // no scores for padding rows
    rows_dot<HDP>(g_s, row0, v_s + lane * (HDP + 1), dp);
    const int j = c0 + lane;
    const bool key_in = j < w1, key_ok = band && key_in && ok_s[j - start] > 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float d;
      if (pad_s[row0 + r] != 0.f) {
        d = key_in ? inv_kwin * (dp[r] - rp_s[row0 + r]) * sh.scale : 0.f;
      } else {
        const bool ok = key_ok && abs(i0 + r - j) <= sh.half;
        const float p = ok ? expf(s[r] * sh.scale - m_s[row0 + r]) / l_s[row0 + r] : 0.f;
        d = p * (dp[r] - r_s[row0 + r]) * sh.scale;
      }
      ds_w[r * kChunk + lane] = d;
    }
    __syncwarp();
#pragma unroll 2
    for (int jj = 0; jj < kChunk; jj += 4) {
      float kk[4][DCH];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < DCH; ++c) kk[u][c] = k_s[(jj + u) * (HDP + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 d4 = *reinterpret_cast<const float4*>(ds_w + r * kChunk + jj);
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          acc[r][c] = fmaf(d4.x, kk[0][c], acc[r][c]);
          acc[r][c] = fmaf(d4.y, kk[1][c], acc[r][c]);
          acc[r][c] = fmaf(d4.z, kk[2][c], acc[r][c]);
          acc[r][c] = fmaf(d4.w, kk[3][c], acc[r][c]);
        }
      }
    }
    __syncwarp();
  }

  float* dq = static_cast<float*>(const_cast<void*>(dqv.p)) + b * dqv.sb + h * dqv.sh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i >= sh.T) continue;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) dq[i * dqv.sl + d] = acc[r][c];
    }
  }
}

// dkv_f32's shared memory: one region used by phase A (Q/G pass of 128
// rows, K/V chunk of 32 keys) and phase B (own K and V, Q/G chunk of 32
// rows, each warp's p and ds), then the query window's m, l, row and
// padding flags (K_WIN each), V summed over the K2 slice and g over the
// padding rows (HDP each) and the K2 slice's key validity.
template <int HDP>
__host__ __device__ constexpr size_t dkv_f32_work_floats() {
  constexpr size_t a = 2 * (size_t)kTile * HDP + 2 * (size_t)kChunk * (HDP + 1);
  constexpr size_t b = 2 * (size_t)kTile * HDP + 2 * (size_t)kChunk * (HDP + 1)
                       + 2 * (size_t)kWarps * kRows * kChunk;
  return a > b ? a : b;
}

// Kernel #7 in f32 on the CUDA cores.  DCH = head dim rounded up to 32, over
// 32: the dk/dv columns a lane holds.
template <int DCH>
__global__ void __launch_bounds__(kWarps * 32)
    dkv_f32(View qv, View kv, View vv, const float* mask, View gv, View dkv, View dvv, Shape sh,
            int hd) {
  constexpr int HDP = 32 * DCH;
  extern __shared__ __align__(16) float smem[];
  const int k2 = min(2 * sh.k_win - kTile, sh.T_pad);
  float* work = smem;
  float* m_s = work + dkv_f32_work_floats<HDP>();
  float* l_s = m_s + sh.k_win;
  float* r_s = l_s + sh.k_win;
  float* pad_s = r_s + sh.k_win;
  float* cs_s = pad_s + sh.k_win;
  float* gp_s = cs_s + HDP;  // (HDP,) g summed over the window's padding rows
  float* okk_s = gp_s + HDP;
  // phase A
  float* q_s = work;
  float* g_s = q_s + kTile * HDP;
  float* k_s = g_s + kTile * HDP;
  float* v_s = k_s + kChunk * (HDP + 1);
  // phase B
  float* ko_s = work;
  float* vo_s = ko_s + kTile * HDP;
  float* qc_s = vo_s + kTile * HDP;
  float* gc_s = qc_s + kChunk * (HDP + 1);
  float* p_s = gc_s + kChunk * (HDP + 1);
  float* ds_s = p_s + kWarps * kRows * kChunk;

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = tile * kTile, start = slice_start(k0, sh);
  const int n_start = max(0, min(start - (sh.k_win - kTile) / 2, sh.T_pad - k2));
  const int qu0 = warp_key_span(k0, sh).x;
  const int qu1 = min(warp_key_span(k0 + kTile - 16, sh).y, (sh.T + 15) / 16 * 16);
  const float* q = at<float>(qv, b, h);
  const float* k = at<float>(kv, b, h);
  const float* v = at<float>(vv, b, h);
  const float* g = at<float>(gv, b, h);
  const float* m = mask + (long long)b * sh.T;

  stage_valid(m, n_start, k2, sh.T, okk_s);
  __syncthreads();
  const bool any_pad = mark_padding_rows(start, sh.k_win, okk_s, n_start, k2, sh, pad_s);

  // phase A: each union row's statistics over its key span, 128 rows a pass
  for (int p0 = qu0; p0 < qu1; p0 += kTile) {
    const int p1 = min(p0 + kTile, qu1);
    __syncthreads();
    load_rows<HDP>(q, qv.sl, p0, kTile, sh.T, hd, HDP, q_s);
    load_rows<HDP>(g, gv.sl, p0, kTile, sh.T, hd, HDP, g_s);
    span_stats_f32<HDP>(q_s, g_s, k_s, v_s, k, kv.sl, v, vv.sl, okk_s, n_start, p0, p1 - p0,
                        warp_key_span(p0, sh).x, warp_key_span(p1 - 16, sh).y, hd, sh,
                        pad_s + p0 - start, m_s + p0 - start, l_s + p0 - start,
                        r_s + p0 - start);
  }
  __syncthreads();
  if (any_pad) {  // padding rows: row = (g . V summed over the K2 slice) / K2;
                  // their dv terms, g / K2 on every own key, as one sum of g
    slice_colsum<float, HDP>(v, vv.sl, n_start, min(n_start + k2, sh.T), hd, work, cs_s);
    slice_colsum<float, HDP>(g, gv.sl, start, min(start + sh.k_win, sh.T), hd, work, gp_s,
                             pad_s);
    padding_row_sums(g, gv.sl, start, sh.k_win, hd, pad_s, cs_s, 1.f / k2, r_s);
    __syncthreads();
  }

  // phase B: the own keys against the union's rows (every row of the query
  // window in a block with a padding row), 32 rows at a time
  load_rows<HDP>(k, kv.sl, k0, kTile, sh.T, hd, HDP, ko_s);
  load_rows<HDP>(v, vv.sl, k0, kTile, sh.T, hd, HDP, vo_s);
  const int key0 = warp * kRows, kw = k0 + key0;  // the warp's first own key
  float ok_own[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) ok_own[r] = okk_s[kw + r - n_start];
  const float inv_k2 = 1.f / k2;
  float dk[kRows][DCH], dv[kRows][DCH];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) dk[r][c] = dv[r][c] = 0.f;
  float* p_w = p_s + warp * kRows * kChunk;
  float* ds_w = ds_s + warp * kRows * kChunk;
  const int w0 = any_pad ? start : qu0;
  const int w1 = any_pad ? min(start + sh.k_win, sh.T) : qu1;
  for (int rc = w0; rc < w1; rc += kChunk) {
    bool need = rc < qu1 && rc + kChunk > qu0, chunk_pad = false;
    for (int i = rc; i < min(rc + kChunk, w1); ++i) chunk_pad |= pad_s[i - start] != 0.f;
    if (!need && !chunk_pad) continue;  // the same answer in every thread
    __syncthreads();
    load_rows<HDP>(q, qv.sl, rc, kChunk, sh.T, hd, HDP + 1, qc_s);
    load_rows<HDP>(g, gv.sl, rc, kChunk, sh.T, hd, HDP + 1, gc_s);
    __syncthreads();
    const bool band = !(rc > kw + kRows - 1 + sh.half || rc + kChunk - 1 < kw - sh.half);
    if (!band && !chunk_pad) continue;
    // lane = query row i, against the warp's kRows own keys
    const float* qrow = qc_s + lane * (HDP + 1);
    const float* grow = gc_s + lane * (HDP + 1);
    float s[kRows], dp[kRows];
    if (band) own_dots<HDP>(qrow, ko_s + key0 * HDP, s);  // no scores for padding rows
    own_dots<HDP>(grow, vo_s + key0 * HDP, dp);
    const int i = rc + lane, wi = i - start;
    const bool live = i < w1 && i < sh.T;
    const bool pad = live && pad_s[wi] != 0.f;
    const float mi = live ? m_s[wi] : 0.f, li = live ? l_s[wi] : 1.f, rowi = live ? r_s[wi] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float p = 0.f, d = 0.f;
      if (pad) {  // its p goes to dv through gp_s
        d = inv_k2 * (dp[r] - rowi) * sh.scale;
      } else if (band && live && ok_own[r] > 0.f && abs(i - (kw + r)) <= sh.half) {
        p = expf(s[r] * sh.scale - mi) / li;
        d = p * (dp[r] - rowi) * sh.scale;
      }
      p_w[r * kChunk + lane] = p;
      ds_w[r * kChunk + lane] = d;
    }
    __syncwarp();
    for (int jj = 0; jj < kChunk; jj += 4) {
      float gg[4][DCH], qq[4][DCH];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          gg[u][c] = gc_s[(jj + u) * (HDP + 1) + lane + 32 * c];
          qq[u][c] = qc_s[(jj + u) * (HDP + 1) + lane + 32 * c];
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(p_w + r * kChunk + jj);
        const float4 d4 = *reinterpret_cast<const float4*>(ds_w + r * kChunk + jj);
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          if (band) {
            dv[r][c] = fmaf(p4.x, gg[0][c], dv[r][c]);
            dv[r][c] = fmaf(p4.y, gg[1][c], dv[r][c]);
            dv[r][c] = fmaf(p4.z, gg[2][c], dv[r][c]);
            dv[r][c] = fmaf(p4.w, gg[3][c], dv[r][c]);
          }
          dk[r][c] = fmaf(d4.x, qq[0][c], dk[r][c]);
          dk[r][c] = fmaf(d4.y, qq[1][c], dk[r][c]);
          dk[r][c] = fmaf(d4.z, qq[2][c], dk[r][c]);
          dk[r][c] = fmaf(d4.w, qq[3][c], dk[r][c]);
        }
      }
    }
    __syncwarp();
  }

  float* dko = static_cast<float*>(const_cast<void*>(dkv.p)) + b * dkv.sb + h * dkv.sh;
  float* dvo = static_cast<float*>(const_cast<void*>(dvv.p)) + b * dvv.sb + h * dvv.sh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = kw + r;
    if (j >= sh.T) continue;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) {
        dko[j * dkv.sl + d] = dk[r][c];
        dvo[j * dvv.sl + d] = any_pad ? dv[r][c] + inv_k2 * gp_s[d] : dv[r][c];
      }
    }
  }
}

// ---------------------------------------------------------- backward launch

constexpr int kMaxSharedBytes = 232448;  // what one block of an H100 can have

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int HDK>
int launch_dq_mma(View q, View k, View v, const void* mask, View g, View dq, int B, int hd,
                  Shape sh, cudaStream_t stream) {
  // chunks of up to K_WIN keys (at least the 128 rows of the Q and G tile):
  // the union (160 keys at window 19) is staged once for both walks where
  // it fits, as it does at every head dim up to 128 for windows up to 255
  const int row_bytes = 2 * (16 * HDK + 8) * (int)sizeof(bf16);
  const int fixed = (int)dq_mma_bytes<HDK>(sh.k_win, 0);
  const int cap = max(kTile, min(sh.k_win, (kMaxSharedBytes - fixed) / row_bytes / 16 * 16));
  const size_t bytes = dq_mma_bytes<HDK>(sh.k_win, cap);
  if (int err = prepare(dq_mma<HDK>, bytes)) return err;
  dq_mma<HDK><<<dim3(sh.T_pad / kTile, B * sh.H), kMmaWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const bf16*>(mask), g, dq, sh, hd, cap);
  return (int)cudaGetLastError();
}

template <int DCH>
int launch_dq_f32(View q, View k, View v, const void* mask, View g, View dq, int B, int hd,
                  Shape sh, cudaStream_t stream) {
  const size_t bytes = (dq_f32_floats_fixed<32 * DCH>() + sh.k_win) * sizeof(float);
  if (int err = prepare(dq_f32<DCH>, bytes)) return err;
  dq_f32<DCH><<<dim3(sh.T_pad / kTile, B * sh.H), kWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const float*>(mask), g, dq, sh, hd);
  return (int)cudaGetLastError();
}

template <int HDK>
int launch_dkv_mma(View q, View k, View v, const void* mask, View g, View dk, View dv, int B,
                   int hd, Shape sh, cudaStream_t stream) {
  // a chunk of up to K_WIN rows: a block walks each of its ranges in one
  // chunk where the shared memory holds it (the union, 160 rows at window
  // 19, always does at head dim 128; a padding row's whole window may not)
  const int k2 = min(2 * sh.k_win - kTile, sh.T_pad);
  const int row_bytes = 2 * (16 * HDK + 8) * (int)sizeof(bf16);
  const int fixed = (int)dkv_mma_bytes<HDK>(sh.k_win, k2, 0);
  const int cap = min(sh.k_win, (kMaxSharedBytes - fixed) / row_bytes / 16 * 16);
  const size_t bytes = dkv_mma_bytes<HDK>(sh.k_win, k2, cap);
  if (int err = prepare(dkv_mma<HDK>, bytes)) return err;
  dkv_mma<HDK><<<dim3(sh.T_pad / kTile, B * sh.H), kMmaWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const bf16*>(mask), g, dk, dv, sh, hd, cap);
  return (int)cudaGetLastError();
}

template <int DCH>
int launch_dkv_f32(View q, View k, View v, const void* mask, View g, View dk, View dv, int B,
                   int hd, Shape sh, cudaStream_t stream) {
  const int k2 = min(2 * sh.k_win - kTile, sh.T_pad);
  const size_t bytes =
      (dkv_f32_work_floats<32 * DCH>() + 4 * (size_t)sh.k_win + 64 * DCH + k2) * sizeof(float);
  if (int err = prepare(dkv_f32<DCH>, bytes)) return err;
  dkv_f32<DCH><<<dim3(sh.T_pad / kTile, B * sh.H), kWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const float*>(mask), g, dk, dv, sh, hd);
  return (int)cudaGetLastError();
}

int launch_dq(int dtype, View q, View k, View v, const void* mask, View g, View dq, int B, int hd,
              Shape sh, cudaStream_t s) {
  if (dtype == 0) {
    switch ((hd + 31) / 32) {
      case 1: return launch_dq_f32<1>(q, k, v, mask, g, dq, B, hd, sh, s);
      case 2: return launch_dq_f32<2>(q, k, v, mask, g, dq, B, hd, sh, s);
      case 3: return launch_dq_f32<3>(q, k, v, mask, g, dq, B, hd, sh, s);
      case 4: return launch_dq_f32<4>(q, k, v, mask, g, dq, B, hd, sh, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch ((hd + 15) / 16) {
    case 1: return launch_dq_mma<1>(q, k, v, mask, g, dq, B, hd, sh, s);
    case 2: return launch_dq_mma<2>(q, k, v, mask, g, dq, B, hd, sh, s);
    case 3: return launch_dq_mma<3>(q, k, v, mask, g, dq, B, hd, sh, s);
    case 4: return launch_dq_mma<4>(q, k, v, mask, g, dq, B, hd, sh, s);
    case 5: return launch_dq_mma<5>(q, k, v, mask, g, dq, B, hd, sh, s);
    case 6: return launch_dq_mma<6>(q, k, v, mask, g, dq, B, hd, sh, s);
    case 7: return launch_dq_mma<7>(q, k, v, mask, g, dq, B, hd, sh, s);
    case 8: return launch_dq_mma<8>(q, k, v, mask, g, dq, B, hd, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_dkv(int dtype, View q, View k, View v, const void* mask, View g, View dk, View dv,
               int B, int hd, Shape sh, cudaStream_t s) {
  if (dtype == 0) {
    switch ((hd + 31) / 32) {
      case 1: return launch_dkv_f32<1>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
      case 2: return launch_dkv_f32<2>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
      case 3: return launch_dkv_f32<3>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
      case 4: return launch_dkv_f32<4>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch ((hd + 15) / 16) {
    case 1: return launch_dkv_mma<1>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
    case 2: return launch_dkv_mma<2>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
    case 3: return launch_dkv_mma<3>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
    case 4: return launch_dkv_mma<4>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
    case 5: return launch_dkv_mma<5>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
    case 6: return launch_dkv_mma<6>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
    case 7: return launch_dkv_mma<7>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
    case 8: return launch_dkv_mma<8>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
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

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  hd is 1 to
// 128; T rounded up to 128 must hold one K_WIN slice; scale is 1/sqrt(hd).
// g is the forward output's cotangent; dq (dk, dv) are written through
// their strides.
extern "C" int vmr_banded_attention_dq(int dtype, const void* q, long long q_sb, long long q_sh,
                                       long long q_sl, const void* k, long long k_sb,
                                       long long k_sh, long long k_sl, const void* v,
                                       long long v_sb, long long v_sh, long long v_sl,
                                       const void* mask, const void* g, long long g_sb,
                                       long long g_sh, long long g_sl, void* dq, long long dq_sb,
                                       long long dq_sh, long long dq_sl, int B, int H, int T,
                                       int hd, int window, float scale, void* stream) {
  Shape sh;
  if (!make_shape(B, H, T, window, scale, &sh) || hd < 1 || hd > 128)
    return (int)cudaErrorInvalidValue;
  const View qv{q, q_sb, q_sh, q_sl}, kv{k, k_sb, k_sh, k_sl}, vv{v, v_sb, v_sh, v_sl};
  const View gv{g, g_sb, g_sh, g_sl}, dqv{dq, dq_sb, dq_sh, dq_sl};
  return launch_dq(dtype, qv, kv, vv, mask, gv, dqv, B, hd, sh,
                   static_cast<cudaStream_t>(stream));
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
  if (!make_shape(B, H, T, window, scale, &sh) || hd < 1 || hd > 128)
    return (int)cudaErrorInvalidValue;
  const View qv{q, q_sb, q_sh, q_sl}, kv{k, k_sb, k_sh, k_sl}, vv{v, v_sb, v_sh, v_sl};
  const View gv{g, g_sb, g_sh, g_sl}, dkv{dk, dk_sb, dk_sh, dk_sl}, dvv{dv, dv_sb, dv_sh, dv_sl};
  return launch_dkv(dtype, qv, kv, vv, mask, gv, dkv, dvv, B, hd, sh,
                    static_cast<cudaStream_t>(stream));
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
