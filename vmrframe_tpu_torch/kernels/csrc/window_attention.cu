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
// still -1e30 is such a row (the span holds its band; the f32 body marks
// them from the mask instead); only a block that has one sums V over its
// slice, once, on the CUDA cores (slice_colsum).
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
// f32, banded_tf32 (the training type): both products, S = Q K^T and O +=
// P.V, on mma.sync m16n8k8 TF32 in the 3xTF32 split (mma_tf32.cuh; the
// backward's note below says why one TF32 pass is not enough), p kept in f32
// and never rounded (the TPU's p.astype(v.dtype) is a no-op in f32).  The
// grid and warps are banded_mma's, a warp per 16 rows over its span: one
// block of 8 warps per 128-row tile, one block an SM (~169 KB at hd 128,
// window 19), which ran 3-8% faster on an H100 than blocks of 4 warps over
// 64-row half tiles at two an SM (~101 KB; their unions re-read more keys,
// and both halves sum V over the same slice).  K and V of the block's key
// union (160 rows at window 19) are staged once with 16-byte cp.async in f32
// rows of 8 hd8 + kTfRowPad floats, in chunks where the union does not fit
// (wide windows); the warp's Q rows, an A operand no other warp reads, come
// from device memory step by step.  Scores go kTfChunk keys (a window-19
// span) a step with a running max and sum, O rescaled once a step: f32
// rounds p nowhere, so this is one walk, exact up to the order of the sums.
// p leaves its C layout as the A tile of P.V as it stands (V's B rows read
// from keys 2t, 2t + 1).  Padding rows are marked from the mask before the
// walk (mark_padding_rows), a block that has one sums V over its slice first
// (slice_colsum), and a warp whose rows are all padding rows or past T skips
// the walk.  Head dims 1 to 128 in buckets of 32, 64 and 128 columns (HD8 4,
// 8, 16), the call's own 8 hd8 columns staged, zero-filled up to the next
// multiple of 8.
//
// What bounds it on an H100: at the long config (T up to 2304, hd 128,
// window 19) the band needs 2*2*T*19*hd FLOPs per (batch, head) and reads
// q, k, v once, so the least time is set by bytes (~22 us at T = 2304, batch
// 8, 4 heads, bf16; the f32 products at 3xTF32's third of TF32's rate do not
// change that).  The bf16 body reads K and V 160/128 times (the union)
// and Q once, and at window 19 issues 6 + 6 mma per 16 rows and 16 head
// columns (the scores of a 48-key span, then P.V); the f32 body 3 x (6 + 6)
// per 8 head columns.
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
#include "mma_tf32.cuh"  // to_tf32, split_tf32, mma_tf32, mma_3xtf32

namespace {

constexpr float kMask = -1e30f;
constexpr int kTile = 128;                          // query rows per block (the TPU tile)
constexpr int kMmaWarps = kTile / 16;               // a warp per 16 rows (or own keys)
constexpr int kMmaChunk = 64;                       // banded_mma: keys per score chunk (8 n-tiles)
constexpr int kTwoBlockBytes = 113 * 1024;          // shared memory of one of two blocks per SM
constexpr int kColSumFloats = 2048;                 // slice_colsum: 16 bytes a thread
constexpr int kTfChunk = 48;   // the f32 bodies: keys of a warp's score step, 6 n-tiles
constexpr int kTfRowPad = 4;   // the f32 bodies: floats after each staged f32 row
static_assert(kColSumFloats >= kMmaWarps * 32 * 8, "slice_colsum's partial sums");

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
// (dk/dv), only in blocks that hold one; the span walk skips them (the f32
// bodies factor the pass through one hd x hd matrix, below).  Their dv
// terms, the same round(1/K2) g on every own key, come from one sum of g
// over the window's padding rows.  Rows at or past T add nothing to dk/dv
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
// f32 (dq_tf32, dkv_tf32): the same grid, warps, spans and statistics on
// the tensor cores, every product (S = Q K^T, dP = G V^T, dq += ds K; S^T =
// K Q^T, dP^T = V G^T, dv += p^T G, dk += ds^T Q) on mma.sync m16n8k8 TF32
// in the 3xTF32 split (mma_tf32.cuh: each operand x as big = tf32(x) and
// small = tf32(x - big), rounded as cvt.rna rounds; big.small + small.big +
// big.big summed in f32), which keeps ~22 of f32's 24 bits of each operand
// where one TF32 pass keeps 11: the port's f32 route keeps TF32 out of
// cuBLAS and cuDNN (device.py), and these bodies hold the plain versions to
// 1e-4 as the former CUDA-core ones did.  Fragments are split as they are
// read; the products go in rounds over independent accumulator tiles with
// no branch between them (a step computes all its tiles, those past the
// span or head dim re-reading tile 0, never used).  p and ds leave their C
// layout as the A tiles of the value products as they stand (lane t holds
// columns 2t, 2t + 1, the k indices t, t + 4), the B rows read from the
// matching keys (dq) or query rows (dk/dv).  The operands a warp alone
// reads (its 16 rows' Q and G in dq and in dk/dv's statistics, its 16 own
// keys' K and V) come from device memory step by step; those that
// neighbouring warps share (K and V of the key union, Q and G of the query
// union) are staged once with 16-byte cp.async in f32 rows of 8 hd8 +
// kTfRowPad floats (both fragment patterns, row g column t and rows 2t,
// 2t + 1 column g, on 32 distinct banks), in chunks where the union does
// not fit.  Scores go kTfChunk keys (a window-19 span) a step, and dq keeps
// a span of at most kTfChunk keys (window <= 33) in registers from walk 1
// to ds: one walk.
//   Padding rows: p is a constant on every key they reach, and f32 rounds
// nothing, so their products factor through one hd x hd matrix a block,
// taken on the tensor cores a 16-row slab a warp and kept in shared memory
// already split: dq = (scale / K_WIN) g N with N = sum over the slice of
// (v - cs / K_WIN) k^T (cs: V summed over the slice), written before the
// walks, which give these rows nothing; dk += (scale / K2) M (v - cs / K2)
// on every own key with M = sum over the window's padding rows of q g^T
// (cs over the K2 slice).  Their row sums of dp p are then not needed.  The
// span walks the CUDA-core bodies took for these rows walked the whole
// slice or window per warp, and set the bodies' time in blocks that hold
// one.
//   Registers, not shared memory, bound them: dk and dv hold 128 floats a
// thread at head dim 128, so one block of 8 warps an SM (~179 KB, ~172 KB
// at hd 128, window 19).  Head dims 1 to 128 in buckets of 32, 64 and 128
// columns (HD8 4, 8, 16), the call's own 8 hd8 columns staged, zero-filled
// up to the next multiple of 8.
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

// ------------------------------------------- f32 products on the tensor cores

// Rows [0, rows) x columns [0, hd) of a strided f32 matrix into a (rows_pad,
// hdp) tile of row stride rs floats, zero beyond (hdp a multiple of 4);
// threads tid, tid + nthr, ... each take 16-byte pieces, by cp.async where
// the source rows are 16-byte aligned.  The caller waits.
__device__ __forceinline__ void stage_f32(float* dst, int rs, const float* src, long long sl,
                                          int rows, int rows_pad, int hd, int hdp, int tid,
                                          int nthr) {
  const bool aligned = hd % 4 == 0 && sl % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int pieces = hdp / 4;
  for (int idx = tid; idx < rows_pad * pieces; idx += nthr) {
    const int r = idx / pieces, c = (idx % pieces) * 4;
    float* d = dst + r * rs + c;
    if (aligned && r < rows && c < hd) {
      cp_async16(d, src + r * sl + c);
    } else {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = (r < rows && c + e < hd) ? src[r * sl + c + e] : 0.f;
      *reinterpret_cast<float4*>(d) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// The split A fragment of two rows of a strided f32 matrix in device memory
// (row g of the tile at xa, row g + 8 at xb; null past T), columns c and
// c + 4, zero from column hd.
__device__ __forceinline__ void load_a_tf32(uint32_t (&ab)[4], uint32_t (&as)[4], const float* xa,
                                            const float* xb, int c, int hd) {
  split_tf32(xa && c < hd ? __ldg(xa + c) : 0.f, ab[0], as[0]);
  split_tf32(xb && c < hd ? __ldg(xb + c) : 0.f, ab[1], as[1]);
  split_tf32(xa && c + 4 < hd ? __ldg(xa + c + 4) : 0.f, ab[2], as[2]);
  split_tf32(xb && c + 4 < hd ? __ldg(xb + c + 4) : 0.f, ab[3], as[3]);
}

// acc[x][j] += X_x Y_x^T for the X (1 or 2) operand pairs x and the n-tiles
// j < NT (8 staged rows each), summed over the head dim's 8-column steps in
// 3xTF32: X_x the 16 rows of a warp in device memory (rows at xa[x], xb[x]:
// load_a_tf32), Y_x the rows y_s[x] + 8j + g (row stride rs, hd8 * 8
// columns).  Each step's products go in rounds over independent
// accumulators: all 2 NT at once for two pairs and NT <= 2, else the NT of
// one x at a time (half the B fragments live).  Every tile to NT is
// computed, those from nt re-reading tile 0 (their keys are masked out
// after); past the call's hd8 the A fragments are zero and the B fragments
// re-read step 0: no branch between the products, no uninitialised shared
// memory read.
template <int HD8, int NT, int X>
__device__ __forceinline__ void tf32_xyt(float (&acc)[X][NT][4], const float* const (&xa)[X],
                                         const float* const (&xb)[X], const float* const (&y_s)[X],
                                         int rs, int hd, int nt, int lane) {
  constexpr int NX = X == 2 && NT <= 2 ? 2 : 1;  // both x in one round
  const int g = lane >> 2, t = lane & 3, hd8 = (hd + 7) >> 3;
#pragma unroll 2  // a whole unrolled walk hoisted every step's loads and spilled
  for (int kk = 0; kk < HD8; ++kk) {
    const int c = 8 * kk + t, cy = 8 * (kk < hd8 ? kk : 0) + t;
#pragma unroll
    for (int x0 = 0; x0 < X; x0 += NX) {
      uint32_t ab[NX][4], as[NX][4], bb[NX][NT][2], bs[NX][NT][2];
#pragma unroll
      for (int u = 0; u < NX; ++u) {
        const int x = x0 + u;
        load_a_tf32(ab[u], as[u], xa[x], xb[x], c, hd);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* yr = y_s[x] + (8 * (j < nt ? j : 0) + g) * rs + cy;
          split_tf32(yr[0], bb[u][j][0], bs[u][j][0]);
          split_tf32(yr[4], bb[u][j][1], bs[u][j][1]);
        }
      }
#pragma unroll
      for (int u = 0; u < NX; ++u)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[x0 + u][j], ab[u], bs[u][j][0], bs[u][j][1]);
#pragma unroll
      for (int u = 0; u < NX; ++u)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[x0 + u][j], as[u], bb[u][j][0], bb[u][j][1]);
#pragma unroll
      for (int u = 0; u < NX; ++u)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[x0 + u][j], ab[u], bb[u][j][0], bb[u][j][1]);
    }
  }
}

// o[d] += C Y for the output tiles d < hd8 (8 columns each) in 3xTF32: C a
// 16 x 8 tile in the mma's C layout, which is the A tile as it stands (its
// columns 2t, 2t + 1 are the k indices t, t + 4; mma_tf32.cuh), Y the 8
// staged rows from y_s (row stride rs) in the same order: b[0] = row 2t,
// b[1] = row 2t + 1, column 8d + g.  In rounds of G independent tiles,
// every tile to HD8 (past hd8 they re-read tile 0 and are never stored).
template <int HD8>
__device__ __forceinline__ void tf32_cy(float (&o)[HD8][4], const float (&c)[4], const float* y_s,
                                        int rs, int hd8, int lane) {
  constexpr int G = HD8 < 8 ? HD8 : 8;
  const int g = lane >> 2, t = lane & 3;
  uint32_t ab[4], as[4];
  split_tf32(c[0], ab[0], as[0]);
  split_tf32(c[2], ab[1], as[1]);
  split_tf32(c[1], ab[2], as[2]);
  split_tf32(c[3], ab[3], as[3]);
  const float* yr = y_s + 2 * t * rs + g;
#pragma unroll
  for (int d0 = 0; d0 < HD8; d0 += G) {
    uint32_t bb[G][2], bs[G][2];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int d = d0 + u < hd8 ? d0 + u : 0;
      split_tf32(yr[8 * d], bb[u][0], bs[u][0]);
      split_tf32(yr[rs + 8 * d], bb[u][1], bs[u][1]);
    }
    mma_3xtf32<G>(o, d0, ab, as, bb, bs, G);
  }
}

// s[n] (16 x 8, n < HD8) += A^T B over rows [0, nrows) (a multiple of 8) of
// two staged f32 tiles (row stride rs) in 3xTF32: A^T's 16 rows are the
// columns c0 .. c0 + 15 of a_s (zero from column hdp; less shift_k *
// shift[c] where shift is given; zero on rows whose keep is 0 where keep is
// given), B the columns of b_s.  The row index runs in steps of 8, each
// step's rows 2t and 2t + 1 in both operands (the order the A tile reads
// them: mma_tf32.cuh); a step whose 8 rows are all kept out is skipped.
// Every n-tile to HD8 is computed (those past hdp re-read tile 0 and are
// never stored), so that no branch stands between the products.
template <int HD8>
__device__ __forceinline__ void tf32_atb(float (&s)[HD8][4], const float* a_s, const float* b_s,
                                         int rs, int nrows, int c0, int hdp, const float* keep,
                                         const float* shift, float shift_k, int lane) {
  constexpr int G = HD8 < 8 ? HD8 : 8;
  const int g = lane >> 2, t = lane & 3, hd8 = hdp >> 3;
  const int ca = c0 + g, cb = ca + 8;
  const float sa = shift && ca < hdp ? shift_k * shift[ca] : 0.f;
  const float sb = shift && cb < hdp ? shift_k * shift[cb] : 0.f;
#pragma unroll 2
  for (int r8 = 0; r8 < nrows; r8 += 8) {
    if (keep && !__any_sync(0xffffffffu, keep[r8 + (lane & 7)] != 0.f)) continue;
    const float* ar = a_s + (r8 + 2 * t) * rs;
    const float k0 = keep ? keep[r8 + 2 * t] : 1.f, k1 = keep ? keep[r8 + 2 * t + 1] : 1.f;
    uint32_t ab[4], as[4];
    split_tf32(ca < hdp ? (ar[ca] - sa) * k0 : 0.f, ab[0], as[0]);
    split_tf32(cb < hdp ? (ar[cb] - sb) * k0 : 0.f, ab[1], as[1]);
    split_tf32(ca < hdp ? (ar[rs + ca] - sa) * k1 : 0.f, ab[2], as[2]);
    split_tf32(cb < hdp ? (ar[rs + cb] - sb) * k1 : 0.f, ab[3], as[3]);
    const float* br = b_s + (r8 + 2 * t) * rs + g;
#pragma unroll
    for (int n0 = 0; n0 < HD8; n0 += G) {
      uint32_t bb[G][2], bs[G][2];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int n = n0 + u < hd8 ? n0 + u : 0;
        split_tf32(br[8 * n], bb[u][0], bs[u][0]);
        split_tf32(br[rs + 8 * n], bb[u][1], bs[u][1]);
      }
      mma_3xtf32<G>(s, n0, ab, as, bb, bs, G);
    }
  }
}

// Writes k * s (tf32_atb's slab of rows c0 .. c0 + 15) split into TF32 big
// and small parts, m_s and ms_s (row stride rs): [row][col] for each slab
// row and column below hdp, or with `transpose` [col][row].
template <int HD8>
__device__ __forceinline__ void store_slab(float* m_s, float* ms_s, int rs, const float (&s)[HD8][4],
                                           int c0, int hdp, float k, bool transpose, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < HD8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = c0 + g + 4 * (e & 2), col = 8 * n + 2 * t + (e & 1);
      if (row < hdp && col < hdp) {
        uint32_t big, small;
        split_tf32(k * s[n][e], big, small);
        const int i = transpose ? col * rs + row : row * rs + col;
        m_s[i] = __uint_as_float(big);
        ms_s[i] = __uint_as_float(small);
      }
    }
}

// o[n] (n < hd8) += X Y^T over the head dim in 3xTF32: X the 16 rows of a
// warp in device memory (rows at xa, xb; null rows zero), less shift[c] on
// each row where shift is given; Y the rows 8n + g of a staged tile already
// split (store_slab: big parts in y_s, small parts in ys_s; row stride rs).
// The next step's X values are loaded before this step's products; rounds
// of G tiles, every tile to HD8 (past hd8 they re-read tile 0 and are never
// stored).
template <int HD8>
__device__ __forceinline__ void tf32_xy(float (&o)[HD8][4], const float* xa, const float* xb,
                                        const float* shift, const float* y_s, const float* ys_s,
                                        int rs, int hd, int lane) {
  constexpr int G = HD8 < 8 ? HD8 : 8;
  const int g = lane >> 2, t = lane & 3, hd8 = (hd + 7) >> 3;
  // the X values of step kk (columns 8 kk + t, + 4 of rows g, g + 8)
  auto load = [&](int kk, float (&x)[4]) {
    const int c = 8 * kk + t;
    x[0] = xa && c < hd ? __ldg(xa + c) : 0.f;
    x[1] = xb && c < hd ? __ldg(xb + c) : 0.f;
    x[2] = xa && c + 4 < hd ? __ldg(xa + c + 4) : 0.f;
    x[3] = xb && c + 4 < hd ? __ldg(xb + c + 4) : 0.f;
  };
  float next[4];
  load(0, next);
#pragma unroll 1
  for (int kk = 0; kk < hd8; ++kk) {
    const int c = 8 * kk + t;
    float x[4] = {next[0], next[1], next[2], next[3]};
    if (kk + 1 < hd8) load(kk + 1, next);
    if (shift) {
      const float s0 = c < hd ? shift[c] : 0.f, s1 = c + 4 < hd ? shift[c + 4] : 0.f;
      x[0] = xa && c < hd ? x[0] - s0 : 0.f;
      x[1] = xb && c < hd ? x[1] - s0 : 0.f;
      x[2] = xa && c + 4 < hd ? x[2] - s1 : 0.f;
      x[3] = xb && c + 4 < hd ? x[3] - s1 : 0.f;
    }
    uint32_t ab[4], as[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[e], ab[e], as[e]);
    const int yr = g * rs + c;
#pragma unroll
    for (int n0 = 0; n0 < HD8; n0 += G) {
      uint32_t bb[G][2], bs[G][2];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int i = yr + 8 * (n0 + u < hd8 ? n0 + u : 0) * rs;
        bb[u][0] = __float_as_uint(y_s[i]);
        bb[u][1] = __float_as_uint(y_s[i + 4]);
        bs[u][0] = __float_as_uint(ys_s[i]);
        bs[u][1] = __float_as_uint(ys_s[i + 4]);
      }
      mma_3xtf32<G>(o, n0, ab, as, bb, bs, G);
    }
  }
}

// One step of a running max m, sum l of e = exp(s - m) and sum a of e dp
// over the NT tiles of s (scaled, masked with -1e30; -inf past the keys) for
// the rows of c[.][0..1] (x = 0) or c[.][2..3] (x = 2).  m is shared by the
// 4 lanes of a quad.
template <int NT>
__device__ __forceinline__ void online_tiles(const float (&s)[NT][4], const float (&dp)[NT][4],
                                             int x, float& m, float& l, float& a) {
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][x], s[j][x + 1]));
  const float n = fmaxf(m, quad_max(mx)), f = expf(m - n);
  l *= f;
  a *= f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = x; e < x + 2; ++e) {
      const float w = expf(s[j][e] - n);
      l += w;
      a += w * dp[j][e];
    }
  m = n;
}

// Writes a warp's 16 x hd f32 tile in the C layout (rows r0 + g, r0 + g + 8)
// through the strides of ov, rows below T only, and of those only row g
// with put0 and row g + 8 with put1.
template <int HD8>
__device__ __forceinline__ void store_c_f32(const float (&o)[HD8][4], const View& ov, int b, int h,
                                            int r0, int hd, int T_len, int lane, bool put0 = true,
                                            bool put1 = true) {
  const int g = lane >> 2, t = lane & 3;
  float* out = static_cast<float*>(const_cast<void*>(ov.p)) + b * ov.sb + h * ov.sh;
  const bool pairs = hd % 2 == 0 && ov.sl % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
#pragma unroll
  for (int d = 0; d < HD8; ++d) {
    const int col = 8 * d + 2 * t;
    if (col >= hd) continue;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int row = r0 + g + 4 * e;
      if (row >= T_len || !(e ? put1 : put0)) continue;
      float* dst = out + row * ov.sl + col;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(o[d][e], o[d][e + 1]);
      } else {
        dst[0] = o[d][e];
        if (col + 1 < hd) dst[1] = o[d][e + 1];
      }
    }
  }
}

// ---------------------------------------------------------- f32 dk/dv (#7)

// Shared memory of dkv_tf32: two planes of cap rows of rs floats (phase 1's
// K and V key chunks, then phase 2's Q and G row chunks), then as in
// dkv_mma the query window's m, l, row and padding flags (K_WIN each), the
// K2 slice's key validity, V summed over it and g over the padding rows
// (hdp each).
size_t dkv_tf32_bytes(int rs, int hdp, int k_win, int k2, int cap) {
  return ((size_t)2 * cap * rs + 4 * k_win + k2 + 2 * hdp) * sizeof(float);
}

// Kernel #7 in f32 on the tensor cores (3xTF32).  HD8 = the most 8-column
// steps of the head dim the body is built for (a bucket: 4, 8 or 16), the
// call's own read at run time; cap: rows of a staged chunk (a multiple of
// 16).  The A operands, private to a warp (phase 1's Q and G rows, phase
// 2's own K and V), are read from device memory step by step; the B
// operands, which neighbouring warps share, from the staged chunks.
template <int HD8>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
    dkv_tf32(View qv, View kv, View vv, const float* mask, View gv, View dkv, View dvv, Shape sh,
             int hd, int cap) {
  constexpr int HDP = 8 * HD8;
  extern __shared__ __align__(16) float tf_smem[];
  const int hd8 = (hd + 7) >> 3, hdp = 8 * hd8, rs = hdp + kTfRowPad;
  const int k2 = min(2 * sh.k_win - kTile, sh.T_pad);
  float* x_s = tf_smem;        // (cap, rs): K, then Q
  float* y_s = x_s + cap * rs;  // (cap, rs): V, then G
  float* m_s = y_s + cap * rs;
  float* l_s = m_s + sh.k_win;
  float* row_s = l_s + sh.k_win;
  float* pad_s = row_s + sh.k_win;
  float* okk_s = pad_s + sh.k_win;
  float* cs_s = okk_s + k2;
  float* gp_s = cs_s + HDP;  // (HDP,) g summed over the window's padding rows
  float* part_s = x_s;       // slice_colsum's, between the phases

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int k0 = tile * kTile, start = slice_start(k0, sh);
  const int n_start = max(0, min(start - (sh.k_win - kTile) / 2, sh.T_pad - k2));
  // the query union: the spans of the first and last 16 own keys, rows below T
  const int qu0 = warp_key_span(k0, sh).x;
  const int qu1 = min(warp_key_span(k0 + kTile - 16, sh).y, (sh.T + 15) / 16 * 16);
  const float* q = at<float>(qv, b, h);
  const float* k = at<float>(kv, b, h);
  const float* v = at<float>(vv, b, h);
  const float* gr = at<float>(gv, b, h);
  const float* m = mask + (long long)b * sh.T;
  const int tid = threadIdx.x, nthr = blockDim.x;
  auto row_at = [&](const float* x, long long sl, int r) { return r < sh.T ? x + r * sl : nullptr; };
  // rows [c0, c1) of x and y into x_s and y_s, zero past T
  auto stage_pair = [&](const float* x, long long x_sl, const float* y, long long y_sl, int c0,
                        int c1) {
    const int rows = max(0, min(c1, sh.T) - c0);
    __syncthreads();
    stage_f32(x_s, rs, x + c0 * x_sl, x_sl, rows, c1 - c0, hd, hdp, tid, nthr);
    stage_f32(y_s, rs, y + c0 * y_sl, y_sl, rows, c1 - c0, hd, hdp, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
  };

  stage_valid(m, n_start, k2, sh.T, okk_s);
  __syncthreads();
  const bool any_pad = mark_padding_rows(start, sh.k_win, okk_s, n_start, k2, sh, pad_s);

  // phase 1: each union row's m, l and row over its key span, 128 rows a
  // pass, up to kTfChunk keys of a warp's span a step
  for (int p0 = qu0; p0 < qu1; p0 += kTile) {
    const int p1 = min(p0 + kTile, qu1), r0 = p0 + 16 * warp;
    // a warp takes 16 rows of the pass that are not all padding rows
    const bool active = r0 < p1 &&
                        __any_sync(0xffffffffu, lane < 16 && pad_s[r0 - start + lane] == 0.f);
    if (!__syncthreads_or(active)) continue;  // every row of the pass a padding row
    const int2 span = warp_key_span(r0, sh);
    const float* const xa[2] = {row_at(q, qv.sl, r0 + g), row_at(gr, gv.sl, r0 + g)};
    const float* const xb[2] = {row_at(q, qv.sl, r0 + g + 8), row_at(gr, gv.sl, r0 + g + 8)};
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;
    const int kl = warp_key_span(p0, sh).x, kh = warp_key_span(p1 - 16, sh).y;
    for (int c0 = kl; c0 < kh; c0 += cap) {
      const int c1 = min(c0 + cap, kh), e1 = min(c1, span.y);
      stage_pair(k, kv.sl, v, vv.sl, c0, c1);
      if (!active) continue;
      for (int j0 = max(c0, span.x); j0 < e1; j0 += kTfChunk) {
        const int nk = min(kTfChunk, e1 - j0);
        float acc[2][kTfChunk / 8][4] = {};  // S = Q K^T, dP = G V^T
        const float* const ys[2] = {x_s + (j0 - c0) * rs, y_s + (j0 - c0) * rs};
        tf32_xyt<HD8, kTfChunk / 8>(acc, xa, xb, ys, rs, hd, nk >> 3, lane);
#pragma unroll
        for (int j = 0; j < kTfChunk / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1), key = j0 + col, row = r0 + g + 4 * (e & 2);
            acc[0][j][e] = col >= nk ? -CUDART_INF_F
                           : okk_s[key - n_start] > 0.f && abs(row - key) <= sh.half
                               ? acc[0][j][e] * sh.scale
                               : kMask;
          }
        online_tiles<kTfChunk / 8>(acc[0], acc[1], 0, m0, l0, a0);
        online_tiles<kTfChunk / 8>(acc[0], acc[1], 2, m1, l1, a1);
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

  // the warp's 16 own keys
  const int kw0 = k0 + 16 * warp;
  const int2 qspan = warp_key_span(kw0, sh);
  const float* const ka[2] = {row_at(k, kv.sl, kw0 + g), row_at(v, vv.sl, kw0 + g)};
  const float* const kb[2] = {row_at(k, kv.sl, kw0 + g + 8), row_at(v, vv.sl, kw0 + g + 8)};
  const float key_ok0 = okk_s[kw0 + g - n_start], key_ok1 = okk_s[kw0 + g + 8 - n_start];
  const float inv_k2 = 1.f / k2;

  // padding rows (p = 1/K2 on every own key, row = g . cs / K2 with cs the
  // V summed over the K2 slice): their ds^T q on a key is (scale / K2)
  // M (v - cs / K2) with M = sum over the window's padding rows of q g^T,
  // one hd x hd matrix, a 16-row slab a warp; their dv terms, g / K2 on
  // every own key, one sum of g
  __syncthreads();
  if (any_pad) {
    slice_colsum<float, HDP>(v, vv.sl, n_start, min(n_start + k2, sh.T), hd, part_s, cs_s);
    slice_colsum<float, HDP>(gr, gv.sl, start, min(start + sh.k_win, sh.T), hd, part_s, gp_s,
                             pad_s);
    const bool slab = 16 * warp < hdp;
    float m_acc[HD8][4];
#pragma unroll
    for (int d = 0; d < HD8; ++d) m_acc[d][0] = m_acc[d][1] = m_acc[d][2] = m_acc[d][3] = 0.f;
    const int pw1 = min(start + sh.k_win, (sh.T + 15) / 16 * 16);
    for (int c0 = start; c0 < pw1; c0 += cap) {
      const int c1 = min(c0 + cap, pw1);
      bool need = false;
      for (int i = c0; !need && i < c1; ++i) need = pad_s[i - start] != 0.f;
      if (!need) continue;  // the same answer in every thread
      stage_pair(q, qv.sl, gr, gv.sl, c0, c1);
      if (slab)
        tf32_atb<HD8>(m_acc, x_s, y_s, rs, c1 - c0, 16 * warp, hdp, pad_s + c0 - start, nullptr,
                      0.f, lane);
    }
    __syncthreads();
    if (slab)
      store_slab<HD8>(x_s, y_s, rs, m_acc, 16 * warp, hdp, sh.scale / k2, false, lane);
    for (int c = tid; c < HDP; c += nthr) cs_s[c] *= inv_k2;
    __syncthreads();
  }
  float dk[HD8][4], dv[HD8][4];
#pragma unroll
  for (int d = 0; d < HD8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  if (any_pad) tf32_xy<HD8>(dk, ka[1], kb[1], cs_s, x_s, y_s, rs, hd, lane);

  // phase 2: the warp's 16 own keys against the rows of the union, 16 rows
  // a step over its span: S^T = K Q^T and dP^T = V G^T, then dv += p^T G and
  // dk += ds^T Q with p and ds in their C layout as the A tiles
  for (int c0 = qu0; c0 < qu1; c0 += cap) {
    const int c1 = min(c0 + cap, qu1);
    bool need = false;  // a row below T that is not a padding row
    for (int i = c0; !need && i < min(c1, sh.T); ++i) need = pad_s[i - start] == 0.f;
    if (!need) continue;  // the same answer in every thread
    stage_pair(q, qv.sl, gr, gv.sl, c0, c1);
    for (int r0 = max(c0, qspan.x); r0 < min(c1, qspan.y); r0 += 16) {
      float acc[2][2][4] = {};  // S^T, dP^T; then p, ds
      const float* const ys[2] = {x_s + (r0 - c0) * rs, y_s + (r0 - c0) * rs};
      tf32_xyt<HD8, 2>(acc, ka, kb, ys, rs, hd, 2, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw0 + g + 4 * (e & 2), row = r0 + 8 * j + 2 * t + (e & 1);
          const int wi = row - start;
          float pe = 0.f, de = 0.f;
          if (row < sh.T && pad_s[wi] == 0.f && (e & 2 ? key_ok1 : key_ok0) > 0.f &&
              abs(row - key) <= sh.half) {
            pe = expf(acc[0][j][e] * sh.scale - m_s[wi]) / l_s[wi];
            de = pe * (acc[1][j][e] - row_s[wi]) * sh.scale;
          }
          acc[0][j][e] = pe;
          acc[1][j][e] = de;
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tf32_cy<HD8>(dv, acc[0][j], y_s + (r0 - c0 + 8 * j) * rs, rs, hd8, lane);
        tf32_cy<HD8>(dk, acc[1][j], x_s + (r0 - c0 + 8 * j) * rs, rs, hd8, lane);
      }
    }
  }
  if (any_pad) {
#pragma unroll
    for (int d = 0; d < HD8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[d][e] += inv_k2 * gp_s[8 * d + 2 * t + (e & 1)];
  }
  store_c_f32<HD8>(dk, dkv, b, h, kw0, hd, sh.T, lane);
  store_c_f32<HD8>(dv, dvv, b, h, kw0, hd, sh.T, lane);
}

// ------------------------------------------------------------- f32 dq (#6)

// Shared memory of dq_tf32 and banded_tf32: two planes of cap rows of rs
// floats (the K and V of a key chunk; first dq's padding rows' hd x hd
// matrix, or the forward's slice_colsum partial sums), then the slice's key
// validity (K_WIN), the tile's padding flags (128) and V summed over the
// slice (hdp).
size_t tf32_tile_bytes(int rs, int hdp, int k_win, int cap) {
  return ((size_t)2 * cap * rs + k_win + kTile + hdp) * sizeof(float);
}

// Kernel #6 in f32 on the tensor cores (3xTF32).  HD8 as in dkv_tf32; cap:
// keys of a staged chunk (a multiple of 16).  ONE: every warp's span is at
// most kTfChunk keys and the key union is staged whole, so walk 1's scores
// and dp stay in registers for ds (one walk).  The warp's Q and G rows (A operands) are read from device memory
// step by step; K and V (B operands) from the staged chunk.
template <int HD8, bool ONE>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
    dq_tf32(View qv, View kv, View vv, const float* mask, View gv, View dqv, Shape sh, int hd,
            int cap) {
  constexpr int HDP = 8 * HD8;
  extern __shared__ __align__(16) float tf_smem[];
  const int hd8 = (hd + 7) >> 3, hdp = 8 * hd8, rs = hdp + kTfRowPad;
  float* x_s = tf_smem;         // (cap, rs): K
  float* y_s = x_s + cap * rs;  // (cap, rs): V
  float* ok_s = y_s + cap * rs;
  float* pad_s = ok_s + sh.k_win;
  float* cs_s = pad_s + kTile;
  float* part_s = x_s;  // slice_colsum's, before the walks

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int q0 = tile * kTile, r0 = q0 + 16 * warp, ra = r0 + g, rb = ra + 8;
  const int start = slice_start(q0, sh);
  const int u0 = warp_key_span(q0, sh).x, u1 = warp_key_span(q0 + kTile - 16, sh).y;
  const int2 span = warp_key_span(r0, sh);
  const float* q = at<float>(qv, b, h);
  const float* k = at<float>(kv, b, h);
  const float* v = at<float>(vv, b, h);
  const float* gr = at<float>(gv, b, h);
  const float* m = mask + (long long)b * sh.T;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const float* const xa[2] = {ra < sh.T ? q + ra * qv.sl : nullptr,
                              ra < sh.T ? gr + ra * gv.sl : nullptr};
  const float* const xb[2] = {rb < sh.T ? q + rb * qv.sl : nullptr,
                              rb < sh.T ? gr + rb * gv.sl : nullptr};

  // the slice's key validity; padding rows
  stage_valid(m, start, sh.k_win, sh.T, ok_s);
  __syncthreads();
  const bool any_pad = mark_padding_rows(q0, kTile, ok_s, start, sh.k_win, sh, pad_s);
  const bool pad0 = pad_s[16 * warp + g] != 0.f, pad1 = pad_s[16 * warp + g + 8] != 0.f;
  const bool warp_pad = __any_sync(0xffffffffu, pad0 || pad1);

  // K and V of keys [c0, c1) into x_s and y_s, zero past T
  auto stage_kv = [&](int c0, int c1) {
    const int rows = max(0, min(c1, sh.T) - c0);
    __syncthreads();
    stage_f32(x_s, rs, k + c0 * kv.sl, kv.sl, rows, c1 - c0, hd, hdp, tid, nthr);
    stage_f32(y_s, rs, v + c0 * vv.sl, vv.sl, rows, c1 - c0, hd, hdp, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
  };
  // the warp's masked, scaled scores (acc[0]) and dp (acc[1]) of the nk
  // keys from j0 (a chunk staged from c0), NT 8-key tiles at most
  auto products = [&](auto& acc, int j0, int c0, int nk) {
    constexpr int NT = sizeof(acc[0]) / sizeof(acc[0][0]);
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[x][j][0] = acc[x][j][1] = acc[x][j][2] = acc[x][j][3] = 0.f;
    const float* const ys[2] = {x_s + (j0 - c0) * rs, y_s + (j0 - c0) * rs};
    tf32_xyt<HD8, NT>(acc, xa, xb, ys, rs, hd, nk >> 3, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), key = j0 + col, row = e & 2 ? rb : ra;
        acc[0][j][e] = col >= nk ? -CUDART_INF_F
                       : ok_s[key - start] > 0.f && abs(row - key) <= sh.half
                           ? acc[0][j][e] * sh.scale
                           : kMask;
      }
  };

  // padding rows first (p = 1/K_WIN on every key of the slice, row = g .
  // cs / K_WIN with cs the V summed over the slice): their dq is (scale /
  // K_WIN) g N with N = sum over the slice's keys of (v - cs / K_WIN) k^T,
  // one hd x hd matrix, a 16-row slab a warp; written here, as the walks
  // below give them nothing
  if (any_pad) {
    slice_colsum<float, HDP>(v, vv.sl, start, min(start + sh.k_win, sh.T), hd, part_s, cs_s);
    const bool slab = 16 * warp < hdp;
    float n_acc[HD8][4];
#pragma unroll
    for (int d = 0; d < HD8; ++d) n_acc[d][0] = n_acc[d][1] = n_acc[d][2] = n_acc[d][3] = 0.f;
    for (int c0 = start; c0 < start + sh.k_win; c0 += cap) {
      const int c1 = min(c0 + cap, start + sh.k_win);
      stage_kv(c0, c1);
      if (slab)
        tf32_atb<HD8>(n_acc, y_s, x_s, rs, c1 - c0, 16 * warp, hdp, nullptr, cs_s,
                      1.f / sh.k_win, lane);
    }
    __syncthreads();
    if (slab)
      store_slab<HD8>(x_s, y_s, rs, n_acc, 16 * warp, hdp, sh.scale / sh.k_win, true, lane);
    __syncthreads();
    if (warp_pad) {
      float o[HD8][4];
#pragma unroll
      for (int d = 0; d < HD8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
      tf32_xy<HD8>(o, pad0 ? xa[1] : nullptr, pad1 ? xb[1] : nullptr, nullptr, x_s, y_s, rs, hd,
                   lane);
      store_c_f32<HD8>(o, dqv, b, h, r0, hd, sh.T, lane, pad0, pad1);
    }
  }

  // walk 1: m, l and sum(e dp) of rows ra and rb over the warp's span (a
  // warp of padding rows only has none to take)
  const bool stats = __any_sync(0xffffffffu, !pad0 || !pad1);
  const bool any_stats = __syncthreads_or(stats);  // else no walk has work
  float acc[2][kTfChunk / 8][4];  // S, dP; then ds in acc[1]
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;
  for (int c0 = u0; any_stats && c0 < u1; c0 += cap) {
    const int c1 = min(c0 + cap, u1), e1 = min(c1, span.y);
    stage_kv(c0, c1);
    for (int j0 = max(c0, span.x); stats && j0 < e1; j0 += kTfChunk) {
      products(acc, j0, c0, min(kTfChunk, e1 - j0));
      online_tiles<kTfChunk / 8>(acc[0], acc[1], 0, m0, l0, a0);
      online_tiles<kTfChunk / 8>(acc[0], acc[1], 2, m1, l1, a1);
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float row0 = quad_sum(a0) / l0, row1 = quad_sum(a1) / l1;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float o[HD8][4];
#pragma unroll
  for (int d = 0; d < HD8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  // the other rows: ds = p (dp - row) scale in acc[1], then dq += ds K with
  // ds in its C layout as the A tiles
  auto accumulate = [&](auto& acc, int j0, int c0, int nk) {
    constexpr int NT = sizeof(acc[0]) / sizeof(acc[0][0]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool second = e & 2;
        const float p = expf(acc[0][j][e] - (second ? m1 : m0)) * (second ? inv1 : inv0);
        acc[1][j][e] = (second ? pad1 : pad0)
                           ? 0.f
                           : p * (acc[1][j][e] - (second ? row1 : row0)) * sh.scale;
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (8 * j < nk) tf32_cy<HD8>(o, acc[1][j], x_s + (j0 - c0 + 8 * j) * rs, rs, hd8, lane);
  };
  if (ONE) {
    // walk 1 took the span in one step from the resident union: its scores
    // and dp are still in acc
    if (stats) accumulate(acc, span.x, u0, span.y - span.x);
  } else {
    // walk 2 over the span in steps of half as many keys (dq's accumulators
    // are live now), the scores recomputed; a union staged whole in walk 1
    // stays
    const bool resident = u1 - u0 <= cap;
    float acc2[2][kTfChunk / 16][4];
    for (int c0 = u0; any_stats && c0 < u1; c0 += cap) {
      const int c1 = min(c0 + cap, u1), e1 = min(c1, span.y);
      if (!resident) stage_kv(c0, c1);
      for (int j0 = max(c0, span.x); stats && j0 < e1; j0 += kTfChunk / 2) {
        const int nk = min(kTfChunk / 2, e1 - j0);
        products(acc2, j0, c0, nk);
        accumulate(acc2, j0, c0, nk);
      }
    }
  }
  store_c_f32<HD8>(o, dqv, b, h, r0, hd, sh.T, lane, !pad0, !pad1);
}

// ------------------------------------------------------------ f32 forward (#5)

// Kernel #5 in f32 on the tensor cores (3xTF32).  HD8 as in dkv_tf32; cap:
// keys of a staged chunk (a multiple of 16).  The warp's Q rows (A operand)
// are read from device memory step by step; K and V (B operands) from the
// staged chunk.
template <int HD8>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
    banded_tf32(View qv, View kv, View vv, const float* mask, View ov, Shape sh, int hd, int cap) {
  constexpr int HDP = 8 * HD8, NT = kTfChunk / 8;
  extern __shared__ __align__(16) float tf_smem[];
  const int hd8 = (hd + 7) >> 3, hdp = 8 * hd8, rs = hdp + kTfRowPad;
  float* k_s = tf_smem;              // (cap, rs): K
  float* v_s = k_s + cap * rs;       // (cap, rs): V
  float* ok_s = v_s + cap * rs;      // (K_WIN,)
  float* pad_s = ok_s + sh.k_win;    // (128,)
  float* cs_s = pad_s + kTile;       // (HDP,)
  float* part_s = k_s;               // slice_colsum's, before the walk

  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, r0 = q0 + 16 * warp, ra = r0 + g, rb = ra + 8;
  const int start = slice_start(q0, sh);
  const int u0 = warp_key_span(q0, sh).x, u1 = warp_key_span(q0 + kTile - 16, sh).y;
  const int2 span = warp_key_span(r0, sh);
  const float* q = at<float>(qv, b, h);
  const float* k = at<float>(kv, b, h);
  const float* v = at<float>(vv, b, h);
  const float* m = mask + (long long)b * sh.T;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const float* const xa[1] = {ra < sh.T ? q + ra * qv.sl : nullptr};
  const float* const xb[1] = {rb < sh.T ? q + rb * qv.sl : nullptr};

  // the slice's key validity; padding rows, whose output is V summed over
  // the slice over K_WIN
  stage_valid(m, start, sh.k_win, sh.T, ok_s);
  __syncthreads();
  if (mark_padding_rows(q0, kTile, ok_s, start, sh.k_win, sh, pad_s))
    slice_colsum<float, HDP>(v, vv.sl, start, min(start + sh.k_win, sh.T), hd, part_s, cs_s);
  const bool pad0 = pad_s[16 * warp + g] != 0.f, pad1 = pad_s[16 * warp + g + 8] != 0.f;
  // the walk serves rows below T that are not padding rows
  const bool walk = __any_sync(0xffffffffu, (ra < sh.T && !pad0) || (rb < sh.T && !pad1));
  const bool any_walk = __syncthreads_or(walk);

  // one walk over the warp's span, kTfChunk keys a step: S = Q K^T, the
  // running max and sum, O rescaled, then O += P V with p in its C layout as
  // the A tiles
  float o[HD8][4], s[1][NT][4];
#pragma unroll
  for (int d = 0; d < HD8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  for (int c0 = u0; any_walk && c0 < u1; c0 += cap) {
    const int c1 = min(c0 + cap, u1), e1 = min(c1, span.y);
    const int rows = max(0, min(c1, sh.T) - c0);
    __syncthreads();
    stage_f32(k_s, rs, k + c0 * kv.sl, kv.sl, rows, c1 - c0, hd, hdp, tid, nthr);
    stage_f32(v_s, rs, v + c0 * vv.sl, vv.sl, rows, c1 - c0, hd, hdp, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
    for (int j0 = max(c0, span.x); walk && j0 < e1; j0 += kTfChunk) {
      const int nk = min(kTfChunk, e1 - j0);
#pragma unroll
      for (int j = 0; j < NT; ++j) s[0][j][0] = s[0][j][1] = s[0][j][2] = s[0][j][3] = 0.f;
      const float* const ys[1] = {k_s + (j0 - c0) * rs};
      tf32_xyt<HD8, NT>(s, xa, xb, ys, rs, hd, nk >> 3, lane);
      // scaled; -1e30 outside the band or on an invalid key, -inf past nk
      float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1), key = j0 + col, row = e & 2 ? rb : ra;
          s[0][j][e] = col >= nk ? -CUDART_INF_F
                       : ok_s[key - start] > 0.f && abs(row - key) <= sh.half
                           ? s[0][j][e] * sh.scale
                           : kMask;
          if (e & 2)
            x1 = fmaxf(x1, s[0][j][e]);
          else
            x0 = fmaxf(x0, s[0][j][e]);
        }
      const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
      const float f0 = expf(m0 - n0), f1 = expf(m1 - n1);
      l0 *= f0;
      l1 *= f1;
#pragma unroll
      for (int d = 0; d < HD8; ++d) {
        o[d][0] *= f0;
        o[d][1] *= f0;
        o[d][2] *= f1;
        o[d][3] *= f1;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[0][j][e] - (e & 2 ? n1 : n0));
          s[0][j][e] = p;
          if (e & 2)
            l1 += p;
          else
            l0 += p;
        }
      m0 = n0;
      m1 = n1;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (8 * j < nk) tf32_cy<HD8>(o, s[0][j], v_s + (j0 - c0 + 8 * j) * rs, rs, hd8, lane);
    }
  }

  // out: O / l, or on a padding row (V summed over the slice) / K_WIN
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1), pad_p = 1.f / sh.k_win;
#pragma unroll
  for (int d = 0; d < HD8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool second = e & 2;
      o[d][e] = (second ? pad1 : pad0) ? pad_p * cs_s[8 * d + 2 * t + (e & 1)]
                                       : o[d][e] * (second ? inv1 : inv0);
    }
  store_c_f32<HD8>(o, ov, b, h, r0, hd, sh.T, lane);
}

// ------------------------------------------------------------------- launch

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

template <int HD8>
int launch_dq_tf32(View q, View k, View v, const void* mask, View g, View dq, int B, int hd,
                   Shape sh, cudaStream_t stream) {
  // chunks of up to the key union (160 keys at window 19), which one chunk
  // holds at every head dim up to 128 for windows up to 65; one walk where
  // every warp's span is one step of kTfChunk keys
  const int rs = 8 * ((hd + 7) / 8) + kTfRowPad, reach = (sh.half + 15) / 16 * 16;
  const int need = min(sh.k_win, kTile + 2 * reach), span = 16 + 2 * reach;
  const int fixed = (int)tf32_tile_bytes(rs, 8 * HD8, sh.k_win, 0);
  const int cap = min(need, (kMaxSharedBytes - fixed) / (2 * rs * (int)sizeof(float)) / 16 * 16);
  const size_t bytes = tf32_tile_bytes(rs, 8 * HD8, sh.k_win, cap);
  const dim3 grid(sh.T_pad / kTile, B * sh.H);
  const float* m = static_cast<const float*>(mask);
  if (need <= cap && span <= kTfChunk) {
    if (int err = prepare(dq_tf32<HD8, true>, bytes)) return err;
    dq_tf32<HD8, true><<<grid, kMmaWarps * 32, bytes, stream>>>(q, k, v, m, g, dq, sh, hd, cap);
  } else {
    if (int err = prepare(dq_tf32<HD8, false>, bytes)) return err;
    dq_tf32<HD8, false><<<grid, kMmaWarps * 32, bytes, stream>>>(q, k, v, m, g, dq, sh, hd, cap);
  }
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

template <int HD8>
int launch_dkv_tf32(View q, View k, View v, const void* mask, View g, View dk, View dv, int B,
                    int hd, Shape sh, cudaStream_t stream) {
  // chunks of up to the query union's rows (160 at window 19), which one
  // chunk holds at every head dim up to 128 for windows up to 65
  const int k2 = min(2 * sh.k_win - kTile, sh.T_pad);
  const int rs = 8 * ((hd + 7) / 8) + kTfRowPad, reach = (sh.half + 15) / 16 * 16;
  const int need = min(sh.k_win, kTile + 2 * reach);
  const int fixed = (int)dkv_tf32_bytes(rs, 8 * HD8, sh.k_win, k2, 0);
  const int cap = min(need, (kMaxSharedBytes - fixed) / (2 * rs * (int)sizeof(float)) / 16 * 16);
  const size_t bytes = dkv_tf32_bytes(rs, 8 * HD8, sh.k_win, k2, cap);
  if (int err = prepare(dkv_tf32<HD8>, bytes)) return err;
  dkv_tf32<HD8><<<dim3(sh.T_pad / kTile, B * sh.H), kMmaWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const float*>(mask), g, dk, dv, sh, hd, cap);
  return (int)cudaGetLastError();
}

template <int HD8>
int launch_banded_tf32(View q, View k, View v, const void* mask, View o, int B, int hd, Shape sh,
                       cudaStream_t stream) {
  // chunks of up to the key union (160 keys at window 19), which one chunk
  // holds at every head dim up to 128 for windows up to 65
  const int rs = 8 * ((hd + 7) / 8) + kTfRowPad, reach = (sh.half + 15) / 16 * 16;
  const int need = min(sh.k_win, kTile + 2 * reach);
  const int fixed = (int)tf32_tile_bytes(rs, 8 * HD8, sh.k_win, 0);
  const int cap = min(need, (kMaxSharedBytes - fixed) / (2 * rs * (int)sizeof(float)) / 16 * 16);
  const size_t bytes = tf32_tile_bytes(rs, 8 * HD8, sh.k_win, cap);
  if (int err = prepare(banded_tf32<HD8>, bytes)) return err;
  banded_tf32<HD8><<<dim3(sh.T_pad / kTile, B * sh.H), kMmaWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const float*>(mask), o, sh, hd, cap);
  return (int)cudaGetLastError();
}

int launch_forward(int dtype, View q, View k, View v, const void* mask, View o, int B, int hd,
                   Shape sh, cudaStream_t stream) {
  if (dtype == 0) {
    switch ((hd + 31) / 32) {
      case 1: return launch_banded_tf32<4>(q, k, v, mask, o, B, hd, sh, stream);
      case 2: return launch_banded_tf32<8>(q, k, v, mask, o, B, hd, sh, stream);
      case 3:
      case 4: return launch_banded_tf32<16>(q, k, v, mask, o, B, hd, sh, stream);
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

int launch_dq(int dtype, View q, View k, View v, const void* mask, View g, View dq, int B, int hd,
              Shape sh, cudaStream_t s) {
  if (dtype == 0) {
    switch ((hd + 31) / 32) {
      case 1: return launch_dq_tf32<4>(q, k, v, mask, g, dq, B, hd, sh, s);
      case 2: return launch_dq_tf32<8>(q, k, v, mask, g, dq, B, hd, sh, s);
      case 3:
      case 4: return launch_dq_tf32<16>(q, k, v, mask, g, dq, B, hd, sh, s);
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
      case 1: return launch_dkv_tf32<4>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
      case 2: return launch_dkv_tf32<8>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
      case 3:
      case 4: return launch_dkv_tf32<16>(q, k, v, mask, g, dk, dv, B, hd, sh, s);
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
