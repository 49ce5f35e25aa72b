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
// (kv_mask > 0), times V.  Like the TPU kernel, each 128-row query tile works
// on one K_WIN slice of the keys,
//
//   K_WIN = 128 + 2 * ceil(half / 128) * 128          (384 for window 19)
//   start = clip(128 * floor(i / 128) - (K_WIN - 128) / 2, 0, T_pad - K_WIN)
//
// with T_pad the length rounded up to 128, and walks the whole slice with
// every score outside the band or on an invalid key REPLACED by -1e30.  So a
// row with no valid key in its band (a padding row) comes out as the uniform
// average of V over its slice, as on the TPU; positions T..T_pad-1 are zero
// keys and values with mask 0, which is what the TPU wrapper's zero padding
// gives, but nothing is padded in memory: loads are bound-checked.
//
// Numerics: scores q.k * 1/sqrt(hd) in f32, a stable softmax in f32,
// p = e / sum rounded to the input type before the value product (as the TPU
// kernel casts p to v's type), f32 accumulation, output in the input type.
// To round the normalised p exactly there, the kernel makes two passes over
// the slice: the first keeps an online (running) maximum and sum per row,
// the second recomputes the scores and accumulates p v.
//
// What bounds it on an H100: at the long config (T up to 2304, hd 128,
// window 19) the band needs 2*2*T*19*hd FLOPs per (batch, head) and reads q,
// k, v once, so the least time is set by bytes (~22 us at T = 2304, batch 8,
// 4 heads, bf16).  This first version is simple and far from that: it walks
// all K_WIN = 384 keys of the slice, though only ~146 of them can fall in the
// band of a tile, computes the scores twice, and runs on the CUDA cores in
// f32.  Design: one block of 16 warps per (batch*head, 128-row query tile);
// the Q tile sits in shared memory in f32; 32-key chunks of K (rows padded to
// hd+1 floats, so the 32 lanes read 32 keys without bank conflicts) and V are
// staged in shared memory; each warp owns 8 query rows and each lane one key
// of the chunk for the scores, then 4 (hd/32) output columns of each row for
// the value product.  Shared memory is ~113 KB at hd 128, so one block
// (16 warps) runs on each SM.  Next steps: skip the chunks outside the band
// (keeping the padding-row result), tensor cores (mma / wgmma) for both
// products.
//
// Layout: q, k, v are (B, H, T, hd) through their strides (unit stride on
// hd), so head-split views of (B, T, C) projections are read in place; the
// output is written through strides too, (B, T, H, hd) in memory from the
// Python wrapper, so the head merge is free.  kv_mask is (B, T) in the input
// type, read at b = bh / H.
//
// Interface: plain C, loaded with ctypes; returns cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMask = -1e30f;
constexpr int kTile = 128;                          // query rows per block (the TPU tile)
constexpr int kChunk = 32;                          // keys per staged chunk, one per lane
constexpr int kWarps = 16;
constexpr int kRows = kTile / kWarps;               // query rows per warp

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

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)kTile * HD            // Q tile
         + (size_t)kChunk * (HD + 1)   // K chunk, padded rows
         + (size_t)kChunk * HD         // V chunk
         + (size_t)kWarps * kRows * kChunk  // p of each warp's rows
         + 2 * (size_t)kTile           // row max and sum
         + kChunk;                     // key validity of the chunk
}

// Stage keys [c0, c0 + kChunk) of the slice: K (and V) in f32, zero past T,
// and each key's validity (inside T and kv_mask > 0).
template <typename T, int HD>
__device__ __forceinline__ void stage_chunk(const T* k, long long k_sl, const T* v, long long v_sl,
                                            const T* mask, int j0, int T_len, bool with_v,
                                            float* k_s, float* v_s, float* ok_s) {
  for (int idx = threadIdx.x; idx < kChunk * HD; idx += blockDim.x) {
    const int jj = idx / HD, d = idx % HD, j = j0 + jj;
    const bool in = j < T_len;
    k_s[jj * (HD + 1) + d] = in ? to_f(k[j * k_sl + d]) : 0.f;
    if (with_v) v_s[jj * HD + d] = in ? to_f(v[j * v_sl + d]) : 0.f;
  }
  if (threadIdx.x < kChunk) {
    const int j = j0 + threadIdx.x;
    ok_s[threadIdx.x] = (j < T_len && to_f(mask[j]) > 0.f) ? 1.f : 0.f;
  }
}

// The lane's key (j = j0 + lane) against the warp's kRows query rows:
// s[r] = q_r . k_j * scale inside the band on a valid key, else -1e30.
template <int HD>
__device__ __forceinline__ void chunk_scores(const float* q_s, const float* k_s, const float* ok_s,
                                             int row0, int i0, int j0, const Shape& sh,
                                             float (&s)[kRows]) {
  const int lane = threadIdx.x & 31;
  const float* krow = k_s + lane * (HD + 1);
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2], k3 = krow[d + 3];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 q4 = *reinterpret_cast<const float4*>(q_s + (row0 + r) * HD + d);
      s[r] = fmaf(q4.x, k0, s[r]);
      s[r] = fmaf(q4.y, k1, s[r]);
      s[r] = fmaf(q4.z, k2, s[r]);
      s[r] = fmaf(q4.w, k3, s[r]);
    }
  }
  const int j = j0 + lane;
  const bool key_ok = ok_s[lane] > 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    const bool ok = key_ok && abs(i - j) <= sh.half;
    s[r] = ok ? s[r] * sh.scale : kMask;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
banded_kernel(View qv, View kv, View vv, const T* mask, View ov, Shape sh) {
  constexpr int kDL = HD / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * HD;
  float* v_s = k_s + kChunk * (HD + 1);
  float* p_s = v_s + kChunk * HD;
  float* m_s = p_s + kWarps * kRows * kChunk;
  float* l_s = m_s + kTile;
  float* ok_s = l_s + kTile;

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = tile * kTile;
  const int start = max(0, min(q0 - (sh.k_win - kTile) / 2, sh.T_pad - sh.k_win));
  const int row0 = warp * kRows;  // the warp's first row in the tile
  const int i0 = q0 + row0;       // ... and in the sequence

  const T* q = static_cast<const T*>(qv.p) + b * qv.sb + h * qv.sh;
  const T* k = static_cast<const T*>(kv.p) + b * kv.sb + h * kv.sh;
  const T* v = static_cast<const T*>(vv.p) + b * vv.sb + h * vv.sh;
  const T* m = mask + (long long)b * sh.T;

  for (int idx = threadIdx.x; idx < kTile * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD, i = q0 + r;
    q_s[idx] = i < sh.T ? to_f(q[i * qv.sl + d]) : 0.f;
  }

  // pass 1: each lane's running max and sum over its keys, then merged
  float mx[kRows], sum[kRows], s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    mx[r] = kMask;
    sum[r] = 0.f;
  }
  for (int c = 0; c < sh.k_win; c += kChunk) {
    __syncthreads();
    stage_chunk<T, HD>(k, kv.sl, v, vv.sl, m, start + c, sh.T, false, k_s, v_s, ok_s);
    __syncthreads();
    chunk_scores<HD>(q_s, k_s, ok_s, row0, i0, start + c, sh, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float mn = fmaxf(mx[r], s[r]);
      sum[r] = sum[r] * expf(mx[r] - mn) + expf(s[r] - mn);
      mx[r] = mn;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float row_max = warp_max(mx[r]);
    const float row_sum = warp_sum(sum[r] * expf(mx[r] - row_max));
    if (lane == 0) {
      m_s[row0 + r] = row_max;
      l_s[row0 + r] = row_sum;
    }
  }

  // pass 2: p = e / sum rounded to T, out = p v accumulated in f32
  float acc[kRows][kDL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < kDL; ++t) acc[r][t] = 0.f;
  float* p_w = p_s + warp * kRows * kChunk;
  for (int c = 0; c < sh.k_win; c += kChunk) {
    __syncthreads();
    stage_chunk<T, HD>(k, kv.sl, v, vv.sl, m, start + c, sh.T, true, k_s, v_s, ok_s);
    __syncthreads();
    chunk_scores<HD>(q_s, k_s, ok_s, row0, i0, start + c, sh, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      p_w[r * kChunk + lane] = round_to<T>(expf(s[r] - m_s[row0 + r]) / l_s[row0 + r]);
    __syncwarp();
#pragma unroll 2
    for (int jj = 0; jj < kChunk; jj += 4) {
      float vk[4][kDL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int t = 0; t < kDL; ++t) vk[u][t] = v_s[(jj + u) * HD + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(p_w + r * kChunk + jj);
#pragma unroll
        for (int t = 0; t < kDL; ++t) {
          acc[r][t] = fmaf(p4.x, vk[0][t], acc[r][t]);
          acc[r][t] = fmaf(p4.y, vk[1][t], acc[r][t]);
          acc[r][t] = fmaf(p4.z, vk[2][t], acc[r][t]);
          acc[r][t] = fmaf(p4.w, vk[3][t], acc[r][t]);
        }
      }
    }
  }

  T* o = static_cast<T*>(const_cast<void*>(ov.p)) + b * ov.sb + h * ov.sh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i < sh.T) {
#pragma unroll
      for (int t = 0; t < kDL; ++t) o[i * ov.sl + lane + 32 * t] = from_f<T>(acc[r][t]);
    }
  }
}

template <typename T, int HD>
int launch(View q, View k, View v, const void* mask, View o, int B, Shape sh,
           cudaStream_t stream) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(banded_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.T_pad / kTile, B * sh.H);
  banded_kernel<T, HD><<<grid, kWarps * 32, bytes, stream>>>(
      q, k, v, static_cast<const T*>(mask), o, sh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(View q, View k, View v, const void* mask, View o, int B, int hd, Shape sh,
              cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, mask, o, B, sh, stream);
    case 64: return launch<T, 64>(q, k, v, mask, o, B, sh, stream);
    case 128: return launch<T, 128>(q, k, v, mask, o, B, sh, stream);
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

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  hd is 32, 64
// or 128; T rounded up to 128 must hold one K_WIN slice.
extern "C" int vmr_banded_attention(int dtype, const void* q, long long q_sb, long long q_sh,
                                    long long q_sl, const void* k, long long k_sb,
                                    long long k_sh, long long k_sl, const void* v,
                                    long long v_sb, long long v_sh, long long v_sl,
                                    const void* mask, void* out, long long o_sb, long long o_sh,
                                    long long o_sl, int B, int H, int T, int hd, int window,
                                    float scale, void* stream) {
  const int half = window / 2;
  const int k_win = kTile + 2 * ((half + kTile - 1) / kTile) * kTile;
  const int T_pad = (T + kTile - 1) / kTile * kTile;
  if (T_pad < k_win || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Shape sh{H, T, T_pad, half, k_win, scale};
  const View qv{q, q_sb, q_sh, q_sl}, kv{k, k_sb, k_sh, k_sl}, vv{v, v_sb, v_sh, v_sl};
  const View ov{out, o_sb, o_sh, o_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_hd<__nv_bfloat16>(qv, kv, vv, mask, ov, B, hd, sh, s)
                    : launch_hd<float>(qv, kv, vv, mask, ov, B, hd, sh, s);
}
