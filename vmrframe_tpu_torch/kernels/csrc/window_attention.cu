// Hopper (sm_90a) kernel for ActionFormer's banded (sliding-window) attention.
//
//   vmr_banded_attention  <- vmrframe_tpu/kernels/window_attention.py::banded_attention
//                            (_fwd_kernel, the forward)
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

}  // namespace

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
