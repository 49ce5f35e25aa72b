// Hopper (sm_90a) kernels for SeqPAN's three attention cores.
//
// Each replaces one Pallas TPU kernel of vmrframe_tpu/kernels/attention.py
// and computes the same function, not the same blocking:
//
//   vmr_masked_attention  <- fused_masked_attention (_attn_kernel)
//   vmr_dual_attention    <- fused_dual_attention   (_dual_attn_kernel)
//   vmr_cq_attention      <- fused_cq_attention     (_cq_kernel)
//
// What bounds them on an H100: at SeqPAN's widths (L <= 64, head dim 32,
// D = 128) every score tile is tiny, so the least time is set by bytes, not
// operations: each (batch, head) reads a few KB and does ~0.5 MFLOP.  The
// design therefore reads each block's inputs from device memory once into
// shared memory, keeps scores, probabilities and the CQ intermediates on
// chip, and writes each output once.  The arithmetic is plain f32 on the
// CUDA cores: these are the simple first versions.  On an H100 they run far
// above the bytes bound (PERF.md, from chip_smoke.py): a warp walks its
// query rows one after another and each lane's dot products are serial, so
// instruction latency, not memory, sets their time.  Spreading rows over
// more warps and moving the products to the tensor cores (mma / wgmma) is
// the next step.
//
// Numerics follow the TPU kernels: f32 scores and softmax, additive -1e30
// masking (a fully masked row comes out as the uniform average over all
// keys), probabilities rounded to the input type before the value product,
// output in the input type.  T is float or __nv_bfloat16; masks are {0,1}
// in T.  Ragged lengths are plain loop bounds: there are no fixed tiles.
//
// Interface: plain C, loaded with ctypes.  Every entry returns
// cudaGetLastError() after its launch; the Python wrapper raises on non-0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMask = -1e30f;
constexpr int kAttnWarps = 4;
constexpr int kCqThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A probability rounded to the input type, as the TPU kernels cast p before
// their value matmul.
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

// A (B, H, L, hd) tensor addressed through its strides (the last one is 1),
// so (B, L, H, hd) projections are read in place, without a transpose copy.
struct View {
  const void* p;
  long long sb, sh, sl;
};

struct Branch {
  View k, v, out;
  const void* mask;  // (B, Lq, Lk), contiguous, shared by the heads
  int Lk;
};

// vmr_masked_attention (nbranch = 1) and vmr_dual_attention (nbranch = 2).
// One block per (batch, head): K and V of each branch go to shared memory
// once; each warp takes query rows, keeps its row's scores in shared memory
// and reduces max and sum with shuffles.  With two branches the Q row is
// read once for the self and the cross branch, as the TPU kernel shares its
// Q tile.  The (B, Lq, Lk) mask is read at b = bh / H by the H blocks of a
// batch element (the TPU wrapper repeats it to B*H in device memory).
template <typename T>
__global__ void attention_kernel(View qv, Branch b0, Branch b1, int nbranch, int H, int Lq,
                                 int hd, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = hd + 1;  // padded K rows: lanes read K[j][d] for 32 j at once

  Branch br[2] = {b0, b1};
  float* kv_s[2][2];
  float* cur = smem;
  int maxLk = 0;
  for (int n = 0; n < nbranch; ++n) {
    const Branch& B_ = br[n];
    kv_s[n][0] = cur;
    cur += B_.Lk * ks;
    kv_s[n][1] = cur;
    cur += B_.Lk * hd;
    maxLk = max(maxLk, B_.Lk);
    const T* k = static_cast<const T*>(B_.k.p) + b * B_.k.sb + h * B_.k.sh;
    const T* v = static_cast<const T*>(B_.v.p) + b * B_.v.sb + h * B_.v.sh;
    for (int idx = threadIdx.x; idx < B_.Lk * hd; idx += blockDim.x) {
      const int j = idx / hd, d = idx % hd;
      kv_s[n][0][j * ks + d] = to_f(k[j * B_.k.sl + d]);
      kv_s[n][1][j * hd + d] = to_f(v[j * B_.v.sl + d]);
    }
  }
  float* q_s = cur + warp * (hd + maxLk);
  float* p_s = q_s + hd;
  __syncthreads();

  const T* q = static_cast<const T*>(qv.p) + b * qv.sb + h * qv.sh;
  for (int i = warp; i < Lq; i += kAttnWarps) {
    for (int d = lane; d < hd; d += 32) q_s[d] = to_f(q[i * qv.sl + d]);
    __syncwarp();
    for (int n = 0; n < nbranch; ++n) {
      const Branch& B_ = br[n];
      const float* k_s = kv_s[n][0];
      const float* v_s = kv_s[n][1];
      const T* mrow = static_cast<const T*>(B_.mask) + ((long long)b * Lq + i) * B_.Lk;
      float mx = kMask;
      for (int j = lane; j < B_.Lk; j += 32) {
        float s = 0.f;
        for (int d = 0; d < hd; ++d) s += q_s[d] * k_s[j * ks + d];
        s = s * scale + (1.f - to_f(mrow[j])) * kMask;
        p_s[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < B_.Lk; j += 32) {
        const float e = expf(p_s[j] - mx);
        p_s[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < B_.Lk; j += 32) p_s[j] = round_to<T>(p_s[j] / sum);
      __syncwarp();
      T* o = static_cast<T*>(const_cast<void*>(B_.out.p)) + b * B_.out.sb + h * B_.out.sh +
             i * B_.out.sl;
      for (int d = lane; d < hd; d += 32) {
        float acc = 0.f;
        for (int j = 0; j < B_.Lk; ++j) acc += p_s[j] * v_s[j * hd + d];
        o[d] = from_f<T>(acc);
      }
      __syncwarp();
    }
  }
}

// vmr_cq_attention: QANet context-query attention, one block per batch
// element: the column softmax runs over all Lc context rows, so one block
// owns the element's whole (Lc, Lq) score tile (128 blocks at the serving
// batch, on 132 SMs).  c, q, both score tiles and S_t^T c live in
// shared memory (~80 KB at Lc = 64, Lq = 30, D = 128: dynamic shared memory
// above the 48 KB default).  q2c keeps the TPU kernel's association
// S_ (S_t^T c), Lc*Lq*D twice instead of Lc*Lq*Lc.
template <typename T>
__global__ void cq_kernel(const T* c, const T* q, const T* w4c, const T* w4q, const T* w4m,
                          const T* cmask, const T* qmask, T* c2q, T* q2c, int Lc, int Lq, int D) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int ds = D + 1;  // padded rows: threads read q[j][d] for consecutive j
  float* c_s = smem;               // (Lc, D+1)
  float* q_s = c_s + Lc * ds;      // (Lq, D+1)
  float* S = q_s + Lq * ds;        // (Lc, Lq) scores, then the row softmax S_
  float* St = S + Lc * Lq;         // (Lc, Lq) column softmax S_t
  float* s0 = St + Lc * Lq;        // (Lc,) c . w4C
  float* s1 = s0 + Lc;             // (Lq,) q . w4Q
  float* w_s = s1 + Lq;            // (D,) w4mlu
  float* stc = w_s + D;            // (Lq, D) S_t^T c

  c += (long long)b * Lc * D;
  q += (long long)b * Lq * D;
  cmask += (long long)b * Lc;
  qmask += (long long)b * Lq;
  for (int idx = threadIdx.x; idx < Lc * D; idx += blockDim.x)
    c_s[(idx / D) * ds + idx % D] = to_f(c[idx]);
  for (int idx = threadIdx.x; idx < Lq * D; idx += blockDim.x)
    q_s[(idx / D) * ds + idx % D] = to_f(q[idx]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) w_s[d] = to_f(w4m[d]);
  __syncthreads();

  // rank-1 terms: one warp per row of c, then of q
  for (int r = warp; r < Lc + Lq; r += nwarp) {
    const bool is_c = r < Lc;
    const float* row = is_c ? c_s + r * ds : q_s + (r - Lc) * ds;
    const T* w = is_c ? w4c : w4q;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += row[d] * to_f(w[d]);
    acc = warp_sum(acc);
    if (lane == 0) (is_c ? s0[r] : s1[r - Lc]) = acc;
  }
  __syncthreads();

  // trilinear score: (c * w4mlu) . q + c . w4C + q . w4Q
  for (int idx = threadIdx.x; idx < Lc * Lq; idx += blockDim.x) {
    const int i = idx / Lq, j = idx % Lq;
    const float* ci = c_s + i * ds;
    const float* qj = q_s + j * ds;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += ci[d] * w_s[d] * qj[d];
    S[idx] = acc + s0[i] + s1[j];
  }
  __syncthreads();

  // column softmax over the context rows (c_mask), one warp per column
  for (int j = warp; j < Lq; j += nwarp) {
    float mx = kMask;
    for (int i = lane; i < Lc; i += 32) {
      const float v = S[i * Lq + j] + (1.f - to_f(cmask[i])) * kMask;
      St[i * Lq + j] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < Lc; i += 32) {
      const float e = expf(St[i * Lq + j] - mx);
      St[i * Lq + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int i = lane; i < Lc; i += 32) St[i * Lq + j] = round_to<T>(St[i * Lq + j] / sum);
  }
  __syncthreads();

  // row softmax over the query columns (q_mask), in place, one warp per row
  for (int i = warp; i < Lc; i += nwarp) {
    float* row = S + i * Lq;
    float mx = kMask;
    for (int j = lane; j < Lq; j += 32) {
      row[j] += (1.f - to_f(qmask[j])) * kMask;
      mx = fmaxf(mx, row[j]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Lq; j += 32) {
      row[j] = expf(row[j] - mx);
      sum += row[j];
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Lq; j += 32) row[j] /= sum;
  }

  // S_t^T c: (Lq, D), f32
  for (int idx = threadIdx.x; idx < Lq * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    float acc = 0.f;
    for (int i = 0; i < Lc; ++i) acc += St[i * Lq + j] * c_s[i * ds + d];
    stc[idx] = acc;
  }
  __syncthreads();

  // c2q = S_ q (S_ rounded to T) and q2c = S_ (S_t^T c) (S_ in f32)
  c2q += (long long)b * Lc * D;
  q2c += (long long)b * Lc * D;
  for (int idx = threadIdx.x; idx < Lc * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    const float* row = S + i * Lq;
    float a = 0.f, z = 0.f;
    for (int j = 0; j < Lq; ++j) {
      a += round_to<T>(row[j]) * q_s[j * ds + d];
      z += row[j] * stc[j * D + d];
    }
    c2q[idx] = from_f<T>(a);
    q2c[idx] = from_f<T>(z);
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_attention(View q, Branch b0, Branch b1, int nbranch, int B, int H, int Lq, int hd,
                     float scale, cudaStream_t stream) {
  const int maxLk = (nbranch == 2 && b1.Lk > b0.Lk) ? b1.Lk : b0.Lk;
  size_t floats = (size_t)kAttnWarps * (hd + maxLk) + (size_t)b0.Lk * (2 * hd + 1);
  if (nbranch == 2) floats += (size_t)b1.Lk * (2 * hd + 1);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = allow_smem(attention_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<T><<<B * H, kAttnWarps * 32, bytes, stream>>>(q, b0, b1, nbranch, H, Lq, hd,
                                                                 scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cq(const void* c, const void* q, const void* w4c, const void* w4q, const void* w4m,
              const void* cmask, const void* qmask, void* c2q, void* q2c, int B, int Lc, int Lq,
              int D, cudaStream_t stream) {
  const size_t floats = (size_t)(Lc + Lq) * (D + 1) + 2 * (size_t)Lc * Lq + Lc + Lq + D +
                        (size_t)Lq * D;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = allow_smem(cq_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  cq_kernel<T><<<B, kCqThreads, bytes, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(q), static_cast<const T*>(w4c),
      static_cast<const T*>(w4q), static_cast<const T*>(w4m), static_cast<const T*>(cmask),
      static_cast<const T*>(qmask), static_cast<T*>(c2q), static_cast<T*>(q2c), Lc, Lq, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.
extern "C" int vmr_masked_attention(int dtype, const void* q, long long q_sb, long long q_sh,
                                    long long q_sl, const void* k, long long k_sb,
                                    long long k_sh, long long k_sl, const void* v,
                                    long long v_sb, long long v_sh, long long v_sl,
                                    const void* mask, void* out, long long o_sb, long long o_sh,
                                    long long o_sl, int B, int H, int Lq, int Lk, int hd,
                                    float scale, void* stream) {
  const View qv{q, q_sb, q_sh, q_sl};
  const Branch b0{{k, k_sb, k_sh, k_sl}, {v, v_sb, v_sh, v_sl}, {out, o_sb, o_sh, o_sl}, mask,
                  Lk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_attention<__nv_bfloat16>(qv, b0, b0, 1, B, H, Lq, hd, scale, s)
                    : launch_attention<float>(qv, b0, b0, 1, B, H, Lq, hd, scale, s);
}

extern "C" int vmr_dual_attention(int dtype, const void* q, long long q_sb, long long q_sh,
                                  long long q_sl, const void* fk, long long fk_sb,
                                  long long fk_sh, long long fk_sl, const void* fv,
                                  long long fv_sb, long long fv_sh, long long fv_sl,
                                  const void* tk, long long tk_sb, long long tk_sh,
                                  long long tk_sl, const void* tv, long long tv_sb,
                                  long long tv_sh, long long tv_sl, const void* s_mask,
                                  const void* x_mask, void* s_out, long long so_sb,
                                  long long so_sh, long long so_sl, void* x_out, long long xo_sb,
                                  long long xo_sh, long long xo_sl, int B, int H, int L, int M,
                                  int hd, float scale, void* stream) {
  const View qv{q, q_sb, q_sh, q_sl};
  const Branch self{{fk, fk_sb, fk_sh, fk_sl}, {fv, fv_sb, fv_sh, fv_sl},
                    {s_out, so_sb, so_sh, so_sl}, s_mask, L};
  const Branch cross{{tk, tk_sb, tk_sh, tk_sl}, {tv, tv_sb, tv_sh, tv_sl},
                     {x_out, xo_sb, xo_sh, xo_sl}, x_mask, M};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_attention<__nv_bfloat16>(qv, self, cross, 2, B, H, L, hd, scale, s)
             : launch_attention<float>(qv, self, cross, 2, B, H, L, hd, scale, s);
}

extern "C" int vmr_cq_attention(int dtype, const void* c, const void* q, const void* w4c,
                                const void* w4q, const void* w4m, const void* c_mask,
                                const void* q_mask, void* c2q, void* q2c, int B, int Lc, int Lq,
                                int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_cq<__nv_bfloat16>(c, q, w4c, w4q, w4m, c_mask, q_mask, c2q, q2c, B,
                                               Lc, Lq, D, s)
                    : launch_cq<float>(c, q, w4c, w4q, w4m, c_mask, q_mask, c2q, q2c, B, Lc,
                                       Lq, D, s);
}
