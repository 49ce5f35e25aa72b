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
// inputs and outputs, and all samples share 0.9 MB of weights.
//
// Design.  One block of 512 threads per sample (128 samples on 132 SMs: one
// wave; a sample's four calls depend on each other, so there is nothing to
// split without exchanging activations between blocks).  A call's
// activations live in five (64, 128) f32 buffers in shared memory (rows
// padded to 132 floats, so that 16-byte reads along a row are free of bank
// conflicts both for one row per lane and for one row per warp); the
// schedule below reuses them so that five are enough in f32 too.  Each
// D x D projection is a block-wide product: the weight matrix streams from
// L2 in 32-row chunks through a double buffer in shared memory (every block
// reads the same 28 matrices), each warp owns 4 rows and each lane 4
// columns, 16 f32 accumulators per thread, FMA on the CUDA cores.
// Attention is one warp per (row, head): lanes take keys for the scores,
// then head dims for p v, and the context overwrites the query's own head
// slice.  The first layer's results go to an f32 scratch in device memory
// that the same block reads back (it stays in L2), so nothing is rounded
// between the layers, as on the TPU.  Moving the products to the tensor
// cores (mma / wgmma, bf16) is the next step.
//
// Numerics follow the TPU kernel body: fn, tn, k, v, the probabilities and
// every matmul operand are rounded to T (the weights' type); LN, softmax,
// the sigmoid and all sums are f32; additive -1e30 key masks per sample; the
// BiLinear is two products, over fn and over gc, accumulated
// one after the other.  Ragged lengths are loop bounds and row guards.
//
// Takes D = 128, H dividing 128 with a head dim that is a multiple of 4, and
// 1 <= Lv, Lt <= 64.  Interface: plain C, loaded with ctypes; the entry
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 128;
constexpr int kMaxL = 64;
constexpr int kLD = kD + 4;  // padded row stride of the activation buffers
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;  // weight rows per staged chunk
constexpr int kChunks = kD / kKC;
constexpr int kBuf = kMaxL * kLD;
constexpr int kSmemFloats = 5 * kBuf + 2 * kKC * kD + kWarps * kMaxL + 2 * kMaxL;
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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
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

template <typename T> __device__ __forceinline__ void act_store(Act a, int idx, float x) {
  if (a.f32)
    static_cast<float*>(const_cast<void*>(a.p))[idx] = x;
  else
    static_cast<T*>(const_cast<void*>(a.p))[idx] = from_f<T>(x);
}

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
__device__ __forceinline__ void gemm(const float* A0, const float* A1, int M, const T* W,
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

// H-head attention of F query rows over Tn keys: one warp per (row, head).
// q, k, v, out: activation buffers (q and k, v already rounded to T); out
// may be q itself: a task reads only its own head slice of its own row, and
// has read it before it writes.  fm (F,) and tmk (Tn,) are the {0,1}
// validities; the context is rounded to T.
template <typename T>
__device__ __forceinline__ void attention(const float* q, const float* k, const float* v,
                                          float* out, int F, int Tn, int H, const float* fm,
                                          const float* tmk, float* p_all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = kD / H;
  const float scale = 1.f / sqrtf((float)hd);
  float* p_s = p_all + warp * kMaxL;
  for (int task = warp; task < F * H; task += kWarps) {
    const int i = task / H, h = task % H;
    const float* qi = q + i * kLD + h * hd;
    float s[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = lane + 32 * jj;
      s[jj] = -INFINITY;
      if (j < Tn) {
        const float* kj = k + j * kLD + h * hd;
        float dot = 0.f;
        for (int d = 0; d < hd; d += 4) {
          const float4 a = load4(qi + d), b = load4(kj + d);
          dot = fmaf(a.x, b.x, dot), dot = fmaf(a.y, b.y, dot);
          dot = fmaf(a.z, b.z, dot), dot = fmaf(a.w, b.w, dot);
        }
        s[jj] = dot * scale + (1.f - fm[i] * tmk[j]) * kMask;
      }
    }
    const float mx = warp_max(fmaxf(s[0], s[1]));
    const float e0 = expf(s[0] - mx), e1 = expf(s[1] - mx);  // exp(-inf) = 0 beyond Tn
    const float sum = warp_sum(e0 + e1);
    p_s[lane] = round_to<T>(e0 / sum);
    p_s[lane + 32] = round_to<T>(e1 / sum);
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      const float* vd = v + h * hd + d;
      float acc = 0.f;
      for (int j = 0; j < Tn; ++j) acc = fmaf(p_s[j], vd[j * kLD], acc);
      out[i * kLD + h * hd + d] = round_to<T>(acc);
    }
    __syncwarp();
  }
  __syncthreads();
}

// One DualAttentionBlock call for one sample.  x (F, D) is the from-side, y
// (Tn, D) the to-side, both in device memory; fm_g (F,), tm_g (Tn,) their
// validities; W (14, D, D), b (14, D), ln (6, D), xb (2, D) one layer's
// stacks.  Buffer schedule (A..E):
//   tn -> A; tk -> B; tv -> C; fn -> A; q -> D; x_att = attn(D; B, C) -> E;
//   fk -> B; fv -> C; s_att = attn(D; B, C) -> D (in place);
//   x_value = E Wxd -> B; x_score = B Wxg -> C; s_value = D Wsd -> E;
//   s_score = E Wsg -> D; D = s_score x_value + x_score s_value;
//   gc = D Wgd -> B; scores = (A, B) Wbl1 -> C; gate * values -> D;
//   residual = D Wd1 + b + x -> E; z = LN2(E) -> A; out = A Wd2 + b + E.
template <typename T>
__device__ __noinline__ void dab_call(Act x, Act y, Act out, const float* fm_g,
                                         const float* tm_g, int F, int Tn, int H, const T* W,
                                         const float* b, const float* ln, const float* xb,
                                         float* smem) {
  float* A = smem;
  float* Bf = A + kBuf;
  float* C = Bf + kBuf;
  float* Dq = C + kBuf;
  float* E = Dq + kBuf;
  float* wbuf = E + kBuf;
  float* p_s = wbuf + 2 * kKC * kD;
  float* fm = p_s + kWarps * kMaxL;
  float* tmk = fm + kMaxL;
  const T* Wm[kNumW];
#pragma unroll
  for (int i = 0; i < kNumW; ++i) Wm[i] = W + i * kD * kD;

  for (int i = threadIdx.x; i < F; i += kThreads) fm[i] = fm_g[i];
  for (int i = threadIdx.x; i < Tn; i += kThreads) tmk[i] = tm_g[i];
  auto biased_rounded = [&](float* dst, int w) {
    return [=](int r, int c, float acc) { dst[r * kLD + c] = round_to<T>(acc + b[w * kD + c]); };
  };
  auto biased = [&](float* dst, int w) {
    return [=](int r, int c, float acc) { dst[r * kLD + c] = acc + b[w * kD + c]; };
  };

  // the to-side: tn, its keys and values
  layer_norm<T>(Tn, [&](int r, int c) { return act_load4<T>(y, r * kD + c); },
                ln + LNT_S * kD, ln + LNT_B * kD, A);
  __syncthreads();
  gemm<T, 1, false>(A, nullptr, Tn, Wm[W_TK], wbuf, biased_rounded(Bf, W_TK));
  gemm<T, 1, false>(A, nullptr, Tn, Wm[W_TV], wbuf, biased_rounded(C, W_TV));
  // the from-side: fn, the shared query, cross attention
  layer_norm<T>(F, [&](int r, int c) { return act_load4<T>(x, r * kD + c); },
                ln + LN1_S * kD, ln + LN1_B * kD, A);
  __syncthreads();
  gemm<T, 1, false>(A, nullptr, F, Wm[W_Q], wbuf, biased_rounded(Dq, W_Q));
  attention<T>(Dq, Bf, C, E, F, Tn, H, fm, tmk, p_s);
  // self attention, over the query in place
  gemm<T, 1, false>(A, nullptr, F, Wm[W_FK], wbuf, biased_rounded(Bf, W_FK));
  gemm<T, 1, false>(A, nullptr, F, Wm[W_FV], wbuf, biased_rounded(C, W_FV));
  attention<T>(Dq, Bf, C, Dq, F, F, H, fm, fm, p_s);
  // values and cross gates
  gemm<T, 1, false>(E, nullptr, F, Wm[W_XD], wbuf, biased(Bf, W_XD));
  gemm<T, 1, true>(Bf, nullptr, F, Wm[W_XG], wbuf, biased(C, W_XG));
  gemm<T, 1, false>(Dq, nullptr, F, Wm[W_SD], wbuf, biased(E, W_SD));
  gemm<T, 1, true>(E, nullptr, F, Wm[W_SG], wbuf, biased(Dq, W_SG));
  for (int idx = threadIdx.x; idx < F * kD; idx += kThreads) {
    const int o = (idx / kD) * kLD + idx % kD;
    Dq[o] = round_to<T>(Dq[o] * Bf[o] + C[o] * E[o]);
  }
  __syncthreads();
  gemm<T, 1, false>(Dq, nullptr, F, Wm[W_GD], wbuf, biased_rounded(Bf, W_GD));
  // BiLinear gate: fn W + gc W + 2 b + xb, twice; sigmoid(scores masked) * values
  gemm<T, 2, false>(A, Bf, F, Wm[W_BL1], wbuf, [=](int r, int c, float acc) {
    C[r * kLD + c] = acc + 2.f * b[W_BL1 * kD + c] + xb[c];
  });
  gemm<T, 2, false>(A, Bf, F, Wm[W_BL2], wbuf, [=](int r, int c, float acc) {
    const float values = acc + 2.f * b[W_BL2 * kD + c] + xb[kD + c];
    const float z = C[r * kLD + c] + kMask * (1.f - fm[r]);
    Dq[r * kLD + c] = round_to<T>(values / (1.f + expf(-z)));
  });
  // dense + residual, LN, dense + residual
  gemm<T, 1, false>(Dq, nullptr, F, Wm[W_D1], wbuf, [=](int r, int c, float acc) {
    E[r * kLD + c] = acc + b[W_D1 * kD + c] + act_load<T>(x, r * kD + c);
  });
  layer_norm<T>(F, [&](int r, int c) { return load4(E + r * kLD + c); }, ln + LN2_S * kD,
                ln + LN2_B * kD, A);
  __syncthreads();
  gemm<T, 1, false>(A, nullptr, F, Wm[W_D2], wbuf, [=](int r, int c, float acc) {
    act_store<T>(out, r * kD + c, acc + b[W_D2 * kD + c] + E[r * kLD + c]);
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    stack_kernel(const T* v_in, const T* t_in, const float* vm, const float* tm, const T* W,
                 const float* b, const float* ln, const float* xb, T* v_out, T* t_out,
                 float* scratch, int Lv, int Lt, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // rows beyond a call's length are read (never used) by the 4-row tiles
  for (int i = threadIdx.x; i < 5 * kBuf; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const long long s = blockIdx.x;
  const Act v0{v_in + s * Lv * kD, false}, t0{t_in + s * Lt * kD, false};
  const Act v1{scratch + s * (Lv + Lt) * kD, true};
  const Act t1{scratch + s * (Lv + Lt) * kD + Lv * kD, true};
  const Act v2{v_out + s * Lv * kD, false}, t2{t_out + s * Lt * kD, false};
  const float* vmask = vm + s * Lv;
  const float* tmask = tm + s * Lt;
  for (int layer = 0; layer < 2; ++layer) {
    const T* Wl = W + layer * kNumW * kD * kD;
    const float* bl = b + layer * kNumW * kD;
    const float* lnl = ln + layer * kNumLn * kD;
    const float* xbl = xb + layer * 2 * kD;
    const Act xv = layer ? v1 : v0, xt = layer ? t1 : t0;
    dab_call<T>(xv, xt, layer ? v2 : v1, vmask, tmask, Lv, Lt, H, Wl, bl, lnl, xbl, smem);
    dab_call<T>(xt, xv, layer ? t2 : t1, tmask, vmask, Lt, Lv, H, Wl, bl, lnl, xbl, smem);
    __syncthreads();  // the scratch rows written above are read by other threads below
  }
}

template <typename T>
int launch(const void* v, const void* t, const void* vm, const void* tm, const void* W,
           const void* b, const void* ln, const void* xb, void* v_out, void* t_out,
           void* scratch, int B, int Lv, int Lt, int H, cudaStream_t stream) {
  const size_t bytes = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stack_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  stack_kernel<T><<<B, kThreads, bytes, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(t), static_cast<const float*>(vm),
      static_cast<const float*>(tm), static_cast<const T*>(W), static_cast<const float*>(b),
      static_cast<const float*>(ln), static_cast<const float*>(xb), static_cast<T*>(v_out),
      static_cast<T*>(t_out), static_cast<float*>(scratch), Lv, Lt, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features, weights and outputs); masks,
// b, ln, xb and scratch are float32.  Returns 1 (cudaErrorInvalidValue) for
// a shape the kernel does not take.
extern "C" int vmr_dual_stack(int dtype, const void* v, const void* t, const void* vm,
                              const void* tm, const void* W, const void* b, const void* ln,
                              const void* xb, void* v_out, void* t_out, void* scratch, int B,
                              int Lv, int Lt, int H, void* stream) {
  if (B < 1 || Lv < 1 || Lt < 1 || Lv > kMaxL || Lt > kMaxL || H < 1 || kD % H || (kD / H) % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch,
                                            B, Lv, Lt, H, s)
                    : launch<float>(v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch, B, Lv,
                                    Lt, H, s);
}
