// Hopper (sm_90a) kernels for SeqPAN's three attention cores.
//
// Each replaces one Pallas TPU kernel of vmrframe_tpu/kernels/attention.py
// and computes the same function, not the same blocking:
//
//   vmr_masked_attention  <- fused_masked_attention (_attn_kernel)
//   vmr_dual_attention    <- fused_dual_attention   (_dual_attn_kernel)
//   vmr_cq_attention      <- fused_cq_attention     (_cq_kernel)
//
// What bounds them on an H100.  At SeqPAN's widths (L = 30..256, head dim
// 32, D = 128) each (batch, head) of #1/#2 reads a few KB and does well
// under a MFLOP, so the least time is set by bytes (PERF.md); what sets the
// real time is latency: how many dependent steps a warp takes per row.
//
// #1/#2, bf16: attention_mma.  One block per (batch, head); K and V of each
// branch go to shared memory once with 16-byte cp.async copies (rows padded
// to 16 keys and to a multiple of 16 head columns with zeros, and 8 more
// columns so that ldmatrix rows fall on distinct banks).  Each warp owns a
// 16-row query tile whose Q fragments stay in registers (ldmatrix), and
// copies the tile's mask 64 keys at a time into shared memory; scores
// come from mma.sync m16n8k16 (bf16 in, f32 out) 64 keys at a time and stay
// in registers; row max and sum use quad shuffles.  Over the key chunks the
// warp walks twice: max and sum first, then the normalised probability,
// rounded to bf16 in registers, is the A operand of the P.V mma (V's B
// fragments by ldmatrix.trans).  That is where the TPU kernel and the plain
// version round, so the numbers are theirs, not an online softmax's.  With
// one chunk (Lk <= 64) the scores of the first walk are kept.  #2 runs the
// same tile over two branches with the Q fragments loaded once.  The
// fragment helpers are in mma_bf16.cuh, shared with window_attention.cu.
//
// #1/#2, f32: attention_f32 stays full f32 on the CUDA cores (TF32 would
// keep ~3 digits): the same two walks over keys staged 32 at a time in
// shared memory, a warp per query row and a lane per key; head dims to 256.
//
// #3: cq_kernel, one block per batch element (the column softmax runs over
// all Lc rows).  Shared memory no longer grows with the long side times D:
// c and q pass through it in chunks of R rows (R * D <= 8192 floats), and
// the score tiles S, S_t and the (Lq, D) product S_t^T c live in shared
// memory while they fit, else in a device scratch that the wrapper
// allocates (L2-resident).  The plan (R, bytes, what goes to scratch) is
// worked out in Python (kernels/attention.py::cq_plan) and passed in.
//
// Numerics follow the TPU kernels: f32 scores and softmax, additive -1e30
// masking (a wholly masked row comes out as the uniform average over all
// keys; padding keys beyond Lk are -inf and take no part), probabilities
// rounded to the input type before the value product, output in the input
// type.  CQ keeps the S_ (S_t^T c) association of q2c, S_t rounded to T
// before S_t^T c, S_ rounded to T for c2q and f32 for q2c.  T is float or
// __nv_bfloat16; masks are {0,1} in T.
//
// Interface: plain C, loaded with ctypes.  Every entry returns
// cudaGetLastError() after its launch; the Python wrapper raises on non-0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // bf16, quad reductions, cp.async, ldmatrix, mma_bf16, stage

namespace {

constexpr float kMask = -1e30f;
constexpr int kF32Warps = 4;
constexpr int kF32Chunk = 32;   // attention_f32: keys per chunk, a lane each
constexpr int kF32Rows = 16;    // attention_f32: query rows per block (4 a warp)
constexpr int kMaxWarps = 8;    // attention_mma: query tiles of 16 rows in flight per block
constexpr int kChunk = 64;      // attention_mma: keys per score chunk (8 mma n-tiles)
constexpr int kMaskRS = kChunk + 8;  // attention_mma: row stride of a warp's mask tile
constexpr int kCqThreads = 256;
constexpr int kCqAcc = 32;      // cq_kernel: outputs per thread per row chunk (R * D <= 8192)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

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

template <typename T>
__device__ __forceinline__ const T* at(const View& v, int b, int h) {
  return static_cast<const T*>(v.p) + b * v.sb + h * v.sh;
}

// The scores of one 64-key chunk for a warp's 16-row tile, in the mma's C
// layout: s[j] holds keys c0 + 8j + 2t, +1 of rows g (s[j][0..1]) and g + 8
// (s[j][2..3]); scaled, masked with -1e30 by the chunk's mask tile m_s
// (16 rows of kMaskRS), -inf beyond Lk.
template <int HDK, int RS>
__device__ __forceinline__ void chunk_scores(float (&s)[8][4], const uint32_t (&qa)[HDK][4],
                                             const bf16* k_s, const bf16* m_s, int c0, int Lk,
                                             int Lkp, float scale, int lane) {
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int j2 = 0; j2 < 4; ++j2) {
    if (c0 + 16 * j2 < Lkp) {
      const bf16* krow = k_s + (c0 + 16 * j2 + r + ((mi >> 1) << 3)) * RS + ((mi & 1) << 3);
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
      const int col = 8 * j + 2 * t + (e & 1);
      if (c0 + col >= Lk) {
        s[j][e] = -CUDART_INF_F;
      } else {
        const float m = __bfloat162float(m_s[(g + (e & 2) * 4) * kMaskRS + col]);
        s[j][e] = s[j][e] * scale + (1.f - m) * kMask;
      }
    }
  }
}

// vmr_masked_attention (nbranch = 1) and vmr_dual_attention (nbranch = 2),
// bf16, on the tensor cores.  HDK = head dim padded to 16, over 16.
template <int HDK>
__global__ void __launch_bounds__(kMaxWarps * 32)
    attention_mma(View qv, Branch b0, Branch b1, int nbranch, int H, int Lq, int hd,
                  float scale) {
  constexpr int HDP = 16 * HDK, RS = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r = lane & 7;

  Branch br[2] = {b0, b1};
  bf16* kv_s[2][2];
  bf16* cur = smem;
  for (int n = 0; n < nbranch; ++n) {
    const int Lkp = (br[n].Lk + 15) & ~15;
    kv_s[n][0] = cur;
    kv_s[n][1] = cur + Lkp * RS;
    cur += 2 * Lkp * RS;
    stage<HDP, RS>(kv_s[n][0], at<bf16>(br[n].k, b, h), br[n].k.sl, br[n].Lk, Lkp, hd,
                   threadIdx.x, blockDim.x);
    stage<HDP, RS>(kv_s[n][1], at<bf16>(br[n].v, b, h), br[n].v.sl, br[n].Lk, Lkp, hd,
                   threadIdx.x, blockDim.x);
  }
  cp_async_wait_all();
  __syncthreads();  // K and V, staged by the whole block
  bf16* q_s = cur + warp * 16 * (RS + kMaskRS);  // this warp's Q tile, then its mask tile
  bf16* m_s = q_s + 16 * RS;
  const bf16* q = at<bf16>(qv, b, h);

  for (int i0 = warp * 16; i0 < Lq; i0 += nwarp * 16) {
    stage<HDP, RS>(q_s, q + i0 * qv.sl, qv.sl, min(16, Lq - i0), 16, hd, lane, 32);
    cp_async_wait_all();
    __syncwarp();
    uint32_t qa[HDK][4];
#pragma unroll
    for (int kk = 0; kk < HDK; ++kk)
      ldmatrix_x4(qa[kk], q_s + (r + ((mi & 1) << 3)) * RS + 16 * kk + ((mi >> 1) << 3));
    const int ra = i0 + g, rb = ra + 8;

    for (int n = 0; n < nbranch; ++n) {
      const Branch& B_ = br[n];
      const int Lk = B_.Lk, Lkp = (Lk + 15) & ~15, nchunk = (Lk + kChunk - 1) / kChunk;
      const bf16* k_s = kv_s[n][0];
      const bf16* v_s = kv_s[n][1];
      const bf16* mask = static_cast<const bf16*>(B_.mask) + ((long long)b * Lq + i0) * Lk;
      // the tile's (16, 64) slice of the mask at key c0, with coalesced copies
      auto stage_mask = [&](int c0) {
        __syncwarp();  // every lane is done with the last slice
        stage<kChunk, kMaskRS>(m_s, mask + c0, Lk, min(16, Lq - i0), 16, min(kChunk, Lk - c0),
                               lane, 32);
        cp_async_wait_all();
        __syncwarp();
      };

      // walk 1: row max and sum (rows g and g + 8 of the tile)
      float s[8][4];
      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
      for (int c = 0; c < nchunk; ++c) {
        stage_mask(c * kChunk);
        chunk_scores<HDK, RS>(s, qa, k_s, m_s, c * kChunk, Lk, Lkp, scale, lane);
        float c0 = -CUDART_INF_F, c1 = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c0 = fmaxf(c0, fmaxf(s[j][0], s[j][1]));
          c1 = fmaxf(c1, fmaxf(s[j][2], s[j][3]));
        }
        const float n0 = fmaxf(m0, quad_max(c0)), n1 = fmaxf(m1, quad_max(c1));
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
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

      // walk 2: the normalised probabilities, rounded to bf16, times V
      float o[2 * HDK][4];
#pragma unroll
      for (int d = 0; d < 2 * HDK; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
      for (int c = 0; c < nchunk; ++c) {
        if (nchunk > 1) {
          stage_mask(c * kChunk);
          chunk_scores<HDK, RS>(s, qa, k_s, m_s, c * kChunk, Lk, Lkp, scale, lane);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int key0 = c * kChunk + 16 * kk;
          if (key0 < Lkp) {
            uint32_t pa[4];
            pa[0] = pack_bf16(__expf(s[2 * kk][0] - m0) * inv0, __expf(s[2 * kk][1] - m0) * inv0);
            pa[1] = pack_bf16(__expf(s[2 * kk][2] - m1) * inv1, __expf(s[2 * kk][3] - m1) * inv1);
            pa[2] = pack_bf16(__expf(s[2 * kk + 1][0] - m0) * inv0,
                              __expf(s[2 * kk + 1][1] - m0) * inv0);
            pa[3] = pack_bf16(__expf(s[2 * kk + 1][2] - m1) * inv1,
                              __expf(s[2 * kk + 1][3] - m1) * inv1);
            const bf16* vrow = v_s + (key0 + r + ((mi & 1) << 3)) * RS + ((mi >> 1) << 3);
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
      bf16* out = static_cast<bf16*>(const_cast<void*>(B_.out.p)) + b * B_.out.sb + h * B_.out.sh;
#pragma unroll
      for (int d = 0; d < 2 * HDK; ++d) {
        const int col = 8 * d + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb;
          if (row < Lq && col + (e & 1) < hd)
            out[row * B_.out.sl + col + (e & 1)] = __float2bfloat16(o[d][e]);
        }
      }
    }
    __syncwarp();  // every lane is done with q_s before the next tile overwrites it
  }
}

// vmr_masked_attention and vmr_dual_attention, f32, on the CUDA cores.
// One block per (batch, head) and 16 query rows (more blocks in flight hide
// the latency of each row's dependent steps); keys pass through shared
// memory 32 at a time (K rows padded to hd + 1, so a lane per key reads
// without bank conflicts); each warp takes rows, a lane per key.  Walk
// 1 keeps each row's running max and sum in shared memory; walk 2 adds each
// chunk's p.V (a lane per output column) to the f32 output in place.
// DCH = head dim over 32, rounded up: the output columns a lane holds.
template <int DCH>
__global__ void __launch_bounds__(kF32Warps * 32)
    attention_f32(View qv, Branch b0, Branch b1, int nbranch, int H, int Lq, int hd,
                  float scale) {
  extern __shared__ float f32_smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = hd + 1;
  float* k_s = f32_smem;                          // (32, hd + 1)
  float* v_s = k_s + kF32Chunk * ks;              // (32, hd)
  float* q_s = v_s + kF32Chunk * hd + warp * hd;  // this warp's query row
  float* stat = v_s + kF32Chunk * hd + kF32Warps * hd;  // (16, 2): running max, sum
  const int r0 = blockIdx.y * kF32Rows, r1 = min(Lq, r0 + kF32Rows);
  const float* q = at<float>(qv, b, h);
  Branch br[2] = {b0, b1};
  for (int n = 0; n < nbranch; ++n) {
    const Branch& B_ = br[n];
    const int Lk = B_.Lk;
    const float* k = at<float>(B_.k, b, h);
    const float* v = at<float>(B_.v, b, h);
    const float* mask = static_cast<const float*>(B_.mask) + (long long)b * Lq * Lk;
    float* out = static_cast<float*>(const_cast<void*>(B_.out.p)) + b * B_.out.sb +
                 h * B_.out.sh;
    for (int walk = 0; walk < 2; ++walk) {
      for (int j0 = 0; j0 < Lk; j0 += kF32Chunk) {
        const int nj = min(kF32Chunk, Lk - j0);
        __syncthreads();  // the last chunk's readers are done
        for (int idx = threadIdx.x; idx < nj * hd; idx += blockDim.x) {
          const int j = idx / hd, d = idx % hd;
          k_s[j * ks + d] = k[(j0 + j) * B_.k.sl + d];
          if (walk) v_s[idx] = v[(j0 + j) * B_.v.sl + d];
        }
        __syncthreads();
        for (int i = r0 + warp; i < r1; i += kF32Warps) {
          float* st = stat + 2 * (i - r0);
          for (int d = lane; d < hd; d += 32) q_s[d] = q[i * qv.sl + d];
          __syncwarp();
          float s = -CUDART_INF_F;
          if (lane < nj) {
            const float* kj = k_s + lane * ks;
            float dot = 0.f;
#pragma unroll 8
            for (int d = 0; d < hd; ++d) dot += q_s[d] * kj[d];
            s = dot * scale + (1.f - mask[(long long)i * Lk + j0 + lane]) * kMask;
          }
          if (walk == 0) {
            const float m = j0 ? st[0] : -CUDART_INF_F, l = j0 ? st[1] : 0.f;
            const float mn = fmaxf(m, warp_max(s));
            const float ln = l * expf(m - mn) + warp_sum(expf(s - mn));
            if (lane == 0) {
              st[0] = mn;
              st[1] = ln;
            }
          } else {
            const float p = expf(s - st[0]) / st[1];
            float acc[DCH] = {};
            for (int jj = 0; jj < nj; ++jj) {
              const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
              for (int dd = 0; dd < DCH; ++dd)
                if (lane + 32 * dd < hd) acc[dd] += pj * v_s[jj * hd + lane + 32 * dd];
            }
            float* o = out + i * B_.out.sl;
#pragma unroll
            for (int dd = 0; dd < DCH; ++dd) {
              const int d = lane + 32 * dd;
              if (d < hd) o[d] = (j0 ? o[d] : 0.f) + acc[dd];
            }
          }
          __syncwarp();  // q_s is read by every lane before the next row overwrites it
        }
      }
    }
  }
}

// vmr_cq_attention: QANet context-query attention, one block per batch
// element.  c and q pass through shared memory in chunks of R rows; the
// score tiles and S_t^T c sit at the pointers the launch hands in (shared
// memory or this block's slice of the scratch).
struct CqPlan {
  int R;                // rows per chunk of c or q
  int scores_shared;    // S, S_t in shared memory (else scratch)
  int stc_shared;       // S_t^T c in shared memory (else scratch)
  long long scratch_floats;  // per batch element
};

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int rows, int D,
                                          const float* w) {
  const int ds = D + 1;  // padded rows: threads read dst[j][d] for consecutive j
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    const float x = to_f(src[(long long)(r0 + r) * D + d]);
    dst[r * ds + d] = w ? x * w[d] : x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCqThreads)
    cq_kernel(const T* c, const T* q, const T* w4c, const T* w4q, const T* w4m, const T* cmask,
              const T* qmask, T* c2q, T* q2c, float* scratch, int Lc, int Lq, int D,
              CqPlan plan) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int R = plan.R, ds = D + 1;
  float* c_s = smem;            // (R, D+1): a chunk of c (times w4mlu for the scores)
  float* q_s = c_s + R * ds;    // (R, D+1): a chunk of q
  float* s0 = q_s + R * ds;     // (Lc,) c . w4C
  float* s1 = s0 + Lc;          // (Lq,) q . w4Q
  float* w_s = s1 + Lq;         // (D,) w4mlu
  float* free_s = w_s + D;
  float* scr = scratch ? scratch + (long long)b * plan.scratch_floats : nullptr;
  float* S;                     // (Lc, Lq) scores, then the row softmax S_
  if (plan.scores_shared) {
    S = free_s;
    free_s += 2 * Lc * Lq;
  } else {
    S = scr;
    scr += 2LL * Lc * Lq;
  }
  float* St = S + Lc * Lq;      // (Lc, Lq) column softmax S_t, rounded to T
  float* stc = plan.stc_shared ? free_s : scr;  // (Lq, D) S_t^T c, f32

  c += (long long)b * Lc * D;
  q += (long long)b * Lq * D;
  cmask += (long long)b * Lc;
  qmask += (long long)b * Lq;
  for (int d = threadIdx.x; d < D; d += blockDim.x) w_s[d] = to_f(w4m[d]);

  // rank-1 terms: one warp per row of c, then of q, read from device memory
  for (int r = warp; r < Lc + Lq; r += nwarp) {
    const bool is_c = r < Lc;
    const T* row = is_c ? c + (long long)r * D : q + (long long)(r - Lc) * D;
    const T* w = is_c ? w4c : w4q;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += to_f(row[d]) * to_f(w[d]);
    acc = warp_sum(acc);
    if (lane == 0) (is_c ? s0[r] : s1[r - Lc]) = acc;
  }
  __syncthreads();

  // trilinear score: (c * w4mlu) . q + c . w4C + q . w4Q, chunk by chunk
  const int nq = (Lq + R - 1) / R;
  for (int i0 = 0; i0 < Lc; i0 += R) {
    const int ri = min(R, Lc - i0);
    load_rows(c_s, c, i0, ri, D, w_s);
    for (int j0 = 0; j0 < Lq; j0 += R) {
      const int rj = min(R, Lq - j0);
      if (nq > 1 || i0 == 0) load_rows(q_s, q, j0, rj, D, static_cast<const float*>(nullptr));
      __syncthreads();
      for (int idx = threadIdx.x; idx < ri * rj; idx += blockDim.x) {
        const int i = idx / rj, j = idx % rj;
        const float* ci = c_s + i * ds;
        const float* qj = q_s + j * ds;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc += ci[d] * qj[d];
        S[(i0 + i) * Lq + j0 + j] = acc + s0[i0 + i] + s1[j0 + j];
      }
      __syncthreads();
    }
  }

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

  // S_t^T c: (Lq, D), f32, over the chunks of c
  for (int i0 = 0; i0 < Lc; i0 += R) {
    const int ri = min(R, Lc - i0);
    __syncthreads();  // c_s is free (and, first time, S and S_t are final)
    load_rows(c_s, c, i0, ri, D, static_cast<const float*>(nullptr));
    __syncthreads();
    for (int idx = threadIdx.x; idx < Lq * D; idx += blockDim.x) {
      const int j = idx / D, d = idx % D;
      float acc = i0 == 0 ? 0.f : stc[idx];
      for (int i = 0; i < ri; ++i) acc += St[(i0 + i) * Lq + j] * c_s[i * ds + d];
      stc[idx] = acc;
    }
  }

  // c2q = S_ q (S_ rounded to T) and q2c = S_ (S_t^T c) (S_ in f32): the
  // outputs of R rows at a time in registers, over the chunks of q
  c2q += (long long)b * Lc * D;
  q2c += (long long)b * Lc * D;
  for (int i0 = 0; i0 < Lc; i0 += R) {
    const int ri = min(R, Lc - i0);
    float a[kCqAcc], z[kCqAcc];
#pragma unroll
    for (int k = 0; k < kCqAcc; ++k) a[k] = z[k] = 0.f;
    for (int j0 = 0; j0 < Lq; j0 += R) {
      const int rj = min(R, Lq - j0);
      __syncthreads();  // q_s is free; S_t^T c is final
      if (nq > 1 || i0 == 0) load_rows(q_s, q, j0, rj, D, static_cast<const float*>(nullptr));
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kCqAcc; ++k) {
        const int idx = threadIdx.x + k * kCqThreads;
        if (idx < ri * D) {
          const int i = idx / D, d = idx % D;
          const float* row = S + (i0 + i) * Lq + j0;
          for (int j = 0; j < rj; ++j) {
            a[k] += round_to<T>(row[j]) * q_s[j * ds + d];
            z[k] += row[j] * stc[(j0 + j) * D + d];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCqAcc; ++k) {
      const int idx = threadIdx.x + k * kCqThreads;
      if (idx < ri * D) {
        c2q[(long long)i0 * D + idx] = from_f<T>(a[k]);
        q2c[(long long)i0 * D + idx] = from_f<T>(z[k]);
      }
    }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DCH>
int launch_f32(View q, Branch b0, Branch b1, int nbranch, int B, int H, int Lq, int hd,
               float scale, cudaStream_t stream) {
  const size_t bytes = (kF32Chunk * (2 * (size_t)hd + 1) + kF32Warps * (size_t)hd +
                        2 * kF32Rows) * sizeof(float);
  cudaError_t err = allow_smem(attention_f32<DCH>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lq + kF32Rows - 1) / kF32Rows);
  attention_f32<DCH><<<grid, kF32Warps * 32, bytes, stream>>>(q, b0, b1, nbranch, H, Lq, hd,
                                                              scale);
  return (int)cudaGetLastError();
}

template <int HDK>
int launch_mma(View q, Branch b0, Branch b1, int nbranch, int B, int H, int Lq, int hd,
               float scale, cudaStream_t stream) {
  constexpr int RS = 16 * HDK + 8;
  const int nwarp = min(kMaxWarps, (Lq + 15) / 16);
  size_t elems = (size_t)nwarp * 16 * (RS + kMaskRS) + 2 * (size_t)((b0.Lk + 15) & ~15) * RS;
  if (nbranch == 2) elems += 2 * (size_t)((b1.Lk + 15) & ~15) * RS;
  const size_t bytes = elems * sizeof(bf16);
  cudaError_t err = allow_smem(attention_mma<HDK>, bytes);
  if (err != cudaSuccess) return (int)err;
  attention_mma<HDK><<<B * H, nwarp * 32, bytes, stream>>>(q, b0, b1, nbranch, H, Lq, hd, scale);
  return (int)cudaGetLastError();
}

int launch_attention(int dtype, View q, Branch b0, Branch b1, int nbranch, int B, int H, int Lq,
                     int hd, float scale, cudaStream_t stream) {
  if (dtype == 0) {
    switch ((hd + 31) / 32) {
      case 1: return launch_f32<1>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
      case 2: return launch_f32<2>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
      case 3: return launch_f32<3>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
      case 4: return launch_f32<4>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
      case 5: return launch_f32<5>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
      case 6: return launch_f32<6>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
      case 7: return launch_f32<7>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
      case 8: return launch_f32<8>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch ((hd + 15) / 16) {
    case 1: return launch_mma<1>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 2: return launch_mma<2>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 3: return launch_mma<3>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 4: return launch_mma<4>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 5: return launch_mma<5>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 6: return launch_mma<6>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 7: return launch_mma<7>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 8: return launch_mma<8>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_cq(const void* c, const void* q, const void* w4c, const void* w4q, const void* w4m,
              const void* cmask, const void* qmask, void* c2q, void* q2c, float* scratch, int B,
              int Lc, int Lq, int D, CqPlan plan, size_t bytes, cudaStream_t stream) {
  cudaError_t err = allow_smem(cq_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  cq_kernel<T><<<B, kCqThreads, bytes, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(q), static_cast<const T*>(w4c),
      static_cast<const T*>(w4q), static_cast<const T*>(w4m), static_cast<const T*>(cmask),
      static_cast<const T*>(qmask), static_cast<T*>(c2q), static_cast<T*>(q2c), scratch, Lc, Lq,
      D, plan);
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
  return launch_attention(dtype, qv, b0, b0, 1, B, H, Lq, hd, scale,
                          static_cast<cudaStream_t>(stream));
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
  return launch_attention(dtype, qv, self, cross, 2, B, H, L, hd, scale,
                          static_cast<cudaStream_t>(stream));
}

// rows, scores_shared, stc_shared, scratch_floats and shared_bytes are the
// plan of kernels/attention.py::cq_plan; scratch holds B * scratch_floats
// floats, or is null when nothing goes there.
extern "C" int vmr_cq_attention(int dtype, const void* c, const void* q, const void* w4c,
                                const void* w4q, const void* w4m, const void* c_mask,
                                const void* q_mask, void* c2q, void* q2c, void* scratch, int B,
                                int Lc, int Lq, int D, int rows, int scores_shared,
                                int stc_shared, long long scratch_floats,
                                long long shared_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CqPlan plan{rows, scores_shared, stc_shared, scratch_floats};
  float* scr = static_cast<float*>(scratch);
  const size_t bytes = (size_t)shared_bytes;
  return dtype == 1 ? launch_cq<bf16>(c, q, w4c, w4q, w4m, c_mask, q_mask, c2q, q2c, scr, B, Lc,
                                      Lq, D, plan, bytes, s)
                    : launch_cq<float>(c, q, w4c, w4q, w4m, c_mask, q_mask, c2q, q2c, scr, B,
                                       Lc, Lq, D, plan, bytes, s);
}
