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
// same tile over two branches with the Q fragments loaded once.  Past head
// dim 128 (to 256) a warp holding every Q fragment and every output
// accumulator would spill: there the Q fragments are read from the warp's
// staged Q tile at each 16-column step of the scores, and walk 2 runs twice,
// over each half of the output columns (at most 128 each; the scores are
// kept across the halves when there is one chunk, recomputed otherwise).
// P is the same bf16 value in both halves.  The fragment helpers are in
// mma_bf16.cuh, shared with window_attention.cu.
//
// #1/#2, f32: attention_tf32, the same grid, walks and masking on the
// tensor cores: both products on mma.sync m16n8k8 TF32 in the 3xTF32 split
// (each operand x as big = tf32(x) and small = tf32(x - big), rounded as
// cvt.rna rounds; big.small + small.big + big.big summed in f32), which
// keeps ~22 of f32's 24 bits where one TF32 pass keeps 11.  The branches run
// in turn; K and V go to shared memory with 16-byte cp.async copies, whole
// or, when they do not fit, in 64-key chunks (head dims 1-256, any lengths).
// Q's fragments stay in registers to head dim 64 and come from the warp's
// staged Q tile past it.  A chunk's scores stay in registers; with several
// chunks walk 1 keeps them in the warp's score tile in shared memory, so
// that walk 2 reads only V (and one buffer can hold K, then V).  p leaves
// its C layout as the A operand of P.V as it stands (V's B fragments read
// from the matching key rows), and each output is summed in registers over
// every chunk and written once.  Bytes bound it at SeqPAN's serving shapes
// (0.0056 ms for #1, 0.0071 for #2 at B 128, 4 heads of 32, L 64 and 30);
// the splits' conversions, redone by every warp for every fragment, were
// the largest share of its time in an ablation (PERF.md).  The TF32
// helpers are in mma_tf32.cuh, shared with window_attention.cu.
//
// #3: cq_kernel, one block of 16 warps per batch element, as the TPU
// kernel's grid (B,): the column softmax needs every row of c and the row
// softmax every row of q.  At SeqPAN's grids (Lc, Lq of 30..256, D = 128) a
// sample moves ~24-200 KB and does ~1-10 MFLOP, so bytes bound it; what
// sets the real time is the chain of dependent steps between barriers
// (tools/bench_cq.py --phases times each phase).  c and q are staged once,
// in their own type, with 16-byte cp.async copies (rows padded to 16 with
// zeros, 16 more bytes a row so that ldmatrix rows fall on distinct banks);
// the f32 scores S (Lc, Lq) and S_t beside them stay in shared memory.  The
// phases: c . w4C and q . w4Q (a thread a row); the scores; the row and
// column statistics (a lane takes up to 16 values of a line in sequence,
// few shuffle levels); S_ (f32, in place) and S_t (rounded to T), 4 columns
// a thread; then, DO output columns at a time, S_t^T c into shared memory
// and c2q, q2c straight to their outputs, each quad's bf16 pieces
// exchanged by shuffles into 16-byte stores.  Every output column needs
// only the same columns of c and q, so a long query side narrows DO (the
// (Lq, DO) slice of S_t^T c is what must fit), and a D too wide for c and q
// stages DS columns at a time (the scores summed over the chunks, which are
// staged again for the outputs).  Only grids whose scores do not fit (both
// sides past 144, or one past ~540 against 30) keep S and S_t in a device
// scratch (L2-resident).  The plan (DS, DO, where S goes, bytes) is
// kernels/attention.py::cq_plan's.
//   bf16: all four products on mma.sync m16n8k16 with f32 accumulators.
// The scores take c * w4mlu (exact in f32) as hi + lo bf16 A fragments
// (two mmas, each product exact); c2q takes bf16(S_) (the hi part);
// S_t^T c takes S_t (bf16 values) and c by ldmatrix.trans, and is kept as
// hi + lo bf16; q2c = S_ (S_t^T c) as hi.hi + lo.hi + hi.lo (the dropped
// lo.lo is ~2^-16 of each term).
//   f32: the same phases on the CUDA cores in full f32 (TF32 would keep ~3
// digits), each product in 4 x 4 register tiles over float4 loads.
//
// Numerics follow the TPU kernels: f32 scores and softmax, additive -1e30
// masking (a wholly masked row comes out as the uniform average over all
// keys; padding keys beyond Lk are -inf and take no part), probabilities
// rounded to the input type before the value product, output in the input
// type.  CQ keeps the S_ (S_t^T c) association of q2c, S_t rounded to T
// before S_t^T c, S_ rounded to T for c2q and f32 for q2c; its
// probabilities are exp(x - max) times 1 / sum.  T is float or
// __nv_bfloat16; masks are {0,1} in T.
//
// Interface: plain C, loaded with ctypes.  Every entry returns
// cudaGetLastError() after its launch; the Python wrapper raises on non-0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // bf16, quad reductions, cp.async, ldmatrix, mma_bf16, stage
#include "mma_tf32.cuh"  // to_tf32, split_tf32, mma_tf32, mma_3xtf32

namespace {

constexpr float kMask = -1e30f;
constexpr size_t kSharedBytes = 232448;  // what one block may hold in shared memory on an H100
constexpr int kMaxWarps = 8;    // attention_mma, attention_tf32: query tiles of 16 rows a block
constexpr int kTfChunk = 64;    // attention_tf32: keys per score chunk (8 n-tiles) and per staging
constexpr int kTfRowPad = 4;    // attention_tf32: floats after each staged K, V and Q row
constexpr int kTfQRegs = 8;     // attention_tf32: Q's fragments in registers to 8 column steps
constexpr int kTfOutTiles = 16;  // attention_tf32: 8-column output tiles a pass holds, at most
// attention_tf32's modes (kernels/attention.py::F32_MODES)
constexpr int kTfBoth = 0, kTfAlt = 1, kTfChunked = 2;
constexpr int kChunk = 64;      // attention_mma: keys per score chunk (8 mma n-tiles)
constexpr int kMaskRS = kChunk + 8;  // attention_mma: row stride of a warp's mask tile
constexpr int kCqThreads = 512;  // cq_kernel: 16 warps, one block per batch element
constexpr int kCqScorePad = 4;   // cq_kernel: score rows are Lq rounded up to 16, plus 4 floats
constexpr int kCqMmaCols = 16;   // cq_kernel, bf16: chunks of D in 16s (the mma's k; n in pairs)
constexpr int kCqF32Cols = 8;    // cq_kernel, f32: chunks of D in 8s (rows 16 bytes odd apart)

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
// (16 rows of kMaskRS), -inf beyond Lk.  The Q fragments come from qa, or
// with QS from the warp's Q tile q_s, one 16-column step at a time.
template <int HDK, int RS, bool QS>
__device__ __forceinline__ void chunk_scores(float (&s)[8][4],
                                             const uint32_t (&qa)[QS ? 1 : HDK][4],
                                             const bf16* q_s, const bf16* k_s, const bf16* m_s,
                                             int c0, int Lk, int Lkp, float scale, int lane) {
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if constexpr (QS) {
    // each product still sums its 16-column steps in order, as below
#pragma unroll
    for (int kk = 0; kk < HDK; ++kk) {
      uint32_t qf[4];
      ldmatrix_x4(qf, q_s + (r + ((mi & 1) << 3)) * RS + 16 * kk + ((mi >> 1) << 3));
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        if (c0 + 16 * j2 < Lkp) {
          uint32_t kb[4];
          ldmatrix_x4(kb, k_s + (c0 + 16 * j2 + r + ((mi >> 1) << 3)) * RS + ((mi & 1) << 3) +
                              16 * kk);
          mma_bf16(s[2 * j2], qf, kb[0], kb[1]);
          mma_bf16(s[2 * j2 + 1], qf, kb[2], kb[3]);
        }
      }
    }
  } else {
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
// bf16, on the tensor cores.  HDK = head dim padded to 16, over 16 (1-16).
template <int HDK>
__global__ void __launch_bounds__(kMaxWarps * 32)
    attention_mma(View qv, Branch b0, Branch b1, int nbranch, int H, int Lq, int hd,
                  float scale) {
  constexpr int HDP = 16 * HDK, RS = HDP + 8;
  // past head dim 128: Q fragments from shared memory, P.V over OT column
  // tiles of 16 (at most 8) at a time, in NPASS passes
  constexpr bool QS = HDK > 8;
  constexpr int OT = QS ? (HDK + 1) / 2 : HDK, NPASS = (HDK + OT - 1) / OT;
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
    uint32_t qa[QS ? 1 : HDK][4];
    if constexpr (!QS) {
#pragma unroll
      for (int kk = 0; kk < HDK; ++kk)
        ldmatrix_x4(qa[kk], q_s + (r + ((mi & 1) << 3)) * RS + 16 * kk + ((mi >> 1) << 3));
    }
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
        chunk_scores<HDK, RS, QS>(s, qa, q_s, k_s, m_s, c * kChunk, Lk, Lkp, scale, lane);
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

      // walk 2: the normalised probabilities, rounded to bf16, times V, over
      // output column tiles [d0, d0 + OT) in each pass
      bf16* out = static_cast<bf16*>(const_cast<void*>(B_.out.p)) + b * B_.out.sb + h * B_.out.sh;
#pragma unroll
      for (int pass = 0; pass < NPASS; ++pass) {
        const int d0 = pass * OT;
        float o[2 * OT][4];
#pragma unroll
        for (int d = 0; d < 2 * OT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
        for (int c = 0; c < nchunk; ++c) {
          if (nchunk > 1) {
            stage_mask(c * kChunk);
            chunk_scores<HDK, RS, QS>(s, qa, q_s, k_s, m_s, c * kChunk, Lk, Lkp, scale, lane);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int key0 = c * kChunk + 16 * kk;
            if (key0 < Lkp) {
              uint32_t pa[4];
              pa[0] = pack_bf16(__expf(s[2 * kk][0] - m0) * inv0,
                                __expf(s[2 * kk][1] - m0) * inv0);
              pa[1] = pack_bf16(__expf(s[2 * kk][2] - m1) * inv1,
                                __expf(s[2 * kk][3] - m1) * inv1);
              pa[2] = pack_bf16(__expf(s[2 * kk + 1][0] - m0) * inv0,
                                __expf(s[2 * kk + 1][1] - m0) * inv0);
              pa[3] = pack_bf16(__expf(s[2 * kk + 1][2] - m1) * inv1,
                                __expf(s[2 * kk + 1][3] - m1) * inv1);
              const bf16* vrow = v_s + (key0 + r + ((mi & 1) << 3)) * RS + ((mi >> 1) << 3);
#pragma unroll
              for (int dp = 0; dp < OT; ++dp) {
                if (d0 + dp < HDK) {
                  uint32_t vb[4];
                  ldmatrix_x4_trans(vb, vrow + 16 * (d0 + dp));
                  mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
                  mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int d = 0; d < 2 * OT; ++d) {
          const int col = 16 * d0 + 8 * d + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? ra : rb;
            if (row < Lq && col + (e & 1) < hd)
              out[row * B_.out.sl + col + (e & 1)] = __float2bfloat16(o[d][e]);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with q_s before the next tile overwrites it
  }
}

// Rows [0, rows) x cols [0, cols) of a row-major T matrix (row stride sl)
// into a (rows_pad, cols_pad) tile of row stride ds, zero beyond, in 16-byte
// pieces taken by threads tid, tid + nthr, ...: cp.async where the source
// allows, element loads otherwise.  The caller waits.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ds, const T* src, long long sl, int rows,
                                           int rows_pad, int cols, int cols_pad, int tid,
                                           int nthr) {
  constexpr int E = 16 / sizeof(T);
  const bool aligned =
      cols % E == 0 && sl % E == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int pieces = cols_pad / E;
  for (int idx = tid; idx < rows_pad * pieces; idx += nthr) {
    const int r = idx / pieces, c0 = (idx % pieces) * E;
    T* d = dst + r * ds + c0;
    if (aligned && r < rows && c0 < cols) {
      cp_async16(d, src + r * sl + c0);
    } else {
      __align__(16) T tmp[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        tmp[e] = (r < rows && c0 + e < cols) ? src[r * sl + c0 + e] : from_f<T>(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

// The scores of one kTfChunk-key chunk for a warp's 16-row tile, in the
// mma's C layout: s[j] holds keys c0 + 8j + 2t, +1 of rows g (s[j][0..1])
// and g + 8 (s[j][2..3]); 3xTF32 products summed over the head dim's
// 8-column steps in order, scaled, masked with -1e30 by the tile's mask
// rows mr0, mr1 (null past Lq: taken as valid), -inf beyond the chunk's nk
// keys.  k_s holds the chunk's keys from its row 0, rows rs floats apart.
// Q's big and small fragments come from qb, qs, or (QR false) from the
// warp's Q tile q_s, split at each 8-column step.  The mask values are
// loaded first, so that their latency passes under the products.
template <int HD8, bool QR>
__device__ __forceinline__ void tf32_scores(float (&s)[8][4],
                                            const uint32_t (&qb)[QR ? HD8 : 1][4],
                                            const uint32_t (&qs)[QR ? HD8 : 1][4],
                                            const float* q_s, const float* k_s, int rs, int hd8,
                                            const float* mr0, const float* mr1, int c0, int nk,
                                            float scale, int lane) {
  const int g = lane >> 2, t = lane & 3, nt = (nk + 7) >> 3;
  float mk[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      const float* mr = e < 2 ? mr0 : mr1;
      mk[j][e] = mr && col < nk ? mr[c0 + col] : 1.f;
    }
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  }
  // one 8-column step of the head dim: the 8 n-tiles' K fragments, split
  auto step = [&](int kk, const uint32_t (&ab)[4], const uint32_t (&as)[4]) {
    uint32_t kb[8][2], ks[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nt) {
        const float* kr = k_s + (8 * j + g) * rs + 8 * kk + t;
        split_tf32(kr[0], kb[j][0], ks[j][0]);
        split_tf32(kr[4], kb[j][1], ks[j][1]);
      }
    }
    mma_3xtf32<8>(s, 0, ab, as, kb, ks, nt);
  };
  if constexpr (QR) {
    // past the call's hd8, Q's fragments are zero: those steps read K's
    // first columns again and add zero products (no branch between steps)
#pragma unroll
    for (int kk = 0; kk < HD8; ++kk) step(kk < hd8 ? kk : 0, qb[kk], qs[kk]);
  } else {
#pragma unroll 1
    for (int kk = 0; kk < hd8; ++kk) {
      uint32_t ab[4], as[4];
      const float* qr = q_s + g * rs + 8 * kk + t;
      split_tf32(qr[0], ab[0], as[0]);
      split_tf32(qr[8 * rs], ab[1], as[1]);
      split_tf32(qr[4], ab[2], as[2]);
      split_tf32(qr[8 * rs + 4], ab[3], as[3]);
      step(kk, ab, as);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      s[j][e] = col < nk ? s[j][e] * scale + (1.f - mk[j][e]) * kMask : -CUDART_INF_F;
    }
  }
}

// vmr_masked_attention (nbranch = 1) and vmr_dual_attention (nbranch = 2),
// f32, on the tensor cores in 3xTF32.  One block per (batch, head), nwarp
// warps of 16 query rows (kernels/attention.py::attention_f32_plan); the
// branches one after the other, each over every query tile.  K and V rows
// are the head dim rounded up to 8 plus kTfRowPad floats: fragment loads of
// K (row g, column t) and of V (rows 2t, 2t + 1, column g) then hit 32
// distinct banks.  A branch of several kTfChunk-key chunks keeps walk 1's
// masked scores in the warp's score tile (rows of ss floats) where mode
// allows, one chunk keeps them in registers, so that walk 2 reads V alone.
// mode (the same for both branches):
//   kTfBoth:  K and V whole in two buffers of kv_rows rows, staged once;
//   kTfAlt:   one buffer of kv_rows rows, K for walk 1 and V for walk 2 of
//             each round, the block in step (half the shared memory);
//   kTfChunked: one kTfChunk-key chunk of K (walk 1) or of K and V (walk 2)
//             at a time, the scores recomputed in walk 2, the block in step.
// HD8 = the most 8-column steps of the head dim the body is built for (a
// bucket: 4, 8, 16, 24 or 32), the call's own hd8 read at run time.  To
// kTfQRegs Q's fragments are in registers (zero past hd8); past it they
// come from the warp's staged Q tile and the outputs go in NPASS passes of
// OT 8-column tiles.
template <int HD8>
__global__ void __launch_bounds__(kMaxWarps * 32)
    attention_tf32(View qv, Branch b0, Branch b1, int nbranch, int H, int Lq, int hd,
                   float scale, int mode, int kv_rows, int ss) {
  constexpr bool QR = HD8 <= kTfQRegs;
  constexpr int OT = HD8 <= kTfOutTiles ? HD8 : (HD8 + 1) / 2, NPASS = (HD8 + OT - 1) / OT;
  // output tiles whose V fragments are held at once (a divisor of OT)
  constexpr int G = OT <= 8 ? OT : OT % 8 == 0 ? 8 : 4;
  extern __shared__ __align__(16) float tf_smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int hd8 = (hd + 7) >> 3, hdp = 8 * hd8, rs = hdp + kTfRowPad;
  const bool both = mode == kTfBoth, alt = mode == kTfAlt, chunked = mode == kTfChunked;
  float* k_s = tf_smem;                                  // (kv_rows, rs)
  float* v_s = alt ? k_s : k_s + kv_rows * rs;           // (kv_rows, rs)
  float* w_s = v_s + kv_rows * rs;                       // the warps' tiles
  float* q_s = w_s + warp * 16 * rs;                     // this warp's Q tile (QR false)
  float* sc_s = w_s + (QR ? 0 : nwarp * 16 * rs) + warp * 16 * ss;  // its score tile
  const float* q = at<float>(qv, b, h);

  for (int n = 0; n < nbranch; ++n) {
    const Branch& B_ = n ? b1 : b0;
    const int Lk = B_.Lk, nchunk = (Lk + kTfChunk - 1) / kTfChunk;
    const bool keep = nchunk > 1 && !chunked;  // walk 1's scores in the score tile
    const float* kg = at<float>(B_.k, b, h);
    const float* vg = at<float>(B_.v, b, h);
    // keys [c0, c0 + nk) of K and/or V from row 0 of their buffers, the block in step
    auto stage_keys = [&](int c0, int nk, bool keys, bool values) {
      __syncthreads();  // the last keys' readers are done
      if (keys)
        stage_rows(k_s, rs, kg + c0 * B_.k.sl, B_.k.sl, nk, (nk + 7) & ~7, hd, hdp, threadIdx.x,
                   blockDim.x);
      if (values)
        stage_rows(v_s, rs, vg + c0 * B_.v.sl, B_.v.sl, nk, (nk + 7) & ~7, hd, hdp, threadIdx.x,
                   blockDim.x);
      cp_async_wait_all();
      __syncthreads();
    };
    if (both) stage_keys(0, Lk, true, true);
    const int off = chunked ? 0 : kTfChunk * rs;  // a chunk's offset in the buffers
    const float* mask = static_cast<const float*>(B_.mask) + (long long)b * Lq * Lk;
    float* out = static_cast<float*>(const_cast<void*>(B_.out.p)) + b * B_.out.sb +
                 h * B_.out.sh;

    // every warp takes every round (staging keeps the block in step)
    for (int base = 0; base < Lq; base += nwarp * 16) {
      const int i0 = base + warp * 16, ra = i0 + g, rb = ra + 8;
      const bool active = i0 < Lq;
      uint32_t qb[QR ? HD8 : 1][4], qs[QR ? HD8 : 1][4];
      if constexpr (QR) {
#pragma unroll
        for (int kk = 0; kk < HD8; ++kk) {
          const int c = 8 * kk + t;
          split_tf32(ra < Lq && c < hd ? q[ra * qv.sl + c] : 0.f, qb[kk][0], qs[kk][0]);
          split_tf32(rb < Lq && c < hd ? q[rb * qv.sl + c] : 0.f, qb[kk][1], qs[kk][1]);
          split_tf32(ra < Lq && c + 4 < hd ? q[ra * qv.sl + c + 4] : 0.f, qb[kk][2], qs[kk][2]);
          split_tf32(rb < Lq && c + 4 < hd ? q[rb * qv.sl + c + 4] : 0.f, qb[kk][3], qs[kk][3]);
        }
      } else if (active) {
        __syncwarp();  // every lane is done with the last tile
        stage_rows(q_s, rs, q + i0 * qv.sl, qv.sl, min(16, Lq - i0), 16, hd, hdp, lane, 32);
        cp_async_wait_all();
        __syncwarp();
      }
      const float* mr0 = ra < Lq ? mask + (long long)ra * Lk : nullptr;
      const float* mr1 = rb < Lq ? mask + (long long)rb * Lk : nullptr;
      if (alt) stage_keys(0, Lk, true, false);

      // walk 1: row max and sum (rows g and g + 8 of the tile)
      float s[8][4];
      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
      for (int c = 0; c < nchunk; ++c) {
        const int c0 = c * kTfChunk, nk = min(kTfChunk, Lk - c0);
        if (chunked) stage_keys(c0, nk, true, false);
        if (!active) continue;
        tf32_scores<HD8, QR>(s, qb, qs, q_s, k_s + c * off, rs, hd8, mr0, mr1, c0, nk, scale,
                             lane);
        float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          x0 = fmaxf(x0, fmaxf(s[j][0], s[j][1]));
          x1 = fmaxf(x1, fmaxf(s[j][2], s[j][3]));
          if (keep) {
            *reinterpret_cast<float2*>(sc_s + g * ss + c0 + 8 * j + 2 * t) =
                make_float2(s[j][0], s[j][1]);
            *reinterpret_cast<float2*>(sc_s + (g + 8) * ss + c0 + 8 * j + 2 * t) =
                make_float2(s[j][2], s[j][3]);
          }
        }
        const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
        l0 *= expf(m0 - n0);
        l1 *= expf(m1 - n1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          l0 += expf(s[j][0] - n0) + expf(s[j][1] - n0);
          l1 += expf(s[j][2] - n1) + expf(s[j][3] - n1);
        }
        m0 = n0;
        m1 = n1;
      }
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
      if (alt) stage_keys(0, Lk, false, true);

      // walk 2: p = exp(s - m) / l, split, times V over output column tiles
      // [d0, d0 + OT) in each pass, G tiles at a time.  The A operand is p
      // in its C layout as it stands: its k index t is key 2t of the 8, and
      // t + 4 is key 2t + 1; V's B fragments are read from those rows.
#pragma unroll
      for (int pass = 0; pass < NPASS; ++pass) {
        const int d0 = pass * OT;
        float o[OT][4];
#pragma unroll
        for (int d = 0; d < OT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
        for (int c = 0; c < nchunk; ++c) {
          const int c0 = c * kTfChunk, nk = min(kTfChunk, Lk - c0);
          if (chunked) stage_keys(c0, nk, true, true);
          if (!active) continue;
          if (keep) {
            __syncwarp();  // the tile's scores are the warp's own
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 x = *reinterpret_cast<const float2*>(sc_s + g * ss + c0 + 8 * j + 2 * t);
              const float2 y =
                  *reinterpret_cast<const float2*>(sc_s + (g + 8) * ss + c0 + 8 * j + 2 * t);
              s[j][0] = x.x;
              s[j][1] = x.y;
              s[j][2] = y.x;
              s[j][3] = y.y;
            }
          } else if (nchunk > 1) {
            tf32_scores<HD8, QR>(s, qb, qs, q_s, k_s, rs, hd8, mr0, mr1, c0, nk, scale, lane);
          }
          const float* vc = v_s + c * off;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (8 * j < nk) {
              uint32_t pb[4], ps[4];
              split_tf32(expf(s[j][0] - m0) * inv0, pb[0], ps[0]);
              split_tf32(expf(s[j][2] - m1) * inv1, pb[1], ps[1]);
              split_tf32(expf(s[j][1] - m0) * inv0, pb[2], ps[2]);
              split_tf32(expf(s[j][3] - m1) * inv1, pb[3], ps[3]);
              const float* vr = vc + (8 * j + 2 * t) * rs + 8 * d0 + g;
#pragma unroll
              for (int dg = 0; dg < OT; dg += G) {
                const int nd = min(G, hd8 - d0 - dg);  // tiles of this group within the head dim
                uint32_t vb[G][2], vs[G][2];
#pragma unroll
                for (int u = 0; u < G; ++u) {
                  if (u < nd) {
                    split_tf32(vr[8 * (dg + u)], vb[u][0], vs[u][0]);
                    split_tf32(vr[rs + 8 * (dg + u)], vb[u][1], vs[u][1]);
                  }
                }
                mma_3xtf32<G>(o, dg, pb, ps, vb, vs, nd);
              }
            }
          }
        }
        if (!active) continue;
#pragma unroll
        for (int d = 0; d < OT; ++d) {
          const int col = 8 * (d0 + d) + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? ra : rb;
            if (row < Lq && col + (e & 1) < hd) out[row * B_.out.sl + col + (e & 1)] = o[d][e];
          }
        }
      }
    }
  }
}

// vmr_cq_attention: QANet context-query attention, one block of kCqThreads
// per batch element.  The layout of its shared memory (the plan of
// kernels/attention.py::cq_plan), from the front, with Lcp and Lqp the
// lengths rounded up to 16, LS = Lqp + kCqScorePad, PAD = 16 bytes of T:
//   S, Pc  (Lcp, LS) f32 each: the scores, then the row softmax S_ in
//          place, and the column softmax S_t rounded to T (in this block's
//          slice of a device scratch when they do not fit)
//   per row of c: s0 (then the row max), the c_mask term, 1 / the row sum;
//   per row of q: s1 (then the column max), the q_mask term, 1 / the column sum
//   w4mlu, w4C, w4Q over the staged columns (f32)
//   c, q   (Lcp, DS + PAD), (Lqp, DS + PAD) in T: DS columns of each
//   o      (Lqp, DO + PAD): S_t^T c over DO columns (bf16: hi, then lo)

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// (a, b) as two packed bf16 pairs, hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(a - h.x, b - h.y);
}

// max and sum over aligned groups of n lanes (n a power of 2 up to 32)
__device__ __forceinline__ float group_max(float v, int n) {
  for (int o = n >> 1; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int n) {
  for (int o = n >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// M packed bf16 pairs at columns [d, d + 2M) of an output row: one vector
// store where the row allows, element stores at its edge.
template <int M>
__device__ __forceinline__ void store_pairs(bf16* row, int d, int D, const uint32_t (&v)[M]) {
  if (d + 2 * M <= D && D % (2 * M) == 0) {
    if constexpr (M == 4)
      *reinterpret_cast<uint4*>(row + d) = make_uint4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<uint2*>(row + d) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float2 f = unpack_bf16(v[m]);
      if (d + 2 * m < D) row[d + 2 * m] = __float2bfloat16(f.x);
      if (d + 2 * m + 1 < D) row[d + 2 * m + 1] = __float2bfloat16(f.y);
    }
  }
}

// One row of an output tile of 2 NP tiles of 8 columns from column d0, in
// the mma's C layout packed to bf16 pairs: lane t of a quad holds columns
// 8n + 2t, 8n + 2t + 1 of tile n.  Exchanges within the quad (xor 1 over
// tile pairs, then xor 2 over pairs of pairs) leave lane t all 8 columns of
// one tile of each 4 (NP = 1: 4 columns of one of the 2), so that a quad
// stores 64 (32) contiguous bytes instead of 8 pieces of 4.
template <int NP>
__device__ __forceinline__ void store_row(bf16* row, int d0, int D, const uint32_t (&v)[2 * NP],
                                          bool valid) {
  const int t = threadIdx.x & 3;
  const bool odd = t & 1, up = t & 2;
#pragma unroll
  for (int q = 0; q < 2 * NP; q += 4) {
    // xor 1: keep the tiles of this lane's parity, take the partner's piece
    uint32_t lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2 && q + 2 * h < 2 * NP; ++h) {
      const uint32_t keep = odd ? v[q + 2 * h + 1] : v[q + 2 * h];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? v[q + 2 * h] : v[q + 2 * h + 1], 1);
      lo[h] = odd ? got : keep;
      hi[h] = odd ? keep : got;
    }
    if constexpr (NP == 1) {  // lane t: columns 2 (t & 2) .. + 3 of tile t & 1
      const uint32_t w[2] = {lo[0], hi[0]};
      if (valid) store_pairs<2>(row, d0 + 8 * (t & 1) + 2 * (t & 2), D, w);
    } else {  // xor 2: keep tile t of the four, take the partner's two pieces
      const uint32_t k0 = up ? lo[1] : lo[0], k1 = up ? hi[1] : hi[0];
      const uint32_t g0 = __shfl_xor_sync(0xffffffffu, up ? lo[0] : lo[1], 2);
      const uint32_t g1 = __shfl_xor_sync(0xffffffffu, up ? hi[0] : hi[1], 2);
      const uint32_t w[4] = {up ? g0 : k0, up ? g1 : k1, up ? k0 : g0, up ? k1 : g1};
      if (valid) store_pairs<4>(row, d0 + 8 * (q + t), D, w);
    }
  }
}

__device__ __forceinline__ void store4(float* row, int d, int D, const float (&v)[4]) {
  if (d + 3 < D && D % 4 == 0) {
    *reinterpret_cast<float4*>(row + d) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) row[d + e] = v[e];
  }
}

// acc[m][n] += sum_k a[m].k b[n].k: four rows of each, k along the float4
__device__ __forceinline__ void dot4x4(float (&acc)[4][4], const float4 (&a)[4],
                                       const float4 (&b)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      acc[m][n] = fmaf(a[m].x, b[n].x, acc[m][n]);
      acc[m][n] = fmaf(a[m].y, b[n].y, acc[m][n]);
      acc[m][n] = fmaf(a[m].z, b[n].z, acc[m][n]);
      acc[m][n] = fmaf(a[m].w, b[n].w, acc[m][n]);
    }
}

// acc[m][n] += sum_k a[m].k b[k].n: a's rows along k, b's rows along n
__device__ __forceinline__ void mul4x4(float (&acc)[4][4], const float4 (&a)[4],
                                       const float4 (&b)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float am[4] = {a[m].x, a[m].y, a[m].z, a[m].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[m][0] = fmaf(am[k], b[k].x, acc[m][0]);
      acc[m][1] = fmaf(am[k], b[k].y, acc[m][1]);
      acc[m][2] = fmaf(am[k], b[k].z, acc[m][2]);
      acc[m][3] = fmaf(am[k], b[k].w, acc[m][3]);
    }
  }
}

// One chunk of columns [d0, d0 + dw) of c and q into shared memory, dwp
// (dw rounded up to the chunk granule) wide.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* c_s, T* q_s, int CS, const T* c, const T* q, int D,
                                            int d0, int dw, int dwp, int Lc, int Lq, int Lcp,
                                            int Lqp) {
  stage_rows(c_s, CS, c + d0, D, Lc, Lcp, dw, dwp, threadIdx.x, kCqThreads);
  stage_rows(q_s, CS, q + d0, D, Lq, Lqp, dw, dwp, threadIdx.x, kCqThreads);
}

// The rank-1 terms over one staged chunk, s0 += c . w4C and s1 += q . w4Q:
// a thread a row, 16 bytes of it at a time into E independent sums (the
// staged rows and the weights are 0 past dw, up to dwp; a quarter warp's
// 16-byte reads fall on distinct banks, rows being an odd number of 16
// bytes apart).
template <typename T>
__device__ __forceinline__ void cq_rank1(const T* c_s, const T* q_s, int CS, const float* wc,
                                         const float* wq, float* s0, float* s1, int Lc, int Lq,
                                         int dwp) {
  constexpr int E = 16 / sizeof(T);
  for (int r = threadIdx.x; r < Lc + Lq; r += kCqThreads) {
    const bool is_c = r < Lc;
    const T* row = is_c ? c_s + r * CS : q_s + (r - Lc) * CS;
    const float* w = is_c ? wc : wq;
    float acc[E] = {};
    for (int d = 0; d < dwp; d += E) {
      const uint4 piece = *reinterpret_cast<const uint4*>(row + d);
      const T* v = reinterpret_cast<const T*>(&piece);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += to_f(v[e]) * w[d + e];
    }
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) sum += acc[e];
    (is_c ? s0[r] : s1[r - Lc]) += sum;
  }
}

// S (+)= (c * w4mlu) q^T over one staged chunk, bf16, on the tensor cores.
// c * w4mlu is exact in f32 (a product of two bf16) and goes in as hi + lo
// bf16 A fragments, so every product is exact, summed in f32.  A warp per
// 16 rows of c by 16 rows of q; the last chunk adds the rank-1 terms.
__device__ __forceinline__ void cq_scores(const bf16* c_s, const bf16* q_s, int CS,
                                          const float* w_s, float* S, int LS, const float* s0,
                                          const float* s1, int Lcp, int Lqp, int dwp, bool first,
                                          bool last) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r = lane & 7;
  const int nt = Lqp / 16;
  for (int u = threadIdx.x >> 5; u < (Lcp / 16) * nt; u += kCqThreads / 32) {
    const int i0 = (u / nt) * 16, j0 = (u % nt) * 16;
    const bf16* arow = c_s + (i0 + r + ((mi & 1) << 3)) * CS + ((mi >> 1) << 3);
    const bf16* brow = q_s + (j0 + r + ((mi >> 1) << 3)) * CS + ((mi & 1) << 3);
    float s[2][4] = {};
    for (int k0 = 0; k0 < dwp; k0 += 16) {
      uint32_t a[4], bq[4], hi[4], lo[4];
      ldmatrix_x4(a, arow + k0);
      ldmatrix_x4(bq, brow + k0);
      const float2 wa = *reinterpret_cast<const float2*>(w_s + k0 + 2 * t);
      const float2 wb = *reinterpret_cast<const float2*>(w_s + k0 + 2 * t + 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a[0], a[1]: columns 2t, 2t + 1; a[2], a[3]: 8 more
        const float2 x = unpack_bf16(a[e]), w = e < 2 ? wa : wb;
        split_bf16(x.x * w.x, x.y * w.y, hi[e], lo[e]);
      }
      mma_bf16(s[0], hi, bq[0], bq[1]);
      mma_bf16(s[1], hi, bq[2], bq[3]);
      mma_bf16(s[0], lo, bq[0], bq[1]);
      mma_bf16(s[1], lo, bq[2], bq[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + (e & 2) * 4, j = j0 + 8 * n + 2 * t + (e & 1);
        float v = s[n][e];
        if (!first) v += S[i * LS + j];
        if (last) v = v + s0[i] + s1[j];
        S[i * LS + j] = v;
      }
  }
}

// The same in f32 on the CUDA cores: 4 x 4 register tiles, rows
// ib + k Lcp/4 of c by rows jb + k Lqp/4 of q (neighbouring threads read
// neighbouring rows of q), four columns a step.
__device__ __forceinline__ void cq_scores(const float* c_s, const float* q_s, int CS,
                                          const float* w_s, float* S, int LS, const float* s0,
                                          const float* s1, int Lcp, int Lqp, int dwp, bool first,
                                          bool last) {
  const int rm = Lcp / 4, rn = Lqp / 4;
  for (int idx = threadIdx.x; idx < rm * rn; idx += kCqThreads) {
    const int ib = idx / rn, jb = idx % rn;
    float acc[4][4] = {};
    for (int d = 0; d < dwp; d += 4) {
      const float4 w = *reinterpret_cast<const float4*>(w_s + d);
      float4 a[4], b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = *reinterpret_cast<const float4*>(c_s + (ib + k * rm) * CS + d);
        a[k] = make_float4(a[k].x * w.x, a[k].y * w.y, a[k].z * w.z, a[k].w * w.w);
        b[k] = *reinterpret_cast<const float4*>(q_s + (jb + k * rn) * CS + d);
      }
      dot4x4(acc, a, b);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = ib + m * rm, j = jb + n * rn;
        float v = acc[m][n];
        if (!first) v += S[i * LS + j];
        if (last) v = v + s0[i] + s1[j];
        S[i * LS + j] = v;
      }
  }
}

// Row and column statistics of the softmaxes (max, and 1 / sum of exp)
// under the -1e30 mask terms; tile padding (rows >= Lc, columns >= Lq)
// takes no part.  A group of lanes a line, the fewest (a power of 2) that
// leave a lane at most 16 of its values, taken in sequence; row groups from
// the first warp up, column groups (neighbouring lanes on neighbouring
// columns) from the last warp down, so that the two overlap.
__device__ __forceinline__ void cq_stats(const float* S, int LS, int Lc, int Lq, const float* cmt,
                                         const float* qmt, float* rmax, float* rinv, float* cmax,
                                         float* cinv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = kCqThreads / 32;
  int gw = 1, cw = 1;
  while (gw < 32 && 16 * gw < Lq) gw <<= 1;
  while (cw < 32 && 16 * cw < Lc) cw <<= 1;
  const int rpw = 32 / gw, sub = lane / gw, gl = lane % gw;
  for (int i0 = warp * rpw; i0 < Lc; i0 += nwarp * rpw) {
    const int i = i0 + sub;
    const float* row = S + i * LS;
    float mx = -CUDART_INF_F, sum = 0.f;
    if (i < Lc) {
#pragma unroll 4
      for (int j = gl; j < Lq; j += gw) mx = fmaxf(mx, row[j] + qmt[j]);
    }
    mx = group_max(mx, gw);
    if (i < Lc) {
#pragma unroll 4
      for (int j = gl; j < Lq; j += gw) sum += __expf(row[j] + qmt[j] - mx);
    }
    sum = group_sum(sum, gw);
    if (i < Lc && gl == 0) {
      rmax[i] = mx;
      rinv[i] = 1.f / sum;
    }
  }
  const int cpw = 32 / cw, jj = lane % cpw, rl = lane / cpw;
  for (int j0 = (nwarp - 1 - warp) * cpw; j0 < Lq; j0 += nwarp * cpw) {
    const int j = j0 + jj;
    float mx = -CUDART_INF_F, sum = 0.f;
    if (j < Lq) {
#pragma unroll 4
      for (int i = rl; i < Lc; i += cw) mx = fmaxf(mx, S[i * LS + j] + cmt[i]);
    }
    for (int o = cpw; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (j < Lq) {
#pragma unroll 4
      for (int i = rl; i < Lc; i += cw) sum += __expf(S[i * LS + j] + cmt[i] - mx);
    }
    for (int o = cpw; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (j < Lq && rl == 0) {
      cmax[j] = mx;
      cinv[j] = 1.f / sum;
    }
  }
}

// S becomes S_ (f32) in place and Pc S_t rounded to T, 4 columns a thread;
// both 0 on the tile padding, so that it adds nothing to the products.
template <typename T>
__device__ __forceinline__ void cq_softmax(float* S, float* Pc, int LS, int Lc, int Lq, int Lcp,
                                           int Lqp, const float* cmt, const float* qmt,
                                           const float* rmax, const float* rinv,
                                           const float* cmax, const float* cinv) {
  const int n4 = Lqp / 4;
  for (int idx = threadIdx.x; idx < Lcp * n4; idx += kCqThreads) {
    const int i = idx / n4, j0 = 4 * (idx % n4);
    const float4 x4 = *reinterpret_cast<const float4*>(S + i * LS + j0);
    const float4 qm4 = *reinterpret_cast<const float4*>(qmt + j0);
    const float4 cm4 = *reinterpret_cast<const float4*>(cmax + j0);
    const float4 ci4 = *reinterpret_cast<const float4*>(cinv + j0);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w}, qm[4] = {qm4.x, qm4.y, qm4.z, qm4.w};
    const float cm[4] = {cm4.x, cm4.y, cm4.z, cm4.w}, ci[4] = {ci4.x, ci4.y, ci4.z, ci4.w};
    float pr[4] = {}, pc[4] = {};
    if (i < Lc) {
      const float ct = cmt[i], rm = rmax[i], ri = rinv[i];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e < Lq) {
          pr[e] = __expf(x[e] + qm[e] - rm) * ri;
          pc[e] = round_to<T>(__expf(x[e] + ct - cm[e]) * ci[e]);
        }
    }
    *reinterpret_cast<float4*>(S + i * LS + j0) = make_float4(pr[0], pr[1], pr[2], pr[3]);
    *reinterpret_cast<float4*>(Pc + i * LS + j0) = make_float4(pc[0], pc[1], pc[2], pc[3]);
  }
}

// The widest unit of 16 np columns (np 2 or 1) that divides W and still
// gives every warp one, over `tiles` row tiles of 16.
__device__ __forceinline__ int unit_pairs(int tiles, int W) {
  int np = 2;
  while (np > 1 && (W % (16 * np) || tiles * (W / (16 * np)) < kCqThreads / 32)) np >>= 1;
  return np;
}

// S_t^T c for query rows [j0, j0 + 16) by columns [n0, n0 + 16 NP) of the
// staged c (bf16, on the tensor cores): the A fragments are S_t^T read from
// Pc (bf16 values already), the B fragments c by ldmatrix.trans.  Stored as
// hi and lo bf16, so that q2c's product keeps f32 accuracy.
template <int NP>
__device__ __forceinline__ void stc_tile(const float* Pc, int LS, const bf16* c_s, int CS,
                                         bf16* o_s, bf16* lo_s, int OS, int Lcp, int j0, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r = lane & 7;
  float acc[2 * NP][4] = {};
  for (int i0 = 0; i0 < Lcp; i0 += 16) {
    const float* p = Pc + (i0 + 2 * t) * LS + j0 + g;  // A (m = query row, k = context row)
    uint32_t a[4];
    a[0] = pack_bf16(p[0], p[LS]);
    a[1] = pack_bf16(p[8], p[LS + 8]);
    a[2] = pack_bf16(p[8 * LS], p[9 * LS]);
    a[3] = pack_bf16(p[8 * LS + 8], p[9 * LS + 8]);
    const bf16* brow = c_s + (i0 + r + ((mi & 1) << 3)) * CS + n0 + ((mi >> 1) << 3);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, brow + 16 * np);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (j0 + g + 8 * h) * OS + n0 + 8 * n + 2 * t;
      uint32_t hi, lo;
      split_bf16(acc[n][2 * h], acc[n][2 * h + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(o_s + off) = hi;
      *reinterpret_cast<uint32_t*>(lo_s + off) = lo;
    }
}

// c2q = bf16(S_) q and q2c = S_ (S_t^T c) for context rows [i0, i0 + 16)
// by columns [n0, n0 + 16 NP) of the sub-chunk (col0 + n0 of the output):
// S_ as hi + lo bf16 A fragments (hi is bf16(S_), c2q's operand, rounded
// where the plain version rounds); q2c as hi.hi + lo.hi + hi.lo.
template <int NP>
__device__ __forceinline__ void out_tile(const float* Pr, int LS, const bf16* q_s, int CS,
                                         const bf16* o_s, const bf16* lo_s, int OS, int Lqp,
                                         int Lc, int D, int i0, int n0, int col0, bf16* c2q,
                                         bf16* q2c) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r = lane & 7;
  float x[2 * NP][4] = {}, z[2 * NP][4] = {};
  for (int j0 = 0; j0 < Lqp; j0 += 16) {
    const float* p = Pr + (i0 + g) * LS + j0 + 2 * t;
    uint32_t ah[4], al[4];
    const float2 v0 = *reinterpret_cast<const float2*>(p);
    const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * LS);
    const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * LS + 8);
    split_bf16(v0.x, v0.y, ah[0], al[0]);
    split_bf16(v1.x, v1.y, ah[1], al[1]);
    split_bf16(v2.x, v2.y, ah[2], al[2]);
    split_bf16(v3.x, v3.y, ah[3], al[3]);
    const int br = j0 + r + ((mi & 1) << 3), bc = n0 + ((mi >> 1) << 3);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, q_s + br * CS + bc + 16 * np);
      mma_bf16(x[2 * np], ah, b[0], b[1]);
      mma_bf16(x[2 * np + 1], ah, b[2], b[3]);
      ldmatrix_x4_trans(b, o_s + br * OS + bc + 16 * np);
      mma_bf16(z[2 * np], ah, b[0], b[1]);
      mma_bf16(z[2 * np + 1], ah, b[2], b[3]);
      mma_bf16(z[2 * np], al, b[0], b[1]);
      mma_bf16(z[2 * np + 1], al, b[2], b[3]);
      ldmatrix_x4_trans(b, lo_s + br * OS + bc + 16 * np);
      mma_bf16(z[2 * np], ah, b[0], b[1]);
      mma_bf16(z[2 * np + 1], ah, b[2], b[3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + g + 8 * h;
    uint32_t px[2 * NP], pz[2 * NP];
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
      px[n] = pack_bf16(x[n][2 * h], x[n][2 * h + 1]);
      pz[n] = pack_bf16(z[n][2 * h], z[n][2 * h + 1]);
    }
    store_row<NP>(c2q + (long long)i * D, col0 + n0, D, px, i < Lc);
    store_row<NP>(q2c + (long long)i * D, col0 + n0, D, pz, i < Lc);
  }
}

// S_t^T c over W columns of the staged chunk (c_s points at the first),
// bf16: a warp per unit of 16 query rows by 16 np columns.
__device__ __forceinline__ void cq_stc(const float* Pc, int LS, const bf16* c_s, int CS, bf16* o_s,
                                       int OS, int Lc, int Lcp, int Lqp, int W) {
  const int tiles = Lqp / 16, np = unit_pairs(tiles, W), nu = W / (16 * np);
  bf16* lo_s = o_s + Lqp * OS;
  for (int u = threadIdx.x >> 5; u < tiles * nu; u += kCqThreads / 32) {
    const int j0 = (u / nu) * 16, n0 = (u % nu) * 16 * np;
    if (np == 2) stc_tile<2>(Pc, LS, c_s, CS, o_s, lo_s, OS, Lcp, j0, n0);
    else stc_tile<1>(Pc, LS, c_s, CS, o_s, lo_s, OS, Lcp, j0, n0);
  }
}

// The same in f32 on the CUDA cores: 4 x 4 register tiles of 4 query rows
// by 4 columns, neighbouring threads on neighbouring columns.
__device__ __forceinline__ void cq_stc(const float* Pc, int LS, const float* c_s, int CS,
                                       float* o_s, int OS, int Lc, int Lcp, int Lqp, int W) {
  const int tn = W / 4;
  for (int idx = threadIdx.x; idx < (Lqp / 4) * tn; idx += kCqThreads) {
    const int jb = 4 * (idx / tn), db = 4 * (idx % tn);
    float acc[4][4] = {};
    for (int i = 0; i < Lc; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(Pc + i * LS + jb);
      const float4 cv = *reinterpret_cast<const float4*>(c_s + i * CS + db);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        acc[m][0] = fmaf(pv[m], cv.x, acc[m][0]);
        acc[m][1] = fmaf(pv[m], cv.y, acc[m][1]);
        acc[m][2] = fmaf(pv[m], cv.z, acc[m][2]);
        acc[m][3] = fmaf(pv[m], cv.w, acc[m][3]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
      *reinterpret_cast<float4*>(o_s + (jb + m) * OS + db) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
}

// c2q and q2c over W columns of the staged chunk, written at output column
// col0; bf16: a warp per unit of 16 context rows by 16 np columns.
__device__ __forceinline__ void cq_out(const float* Pr, int LS, const bf16* q_s, int CS,
                                       const bf16* o_s, int OS, int Lc, int Lcp, int Lq, int Lqp,
                                       int D, int W, int col0, bf16* c2q, bf16* q2c) {
  const int tiles = Lcp / 16, np = unit_pairs(tiles, W), nu = W / (16 * np);
  const bf16* lo_s = o_s + Lqp * OS;
  for (int u = threadIdx.x >> 5; u < tiles * nu; u += kCqThreads / 32) {
    const int i0 = (u / nu) * 16, n0 = (u % nu) * 16 * np;
    if (np == 2)
      out_tile<2>(Pr, LS, q_s, CS, o_s, lo_s, OS, Lqp, Lc, D, i0, n0, col0, c2q, q2c);
    else
      out_tile<1>(Pr, LS, q_s, CS, o_s, lo_s, OS, Lqp, Lc, D, i0, n0, col0, c2q, q2c);
  }
}

// f32: 4 x 4 register tiles of 4 context rows by 4 columns; c2q and q2c
// share the S_ loads (in f32, bf16(S_) is S_ itself).
__device__ __forceinline__ void cq_out(const float* Pr, int LS, const float* q_s, int CS,
                                       const float* o_s, int OS, int Lc, int Lcp, int Lq, int Lqp,
                                       int D, int W, int col0, float* c2q, float* q2c) {
  const int tn = W / 4, Lq4 = (Lq + 3) & ~3;
  for (int idx = threadIdx.x; idx < (Lcp / 4) * tn; idx += kCqThreads) {
    const int ib = 4 * (idx / tn), db = 4 * (idx % tn);
    float x[4][4] = {}, z[4][4] = {};
    for (int j = 0; j < Lq4; j += 4) {
      float4 a[4], bq[4], bo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = *reinterpret_cast<const float4*>(Pr + (ib + k) * LS + j);
        bq[k] = *reinterpret_cast<const float4*>(q_s + (j + k) * CS + db);
        bo[k] = *reinterpret_cast<const float4*>(o_s + (j + k) * OS + db);
      }
      mul4x4(x, a, bq);
      mul4x4(z, a, bo);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (ib + m < Lc) {
        store4(c2q + (long long)(ib + m) * D, col0 + db, D, x[m]);
        store4(q2c + (long long)(ib + m) * D, col0 + db, D, z[m]);
      }
  }
}

// Instrumentation, compiled only into the instances of the entry
// vmr_cq_attention_clocked (tools/bench_cq.py --phases): every thread keeps
// the SM clocks since its last mark in phase p's register, each mark right
// after the barrier that ends its phase (rank1 of an early chunk has none);
// thread 0 writes its block's row at the end.
enum CqPhase { kStage, kRank1, kScores, kStats, kSoftmax, kRestage, kStc, kOut, kCqPhases };

template <bool CLK> struct CqMarks {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void write(long long*) {}
};

template <> struct CqMarks<true> {
  long long t, acc[kCqPhases];
  __device__ __forceinline__ void start() {
    t = clock64();
#pragma unroll
    for (int p = 0; p < kCqPhases; ++p) acc[p] = 0;
  }
  __device__ __forceinline__ void mark(int p) {
    const long long now = clock64();
    acc[p] += now - t;
    t = now;
  }
  __device__ __forceinline__ void write(long long* clocks) {
    if (threadIdx.x == 0)
#pragma unroll
      for (int p = 0; p < kCqPhases; ++p) clocks[blockIdx.x * kCqPhases + p] = acc[p];
  }
};

// SH: S and Pc in shared memory (else in the scratch).  DS: columns of c
// and q staged at a time; DO: columns of S_t^T c and of the outputs at a
// time (kernels/attention.py::cq_plan).  CLK: the instrumented instance,
// which writes (B, kCqPhases) clocks.
template <typename T, bool SH, bool CLK>
__global__ void __launch_bounds__(kCqThreads)
    cq_kernel(const T* c, const T* q, const T* w4c, const T* w4q, const T* w4m, const T* cmask,
              const T* qmask, T* c2q, T* q2c, float* scratch, int Lc, int Lq, int D, int DS,
              int DO, long long* clocks) {
  extern __shared__ __align__(16) unsigned char cq_smem[];
  constexpr int PAD = 16 / sizeof(T), G = sizeof(T) == 2 ? kCqMmaCols : kCqF32Cols;
  const int b = blockIdx.x;
  const int Lcp = (Lc + 15) & ~15, Lqp = (Lq + 15) & ~15, LS = Lqp + kCqScorePad;
  const int CS = DS + PAD, OS = DO + PAD, nch = (D + DS - 1) / DS;
  float* f_s = reinterpret_cast<float*>(cq_smem);
  float* S = SH ? f_s : scratch + (long long)b * 2 * Lcp * LS;
  float* Pc = S + Lcp * LS;
  float* s0 = f_s + (SH ? 2 * Lcp * LS : 0);  // then the row max
  float* cmt = s0 + Lcp;
  float* rinv = cmt + Lcp;
  float* s1 = rinv + Lcp;  // then the column max
  float* qmt = s1 + Lqp;
  float* cinv = qmt + Lqp;
  float* w_s = cinv + Lqp;  // w4mlu, w4C, w4Q over the staged columns
  T* c_s = reinterpret_cast<T*>(w_s + 3 * DS);
  T* q_s = c_s + Lcp * CS;
  T* o_s = q_s + Lqp * CS;

  c += (long long)b * Lc * D;
  q += (long long)b * Lq * D;
  c2q += (long long)b * Lc * D;
  q2c += (long long)b * Lc * D;
  cmask += (long long)b * Lc;
  qmask += (long long)b * Lq;
  CqMarks<CLK> marks;
  marks.start();

  // pass 1: the scores, over the chunks of DS columns
  for (int k = 0; k < nch; ++k) {
    const int d0 = k * DS, dw = min(DS, D - d0), dwp = (dw + G - 1) / G * G;
    if (k > 0) {
      __syncthreads();  // the last chunk's readers are done
      marks.mark(kScores);
    }
    stage_chunk(c_s, q_s, CS, c, q, D, d0, dw, dwp, Lc, Lq, Lcp, Lqp);
    if (k == 0) {  // while the first chunk is in flight
      for (int i = threadIdx.x; i < Lcp; i += kCqThreads) {
        s0[i] = 0.f;
        cmt[i] = i < Lc ? (1.f - to_f(cmask[i])) * kMask : 0.f;
      }
      for (int j = threadIdx.x; j < Lqp; j += kCqThreads) {
        s1[j] = 0.f;
        qmt[j] = j < Lq ? (1.f - to_f(qmask[j])) * kMask : 0.f;
      }
    }
    for (int d = threadIdx.x; d < dwp; d += kCqThreads) {
      const bool in = d < dw;
      w_s[d] = in ? to_f(w4m[d0 + d]) : 0.f;
      w_s[DS + d] = in ? to_f(w4c[d0 + d]) : 0.f;
      w_s[2 * DS + d] = in ? to_f(w4q[d0 + d]) : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    marks.mark(kStage);
    cq_rank1(c_s, q_s, CS, w_s + DS, w_s + 2 * DS, s0, s1, Lc, Lq, dwp);
    if (k == nch - 1) __syncthreads();  // s0, s1 are final before the scores add them
    marks.mark(kRank1);
    cq_scores(c_s, q_s, CS, w_s, S, LS, s0, s1, Lcp, Lqp, dwp, k == 0, k == nch - 1);
  }
  __syncthreads();
  marks.mark(kScores);
  cq_stats(S, LS, Lc, Lq, cmt, qmt, s0, rinv, s1, cinv);
  __syncthreads();
  marks.mark(kStats);
  cq_softmax<T>(S, Pc, LS, Lc, Lq, Lcp, Lqp, cmt, qmt, s0, rinv, s1, cinv);

  // pass 2: per chunk (the last one first: it is still staged), S_t^T c and
  // then c2q and q2c, DO columns at a time
  for (int k = nch - 1; k >= 0; --k) {
    const int d0 = k * DS, dw = min(DS, D - d0), dwp = (dw + G - 1) / G * G;
    if (k != nch - 1) {
      __syncthreads();  // the last chunk's readers are done
      marks.mark(kOut);
      stage_chunk(c_s, q_s, CS, c, q, D, d0, dw, dwp, Lc, Lq, Lcp, Lqp);
      cp_async_wait_all();
    }
    for (int e0 = 0; e0 < dwp; e0 += DO) {
      const int W = min(DO, dwp - e0);
      __syncthreads();  // S_, S_t and the staged chunk are final; o_s is free
      if (e0 > 0)
        marks.mark(kOut);
      else if (k == nch - 1)
        marks.mark(kSoftmax);
      else
        marks.mark(kRestage);
      cq_stc(Pc, LS, c_s + e0, CS, o_s, OS, Lc, Lcp, Lqp, W);
      __syncthreads();
      marks.mark(kStc);
      cq_out(S, LS, q_s + e0, CS, o_s, OS, Lc, Lcp, Lq, Lqp, D, W, d0 + e0, c2q, q2c);
    }
  }
  if constexpr (CLK) {
    __syncthreads();
    marks.mark(kOut);
    marks.write(clocks);
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// attention_tf32's plan, computed by kernels/attention.py::attention_f32_plan.
struct Tf32Plan {
  int mode, nwarp, kv_rows, ss;
  size_t bytes;
};

template <int HD8>
int launch_tf32(View q, Branch b0, Branch b1, int nbranch, int B, int H, int Lq, int hd,
                float scale, const Tf32Plan& plan, cudaStream_t stream) {
  cudaError_t err = allow_smem(attention_tf32<HD8>, plan.bytes);
  if (err != cudaSuccess) return (int)err;
  attention_tf32<HD8><<<B * H, plan.nwarp * 32, plan.bytes, stream>>>(
      q, b0, b1, nbranch, H, Lq, hd, scale, plan.mode, plan.kv_rows, plan.ss);
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
                     int hd, float scale, const Tf32Plan& plan, cudaStream_t stream) {
  if (dtype == 0) {
    // head dims in buckets of 32, 64, 128, 192 and 256 (the call's own
    // 8-column steps read at run time)
    const int hd8 = (hd + 7) / 8;
    if (hd8 < 1 || hd8 > 32) return (int)cudaErrorInvalidValue;
    const auto launch = hd8 <= 4 ? launch_tf32<4> : hd8 <= 8 ? launch_tf32<8>
                        : hd8 <= 16 ? launch_tf32<16> : hd8 <= 24 ? launch_tf32<24>
                        : launch_tf32<32>;
    return launch(q, b0, b1, nbranch, B, H, Lq, hd, scale, plan, stream);
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
    case 9: return launch_mma<9>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 10: return launch_mma<10>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 11: return launch_mma<11>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 12: return launch_mma<12>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 13: return launch_mma<13>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 14: return launch_mma<14>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 15: return launch_mma<15>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    case 16: return launch_mma<16>(q, b0, b1, nbranch, B, H, Lq, hd, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool SH, bool CLK>
int launch_cq(const void* c, const void* q, const void* w4c, const void* w4q, const void* w4m,
              const void* cmask, const void* qmask, void* c2q, void* q2c, float* scratch, int B,
              int Lc, int Lq, int D, int DS, int DO, size_t bytes, cudaStream_t stream,
              long long* clocks) {
  cudaError_t err = allow_smem(cq_kernel<T, SH, CLK>, bytes);
  if (err != cudaSuccess) return (int)err;
  cq_kernel<T, SH, CLK><<<B, kCqThreads, bytes, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(q), static_cast<const T*>(w4c),
      static_cast<const T*>(w4q), static_cast<const T*>(w4m), static_cast<const T*>(cmask),
      static_cast<const T*>(qmask), static_cast<T*>(c2q), static_cast<T*>(q2c), scratch, Lc, Lq,
      D, DS, DO, clocks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cq_plan(const void* c, const void* q, const void* w4c, const void* w4q,
                   const void* w4m, const void* cmask, const void* qmask, void* c2q, void* q2c,
                   void* scratch, int B, int Lc, int Lq, int D, int DS, int DO, int shared,
                   long long shared_bytes, void* stream, void* clocks) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  long long* clk = static_cast<long long*>(clocks);
  const size_t bytes = (size_t)shared_bytes;
#define VMR_CQ_LAUNCH(SH, CLK) \
  launch_cq<T, SH, CLK>(c, q, w4c, w4q, w4m, cmask, qmask, c2q, q2c, scr, B, Lc, Lq, D, DS, DO, \
                        bytes, s, clk)
  if (clk != nullptr) return shared ? VMR_CQ_LAUNCH(true, true) : VMR_CQ_LAUNCH(false, true);
  return shared ? VMR_CQ_LAUNCH(true, false) : VMR_CQ_LAUNCH(false, false);
#undef VMR_CQ_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  mode, nwarp,
// kv_rows, ss and shared_bytes are the f32 body's plan
// (kernels/attention.py::attention_f32_plan); the bf16 body ignores them.
extern "C" int vmr_masked_attention(int dtype, const void* q, long long q_sb, long long q_sh,
                                    long long q_sl, const void* k, long long k_sb,
                                    long long k_sh, long long k_sl, const void* v,
                                    long long v_sb, long long v_sh, long long v_sl,
                                    const void* mask, void* out, long long o_sb, long long o_sh,
                                    long long o_sl, int B, int H, int Lq, int Lk, int hd,
                                    float scale, int mode, int nwarp, int kv_rows, int ss,
                                    long long shared_bytes, void* stream) {
  const View qv{q, q_sb, q_sh, q_sl};
  const Branch b0{{k, k_sb, k_sh, k_sl}, {v, v_sb, v_sh, v_sl}, {out, o_sb, o_sh, o_sl}, mask,
                  Lk};
  return launch_attention(dtype, qv, b0, b0, 1, B, H, Lq, hd, scale,
                          {mode, nwarp, kv_rows, ss, (size_t)shared_bytes},
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
                                  int hd, float scale, int mode, int nwarp, int kv_rows, int ss,
                                  long long shared_bytes, void* stream) {
  const View qv{q, q_sb, q_sh, q_sl};
  const Branch self{{fk, fk_sb, fk_sh, fk_sl}, {fv, fv_sb, fv_sh, fv_sl},
                    {s_out, so_sb, so_sh, so_sl}, s_mask, L};
  const Branch cross{{tk, tk_sb, tk_sh, tk_sl}, {tv, tv_sb, tv_sh, tv_sl},
                     {x_out, xo_sb, xo_sh, xo_sl}, x_mask, M};
  return launch_attention(dtype, qv, self, cross, 2, B, H, L, hd, scale,
                          {mode, nwarp, kv_rows, ss, (size_t)shared_bytes},
                          static_cast<cudaStream_t>(stream));
}

// stage_cols, out_cols, scores_shared and shared_bytes are the plan of
// kernels/attention.py::cq_plan; scratch holds B * 2 * Lcp * (Lqp + 4)
// floats when the scores are not shared, else it is null.
extern "C" int vmr_cq_attention(int dtype, const void* c, const void* q, const void* w4c,
                                const void* w4q, const void* w4m, const void* c_mask,
                                const void* q_mask, void* c2q, void* q2c, void* scratch, int B,
                                int Lc, int Lq, int D, int stage_cols, int out_cols,
                                int scores_shared, long long shared_bytes, void* stream) {
  const auto launch = dtype == 1 ? launch_cq_plan<bf16> : launch_cq_plan<float>;
  return launch(c, q, w4c, w4q, w4m, c_mask, q_mask, c2q, q2c, scratch, B, Lc, Lq, D, stage_cols,
                out_cols, scores_shared, shared_bytes, stream, nullptr);
}

// The same, writing each block's SM clocks per phase (CqPhase) to clocks, a
// (B, 8) int64 array: a measurement of tools/bench_cq.py --phases.
extern "C" int vmr_cq_attention_clocked(int dtype, const void* c, const void* q, const void* w4c,
                                        const void* w4q, const void* w4m, const void* c_mask,
                                        const void* q_mask, void* c2q, void* q2c, void* scratch,
                                        int B, int Lc, int Lq, int D, int stage_cols,
                                        int out_cols, int scores_shared, long long shared_bytes,
                                        void* stream, void* clocks) {
  const auto launch = dtype == 1 ? launch_cq_plan<bf16> : launch_cq_plan<float>;
  return launch(c, q, w4c, w4q, w4m, c_mask, q_mask, c2q, q2c, scratch, B, Lc, Lq, D, stage_cols,
                out_cols, scores_shared, shared_bytes, stream, clocks);
}
