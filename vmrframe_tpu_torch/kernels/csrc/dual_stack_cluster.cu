// Hopper (sm_90a) body of kernel #4, the whole dual-attention stack, at the
// widths one block cannot hold: D = 640, 768, 896 and 1024, as one launch of
// a thread-block cluster of D / 128 CTAs a sample.
//
//   vmr_dual_stack_cluster  <- vmrframe_tpu/kernels/dual_stack.py::dual_attention_stack
//                              (_stack_kernel), D 640-1024
//
// It computes what csrc/dual_stack.cu computes (the C entry there sends D
// past 512 here), with that body's rounding points: fn, tn, k, v, the
// probabilities and every matmul operand rounded to T; LN, softmax, the
// sigmoid and all sums in f32; nothing rounded between the layers.  Only the
// order of the sums differs.
//
// What bounds it: operations, as at the narrower widths (12 F D^2 + 2 T D^2
// multiply-adds of projections a call, tools/bench_stack.py::stack_work),
// but five (R, D + 4) f32 buffers of a row tile no longer fit one block's
// 227 KB past D 512 (D 640: 206 KB at 16 rows, before any weight slot).
//
// Design.  A cluster of c = D / 128 CTAs (5-8, the portable sizes) a
// sample; CTA r owns columns [128 r, 128 r + 128) of every activation: five
// (kCTile, 132) f32 buffers, as D 128 lays out a row tile, and the same
// columns of the sample's rows in device memory (the inputs, the first
// layer's results, the keys and values), which no other CTA reads.  c is a
// run-time argument: the instances depend on the type and the head class
// only.  What crosses CTAs goes through distributed shared memory
// (cooperative_groups::this_cluster, map_shared_rank), with cluster.sync()
// wherever the next step reads another CTA's columns or overwrites columns
// another CTA may still read, and once before exit:
//   - LayerNorm (LN1, LNT, LN2): each CTA reduces its 128 columns of a row;
//     the c partial sums are added in rank order in every CTA (the same mean
//     and variance bit for bit), the mean first, then the mean of the squared
//     deviations (the TPU kernel's two passes).
//   - Products: out[:, own 128] = A[:, 0:D] W[0:D, own 128].  A's 128-column
//     k-chunks are copied one at a time from their owners' buffers into a
//     local slot (As; the own chunk is read in place), W's own column slice
//     streams from L2 in chunks of rows through two slots (cp.async), bf16 on
//     mma.sync m16n8k16 (a 16-row band and 16 columns a warp), f32 on the
//     CUDA cores (2 rows a warp, 4 columns a lane).  Bias, the BiLinear's
//     2 b + xb, the gate, gate * values and both residuals are column-local.
//   - Attention: a head is cut at the slice edges into pieces of at most 128
//     columns (a CTA holds at most two pieces of heads that cross an edge);
//     tasks of 16 query rows and one piece are dealt over the CTA's warps.
//     K and V come from kv_scratch for the CTA's own columns only, staged as
//     at D 128.  A piece of a head that crosses an edge first writes its
//     partial scores, q.k over its own columns, into an exchange slot of its
//     CTA (in mma fragment order); after cluster.sync() every piece of that
//     head adds the head's partials in rank order, so all of them hold the
//     same scores, the same max, sum and probabilities, and each takes P.V
//     over its own columns of V into its own columns of the context.  So q,
//     K, V and the context never leave their owner; the exchange slots
//     alternate between two sets, one cluster.sync() a stage of keys.  The
//     walks are those of dual_stack.cuh: one stage of up to kCStage keys,
//     else chunks (bf16 twice: max and sum, then p rounded and P.V; f32 once
//     with the max and sum rescaled).
// Head classes (the divisors of D): exact, multiples of 4 up to 128, pieces
// on 4-column boundaries, loops unrolled to 128 with zeros past the piece;
// wide, 160-1024, multiples of 32 (pieces of 32-128 columns on 32-column
// boundaries, looped to at run time, V through ldmatrix); narrow, 1, 2, 3,
// 5, 6, 7, 10 and 14 (q, K and the context read element by element, k 16).
// Each (row, piece)'s max and sum between the chunks of a longer side stay
// in shared memory: at most 128 pieces (head dim 1) of 32 rows.
//
// Launch: cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension (c, 1,
// 1) over B c CTAs of 512 threads.  The entry checks
// cudaOccupancyMaxActiveClusters for that cluster and shared memory and
// returns the error (the wrapper raises) if it is 0, if the shared-memory
// attribute is refused or if the launch fails: nothing falls back.

#include <cooperative_groups.h>

#include "dual_stack.cuh"  // the single-CTA body's helpers (Act, load4, pack_pair, scores_*, Walk)

namespace cg = cooperative_groups;

namespace {

constexpr int kSlice = 128;       // the columns a CTA owns
constexpr int kMinCluster = 5;    // D 640: the first width past the single-CTA ones
constexpr int kMaxCluster = 8;    // D 1024: the largest portable cluster
constexpr int kCTile = 32;        // rows of a tile
constexpr int kCStage = 32;       // keys of a stage, and of a longer side's chunk
constexpr int kCLD = kSlice + 4;  // f32 row stride of the buffers
constexpr int kCKS = kSlice + 8;  // bf16 row stride of staged K, V and weight rows
constexpr int kCBuf = kCTile * kCLD;
constexpr int kCWK = 128;  // bf16 weight rows a slot: one operand chunk's
constexpr int kCKC = 64;   // f32 weight rows a slot
constexpr int kCWFloats = kCWK * kCKS;  // two bf16 slots of kCWK rows
constexpr int kCNarrowHD = 16;  // the narrow heads' bound: one k-step of 16, two n-tiles
constexpr int kCMaxHeadDim = kSlice * kMaxCluster;  // one head of D 1024
constexpr int kCMaxPieces = kSlice;                 // a CTA's pieces: 128 at head dim 1
constexpr int kRowGroups = kCTile / kRows;
constexpr int kCNT = kCStage / 8;         // n-tiles of 8 keys a stage
constexpr int kXTask = kCNT * 4 * 32;     // one task's score fragments
constexpr int kXFloats = 2 * 2 * kRowGroups * kXTask;  // [set][slot L, R][row group]
constexpr int kCStatFloats = 2 * kCTile * kCMaxPieces;
// A, Bf, C, Dq, E, As; the weight slots; the exchange; the statistics; the
// LN partials (2 kCTile) and means; the tile rows' and the keys' validity
constexpr int kCSmemFloats =
    6 * kCBuf + kCWFloats + kXFloats + kCStatFloats + 4 * kCTile + kCStage;

static_assert(kCLD == L<kSlice>::kLD && kCKS == L<kSlice>::kKS, "the D 128 row strides");
static_assert(kCSmemFloats * 4 <= kSmemLimit, "the layout fits a block");
static_assert(2 * kCKC * kSlice <= kCWFloats, "f32 weight slots");
static_assert(kCStage * kCLD <= kCBuf && kCStage * kCKS / 2 <= kCBuf,
              "a stage's keys fit a buffer");
static_assert(kCTile % kRows == 0 && kWarps == 8 * kRowGroups && kCTile == 2 * kWarps,
              "gemm_c's map: 8 warps a 16-row band in bf16, 2 rows a warp in f32");
static_assert(kSlice % kCWK == 0 && kSlice % kCKC == 0 && kCWK % 16 == 0 && kCKC % 4 == 0,
              "whole weight chunks in each 128-row k-chunk");
static_assert(kCMaxHeadDim > kSliceHD && kCNarrowHD == 2 * 8, "the classes' loops");

enum HeadClass { kClsExact, kClsWide, kClsNarrow };

// The block's shared memory, rebuilt from smem_base() where it is used.
struct CSmem {
  float *A, *Bf, *C, *Dq, *E, *As, *wbuf, *X, *stat, *lnx, *lmu, *fm, *km;
  __device__ explicit CSmem(float* s) {
    A = s, Bf = A + kCBuf, C = Bf + kCBuf, Dq = C + kCBuf, E = Dq + kCBuf, As = E + kCBuf;
    wbuf = As + kCBuf, X = wbuf + kCWFloats, stat = X + kXFloats, lnx = stat + kCStatFloats;
    lmu = lnx + 2 * kCTile, fm = lmu + kCTile, km = fm + kCTile;
  }
};

// This CTA's place in its cluster.
struct Clu {
  int rank, n, D;  // its rank, the cluster's CTAs (D / 128), the width
  __device__ int col0() const { return kSlice * rank; }
};

// a's rows from row0 on, rows of D
template <typename T> __device__ __forceinline__ Act act_rows_c(Act a, int row0, int D) {
  const long long n = (long long)row0 * D;
  return a.f32 ? Act{static_cast<const float*>(a.p) + n, true}
               : Act{static_cast<const T*>(a.p) + n, false};
}

// LayerNorm of M rows over the whole width, a warp a row and a lane 4 of the
// CTA's 128 columns: the partial sums of the c CTAs added in rank order, the
// mean first, then the mean of the squared deviations.  The result (own
// columns) is rounded to T.  row4(r, c): the row's 4 values from own column
// c.  Holds two cluster barriers; out is written after the second.
template <typename T, typename Row4>
__device__ __forceinline__ void layer_norm_c(const Clu& cl, int M, Row4 row4, const float* scale,
                                             const float* bias, float* out) {
  const CSmem sm(smem_base());
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = lane * 4;
  const float inv_d = 1.f / cl.D;
  for (int r = warp; r < M; r += kWarps) {
    const float4 x = row4(r, c);
    const float sum = warp_sum(x.x + x.y + x.z + x.w);
    if (lane == 0) sm.lnx[r] = sum;
  }
  cluster.sync();
  for (int r = warp; r < M; r += kWarps) {
    float sum = 0.f;
    for (int k = 0; k < cl.n; ++k) sum += *cluster.map_shared_rank(sm.lnx + r, k);
    const float mu = sum * inv_d;
    float4 x = row4(r, c);
    x.x -= mu, x.y -= mu, x.z -= mu, x.w -= mu;
    const float sq = warp_sum(x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w);
    if (lane == 0) sm.lnx[kCTile + r] = sq, sm.lmu[r] = mu;
  }
  cluster.sync();
  const float4 s = load4(scale + cl.col0() + c), b = load4(bias + cl.col0() + c);
  for (int r = warp; r < M; r += kWarps) {
    float sq = 0.f;
    for (int k = 0; k < cl.n; ++k) sq += *cluster.map_shared_rank(sm.lnx + kCTile + r, k);
    const float inv = rsqrtf(sq * inv_d + kLnEps), mu = sm.lmu[r];
    const float4 x = row4(r, c);
    store4(out + r * kCLD + c,
           make_float4(round_to<T>((x.x - mu) * inv * s.x + b.x),
                       round_to<T>((x.y - mu) * inv * s.y + b.y),
                       round_to<T>((x.z - mu) * inv * s.z + b.z),
                       round_to<T>((x.w - mu) * inv * s.w + b.w)));
  }
}

// W rows [k0, k0 + R) x the CTA's 128 columns (row stride D) into slot
// `slot` with 16-byte cp.async copies; one commit group.  bf16 rows of kCKS,
// f32 rows of kSlice.
template <typename T>
__device__ __forceinline__ void stage_w(float* wbuf, int slot, const T* W, int k0, int D,
                                        int col0) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  constexpr int R = kBf ? kCWK : kCKC, kRS = kBf ? kCKS : kSlice;
  constexpr int kRow = kSlice * (int)sizeof(T) / 16;  // 16-byte pieces a row
  T* dst = reinterpret_cast<T*>(wbuf) + slot * R * kRS;
  const T* src = W + (long long)k0 * D + col0;
  for (int p = threadIdx.x; p < R * kRow; p += kThreads) {
    const int r = p / kRow, c = p % kRow * (16 / (int)sizeof(T));
    cp_async16(dst + r * kRS + c, src + (long long)r * D + c);
  }
  cp_async_commit();
}

// out(r, c) = sum_k A0[r][k] W[k][col0 + c] (+ the same over A1 when NA is
// 2) for r < M and the CTA's 128 columns c, handed to epi(r, c, sum).  A0,
// A1: buffers that every CTA of the cluster holds at the same place, each
// with its own 128 columns of the operand; chunk kc of the k range is rank
// kc's (copied into As unless it is this CTA's).  Every CTA's operand
// columns must be written before the call (a cluster barrier), and stay
// unchanged until every CTA has returned.  Operands are rounded to bf16 as
// they are read (bf16: pack_pair); W streams in chunks of R rows through
// two slots.  Ends with a block barrier.
template <typename T, int NA, typename Epi>
__device__ __forceinline__ void gemm_c(const Clu& cl, const float* A0, const float* A1, int M,
                                       const T* W, Epi epi) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  constexpr int R = kBf ? kCWK : kCKC, kPer = kSlice / R;
  const CSmem sm(smem_base());
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t = lane & 3, mi = lane >> 3, r8 = lane & 7;
  // bf16: rows r0.. r0 + 15, columns cb.. cb + 15; f32: rows r0, r0 + 1,
  // columns cb.. cb + 3
  const int r0 = kBf ? warp / 8 * 16 : 2 * warp, cb = kBf ? warp % 8 * 16 : 4 * lane;
  const bool active = r0 < M;
  const int nchunk = NA * cl.n * kPer;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  auto w_row = [&](int g) { return (g / kPer % cl.n) * kSlice + g % kPer * R; };
  stage_w<T>(sm.wbuf, 0, W, w_row(0), cl.D, cl.col0());
  const float* Ak = A0;
  for (int g = 0; g < nchunk; ++g) {
    const int kc = g / kPer, owner = kc % cl.n;
    if (g + 1 < nchunk) stage_w<T>(sm.wbuf, (g + 1) & 1, W, w_row(g + 1), cl.D, cl.col0());
    if (g % kPer == 0) {
      const float* Abuf = kc < cl.n ? A0 : A1;
      if (owner == cl.rank) {
        Ak = Abuf;
      } else {
        const float* rem = cluster.map_shared_rank(Abuf, owner);
        for (int i = threadIdx.x; i < kCTile * (kSlice / 4); i += kThreads) {
          const int r = i / (kSlice / 4), c = i % (kSlice / 4) * 4;
          store4(sm.As + r * kCLD + c, load4(rem + r * kCLD + c));
        }
        Ak = sm.As;
      }
    }
    if (g + 1 < nchunk)
      cp_async_wait<1>();  // chunk g has landed; g + 1 is in flight behind the copy above
    else
      cp_async_wait<0>();
    __syncthreads();
    const int ko = g % kPer * R;
    if (active) {
      if constexpr (kBf) {
        const bf16* slot = reinterpret_cast<const bf16*>(sm.wbuf) + (g & 1) * R * kCKS;
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk) {
          const float* ap = Ak + (r0 + g8) * kCLD + ko + 16 * kk + 2 * t;
          const uint32_t a[4] = {pack_pair(ap), pack_pair(ap + 8 * kCLD), pack_pair(ap + 8),
                                 pack_pair(ap + 8 * kCLD + 8)};
          uint32_t b[4];
          ldmatrix_x4_trans(b, slot + (16 * kk + r8 + ((mi & 1) << 3)) * kCKS + cb +
                                   ((mi >> 1) << 3));
          mma_bf16(acc[0], a, b[0], b[1]);
          mma_bf16(acc[1], a, b[2], b[3]);
        }
      } else {
        const float* wb = sm.wbuf + (g & 1) * R * kSlice + cb;
        const float* a0p = Ak + r0 * kCLD + ko;
#pragma unroll 2
        for (int kk = 0; kk < R; kk += 4) {
          const float4 a0 = load4(a0p + kk), a1 = load4(a0p + kCLD + kk);
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const float4 w = load4(wb + (kk + k4) * kSlice);
            const float x0 = pick(a0, k4), x1 = pick(a1, k4);
            acc[0][0] = fmaf(x0, w.x, acc[0][0]), acc[0][1] = fmaf(x0, w.y, acc[0][1]);
            acc[0][2] = fmaf(x0, w.z, acc[0][2]), acc[0][3] = fmaf(x0, w.w, acc[0][3]);
            acc[1][0] = fmaf(x1, w.x, acc[1][0]), acc[1][1] = fmaf(x1, w.y, acc[1][1]);
            acc[1][2] = fmaf(x1, w.z, acc[1][2]), acc[1][3] = fmaf(x1, w.w, acc[1][3]);
          }
        }
      }
    }
    __syncthreads();  // the slot and As are read before they are refilled
  }
  if (active) {
    if constexpr (kBf) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cb + 8 * j + 2 * t, ra = r0 + g8, rb = ra + 8;
        if (ra < M) epi(ra, col, acc[j][0]), epi(ra, col + 1, acc[j][1]);
        if (rb < M) epi(rb, col, acc[j][2]), epi(rb, col + 1, acc[j][3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (r0 + i >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(r0 + i, cb + j, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// Keys [c0, c0 + NK) of K (and, with V, of V), the CTA's 128 columns (kg,
// vg at its first column, rows of stride D, already rounded), into the rows
// of kb (and vb), zero beyond Tn; their validity into km.  As stage_keys.
template <typename T, int NK, bool V>
__device__ __forceinline__ void stage_keys_c(float* kb, float* vb, float* km, const T* kg,
                                             const T* vg, const float* km_g, int c0, int Tn,
                                             int D) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kRow = kSlice * (int)sizeof(T) / 16;
  constexpr int kPieces = NK * kRow, kAll = (V ? 2 : 1) * kPieces;
  constexpr int kPer = (kAll + kThreads - 1) / kThreads;
  constexpr bool kWhole = kPer * kThreads == kAll;
  const int n = min(NK, Tn - c0);
  const int j0 = threadIdx.x;
  const float kmv = j0 < n ? __ldcg(km_g + c0 + j0) : 0.f;
  uint4 x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads, m = idx / kPieces;
    const int j = idx % kPieces / kRow, c = idx % kRow * (16 / (int)sizeof(T));
    const T* src = (m ? vg : kg) + (long long)(c0 + j) * D + c;
    x[i] = j < n && (kWhole || idx < kAll) ? __ldcg(reinterpret_cast<const uint4*>(src))
                                           : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads, m = idx / kPieces;
    const int j = idx % kPieces / kRow, c = idx % kRow * (16 / (int)sizeof(T));
    if (!kWhole && idx >= kAll) continue;
    float* dst = m ? vb : kb;
    if constexpr (kBf16)
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(dst) + j * kCKS + c) = x[i];
    else
      *reinterpret_cast<uint4*>(dst + j * kCLD + c) = x[i];
  }
  if (j0 < NK) km[j0] = kmv;
}

// Rows [0, M) of two buffers (values already rounded) to device memory in T
// at the CTA's columns (kg, vg at its first column, rows of stride D).
template <typename T>
__device__ __forceinline__ void store_rows_c(const float* k, const float* v, int M, T* kg, T* vg,
                                             int D) {
  constexpr int kQ = kSlice / 4;
  for (int idx = threadIdx.x; idx < 2 * M * kQ; idx += kThreads) {
    const int m = idx / (M * kQ), r = idx % (M * kQ) / kQ, c = idx % kQ * 4;
    store4((m ? vg : kg) + (long long)r * D + c, load4((m ? v : k) + r * kCLD + c));
  }
}

// The heads over this CTA's columns: piece p is head h0 + p's columns in the
// slice, local [c0(p), c0(p) + w(p)).
struct Pieces {
  int hd, rank, h0, n;
  __device__ Pieces(int hd_, int rank_)
      : hd(hd_), rank(rank_), h0(kSlice * rank_ / hd_),
        n((kSlice * (rank_ + 1) - 1) / hd_ - kSlice * rank_ / hd_ + 1) {}
  __device__ int c0(int p) const { return max((h0 + p) * hd - kSlice * rank, 0); }
  __device__ int w(int p) const {
    return min((h0 + p + 1) * hd - kSlice * rank, kSlice) - c0(p);
  }
  __device__ int first(int h) const { return h * hd / kSlice; }  // the ranks holding head h
  __device__ int last(int h) const { return ((h + 1) * hd - 1) / kSlice; }
  __device__ bool straddles(int p) const { return first(h0 + p) != last(h0 + p); }
  // head h's exchange slot in rank r: R (1) where the head starts, L (0) in
  // the ranks it reaches from the left (at most one of each a rank)
  __device__ int slot(int h, int r) const { return r == first(h) ? 1 : 0; }
};

// scores_bf16 for the narrow heads' pieces (at most 16 columns from any
// column c0, possibly odd): q and K read one element at a time, k 16.
template <int NT>
__device__ __forceinline__ void scores_narrow16(float (&s)[NT][4], const float* q, const bf16* ks,
                                                int ra, int c0, int g, int t, int w) {
  const int c = 2 * t;
  const bool e0 = c < w, e1 = c + 1 < w, e2 = c + 8 < w, e3 = c + 9 < w;
  const float* qa = q + ra * kCLD + c0 + c;
  const uint32_t a[4] = {pack_bf16(e0 ? qa[0] : 0.f, e1 ? qa[1] : 0.f),
                         pack_bf16(e0 ? qa[8 * kCLD] : 0.f, e1 ? qa[8 * kCLD + 1] : 0.f),
                         pack_bf16(e2 ? qa[8] : 0.f, e3 ? qa[9] : 0.f),
                         pack_bf16(e2 ? qa[8 * kCLD + 8] : 0.f, e3 ? qa[8 * kCLD + 9] : 0.f)};
  const unsigned short* k16 = reinterpret_cast<const unsigned short*>(ks) + c0 + c;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const unsigned short* kp = k16 + (8 * j + g) * kCKS;
    const uint32_t b0 = (e0 ? (uint32_t)kp[0] : 0u) | (e1 ? (uint32_t)kp[1] << 16 : 0u);
    const uint32_t b1 = (e2 ? (uint32_t)kp[8] : 0u) | (e3 ? (uint32_t)kp[9] << 16 : 0u);
    mma_bf16(s[j], a, b0, b1);
  }
}

// s = q K^T over a piece's w columns from c0 for the task's rows (ra = r0 +
// g and ra + 8), the NT n-tiles of staged keys: HDB the class's bound (a
// loop to w at run time past kSliceHD).
template <typename T, int HDB, bool kNarrow, int NT>
__device__ __forceinline__ void piece_scores(float (&s)[NT][4], const float* q, const float* kb,
                                             int ra, int c0, int w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if constexpr (std::is_same<T, bf16>::value) {
    if constexpr (kNarrow)
      scores_narrow16<NT>(s, q, reinterpret_cast<const bf16*>(kb), ra, c0, g, t, w);
    else
      scores_bf16<kSlice, HDB, NT, false>(s, q, reinterpret_cast<const bf16*>(kb), ra, c0, g, t,
                                          w);
  } else {
    scores_tf32<kSlice, HDB, NT>(s, q, kb, ra, c0, g, t, w);
  }
}

// The rest of one warp task once it holds the head's scores s (summed over
// every piece of the head): attend_task's mask, softmax walk W and P.V, the
// latter over the piece's own w columns from c0 of the values staged in vb
// into out.  Each (row, piece)'s max and sum is at stat + 2 (row P + p).
template <typename T, int HDB, bool kNarrow, int NT, Walk W>
__device__ __forceinline__ void piece_finish(float (&s)[NT][4], float* out, const float* vb,
                                             const float* fm, const float* km, float* stat,
                                             int r0, int p, int P, int c0, int w, int n,
                                             float scale, bool first, bool last) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int ND = (HDB + 7) / 8, G = ND < 4 ? ND : 4;
  static_assert(!kBf16 || NT % 2 == 0, "bf16 P.V takes keys 16 at a time");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = ra + 8;

  const float fa = fm[ra], fb = fm[rb];
  float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 kv = *reinterpret_cast<const float2*>(km + 8 * j + 2 * t);  // 0 from n on
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + (e & 1);
      const float valid = (e & 2 ? fb : fa) * (e & 1 ? kv.y : kv.x);
      s[j][e] = key < n ? s[j][e] * scale + (1.f - valid) * kMask : -INFINITY;
      if (e & 2)
        xb = fmaxf(xb, s[j][e]);
      else
        xa = fmaxf(xa, s[j][e]);
    }
  }
  xa = quad_max(xa), xb = quad_max(xb);

  float* sa = stat + 2 * (ra * P + p);
  float* sb = stat + 2 * (rb * P + p);
  float ma = xa, mb = xb, la = 0.f, lb = 0.f, fa_ = 1.f, fb_ = 1.f;
  if constexpr (W == kProbs) {
    ma = sa[0], la = sa[1], mb = sb[0], lb = sb[1];
  } else if constexpr (W == kStats || W == kOnline) {
    const float moa = first ? -INFINITY : sa[0], mob = first ? -INFINITY : sb[0];
    la = first ? 0.f : sa[1], lb = first ? 0.f : sb[1];
    ma = fmaxf(moa, xa), mb = fmaxf(mob, xb);
    fa_ = softmax_exp<T>(moa - ma), fb_ = softmax_exp<T>(mob - mb);
  }
  float ea = 0.f, eb = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = softmax_exp<T>(s[j][e] - (e & 2 ? mb : ma));
      if (e & 2)
        eb += s[j][e];
      else
        ea += s[j][e];
    }
  if constexpr (W != kProbs) {
    ea = quad_sum(ea), eb = quad_sum(eb);
    la = la * fa_ + ea, lb = lb * fb_ + eb;
  }
  if constexpr (W == kStats || W == kOnline) {
    __syncwarp();
    if (t == 0) sa[0] = ma, sa[1] = la, sb[0] = mb, sb[1] = lb;
  }
  if constexpr (W == kStats) return;
  const float ia = 1.f / la, ib = 1.f / lb;
  if constexpr (W == kOne || W == kProbs) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= e & 2 ? ib : ia;
  }

  uint32_t pa[kBf16 ? NT / 2 : 1][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  }
  float* oa = out + ra * kCLD + c0;
  float* ob = out + rb * kCLD + c0;
  head_steps<HDB, 8 * G>(w, [&](int step) {
    const int d0 = G * step;
    float o[G][4];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int col = 8 * (d0 + u) + 2 * t;
      if (W == kOne || first || col >= w) {
        o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
      } else if constexpr (kNarrow) {
        const bool e1 = col + 1 < w;
        o[u][0] = oa[col] * fa_, o[u][1] = e1 ? oa[col + 1] * fa_ : 0.f;
        o[u][2] = ob[col] * fb_, o[u][3] = e1 ? ob[col + 1] * fb_ : 0.f;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(oa + col);
        const float2 b = *reinterpret_cast<const float2*>(ob + col);
        o[u][0] = a.x * fa_, o[u][1] = a.y * fa_, o[u][2] = b.x * fb_, o[u][3] = b.y * fb_;
      }
    }
    if constexpr (kBf16) {
      // the wide heads' pieces start on 32 columns: V through ldmatrix.trans;
      // the others in pairs of elements, zero past w
      const bf16* vs = reinterpret_cast<const bf16*>(vb);
      const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if constexpr (HDB > kSliceHD) {
          const bf16* vr = vs + (16 * kk + r8 + ((mi & 1) << 3)) * kCKS + c0 + 8 * d0;
#pragma unroll
          for (int u = 0; u < G; u += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vr + 8 * u + ((mi >> 1) << 3));
            mma_bf16(o[u], pa[kk], b[0], b[1]);
            mma_bf16(o[u + 1], pa[kk], b[2], b[3]);
          }
        } else {
          const unsigned short* v16 =
              reinterpret_cast<const unsigned short*>(vs) + c0 + 8 * d0 + g;
          const int k0 = 16 * kk + 2 * t;
#pragma unroll
          for (int u = 0; u < G; ++u) {
            const bool ok = 8 * (d0 + u) + g < w;
            auto pair = [&](int k) {
              return ok ? (uint32_t)v16[k * kCKS + 8 * u] |
                              (uint32_t)v16[(k + 1) * kCKS + 8 * u] << 16
                        : 0u;
            };
            mma_bf16(o[u], pa[kk], pair(k0), pair(k0 + 8));
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ab[4], as[4], bb[G][2], bs[G][2];
        split_tf32(s[j][0], ab[0], as[0]);
        split_tf32(s[j][2], ab[1], as[1]);
        split_tf32(s[j][1], ab[2], as[2]);
        split_tf32(s[j][3], ab[3], as[3]);
        const float* vr = vb + (8 * j + 2 * t) * kCLD + c0 + g;
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const int d = 8 * (d0 + u);
          const bool ok = d + g < w;
          split_tf32(ok ? vr[d] : 0.f, bb[u][0], bs[u][0]);
          split_tf32(ok ? vr[kCLD + d] : 0.f, bb[u][1], bs[u][1]);
        }
        mma_3xtf32<G>(o, 0, ab, as, bb, bs, G);
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int col = 8 * (d0 + u) + 2 * t;
      if (col >= w) continue;
      float2 a = make_float2(o[u][0], o[u][1]), b = make_float2(o[u][2], o[u][3]);
      if (W == kOne || last) {
        if constexpr (W == kOnline)
          a.x *= ia, a.y *= ia, b.x *= ib, b.y *= ib;
        a.x = round_to<T>(a.x), a.y = round_to<T>(a.y), b.x = round_to<T>(b.x);
        b.y = round_to<T>(b.y);
      }
      if constexpr (kNarrow) {
        oa[col] = a.x, ob[col] = b.x;
        if (col + 1 < w) oa[col + 1] = a.y, ob[col + 1] = b.y;
      } else {
        *reinterpret_cast<float2*>(oa + col) = a;
        *reinterpret_cast<float2*>(ob + col) = b;
      }
    }
  });
}

// One stage of keys for every (16 rows, piece) task below M.  When a head
// crosses a slice edge (the head dim does not divide 128), the pieces of
// such heads first write their partial scores to exchange set `set`, and
// after a cluster barrier every piece of a crossing head adds the partials
// of all its ranks in rank order.  Ends with a block barrier.
template <typename T, int HDB, bool kNarrow, Walk W>
__device__ __forceinline__ void attend_stage_c(const Clu& cl, const Pieces& pc, const float* q,
                                               float* out, int M, const float* kb,
                                               const float* vb, int set, int n, bool first,
                                               bool last) {
  constexpr int NT = kCNT;
  const CSmem sm(smem_base());
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (M + kRows - 1) / kRows;
  const float scale = 1.f / sqrtf((float)pc.hd);
  const bool crossing = kSlice % pc.hd != 0;  // the same in every CTA of the cluster
  auto xslot = [&](int slot, int rg) {
    return sm.X + ((set * 2 + slot) * kRowGroups + rg) * kXTask + lane;
  };
  if (crossing) {
    int sp[2], ns = 0;
    if (pc.straddles(0)) sp[ns++] = 0;
    if (pc.n > 1 && pc.straddles(pc.n - 1)) sp[ns++] = pc.n - 1;
    for (int task = warp; task < groups * ns; task += kWarps) {
      const int rg = task / ns, p = sp[task % ns];
      float s[NT][4];
      piece_scores<T, HDB, kNarrow, NT>(s, q, kb, rg * kRows + (lane >> 2), pc.c0(p), pc.w(p));
      float* xs = xslot(pc.slot(pc.h0 + p, cl.rank), rg);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[(4 * j + e) * 32] = s[j][e];
    }
    cluster.sync();
  }
  for (int task = warp; task < groups * pc.n; task += kWarps) {
    const int rg = task / pc.n, p = task % pc.n, r0 = rg * kRows;
    float s[NT][4];
    if (crossing && pc.straddles(p)) {
      const int h = pc.h0 + p;
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int r = pc.first(h); r <= pc.last(h); ++r) {
        const float* xs = cluster.map_shared_rank(xslot(pc.slot(h, r), rg), r);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += xs[(4 * j + e) * 32];
      }
    } else {
      piece_scores<T, HDB, kNarrow, NT>(s, q, kb, r0 + (lane >> 2), pc.c0(p), pc.w(p));
    }
    __syncwarp();  // every lane has read its q before out (q itself in place) is written
    piece_finish<T, HDB, kNarrow, NT, W>(s, out, vb, sm.fm, sm.km, sm.stat, r0, p, pc.n,
                                         pc.c0(p), pc.w(p), n, scale, first, last);
  }
  __syncthreads();
}

// H-head attention of a tile's M query rows (the buffer at q_at, rounded to
// T, own columns) over Tn keys whose K and V (own columns, from kg and vg)
// are in device memory; the context, rounded to T, goes to the buffer at
// out_at.  As attention() in dual_stack.cuh at D 128's staging: K in Bf, V in
// C or (a longer side, when C is out) at v_at.  set: the exchange set the
// first stage uses; returns the next one (sets alternate from stage to
// stage, so that a set is rewritten only after the cluster barrier of the
// stage between).
template <typename T, int HDB, bool kNarrow>
__device__ __noinline__ int attention_c(Clu cl, int q_at, int out_at, int v_at, int M, const T* kg,
                                        const T* vg, const float* km_g, int Tn, int hd, int set) {
  const CSmem sm(smem_base());
  const Pieces pc(hd, cl.rank);
  const bool crossing = kSlice % hd != 0;
  const float* q = smem_base() + q_at;
  float* out = smem_base() + out_at;
  float *kb = sm.Bf, *vb = sm.C;
  auto next = [&](int s) { return crossing ? s ^ 1 : s; };
  if (Tn <= kCStage) {
    stage_keys_c<T, kCStage, true>(kb, vb, sm.km, kg, vg, km_g, 0, Tn, cl.D);
    __syncthreads();
    attend_stage_c<T, HDB, kNarrow, kOne>(cl, pc, q, out, M, kb, vb, set, Tn, true, true);
    return next(set);
  }
  float* vc = smem_base() + v_at;
  if constexpr (std::is_same<T, bf16>::value) {
    for (int c0 = 0; c0 < Tn; c0 += kCStage) {
      stage_keys_c<T, kCStage, false>(kb, nullptr, sm.km, kg, vg, km_g, c0, Tn, cl.D);
      __syncthreads();
      attend_stage_c<T, HDB, kNarrow, kStats>(cl, pc, q, out, M, kb, nullptr, set,
                                              min(kCStage, Tn - c0), c0 == 0, false);
      set = next(set);
    }
    for (int c0 = 0; c0 < Tn; c0 += kCStage) {
      stage_keys_c<T, kCStage, true>(kb, vc, sm.km, kg, vg, km_g, c0, Tn, cl.D);
      __syncthreads();
      attend_stage_c<T, HDB, kNarrow, kProbs>(cl, pc, q, out, M, kb, vc, set,
                                              min(kCStage, Tn - c0), c0 == 0,
                                              c0 + kCStage >= Tn);
      set = next(set);
    }
  } else {
    for (int c0 = 0; c0 < Tn; c0 += kCStage) {
      stage_keys_c<T, kCStage, true>(kb, vc, sm.km, kg, vg, km_g, c0, Tn, cl.D);
      __syncthreads();
      attend_stage_c<T, HDB, kNarrow, kOnline>(cl, pc, q, out, M, kb, vc, set,
                                               min(kCStage, Tn - c0), c0 == 0,
                                               c0 + kCStage >= Tn);
      set = next(set);
    }
  }
  return set;
}

// attention_c for the head class: HDB 128 for the exact heads (unrolled,
// zero past the piece), kCMaxHeadDim for the wide ones (past kSliceHD: loops
// to the piece's width at run time), kCNarrowHD for the narrow ones.
template <typename T, int CLS>
__device__ __forceinline__ int attend_c(const Clu& cl, const float* q, float* out, int M,
                                        const T* kg, const T* vg, const float* km_g, int Tn,
                                        int hd, int set) {
  const CSmem sm(smem_base());
  const int q_at = (int)(q - sm.A), out_at = (int)(out - sm.A);  // sm.A is smem_base()
  const int v_at = out == sm.C ? 0 : (int)(sm.C - sm.A);
  constexpr int HDB = CLS == kClsNarrow ? kCNarrowHD : CLS == kClsWide ? kCMaxHeadDim : kSlice;
  return attention_c<T, HDB, CLS == kClsNarrow>(cl, q_at, out_at, v_at, M, kg, vg, km_g, Tn, hd,
                                                set);
}

// One DualAttentionBlock call for one sample, this CTA's columns: dab_call's
// schedule (dual_stack.cuh) at D 128's buffers, with a cluster barrier
// before each step that reads other CTAs' columns written since the last
// one, and before each write to a buffer that another CTA may still be
// reading.  set: the attention's exchange set; returns the next one.
template <typename T, int CLS>
__device__ __noinline__ int dab_call_c(Clu cl, Act x, Act y, Act out, const float* fm_g,
                                       const float* tm_g, int F, int Tn, int hd, const T* W,
                                       const float* b, const float* ln, const float* xb, T* kvg,
                                       int set) {
  const CSmem sm(smem_base());
  cg::cluster_group cluster = cg::this_cluster();
  float *A = sm.A, *Bf = sm.Bf, *C = sm.C, *Dq = sm.Dq, *E = sm.E, *fm = sm.fm;
  const int D = cl.D, col0 = cl.col0();
  const T* Wm[kNumW];
#pragma unroll
  for (int i = 0; i < kNumW; ++i) Wm[i] = W + (long long)i * D * D;
  T* tk = kvg + col0;
  T* tv = tk + (long long)Tn * D;
  T* fk = tv + (long long)Tn * D;
  T* fv = fk + (long long)F * D;
  const float* bc = b + col0;  // own columns' biases: bc[w D + c]
  const float* xbc = xb + col0;
  auto biased_rounded = [&](float* dst, int w) {
    return [=](int r, int c, float acc) { dst[r * kCLD + c] = round_to<T>(acc + bc[w * D + c]); };
  };
  auto biased = [&](float* dst, int w) {
    return [=](int r, int c, float acc) { dst[r * kCLD + c] = acc + bc[w * D + c]; };
  };

  // both sides' keys and values, every row
  for (int side = 0; side < 2; ++side) {
    const Act src = side ? x : y;
    const int Lr = side ? F : Tn, wk = side ? W_FK : W_TK, wv = side ? W_FV : W_TV;
    const int lns = side ? LN1_S : LNT_S, lnb = side ? LN1_B : LNT_B;
    for (int r0 = 0; r0 < Lr; r0 += kCTile) {
      const int M = min(kCTile, Lr - r0);
      layer_norm_c<T>(cl, M,
                      [&](int r, int c) { return act_load4<T>(src, (r0 + r) * D + col0 + c); },
                      ln + lns * D, ln + lnb * D, A);
      cluster.sync();  // A of every CTA
      gemm_c<T, 1>(cl, A, nullptr, M, Wm[wk], biased_rounded(Bf, wk));
      gemm_c<T, 1>(cl, A, nullptr, M, Wm[wv], biased_rounded(C, wv));
      store_rows_c<T>(Bf, C, M, (side ? fk : tk) + (long long)r0 * D,
                      (side ? fv : tv) + (long long)r0 * D, D);
      __syncthreads();
    }
  }

  // the from-rows, tile by tile
  for (int r0 = 0; r0 < F; r0 += kCTile) {
    const int M = min(kCTile, F - r0);
    const Act xr = act_rows_c<T>(x, r0, D), outr = act_rows_c<T>(out, r0, D);
    auto fn = [&]() {  // LN1 of the tile's rows -> A
      layer_norm_c<T>(cl, M, [&](int r, int c) { return act_load4<T>(xr, r * D + col0 + c); },
                      ln + LN1_S * D, ln + LN1_B * D, A);
    };
    for (int i = threadIdx.x; i < kCTile; i += kThreads) fm[i] = i < M ? fm_g[r0 + i] : 0.f;
    fn();
    cluster.sync();  // A of every CTA
    gemm_c<T, 1>(cl, A, nullptr, M, Wm[W_Q], biased_rounded(Dq, W_Q));
    cluster.sync();  // every CTA has read A: a longer self attention stages its values there
    float* S = F <= kCStage ? Dq : C;
    float* R = F <= kCStage ? C : Dq;
    set = attend_c<T, CLS>(cl, Dq, E, M, tk, tv, tm_g, Tn, hd, set);
    set = attend_c<T, CLS>(cl, Dq, S, M, fk, fv, fm_g, F, hd, set);
    if (F > kCStage) fn();  // A held the self attention's values
    cluster.sync();         // E and S of every CTA
    gemm_c<T, 1>(cl, E, nullptr, M, Wm[W_XD], biased(Bf, W_XD));
    gemm_c<T, 1>(cl, S, nullptr, M, Wm[W_SD], biased(R, W_SD));
    cluster.sync();  // Bf and R of every CTA; every CTA has read S
    gemm_c<T, 1>(cl, Bf, nullptr, M, Wm[W_XG], biased(S, W_XG));
    gemm_c<T, 1>(cl, R, nullptr, M, Wm[W_SG], biased(E, W_SG));
    cluster.sync();  // every CTA has read R
    for (int idx = threadIdx.x; idx < M * kSlice; idx += kThreads) {
      const int o = (idx / kSlice) * kCLD + idx % kSlice;
      R[o] = round_to<T>(E[o] * Bf[o] + S[o] * R[o]);
    }
    cluster.sync();  // R of every CTA
    gemm_c<T, 1>(cl, R, nullptr, M, Wm[W_GD], biased_rounded(Bf, W_GD));
    cluster.sync();  // Bf of every CTA
    // BiLinear gate: fn W + gc W + 2 b + xb, twice; sigmoid(scores masked) * values
    gemm_c<T, 2>(cl, A, Bf, M, Wm[W_BL1], [=](int r, int c, float acc) {
      S[r * kCLD + c] = acc + 2.f * bc[W_BL1 * D + c] + xbc[c];
    });
    gemm_c<T, 2>(cl, A, Bf, M, Wm[W_BL2], [=](int r, int c, float acc) {
      const float values = acc + 2.f * bc[W_BL2 * D + c] + xbc[D + c];
      const float z = S[r * kCLD + c] + kMask * (1.f - fm[r]);
      R[r * kCLD + c] = round_to<T>(values / (1.f + expf(-z)));
    });
    cluster.sync();  // R of every CTA
    // dense + residual, LN, dense + residual
    gemm_c<T, 1>(cl, R, nullptr, M, Wm[W_D1], [=](int r, int c, float acc) {
      E[r * kCLD + c] = acc + bc[W_D1 * D + c] + act_load<T>(xr, r * D + col0 + c);
    });
    layer_norm_c<T>(cl, M, [&](int r, int c) { return load4(E + r * kCLD + c); },
                    ln + LN2_S * D, ln + LN2_B * D, A);
    cluster.sync();  // A of every CTA
    gemm_c<T, 1>(cl, A, nullptr, M, Wm[W_D2], [=](int r, int c, float acc) {
      act_store<T>(outr, r * D + col0 + c, acc + bc[W_D2 * D + c] + E[r * kCLD + c]);
    });
  }
  return set;
}

template <typename T, int CLS>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_kernel(const T* v_in, const T* t_in, const float* vm, const float* tm, const T* W,
                   const float* b, const float* ln, const float* xb, T* v_out, T* t_out,
                   float* scratch, T* kv_scratch, int D, int Lv, int Lt, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const Clu cl{(int)cluster.block_rank(), (int)cluster.num_blocks(), D};
  float* smem = smem_base();
  // rows beyond a tile's length are read (never used) by the products
  for (int i = threadIdx.x; i < 6 * kCBuf; i += kThreads) smem[i] = 0.f;
  cluster.sync();  // every CTA runs before any reads another's shared memory

  const long long s = blockIdx.x / cl.n;  // the cluster's sample
  const long long rows = Lv + Lt;
  const Act v0{v_in + s * Lv * D, false}, t0{t_in + s * Lt * D, false};
  const Act v1{scratch + s * rows * D, true};
  const Act t1{scratch + s * rows * D + (long long)Lv * D, true};
  const Act v2{v_out + s * Lv * D, false}, t2{t_out + s * Lt * D, false};
  T* kvg = kv_scratch + s * 2 * rows * D;
  const float* vmask = vm + s * Lv;
  const float* tmask = tm + s * Lt;
  const int hd = D / H;
  int set = 0;
  for (int layer = 0; layer < 2; ++layer) {
    const T* Wl = W + (long long)layer * kNumW * D * D;
    const float* bl = b + layer * kNumW * D;
    const float* lnl = ln + layer * kNumLn * D;
    const float* xbl = xb + layer * 2 * D;
    const Act xv = layer ? v1 : v0, xt = layer ? t1 : t0;
    set = dab_call_c<T, CLS>(cl, xv, xt, layer ? v2 : v1, vmask, tmask, Lv, Lt, hd, Wl, bl, lnl,
                             xbl, kvg, set);
    set = dab_call_c<T, CLS>(cl, xt, xv, layer ? t2 : t1, tmask, vmask, Lt, Lv, hd, Wl, bl, lnl,
                             xbl, kvg, set);
    __syncthreads();  // the scratch rows written above are read by other threads below
  }
  cluster.sync();  // no CTA exits while another may still read its shared memory
}

template <typename T, int CLS>
int launch_cluster(const void* v, const void* t, const void* vm, const void* tm, const void* W,
                   const void* b, const void* ln, const void* xb, void* v_out, void* t_out,
                   void* scratch, void* kv_scratch, int B, int D, int Lv, int Lt, int H,
                   cudaStream_t stream) {
  auto kernel = cluster_kernel<T, CLS>;
  const size_t bytes = (size_t)kCSmemFloats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = D / kSlice;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * (D / kSlice));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(v), static_cast<const T*>(t),
                           static_cast<const float*>(vm), static_cast<const float*>(tm),
                           static_cast<const T*>(W), static_cast<const float*>(b),
                           static_cast<const float*>(ln), static_cast<const float*>(xb),
                           static_cast<T*>(v_out), static_cast<T*>(t_out),
                           static_cast<float*>(scratch), static_cast<T*>(kv_scratch), D, Lv, Lt,
                           H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_class(int cls, const void* v, const void* t, const void* vm, const void* tm,
                 const void* W, const void* b, const void* ln, const void* xb, void* v_out,
                 void* t_out, void* scratch, void* kv_scratch, int B, int D, int Lv, int Lt, int H,
                 cudaStream_t s) {
  auto go = [&](auto launch) {
    return launch(v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch, kv_scratch, B, D, Lv, Lt, H,
                  s);
  };
  return cls == kClsNarrow ? go(launch_cluster<T, kClsNarrow>)
         : cls == kClsWide ? go(launch_cluster<T, kClsWide>)
                           : go(launch_cluster<T, kClsExact>);
}

}  // namespace

// Kernel #4 at D = 640, 768, 896, 1024 (c = D / 128 CTAs a cluster), every
// head count H dividing D, any Lv, Lt >= 1; the arguments are vmr_dual_stack's
// (csrc/dual_stack.cu) less stat_scratch (the statistics stay in shared
// memory).  Returns 1 (cudaErrorInvalidValue), before any launch, for any
// other shape.
extern "C" int vmr_dual_stack_cluster(int dtype, const void* v, const void* t, const void* vm,
                                      const void* tm, const void* W, const void* b, const void* ln,
                                      const void* xb, void* v_out, void* t_out, void* scratch,
                                      void* kv_scratch, int B, int D, int Lv, int Lt, int H,
                                      cudaStream_t s) {
  if (D % kSlice || D / kSlice < kMinCluster || D / kSlice > kMaxCluster || B < 1 || Lv < 1 ||
      Lt < 1 || H < 1 || D % H || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int hd = D / H;
  const int cls = hd % 4 ? kClsNarrow : hd > kSlice ? kClsWide : kClsExact;
  if (dtype == 1)
    return launch_class<bf16>(cls, v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch, kv_scratch,
                              B, D, Lv, Lt, H, s);
  return launch_class<float>(cls, v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch, kv_scratch,
                             B, D, Lv, Lt, H, s);
}
