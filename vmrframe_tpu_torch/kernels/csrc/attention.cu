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
// branch go to shared memory once with 16-byte cp.async copies (rows padded to
// 16 keys and to a multiple of 16 head columns with zeros, and 8 more columns
// so that ldmatrix rows fall on distinct banks).  Then the block's query rows,
// all of them in one round where they fit (else the fewest even rounds of
// 16-row tiles), are staged by the whole block at once: Q's rows, and each
// branch's (B, Lq, Lk) mask as bits, a 64-bit word for each 64 keys of a row.
// A branch of more than 64 keys has its mask made into bits once for all heads
// by mask_bits_kernel, launched first (the attention follows as a programmatic
// dependent launch: its blocks stage K and V while the pass ends), and the
// blocks copy the bits; a shorter branch's blocks make their own (mask_bits).
// A round's work items, (branch, output column half, 16-row tile), are dealt to
// the warps, so #2's branches and, past head dim 128, the two halves of the
// output columns run on warps of their own; the warps a block are the plan's,
// chosen for the grid's occupancy.  An item takes its Q fragments by ldmatrix
// (into registers to head dim 128, at each 16-column step past it); scores come
// from mma.sync m16n8k16 (bf16 in, f32 out) 64 keys at a time, each step's
// fragments loaded before its products, and stay in registers, masked from the
// bits; the softmax runs in log2 units (the scale times log2 e, ex2.approx, as
// __expf does); row max and sum use quad shuffles and trees.  Over the key
// chunks the item walks twice: max and sum first, then the normalised
// probability, rounded to bf16 in registers, is the A operand of the P.V mma
// (V's B fragments by ldmatrix.trans).  That is where the TPU kernel and the
// plain version round, so the numbers are theirs, not an online softmax's; an
// item of another output half rebuilds the same bf16 p from the same f32
// scores.  Walk 1 ends holding 2^(s - max) of its last chunk, whose max is the
// row's, so walk 2 takes that chunk first and recomputes only the others (with
// one chunk, Lk <= 64, no second exponential at all).  Outputs leave as 8-byte
// stores after a swap between lane pairs, so that a store writes whole 32-byte
// sectors.  The plan (warps, rows a round, which masks go through the pass,
// shared memory) is kernels/attention.py::attention_bf16_plan's.  What bounds
// it: bytes at the served shapes (PERF.md); at 256 keys the two exponentials a
// score on the unit MUFU shares come next.  The fragment helpers are in
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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskLog2 = kMask * kLog2e;  // attention_mma: the mask in log2 units
constexpr size_t kSharedBytes = 232448;  // what one block may hold in shared memory on an H100
constexpr int kTfWarps = 8;     // attention_tf32: the most query tiles of 16 rows a block
constexpr int kTfChunk = 64;    // attention_tf32: keys per score chunk (8 n-tiles) and per staging
constexpr int kTfRowPad = 4;    // attention_tf32: floats after each staged K, V and Q row
constexpr int kTfQRegs = 8;     // attention_tf32: Q's fragments in registers to 8 column steps
constexpr int kTfOutTiles = 16;  // attention_tf32: 8-column output tiles a pass holds, at most
// attention_tf32's modes (kernels/attention.py::F32_MODES)
constexpr int kTfBoth = 0, kTfAlt = 1, kTfChunked = 2;
constexpr int kChunk = 64;      // attention_mma: keys per score chunk (8 mma n-tiles) and mask word
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
  // bf16: the mask as bits, (B, Lq, ceil(Lk / 64)) words of mask_bits'
  // layout, made once for every head by mask_bits_kernel; null: each block
  // makes its own (mask_bits)
  uint64_t* bits;
};

template <typename T>
__device__ __forceinline__ const T* at(const View& v, int b, int h) {
  return static_cast<const T*>(v.p) + b * v.sb + h * v.sh;
}

// The keep bits of mask values k0 .. k0 + 7 of a row (bit i set where value
// k0 + i is not 0; 0 at Lk and past it): one 16-byte load where vec (Lk a
// multiple of 8 and the mask 16-byte aligned), element loads otherwise.
__device__ __forceinline__ uint4 load8(const bf16* src, bool vec) {
  return vec ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ unsigned int keep8(uint4 v, const bf16* src, int k0, int Lk, bool vec) {
  unsigned int bits = 0u;
  if (vec) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bits |= ((w[i] & 0x7fffu) != 0u) << (2 * i) | ((w[i] & 0x7fff0000u) != 0u) << (2 * i + 1);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (k0 + e < Lk) bits |= ((__bfloat16_as_ushort(src[e]) & 0x7fffu) != 0u) << e;
  }
  return bits;
}

// The {0,1} mask rows [r0, r0 + rows) of one sample and branch as bits:
// byte kb of a row holds keys 8 kb .. 8 kb + 7 (keep8), a row is nch 64-bit
// words (one a kChunk-key chunk), 0 past Lq and Lk.  Each thread keeps NB
// 16-byte loads in flight.  The caller syncs.
template <int NB>
__device__ __forceinline__ void mask_bits_nb(uint64_t* dst, const bf16* mask, int Lq, int Lk,
                                             int r0, int rows, int nch, int tid, int nthr) {
  unsigned char* bytes = reinterpret_cast<unsigned char*>(dst);
  const int row_bytes = nch * 8, total = rows * row_bytes;
  const bool vec = Lk % 8 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  for (int base = tid; base < total; base += nthr * NB) {
    uint4 v[NB];
    const bf16* src[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int idx = base + u * nthr, row = r0 + idx / row_bytes, k0 = idx % row_bytes * 8;
      src[u] = idx < total && row < Lq && k0 < Lk ? mask + (long long)row * Lk + k0 : nullptr;
      v[u] = src[u] ? load8(src[u], vec) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int idx = base + u * nthr;
      if (idx < total)
        bytes[idx] = src[u] ? keep8(v[u], src[u], idx % row_bytes * 8, Lk, vec) : 0u;
    }
  }
}

// mask_bits_nb with 8 loads in flight a thread where each thread has 8 or
// more to make (256 keys and rows: its latency bounds the staging), else 4.
__device__ __forceinline__ void mask_bits(uint64_t* dst, const bf16* mask, int Lq, int Lk, int r0,
                                          int rows, int nch, int tid, int nthr) {
  if (rows * nch * 8 >= 8 * nthr)
    mask_bits_nb<8>(dst, mask, Lq, Lk, r0, rows, nch, tid, nthr);
  else
    mask_bits_nb<4>(dst, mask, Lq, Lk, r0, rows, nch, tid, nthr);
}

// A branch's whole mask as bits (mask_bits' layout, rows of nch words, the
// B Lq rows one after another), once for all the heads that read it: a
// thread a byte.
__global__ void mask_bits_kernel(const bf16* mask, uint64_t* bits, long long rows, int Lk,
                                 int nch) {
  // the attention launch that reads the bits may start now (it waits for them)
  asm volatile("griddepcontrol.launch_dependents;");
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int row_bytes = nch * 8;
  if (idx >= rows * row_bytes) return;
  const int k0 = idx % row_bytes * 8;
  const bool vec = Lk % 8 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  const bf16* src = mask + idx / row_bytes * Lk + k0;
  reinterpret_cast<unsigned char*>(bits)[idx] =
      k0 < Lk ? keep8(load8(src, vec), src, k0, Lk, vec) : 0u;
}

// Rows [0, rows) of a round's bits from mask_bits_kernel's (nch words a row)
// with 8-byte cp.async copies, zero to rows_pad.  The caller waits.
__device__ __forceinline__ void copy_bits(uint64_t* dst, const uint64_t* src, int rows,
                                          int rows_pad, int nch, int tid, int nthr) {
  for (int idx = tid; idx < rows_pad * nch; idx += nthr) {
    if (idx < rows * nch)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst + idx)),
                   "l"(src + idx));
    else
      dst[idx] = 0ull;
  }
}

// 2^x on the unit MUFU shares (ex2.approx, as __expf takes e^x: 2^(x log2 e)).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct FMax {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct FAdd {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// op over 8 values as a tree (3 dependent steps, not 7)
template <typename Op>
__device__ __forceinline__ float tree8(const float (&v)[8], Op op) {
  return op(op(op(v[0], v[1]), op(v[2], v[3])), op(op(v[4], v[5]), op(v[6], v[7])));
}

// A chunk's products s, in log2 units: s * scale + (key kept ? 0 : kMask
// log2 e) (scale is the softmax's times log2 e), or -inf for a key at Lk or
// past it; the keep bit of s[j][e] is bit 8j + (e & 1) of xa (rows g) or xb
// (rows g + 8).  WHOLE: the chunk's 64 keys all lie below Lk.
template <bool WHOLE>
__device__ __forceinline__ void mask_chunk(float (&s)[8][4], uint64_t xa, uint64_t xb, int t,
                                           int c0, int Lk, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool keep = ((e < 2 ? xa : xb) >> (8 * j + (e & 1))) & 1u;
      const float v = fmaf(s[j][e], scale, keep ? 0.f : kMaskLog2);
      s[j][e] = WHOLE || c0 + 8 * j + 2 * t + (e & 1) < Lk ? v : -CUDART_INF_F;
    }
  }
}

// The scores of one 64-key chunk for a warp's 16-row tile, in the mma's C
// layout: s[j] holds keys c0 + 8j + 2t, +1 of rows g (s[j][0..1]) and g + 8
// (s[j][2..3]); scaled and masked by mask_chunk (in log2 units) from the
// chunk's mask bits ba (row g) and bb (row g + 8).  The Q fragments come
// from qa, or with QS from the tile's staged Q rows q_s, one 16-column step
// at a time.
template <int HDK, int RS, bool QS>
__device__ __forceinline__ void chunk_scores(float (&s)[8][4],
                                             const uint32_t (&qa)[QS ? 1 : HDK][4],
                                             const bf16* q_s, const bf16* k_s, uint64_t ba,
                                             uint64_t bb, int c0, int Lk, int Lkp, float scale,
                                             int lane) {
  const int t = lane & 3, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const bf16* krow = k_s + (c0 + r + ((mi >> 1) << 3)) * RS + ((mi & 1) << 3);
  // each 16-column step: its fragments are all loaded before its products
  // (each product sums the steps in order)
#pragma unroll
  for (int kk = 0; kk < HDK; ++kk) {
    uint32_t qf[4], kb[4][4];
    if constexpr (QS)
      ldmatrix_x4(qf, q_s + (r + ((mi & 1) << 3)) * RS + 16 * kk + ((mi >> 1) << 3));
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2)
      if (c0 + 16 * j2 < Lkp) ldmatrix_x4(kb[j2], krow + 16 * j2 * RS + 16 * kk);
    auto products = [&](const uint32_t (&a)[4]) {
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        if (c0 + 16 * j2 < Lkp) {
          mma_bf16(s[2 * j2], a, kb[j2][0], kb[j2][1]);
          mma_bf16(s[2 * j2 + 1], a, kb[j2][2], kb[j2][3]);
        }
      }
    };
    if constexpr (QS)
      products(qf);
    else
      products(qa[kk]);
  }
  // key 8j + 2t + e of the chunk is bit 8j + e of the row's word shifted by 2t
  const uint64_t xa = ba >> (2 * t), xb = bb >> (2 * t);
  if (c0 + kChunk <= Lk)
    mask_chunk<true>(s, xa, xb, t, c0, Lk, scale);
  else
    mask_chunk<false>(s, xa, xb, t, c0, Lk, scale);
}

// attention_mma's shape for a head dim of 16 HDK columns: past 128 the Q
// fragments are read from the staged rows at each 16-column step and the
// output columns are split in two groups (kHalves) of kOT 16-column tiles,
// one a work item; kWarps, the most warps a block, keeps a thread at 128
// registers where the body fits them (head dims to 64, and 129-192) and at
// 255 elsewhere (Q's fragments and 64 output registers to 128; 256 columns).
template <int HDK>
struct MmaBody {
  static constexpr bool kQS = HDK > 8;
  static constexpr int kHalves = kQS ? 2 : 1;
  static constexpr int kOT = (HDK + kHalves - 1) / kHalves;
  static constexpr int kWarps = HDK <= 4 || (HDK > 8 && HDK <= 12) ? 16 : 8;
};

// vmr_masked_attention (nbranch = 1) and vmr_dual_attention (nbranch = 2),
// bf16, on the tensor cores.  HDK = head dim padded to 16, over 16 (1-16).
// One block per (batch, head), the warps of kernels/attention.py::
// attention_bf16_plan.  K and V of each branch are staged once; the query
// rows go in rounds of round_rows (every row in one round where they fit):
// Q's rows and each branch's mask bits (mask_bits) are staged by the whole
// block, then the round's work items, (branch, output group, 16-row tile)
// with the branch slowest, are dealt to the warps in turn.
template <int HDK>
__global__ void __launch_bounds__(MmaBody<HDK>::kWarps * 32)
    attention_mma(View qv, Branch b0, Branch b1, int nbranch, int H, int Lq, int hd, float scale,
                  int round_rows) {
  using Body = MmaBody<HDK>;
  constexpr bool QS = Body::kQS;
  constexpr int HDP = 16 * HDK, RS = HDP + 8, OT = Body::kOT, NH = Body::kHalves;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r = lane & 7;
  const float scale2 = scale * kLog2e;

  const int Lk0 = b0.Lk, Lk1 = nbranch == 2 ? b1.Lk : 0;
  const int Lkp0 = (Lk0 + 15) & ~15, Lkp1 = (Lk1 + 15) & ~15;
  const int nch0 = (Lk0 + kChunk - 1) / kChunk, nch1 = (Lk1 + kChunk - 1) / kChunk;
  bf16* const k0_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* const v0_s = k0_s + Lkp0 * RS;
  bf16* const k1_s = v0_s + Lkp0 * RS;
  bf16* const v1_s = k1_s + Lkp1 * RS;
  bf16* const q_s = v1_s + Lkp1 * RS;  // the round's query rows
  uint64_t* const bits0 = reinterpret_cast<uint64_t*>(q_s + round_rows * RS);
  uint64_t* const bits1 = bits0 + round_rows * nch0;
  stage<HDP, RS>(k0_s, at<bf16>(b0.k, b, h), b0.k.sl, Lk0, Lkp0, hd, threadIdx.x, blockDim.x);
  stage<HDP, RS>(v0_s, at<bf16>(b0.v, b, h), b0.v.sl, Lk0, Lkp0, hd, threadIdx.x, blockDim.x);
  if (nbranch == 2) {
    stage<HDP, RS>(k1_s, at<bf16>(b1.k, b, h), b1.k.sl, Lk1, Lkp1, hd, threadIdx.x, blockDim.x);
    stage<HDP, RS>(v1_s, at<bf16>(b1.v, b, h), b1.v.sl, Lk1, Lkp1, hd, threadIdx.x, blockDim.x);
  }
  // launched behind mask_bits_kernel, whose bits are read only from here on
  if (b0.bits || (nbranch == 2 && b1.bits)) asm volatile("griddepcontrol.wait;" ::: "memory");
  const bf16* q = at<bf16>(qv, b, h);
  const bf16* mask0 = static_cast<const bf16*>(b0.mask) + (long long)b * Lq * Lk0;
  const bf16* mask1 = static_cast<const bf16*>(b1.mask) + (long long)b * Lq * Lk1;

  for (int r0 = 0; r0 < Lq; r0 += round_rows) {
    const int rows = min(round_rows, Lq - r0), nt = (rows + 15) / 16;
    if (r0 > 0) __syncthreads();  // every warp is done with the last round's rows
    stage<HDP, RS>(q_s, q + r0 * qv.sl, qv.sl, rows, 16 * nt, hd, threadIdx.x, blockDim.x);
    if (b0.bits)
      copy_bits(bits0, b0.bits + ((long long)b * Lq + r0) * nch0, rows, 16 * nt, nch0,
                threadIdx.x, blockDim.x);
    else
      mask_bits(bits0, mask0, Lq, Lk0, r0, 16 * nt, nch0, threadIdx.x, blockDim.x);
    if (nbranch == 2 && b1.bits)
      copy_bits(bits1, b1.bits + ((long long)b * Lq + r0) * nch1, rows, 16 * nt, nch1,
                threadIdx.x, blockDim.x);
    else if (nbranch == 2)
      mask_bits(bits1, mask1, Lq, Lk1, r0, 16 * nt, nch1, threadIdx.x, blockDim.x);
    cp_async_wait_all();
    __syncthreads();  // K, V, the round's Q rows and mask bits, staged by the whole block

    for (int it = warp; it < nbranch * NH * nt; it += nwarp) {
      const int n = it / (NH * nt), tile = it % nt, d0 = (it / nt) % NH * OT;
      const int Lk = n ? Lk1 : Lk0, Lkp = n ? Lkp1 : Lkp0, nch = n ? nch1 : nch0;
      const bf16* k_s = n ? k1_s : k0_s;
      const bf16* v_s = n ? v1_s : v0_s;
      const uint64_t* bits = (n ? bits1 : bits0) + 16 * tile * nch;
      const bf16* qt_s = q_s + 16 * tile * RS;
      uint32_t qa[QS ? 1 : HDK][4];
      if constexpr (!QS) {
#pragma unroll
        for (int kk = 0; kk < HDK; ++kk)
          ldmatrix_x4(qa[kk], qt_s + (r + ((mi & 1) << 3)) * RS + 16 * kk + ((mi >> 1) << 3));
      }

      // walk 1: row max and sum (rows g and g + 8 of the tile), in log2
      // units; s ends as 2^(s - max) of the last chunk, whose max is the
      // row's: walk 2 takes that chunk first, as it stands
      float s[8][4];
      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
      for (int c = 0; c < nch; ++c) {
        chunk_scores<HDK, RS, QS>(s, qa, qt_s, k_s, bits[g * nch + c], bits[(g + 8) * nch + c],
                                  c * kChunk, Lk, Lkp, scale2, lane);
        float a[8], b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          a[j] = fmaxf(s[j][0], s[j][1]);
          b[j] = fmaxf(s[j][2], s[j][3]);
        }
        const float n0 = fmaxf(m0, quad_max(tree8(a, FMax{}))),
                    n1 = fmaxf(m1, quad_max(tree8(b, FMax{})));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j][0] = exp2_approx(s[j][0] - n0);
          s[j][1] = exp2_approx(s[j][1] - n0);
          s[j][2] = exp2_approx(s[j][2] - n1);
          s[j][3] = exp2_approx(s[j][3] - n1);
          a[j] = s[j][0] + s[j][1];
          b[j] = s[j][2] + s[j][3];
        }
        l0 = l0 * exp2_approx(m0 - n0) + tree8(a, FAdd{});
        l1 = l1 * exp2_approx(m1 - n1) + tree8(b, FAdd{});
        m0 = n0;
        m1 = n1;
      }
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

      // walk 2: the normalised probabilities, rounded to bf16, times V over
      // the item's output tiles [d0, d0 + OT)
      float o[2 * OT][4];
#pragma unroll
      for (int d = 0; d < 2 * OT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
      for (int i = 0; i < nch; ++i) {
        const int c = (i + nch - 1) % nch;  // the last chunk, then the others in order
        if (i > 0) {
          chunk_scores<HDK, RS, QS>(s, qa, qt_s, k_s, bits[g * nch + c], bits[(g + 8) * nch + c],
                                    c * kChunk, Lk, Lkp, scale2, lane);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[j][0] = exp2_approx(s[j][0] - m0);
            s[j][1] = exp2_approx(s[j][1] - m0);
            s[j][2] = exp2_approx(s[j][2] - m1);
            s[j][3] = exp2_approx(s[j][3] - m1);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int key0 = c * kChunk + 16 * kk;
          if (key0 < Lkp) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0);
            pa[1] = pack_bf16(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1);
            pa[2] = pack_bf16(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0);
            pa[3] = pack_bf16(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1);
            const bf16* vrow = v_s + (key0 + r + ((mi & 1) << 3)) * RS + ((mi >> 1) << 3);
            uint32_t vb[OT][4];  // the step's V fragments, all loaded before its products
#pragma unroll
            for (int dp = 0; dp < OT; ++dp)
              if (d0 + dp < HDK) ldmatrix_x4_trans(vb[dp], vrow + 16 * (d0 + dp));
#pragma unroll
            for (int dp = 0; dp < OT; ++dp) {
              if (d0 + dp < HDK) {
                mma_bf16(o[2 * dp], pa, vb[dp][0], vb[dp][1]);
                mma_bf16(o[2 * dp + 1], pa, vb[dp][2], vb[dp][3]);
              }
            }
          }
        }
      }

      // rows g and g + 8 of the tile.  Where the head dim, the row stride and
      // the address allow, lanes t and t ^ 1 swap a pair of bf16 so that each
      // lane stores 4 columns (8 bytes) of tile d (even t) or d + 1 (odd t),
      // and a store instruction writes whole 32-byte sectors of every row;
      // else a lane stores its columns one at a time
      const View ov = n ? b1.out : b0.out;
      bf16* out = static_cast<bf16*>(const_cast<void*>(ov.p)) + b * ov.sb + h * ov.sh;
      const bool quads = ((hd | ov.sl) & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 16 * tile + g + 8 * half;
        bf16* dst = out + row * ov.sl + 16 * d0;
        if (quads) {
#pragma unroll
          for (int d = 0; d < 2 * OT; d += 2) {
            const uint32_t a = pack_bf16(o[d][2 * half], o[d][2 * half + 1]);
            const uint32_t c = pack_bf16(o[d + 1][2 * half], o[d + 1][2 * half + 1]);
            const uint32_t got = __shfl_xor_sync(0xffffffffu, t & 1 ? a : c, 1);
            const int col = 8 * d + (t & 1 ? 8 + 2 * (t - 1) : 2 * t);
            if (row < Lq && 16 * d0 + col < hd)
              *reinterpret_cast<uint2*>(dst + col) =
                  t & 1 ? make_uint2(got, c) : make_uint2(a, got);
          }
        } else if (row < Lq) {
#pragma unroll
          for (int d = 0; d < 2 * OT; ++d) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * d + 2 * t + e;
              if (16 * d0 + col < hd) dst[col] = __float2bfloat16(o[d][2 * half + e]);
            }
          }
        }
      }
    }
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
__global__ void __launch_bounds__(kTfWarps * 32)
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

// attention_mma's plan, computed by kernels/attention.py::attention_bf16_plan:
// warps a block, query rows a round (a multiple of 16), shared memory.
struct MmaPlan {
  int nwarp, round_rows;
  size_t bytes;
};

template <int HDK>
int launch_mma(View q, Branch b0, Branch b1, int nbranch, int B, int H, int Lq, int hd,
               float scale, const MmaPlan& plan, cudaStream_t stream) {
  if (plan.nwarp < 1 || plan.nwarp > MmaBody<HDK>::kWarps || plan.round_rows < 16 ||
      plan.round_rows % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attention_mma<HDK>, plan.bytes);
  if (err != cudaSuccess) return (int)err;
  // behind the mask-bits pass, a programmatic dependent launch: the blocks
  // stage K and V while the pass ends, and wait for its bits (griddepcontrol)
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * H);
  config.blockDim = dim3(plan.nwarp * 32);
  config.dynamicSmemBytes = plan.bytes;
  config.stream = stream;
  cudaLaunchAttribute after[1];
  after[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  after[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = after;
  config.numAttrs = b0.bits || (nbranch == 2 && b1.bits) ? 1 : 0;
  err = cudaLaunchKernelEx(&config, attention_mma<HDK>, q, b0, b1, nbranch, H, Lq, hd, scale,
                           plan.round_rows);
  if (err != cudaSuccess) return (int)err;
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
  const MmaPlan mma{plan.nwarp, plan.kv_rows, plan.bytes};
  for (int n = 0; n < nbranch; ++n) {
    const Branch& br = n ? b1 : b0;
    if (!br.bits) continue;
    const long long bytes = (long long)B * Lq * ((br.Lk + kChunk - 1) / kChunk) * 8;
    mask_bits_kernel<<<(unsigned)((bytes + 255) / 256), 256, 0, stream>>>(
        static_cast<const bf16*>(br.mask), br.bits, (long long)B * Lq, br.Lk,
        (br.Lk + kChunk - 1) / kChunk);
  }
  switch ((hd + 15) / 16) {
    case 1: return launch_mma<1>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 2: return launch_mma<2>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 3: return launch_mma<3>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 4: return launch_mma<4>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 5: return launch_mma<5>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 6: return launch_mma<6>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 7: return launch_mma<7>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 8: return launch_mma<8>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 9: return launch_mma<9>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 10: return launch_mma<10>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 11: return launch_mma<11>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 12: return launch_mma<12>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 13: return launch_mma<13>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 14: return launch_mma<14>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 15: return launch_mma<15>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
    case 16: return launch_mma<16>(q, b0, b1, nbranch, B, H, Lq, hd, scale, mma, stream);
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
// (kernels/attention.py::attention_f32_plan); the bf16 body reads nwarp,
// kv_rows as its query rows a round and shared_bytes
// (kernels/attention.py::attention_bf16_plan), mode and ss are 0.
extern "C" int vmr_masked_attention(int dtype, const void* q, long long q_sb, long long q_sh,
                                    long long q_sl, const void* k, long long k_sb,
                                    long long k_sh, long long k_sl, const void* v,
                                    long long v_sb, long long v_sh, long long v_sl,
                                    const void* mask, void* bits, void* out, long long o_sb,
                                    long long o_sh,
                                    long long o_sl, int B, int H, int Lq, int Lk, int hd,
                                    float scale, int mode, int nwarp, int kv_rows, int ss,
                                    long long shared_bytes, void* stream) {
  const View qv{q, q_sb, q_sh, q_sl};
  const Branch b0{{k, k_sb, k_sh, k_sl}, {v, v_sb, v_sh, v_sl}, {out, o_sb, o_sh, o_sl}, mask,
                  Lk, static_cast<uint64_t*>(bits)};
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
                                  const void* x_mask, void* s_bits, void* x_bits, void* s_out,
                                  long long so_sb,
                                  long long so_sh, long long so_sl, void* x_out, long long xo_sb,
                                  long long xo_sh, long long xo_sl, int B, int H, int L, int M,
                                  int hd, float scale, int mode, int nwarp, int kv_rows, int ss,
                                  long long shared_bytes, void* stream) {
  const View qv{q, q_sb, q_sh, q_sl};
  const Branch self{{fk, fk_sb, fk_sh, fk_sl}, {fv, fv_sb, fv_sh, fv_sl},
                    {s_out, so_sb, so_sh, so_sl}, s_mask, L, static_cast<uint64_t*>(s_bits)};
  const Branch cross{{tk, tk_sb, tk_sh, tk_sl}, {tv, tv_sb, tv_sh, tv_sl},
                     {x_out, xo_sb, xo_sh, xo_sl}, x_mask, M, static_cast<uint64_t*>(x_bits)};
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
