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
// inputs and outputs, and all samples share 0.9 MB of weights; ~90% of the
// multiply-adds are the D x D projections (14 products over the from-rows
// and 2 over the to-rows a call), the rest attention.  So the products go
// to the tensor cores: the projections in bf16, attention in both types.
// At the wider D the tiles are shorter (below), each streams every matrix
// from L2 again, and that streaming, not the tensor cores, sets the time at
// D 384 and 512 (PERF.md, section 6).
//
// Design.  One block of 512 threads per sample (128 samples on 132 SMs: one
// wave; a sample's four calls depend on each other, so there is nothing to
// split without exchanging activations between blocks).  Any Lv, Lt >= 1:
// a call first projects the keys and values of both sides for all their
// rows, a tile at a time, into a per-sample scratch in device memory in T
// (it stays in L2: self attention needs every from-row's keys before any
// row's context), then walks its from-rows in tiles through five (R, D) f32
// buffers in shared memory (rows padded to D + 4 floats, so that 16-byte
// reads along a row are free of bank conflicts both for one row per lane
// and for one row per warp); the schedule at dab_call reuses them so that
// five are enough in f32 too.
//
// Widths (Lay<D>): D = 128, 256, 384, 512, each its own instances.  A
// block holds at most 227 KB of shared memory, so the row tile R shrinks as
// D grows: 64 rows at D 128 (five buffers 169 KB), 32 at D 256 (166 KB), 16
// at D 384 and 512 (124 and 165 KB); the weights stream in chunks of rows
// through two slots (below) whose size stays near 33 KB (50 KB at D 384).
// At D 128 a longer side's keys and values share one buffer, 32 keys each;
// at the wider D a buffer holds R keys of one matrix, so values take a
// buffer of their own: C, or, when C holds the self attention's context, A
// (fn), which the tile then takes again from LN1 of its rows.
//
// Projections, bf16 (gemm_mma): mma.sync m16n8k16 with f32 accumulation;
// warp w owns a 16-row band of the tile and D / (16 / bands) columns (32,
// or 24 at D 384); A fragments come from the f32 buffers, rounded to bf16 as
// they are read; each weight matrix streams from L2 in chunks of kWK rows
// (two 64-row halves at D 128) through two bf16 slots with cp.async, and
// the next product's first chunk is prefetched behind the current product's
// last (every block reads the same 28 matrices).  f32 (gemm_f32): FMA on the
// CUDA cores (TF32 would keep ~3 digits), the weight in kKC-row chunks
// through a double buffer, each warp 4 rows and 128 columns, each lane 4
// columns, 16 accumulators a thread (at D 384 12 of the 16 warps work).
//
// Attention (attention<T, D, HD, kExact>: HD the head dim, or a bound on
// it, the head dim then read at run time): a warp task is (16 query rows,
// one head), S = Q K^T and P.V on mma.sync, bf16 on m16n8k16 with f32
// accumulation, f32 on m16n8k8 in 3xTF32 (mma_tf32.cuh;
// each operand split as it is read: split copies of K and V do not fit
// beside the five buffers); k past the head dim and n past it are zero in
// registers, and a task stores only its own columns.  Q's A fragments come
// from its f32 buffer; K and V are staged in the buffers Bf and C: in f32 as
// f32 rows, in bf16 as the bf16 rows of the scratch, copied as they are (K's
// B fragments are 32-bit loads, V's ldmatrix.trans: no conversion, which on
// an H100 was the conversion unit's work that bound the task).  The row max
// and sum are reduced over the quad, p's C fragments are P.V's A fragments
// as they stand, and p = e (1 / sum) with e = 2^((s - max) log2 e) by
// ex2.approx in bf16 (p is rounded to 8 bits after), expf in f32.  A side of
// at most kStage keys (64 at D 128, R past it) is staged once and walked
// once with the scores in registers; self attention then writes its context
// over the query in place.  A longer side is staged kKeys keys at a time
// (32 at D 128, R past it), each (row, head)'s max and sum in shared memory
// between chunks: bf16 walks twice, max and sum first (K alone, kStage keys
// a chunk), then p rounded to T and P.V (an online softmax would round p
// before the final max is known, not where the TPU kernel and the plain
// version round it); f32 walks once with the max and sum rescaled as they
// grow (p rounded to f32 is p).  The first layer's results go to an f32 scratch in device
// memory that the same block reads back, so nothing is rounded between the
// layers, as on the TPU.
//
// Numerics follow the TPU kernel body: fn, tn, k, v, the probabilities and
// every matmul operand are rounded to T (the weights' type); LN, softmax,
// the sigmoid and all sums are f32; additive -1e30 key masks per sample; the
// BiLinear is two products, over fn and over gc, accumulated into the same
// sums.  Ragged lengths are loop bounds and row guards; rows of a tile
// beyond its length are computed on and never stored, and no row's values
// reach another's (bf16 staging leaves bit patterns in such rows of Bf and
// C that need not be finite as f32).
//
// Takes D = 128, 256, 384 or 512 at every head count H dividing D (head
// dims 1-512), and any Lv, Lt >= 1; D 640, 768, 896 and 1024 go to a
// cluster of D / 128 CTAs a sample (csrc/dual_stack_cluster.cu), at every
// head count too (kernels/dual_stack.py::takes is the same set; past D 1024
// it refuses).  4 heads have a kernel of their own at each
// D; other head counts share one a width, whose attention has a body for
// each class of head dim: exact at D 128 for 4-128, else the head dim
// rounded up to 16, 32, 64 or 128, zero past it in registers; the wide
// heads (192-512) one body whose loops over the head dim run to it at run
// time, in rounds of 32 columns that are whole; the narrow heads (1, 2, 3,
// 6) one body that reads and writes q, K and the context one element at a
// time (an odd head dim starts its heads on odd columns, where a pair would
// be misaligned and hold the next head's first column), with each (row,
// head)'s max and sum, up to D heads of a tile, in device memory
// (stat_scratch, 64 KB a sample, L2-resident): grown in shared memory they
// would not fit a block at D 128, 256 or 512.
// Interface: plain C, loaded with ctypes; the entry returns
// cudaGetLastError() after its launch.
//
// Sources: the body is csrc/dual_stack.cuh; this file compiles it for D 128
// and holds the C entry, and dual_stack_256.cu, dual_stack_384.cu and
// dual_stack_512.cu compile it for one wider width each, and
// dual_stack_cluster.cu holds D 640-1024, in parallel with this one
// (kernels/build.py::PARTS), into the same library.

#include "dual_stack.cuh"

// dtype: 0 = float32, 1 = bfloat16 (features, weights, outputs and
// kv_scratch); masks, b, ln, xb, scratch and stat_scratch are float32.
// scratch: (B, Lv + Lt, D), the first layer's results; kv_scratch: (B, 2 (Lv
// + Lt), D), a call's keys and values; stat_scratch: (B, kNarrowStat), the
// narrow heads' statistics, needed when the head dim is not a multiple of 4
// at D 128-512 (may be null otherwise; the cluster keeps its statistics in
// shared memory).  Returns 1 (cudaErrorInvalidValue), before any launch, for
// a shape the kernel does not take: D neither in kWidths nor a cluster width
// (640-1024), H not dividing D, B, Lv, Lt < 1, or narrow heads at D 128-512
// without stat_scratch.
extern "C" int vmr_dual_stack_cluster(int dtype, const void* v, const void* t, const void* vm,
                                      const void* tm, const void* W, const void* b, const void* ln,
                                      const void* xb, void* v_out, void* t_out, void* scratch,
                                      void* kv_scratch, int B, int D, int Lv, int Lt, int H,
                                      cudaStream_t s);

extern "C" int vmr_dual_stack(int dtype, const void* v, const void* t, const void* vm,
                              const void* tm, const void* W, const void* b, const void* ln,
                              const void* xb, void* v_out, void* t_out, void* scratch,
                              void* kv_scratch, void* stat_scratch, int B, int D, int Lv, int Lt,
                              int H, void* stream) {
  bool taken = false;
  for (int w : kWidths) taken = taken || D == w;
  if (!taken && D > kWidths[3])  // the cluster widths; it refuses any other
    return vmr_dual_stack_cluster(dtype, v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch,
                                  kv_scratch, B, D, Lv, Lt, H, static_cast<cudaStream_t>(stream));
  if (!taken || B < 1 || Lv < 1 || Lt < 1 || H < 1 || D % H || ((D / H) % 4 && !stat_scratch))
    return (int)cudaErrorInvalidValue;
  auto* width = D == 128   ? stack_width<128>
                : D == 256 ? vmr_dual_stack_256
                : D == 384 ? vmr_dual_stack_384
                           : vmr_dual_stack_512;
  return width(dtype, v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch, kv_scratch, stat_scratch,
               B, Lv, Lt, H, static_cast<cudaStream_t>(stream));
}
