"""SeqPAN's attention cores: three hand-written CUDA kernels for Hopper, each
beside its plain PyTorch version.

- ``fused_masked_attention`` -> CUDA ``vmr_masked_attention``; replaces
  ``vmrframe_tpu/kernels/attention.py::fused_masked_attention`` (``_attn_kernel``).
- ``fused_dual_attention`` -> CUDA ``vmr_dual_attention``; replaces
  ``fused_dual_attention`` (``_dual_attn_kernel``) there.
- ``fused_cq_attention`` -> CUDA ``vmr_cq_attention``; replaces
  ``fused_cq_attention`` (``_cq_kernel``) there.

The sources are ``csrc/attention.cu`` (bounds and design are noted there).
The kernels' limits are pure functions of shapes and types, read by the
models' gates before a launch and by the wrappers, which raise on what they
refuse: ``attention_takes`` (#1/#2: head dims, lengths, and the shared
memory ``attention_shared_bytes`` sizes) and ``cq_takes`` (#3: grids of up
to ``CQ_MAX_LEN`` positions a side, D up to ``CQ_MAX_D``, a layout
``cq_plan`` fits in one block).
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises, and counts the launch in ``<wrapper>.launches``.

The kernels have no backward.  Training goes through three
``torch.autograd.Function``s (``masked_attention``, ``dual_attention``,
``cq_attention``; counterparts of the JAX package's ``fused_*_ad``): the
forward is the wrapper, the backward the VJP of a reference formula
(``*_reference``, the XLA recompute of ``_dual_reference`` and
``_cq_reference`` there), recomputed in the inputs' type.  A wrapper called
directly on CUDA tensors that require grad, with grad mode on, raises: its
outputs would come back detached, and the weights before it would silently
get no gradient.
The public layout is the JAX one, (B, H, L, hd): the attention kernels take
any strides with a unit last stride, so head-split views of (B, L, D)
projections go in without a copy, and their outputs are (B, L, H, hd) in
memory, ready for the head merge.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from vmrframe_tpu_torch.kernels import count_plain, launch_range, plain_route

from vmrframe_tpu_torch.ops.masking import MASK_VALUE

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_VIEW = [_P, _L, _L, _L]
_ARGTYPES = {
    "vmr_masked_attention": [_I] + _VIEW * 3 + [_P, _P] + _VIEW + [_I] * 5 + [_F] + [_I] * 4
    + [_L, _P],
    "vmr_dual_attention": [_I] + _VIEW * 5 + [_P] * 4 + _VIEW * 2 + [_I] * 5 + [_F] + [_I] * 4
    + [_L, _P],
    "vmr_cq_attention": [_I] + [_P] * 10 + [_I] * 7 + [_L, _P],
    "vmr_cq_attention_clocked": [_I] + [_P] * 10 + [_I] * 7 + [_L, _P, _P],
}
_lib = None
SHARED_BYTES = 232_448  # what one block may hold in shared memory on an H100
# bf16 attention: head dims to 128 hold a tile's Q fragments and outputs in
# registers; 129-256 read Q from its staged rows and split the output
# columns into two groups, each a work item of its own
MMA_MAX_HEAD_DIM = 256
# f32 attention: head dims to 256 (Q's fragments in registers to 64, from
# the warp's staged Q tile past it; outputs in two passes past 128)
F32_MAX_HEAD_DIM = 256
# mirror attention.cu: kTfWarps (the f32 body's most warps a block), the bf16
# body's 8-column row pad and kChunk (keys a score chunk and a mask word)
F32_MAX_WARPS, MMA_ROW_PAD, MMA_CHUNK = 8, 8, 64
# mirror attention.cu: kTfChunk (keys a chunk), kTfRowPad (floats after each
# staged row), kTfQRegs (Q in registers up to this many 8-column steps)
F32_CHUNK, F32_ROW_PAD, F32_Q_REGS = 64, 4, 8
F32_MODES = ("both", "alt", "chunked")  # mirror kTfBoth, kTfAlt, kTfChunked
# an H100 SXM's streaming multiprocessors and each one's shared memory, of
# which every resident block reserves 1 KB beside its own
SM_COUNT, SM_SHARED_BYTES, BLOCK_RESERVED_BYTES = 132, 233_472, 1_024
# the modes ``attention_f32_plan`` tries before "chunked", in order
# (``tools/bench_kernels.py --f32-modes`` narrows them to compare modes)
F32_STAGED_MODES = ("both", "alt")
CQ_MAX_LEN = 1024  # the longest context or query grid #3 takes
CQ_MAX_D = 8192  # the widest D #3 takes
# mirror attention.cu: kCqScorePad; kCqMmaCols (bf16) and kCqF32Cols (f32),
# the granules of #3's column chunks; 16 bytes of padding on each staged row
CQ_SCORE_PAD, CQ_COLS, CQ_ROW_PAD_BYTES = 4, {torch.bfloat16: 16, torch.float32: 8}, 16
# mirror attention.cu's CqPhase: the phases vmr_cq_attention_clocked times
CQ_PHASES = ("stage", "rank1", "scores", "stats", "softmax", "restage", "stc", "out")


def load_kernels() -> ctypes.CDLL:
    """The compiled ``csrc/attention.cu`` (built on first use), with every
    entry's C signature set."""
    global _lib
    if _lib is None:
        from vmrframe_tpu_torch.kernels import build

        lib = build.load("attention")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(tensors: Sequence[torch.Tensor], what: str) -> torch.dtype:
    dtype, device = tensors[0].dtype, tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on the CPU or a CUDA device, got {device}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{what}: all inputs must share {device} and {dtype}")
    return dtype


def _view(t: torch.Tensor):
    """(pointer, batch, head and row strides) of a (B, H, L, hd) tensor."""
    if t.stride(3) != 1:
        raise ValueError("attention kernels need a unit stride on the head dim")
    return (t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def _as(t: torch.Tensor, like: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """A {0,1} mask or weight in the kernel's type, contiguous, shape-checked."""
    if tuple(t.shape) != shape:
        raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
    return t.to(device=like.device, dtype=like.dtype).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def refuse_detached(tensors: Sequence[torch.Tensor], what: str) -> None:
    """Raises when grad mode is on and an input requires grad: a raw launch
    writes fresh outputs that autograd cannot trace back to its inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward, and its outputs would be "
                           "detached from inputs that require grad; call it through its "
                           "autograd Function (masked_attention, dual_attention, cq_attention)")


def _head_major_out(q: torch.Tensor, L: int) -> torch.Tensor:
    B, H, _, hd = q.shape
    return torch.empty(B, L, H, hd, dtype=q.dtype, device=q.device).transpose(1, 2)


# ------------------------------------------------------------ plain versions


def masked_attention_plain(q, k, v, mask):
    """softmax(q k^T / sqrt(hd) + (1 - mask) * -1e30) v in f32; probabilities
    are rounded to v's type before the value product, as the kernels do."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhld,bhmd->bhlm", q.float(), k.float()) * scale
    s = s + (1.0 - mask.float()[:, None]) * MASK_VALUE
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("bhlm,bhmd->bhld", p, v.float()).to(q.dtype)


def dual_attention_plain(q, f_k, f_v, t_k, t_v, s_mask, x_mask):
    return (masked_attention_plain(q, f_k, f_v, s_mask),
            masked_attention_plain(q, t_k, t_v, x_mask))


def cq_attention_plain(context, query, w4C, w4Q, w4mlu, c_mask, q_mask):
    """(c2q, q2c): trilinear scores, row softmax over the query (q_mask),
    column softmax over the context (c_mask), c2q = S_ q and
    q2c = S_ (S_t^T c), all in f32 with S_ and S_t rounded to the input type
    where the kernel rounds them."""
    dtype = context.dtype
    c, q = context.float(), query.float()
    score = (c * w4mlu.float()) @ q.transpose(1, 2) + c @ w4C.float() \
        + (q @ w4Q.float()).transpose(1, 2)
    s_ = torch.softmax(score + (1.0 - q_mask.float()[:, None, :]) * MASK_VALUE, dim=2)
    s_t = torch.softmax(score + (1.0 - c_mask.float()[:, :, None]) * MASK_VALUE, dim=1)
    c2q = s_.to(dtype).float() @ q
    stc = s_t.to(dtype).float().transpose(1, 2) @ c
    return c2q.to(dtype), (s_ @ stc).to(dtype)


# ----------------------------------------------- the backward's formulas


def masked_attention_reference(q, k, v, mask):
    """softmax(q k^T / sqrt(hd) + (1 - mask) * -1e30) v in the inputs' type,
    the formula the backward of #1 differentiates."""
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    s = s + (1.0 - mask.to(q.dtype)[:, None]) * MASK_VALUE
    return torch.softmax(s, dim=-1) @ v


def dual_attention_reference(q, f_k, f_v, t_k, t_v, s_mask, x_mask):
    """(self, cross) attention from one query; ``_dual_reference`` of the
    JAX package."""
    return (masked_attention_reference(q, f_k, f_v, s_mask),
            masked_attention_reference(q, t_k, t_v, x_mask))


def cq_attention_reference(context, query, w4C, w4Q, w4mlu, c_mask, q_mask):
    """(c2q, q2c) in the inputs' type, as ``_cq_reference`` of the JAX
    package computes them: q2c = (S_ S_t) c."""
    c_mask, q_mask = c_mask.to(context.dtype), q_mask.to(context.dtype)
    score = context @ w4C + (query @ w4Q).transpose(1, 2) \
        + (context * w4mlu[0]) @ query.transpose(1, 2)
    s_ = torch.softmax(score + (1.0 - q_mask[:, None, :]) * MASK_VALUE, dim=2)
    s_t = torch.softmax(score + (1.0 - c_mask[:, :, None]) * MASK_VALUE, dim=1).transpose(1, 2)
    return s_ @ query, (s_ @ s_t) @ context


# ------------------------------------------------------------- launch plans


def attention_f32_plan(Lq: int, Lks: Sequence[int], hd: int) -> dict:
    """How the f32 kernel (``attention_tf32`` in ``csrc/attention.cu``) lays
    out one (batch, head); the wrappers pass it to the C entries, which
    compute no plan of their own.  Rows of K, V and Q
    are the head dim rounded up to 8 plus ``F32_ROW_PAD`` floats; up to
    ``F32_MAX_WARPS`` warps of 16 query rows, each with a staged 16-row Q
    tile past head dim ``8 * F32_Q_REGS`` and, where a branch has several
    ``F32_CHUNK``-key chunks, a score tile of 16 rows of ``score_row``
    floats (walk 1's masked scores, which walk 2 reads back).  The branches
    run one after the other through the same buffers of ``kv_rows`` rows,
    in one of ``F32_MODES``: "both" (K and V whole, staged once), "alt" (one
    buffer: K for walk 1, V for walk 2), "chunked" (a chunk of K and of V at
    a time, the scores recomputed in walk 2, with as many warps as fit).
    The first of ``F32_STAGED_MODES`` that leaves room for two blocks on an
    SM, else the first that fits one, else "chunked".
    {"mode", "warps", "kv_rows", "score_row", "shared_bytes"}."""
    row = 4 * (-(-hd // 8) * 8 + F32_ROW_PAD)
    qtile = 0 if hd <= 8 * F32_Q_REGS else 16 * row
    warps = min(F32_MAX_WARPS, -(-Lq // 16))
    lk = max(Lks)
    rows, nchunk = -(-lk // 8) * 8, -(-lk // F32_CHUNK)
    score_row = nchunk * F32_CHUNK + 8 if nchunk > 1 else 0
    tiles = warps * (qtile + 16 * score_row * 4)
    sizes = {"both": 2 * rows * row + tiles, "alt": rows * row + tiles}
    for limit in (SHARED_BYTES // 2, SHARED_BYTES):
        for mode in F32_STAGED_MODES:
            size = sizes[mode]
            if size <= limit:
                return {"mode": mode, "warps": warps, "kv_rows": rows, "score_row": score_row,
                        "shared_bytes": size}
    if qtile:
        warps = min(warps, (SHARED_BYTES - 2 * F32_CHUNK * row) // qtile)
    return {"mode": "chunked", "warps": warps, "kv_rows": F32_CHUNK, "score_row": 0,
            "shared_bytes": 2 * F32_CHUNK * row + warps * qtile}


def mma_shape(hd: int) -> Tuple[int, int]:
    """(output column groups, most warps a block) of the bf16 body at head
    dim ``hd``: ``MmaBody<HDK>``'s kHalves and kWarps in ``csrc/attention.cu``.
    Past 128 the output columns split in two; 16 warps where a thread fits
    128 registers (head dims to 64, 129-192), 8 elsewhere."""
    hdk = -(-hd // 16)
    return (2 if hdk > 8 else 1), (16 if hdk <= 4 or 8 < hdk <= 12 else 8)


def _bf16_bytes(Lks: Sequence[int], hd: int) -> Tuple[int, int]:
    """(K and V of every branch, one 16-row tile of a round) in bytes of the
    bf16 body's shared memory."""
    row = 2 * (-(-hd // 16) * 16 + MMA_ROW_PAD)
    kv = row * sum(2 * (-(-Lk // 16) * 16) for Lk in Lks)
    return kv, 16 * (row + 8 * sum(-(-Lk // MMA_CHUNK) for Lk in Lks))


def attention_bf16_plan(Lq: int, Lks: Sequence[int], hd: int, blocks: int = None):
    """How the bf16 kernel (``attention_mma`` in ``csrc/attention.cu``) lays
    out one (batch, head); the wrappers pass it to the C entries, which
    compute no plan of their own.  K and V of every branch whole (rows
    padded to 16 keys, columns to 16 plus ``MMA_ROW_PAD``), then a round of
    query rows: their Q rows (the same stride) and, per branch, their mask
    as bits (a 64-bit word for each ``MMA_CHUNK`` keys of a row).  Every
    query row in one round where the rows fit, else the fewest even rounds
    of 16-row tiles.  A round's work items are (branch, output group, tile);
    the block has one warp an item, up to ``mma_shape``'s most, which is
    also what an SM's registers hold.  Given the grid's ``blocks`` (B H),
    the warps are those that finish the grid in the fewest waves of blocks
    times turns of items a warp (an SM holds as many blocks as its shared
    memory and registers allow), on a tie the most blocks an SM, so that
    one block's staging overlaps another's products.  A branch of more than
    ``MMA_CHUNK`` keys has its mask made into bits once for all heads by a
    pass of its own (``prebits``), which the blocks copy; a shorter one's
    blocks make their own.  {"warps", "round_rows", "items", "prebits",
    "shared_bytes"}, or None when K and V leave no room for one tile.
    Memoized: every call with the same arguments returns the same dict,
    which the caller must not change."""
    return _bf16_plan(Lq, tuple(Lks), hd, blocks)


@functools.lru_cache(maxsize=1024)
def _bf16_plan(Lq: int, Lks: Tuple[int, ...], hd: int, blocks) -> dict:
    halves, most = mma_shape(hd)
    kv, per_tile = _bf16_bytes(Lks, hd)
    tiles, fit = -(-Lq // 16), (SHARED_BYTES - kv) // per_tile
    if fit < 1:
        return None
    round_tiles = -(-tiles // -(-tiles // fit))
    items = round_tiles * halves * len(Lks)
    shared = kv + round_tiles * per_tile
    warps = min(items, most)
    if blocks is not None:
        by_shared = SM_SHARED_BYTES // (shared + BLOCK_RESERVED_BYTES)

        def cost(w):
            per_sm = min(by_shared, most // w)
            return -(-blocks // (SM_COUNT * per_sm)) * -(-items // w), -per_sm

        warps = min(range(1, warps + 1), key=cost)
    return {"warps": warps, "round_rows": 16 * round_tiles, "items": items,
            "prebits": tuple(Lk > MMA_CHUNK for Lk in Lks), "shared_bytes": shared}


def _plan_args(dtype: torch.dtype, Lq: int, Lks: Sequence[int], hd: int,
               blocks: int = None) -> tuple:
    """The plan as the C entries take it (mode, warps, kv_rows, score_row,
    shared_bytes): the f32 plan's, or the bf16 plan's for a grid of
    ``blocks`` (warps, query rows a round, shared memory; mode and
    score_row 0)."""
    if dtype != torch.float32:
        plan = attention_bf16_plan(Lq, Lks, hd, blocks)
        return 0, plan["warps"], plan["round_rows"], 0, plan["shared_bytes"]
    plan = attention_f32_plan(Lq, Lks, hd)
    return (F32_MODES.index(plan["mode"]), plan["warps"], plan["kv_rows"], plan["score_row"],
            plan["shared_bytes"])


def _bits_scratch(dtype: torch.dtype, Lq: int, Lks: Sequence[int], hd: int, B: int,
                  device) -> list:
    """Per branch, the pointer to the scratch the bf16 plan's mask-bits pass
    writes (B Lq ceil(Lk / ``MMA_CHUNK``) 64-bit words), or None, and the
    tensors that hold them."""
    held = [None] * len(Lks)
    if dtype == torch.bfloat16:
        for n, (Lk, pre) in enumerate(zip(Lks, attention_bf16_plan(Lq, Lks, hd)["prebits"])):
            if pre:
                held[n] = torch.empty(B * Lq * -(-Lk // MMA_CHUNK), dtype=torch.int64,
                                      device=device)
    return [t if t is None else t.data_ptr() for t in held], held


def attention_shared_bytes(dtype: torch.dtype, Lq: int, Lks: Sequence[int], hd: int) -> int:
    """Shared memory of the attention kernels: the plan's (``attention_f32_plan``,
    which fits one block at every length and head dims to 256;
    ``attention_bf16_plan``), or for a bf16 shape with no plan what one
    16-row tile would need beside K and V."""
    if dtype == torch.float32:
        return attention_f32_plan(Lq, Lks, hd)["shared_bytes"]
    plan = attention_bf16_plan(Lq, Lks, hd)
    return plan["shared_bytes"] if plan is not None else sum(_bf16_bytes(Lks, hd))


def attention_refusal(dtype: torch.dtype, Lq: int, Lks: Sequence[int], hd: int):
    """Why #1/#2's kernels do not take these shapes, or None when they do:
    every length at least 1, the head dim within the type's limit, shared
    memory within one block's."""
    if min(Lq, *Lks) < 1:
        return f"every length must be at least 1, got Lq {Lq}, Lk {list(Lks)}"
    limit = MMA_MAX_HEAD_DIM if dtype == torch.bfloat16 else F32_MAX_HEAD_DIM
    if not 1 <= hd <= limit:
        return f"the {dtype} kernel takes head dims up to {limit}, got {hd}"
    need = attention_shared_bytes(dtype, Lq, Lks, hd)
    if need > SHARED_BYTES:
        return (f"Lq {Lq} and Lk {list(Lks)} at head dim {hd} need {need} bytes of shared "
                f"memory, more than the {SHARED_BYTES} a block has")
    return None


def attention_takes(dtype: torch.dtype, Lq: int, Lks: Sequence[int], hd: int) -> bool:
    """Whether #1 (``Lks = (Lk,)``) or #2 (``Lks = (L, M)``) takes these
    shapes: the models' gates read it before a launch, the wrappers raise
    on what it refuses."""
    return dtype in _DTYPE_CODE and attention_refusal(dtype, Lq, Lks, hd) is None


def _check_attention(dtype: torch.dtype, Lq: int, Lks: Sequence[int], hd: int, what: str):
    reason = attention_refusal(dtype, Lq, Lks, hd)
    if reason is not None:
        raise ValueError(f"{what}: {reason}")


def cq_shared_bytes(Lc: int, Lq: int, stage_cols: int, out_cols: int, size: int,
                    scores_shared: bool) -> int:
    """Shared memory of ``vmr_cq_attention`` for one batch element, in the
    kernel's order: S and S_t (f32, Lc by Lq, rows padded to 16 and Lq to 16
    plus ``CQ_SCORE_PAD``) when shared; 3 f32 per row of c and of q; w4mlu,
    w4C and w4Q over the staged columns (f32); c and q over ``stage_cols``
    columns in the input type (``size`` bytes); S_t^T c over ``out_cols``
    columns (bf16 as hi and lo, f32 as itself: 4 bytes either way), each row
    padded by ``CQ_ROW_PAD_BYTES``."""
    lcp, lqp = -(-Lc // 16) * 16, -(-Lq // 16) * 16
    pad = CQ_ROW_PAD_BYTES // size
    floats = (2 * lcp * (lqp + CQ_SCORE_PAD) if scores_shared else 0) + 3 * (lcp + lqp) \
        + 3 * stage_cols
    return 4 * floats + size * (lcp + lqp) * (stage_cols + pad) + 4 * lqp * (out_cols + pad)


def _even_chunks(n: int, most: int, gran: int) -> int:
    """The width of each of the fewest even chunks of ``n`` columns that are
    at most ``most`` wide, rounded up to ``gran`` (``most`` is a multiple of
    ``gran``, so the width is at most ``most``)."""
    width = -(-n // -(-n // most))
    return -(-width // gran) * gran


def _cq_layout(Lc: int, Lq: int, D: int, dtype: torch.dtype):
    """``cq_plan``'s layout, or None when no layout fits one block."""
    size, gran = torch.finfo(dtype).bits // 8, CQ_COLS[dtype]
    lcp, lqp = -(-Lc // 16) * 16, -(-Lq // 16) * 16
    widest = -(-D // gran) * gran
    fit = lambda room, per: room // per // gran * gran  # noqa: E731
    for shared in (1, 0):
        fixed = cq_shared_bytes(Lc, Lq, 0, 0, size, shared)
        per_stage = cq_shared_bytes(Lc, Lq, 1, 0, size, shared) - fixed
        per_out = 4 * lqp
        room = SHARED_BYTES - fixed
        if room < (per_stage + per_out) * gran:
            continue
        both = _even_chunks(widest, fit(room, per_stage + per_out), gran)
        stage = _even_chunks(widest, fit(room - per_out * both, per_stage), gran)
        out = _even_chunks(stage, fit(room - per_stage * stage, per_out), gran)
        return {"stage_cols": stage, "out_cols": out, "scores_shared": shared,
                "scratch_floats": 0 if shared else 2 * lcp * (lqp + CQ_SCORE_PAD),
                "shared_bytes": cq_shared_bytes(Lc, Lq, stage, out, size, shared)}
    return None


def cq_refusal(Lc: int, Lq: int, D: int, dtype: torch.dtype = torch.bfloat16):
    """Why #3's kernel does not take these shapes, or None when it does:
    Lc and Lq from 1 to ``CQ_MAX_LEN``, D from 1 to ``CQ_MAX_D``, and a
    layout that fits one block."""
    if not (1 <= Lc <= CQ_MAX_LEN and 1 <= Lq <= CQ_MAX_LEN) or not 1 <= D <= CQ_MAX_D:
        return (f"the kernel takes Lc and Lq from 1 to {CQ_MAX_LEN} and D up to {CQ_MAX_D}, "
                f"got Lc {Lc}, Lq {Lq}, D {D}")
    if _cq_layout(Lc, Lq, D, dtype) is None:
        return f"Lc {Lc}, Lq {Lq} do not fit one block"
    return None


def cq_takes(Lc: int, Lq: int, D: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether #3 takes these shapes: the models' gate reads it before a
    launch, ``cq_plan`` (so the wrapper) raises on what it refuses."""
    return dtype in _DTYPE_CODE and cq_refusal(Lc, Lq, D, dtype) is None


def cq_plan(Lc: int, Lq: int, D: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """How ``vmr_cq_attention`` lays out one batch element in one block's
    shared memory: the scores S and S_t there (``scores_shared``) whenever
    they fit with the narrowest chunks, else in a scratch of
    ``scratch_floats`` per element; then the widest even chunks of columns
    that fit, all multiples of ``CQ_COLS[dtype]``: first one width for both
    (so that neither is starved), then ``stage_cols`` (columns of c and q
    staged at a time) as wide as that leaves room for, then ``out_cols``
    (columns of S_t^T c and of the outputs at a time, within a staged
    chunk); ``shared_bytes`` in all.  Raises on what ``cq_takes`` refuses."""
    reason = cq_refusal(Lc, Lq, D, dtype)
    if reason is not None:
        raise ValueError(f"fused_cq_attention: {reason}")
    return _cq_layout(Lc, Lq, D, dtype)


# ------------------------------------------------------------------ wrappers


def fused_masked_attention(q, k, v, mask):
    """softmax(q k^T / sqrt(hd) masked) v over (B, H, L, hd) tensors.

    mask: (B, Lq, Lk) {0,1}, shared by the heads.
    """
    if q.device.type == "cpu":
        return plain_route("fused_masked_attention", masked_attention_plain, q, k, v, mask)
    refuse_detached((q, k, v), "fused_masked_attention")
    dtype = _check_cuda((q, k, v), "fused_masked_attention")
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    _check_attention(dtype, Lq, (Lk,), hd, "fused_masked_attention")
    mask = _as(mask, q, (B, Lq, Lk))
    out = _head_major_out(q, Lq)
    bits, _held = _bits_scratch(dtype, Lq, (Lk,), hd, B, q.device)
    with launch_range("fused_masked_attention"):
        err = load_kernels().vmr_masked_attention(
            _DTYPE_CODE[dtype], *_view(q), *_view(k), *_view(v), mask.data_ptr(), *bits,
            *_view(out), B, H, Lq, Lk, hd, 1.0 / math.sqrt(hd),
            *_plan_args(dtype, Lq, (Lk,), hd, B * H),
            _stream(q))
    _raise_on(err, "vmr_masked_attention")
    fused_masked_attention.launches += 1
    count_plain(masked_attention_plain, q, k, v, mask, name="fused_masked_attention")
    return out


def fused_dual_attention(q, f_k, f_v, t_k, t_v, s_mask, x_mask):
    """SeqPAN's dual attention core: (s_value, x_value), both (B, H, L, hd).

    q/f_k/f_v: (B, H, L, hd); t_k/t_v: (B, H, M, hd);
    s_mask: (B, L, L); x_mask: (B, L, M), {0,1}.
    """
    if q.device.type == "cpu":
        return plain_route("fused_dual_attention", dual_attention_plain, q, f_k, f_v, t_k, t_v,
                           s_mask, x_mask)
    refuse_detached((q, f_k, f_v, t_k, t_v), "fused_dual_attention")
    dtype = _check_cuda((q, f_k, f_v, t_k, t_v), "fused_dual_attention")
    B, H, L, hd = q.shape
    M = t_k.shape[2]
    if f_k.shape != q.shape or f_v.shape != q.shape or t_k.shape != (B, H, M, hd) \
            or t_v.shape != t_k.shape:
        raise ValueError("fused_dual_attention: q/f_k/f_v must be (B, H, L, hd) and "
                         "t_k/t_v (B, H, M, hd)")
    _check_attention(dtype, L, (L, M), hd, "fused_dual_attention")
    s_mask = _as(s_mask, q, (B, L, L))
    x_mask = _as(x_mask, q, (B, L, M))
    s_out, x_out = _head_major_out(q, L), _head_major_out(q, L)
    bits, _held = _bits_scratch(dtype, L, (L, M), hd, B, q.device)
    with launch_range("fused_dual_attention"):
        err = load_kernels().vmr_dual_attention(
            _DTYPE_CODE[dtype], *_view(q), *_view(f_k), *_view(f_v), *_view(t_k), *_view(t_v),
            s_mask.data_ptr(), x_mask.data_ptr(), *bits, *_view(s_out), *_view(x_out),
            B, H, L, M, hd, 1.0 / math.sqrt(hd), *_plan_args(dtype, L, (L, M), hd, B * H),
            _stream(q))
    _raise_on(err, "vmr_dual_attention")
    fused_dual_attention.launches += 1
    count_plain(dual_attention_plain, q, f_k, f_v, t_k, t_v, s_mask, x_mask,
                name="fused_dual_attention")
    return s_out, x_out


def _cq_launch(entry, context, query, w4C, w4Q, w4mlu, c_mask, q_mask, *extra):
    """Checks and plans one launch of ``entry`` (``vmr_cq_attention``, or
    ``vmr_cq_attention_clocked`` with the clocks' pointer in ``extra``) on
    CUDA tensors; ((c2q, q2c), the seven inputs as the kernel reads them)."""
    dtype = _check_cuda((context, query), "fused_cq_attention")
    B, Lc, D = context.shape
    Lq = query.shape[1]
    if query.shape != (B, Lq, D):
        raise ValueError(f"context {tuple(context.shape)} and query {tuple(query.shape)} disagree")
    plan = cq_plan(Lc, Lq, D, dtype)
    context, query = context.contiguous(), query.contiguous()
    w4C, w4Q = _as(w4C, context, (D, 1)), _as(w4Q, context, (D, 1))
    w4mlu = _as(w4mlu, context, (1, 1, D))
    c_mask, q_mask = _as(c_mask, context, (B, Lc)), _as(q_mask, context, (B, Lq))
    c2q, q2c = torch.empty_like(context), torch.empty_like(context)
    scratch = torch.empty(B * plan["scratch_floats"], dtype=torch.float32, device=context.device)
    with launch_range("fused_cq_attention"):
        err = entry(
            _DTYPE_CODE[dtype], context.data_ptr(), query.data_ptr(), w4C.data_ptr(),
            w4Q.data_ptr(), w4mlu.data_ptr(), c_mask.data_ptr(), q_mask.data_ptr(),
            c2q.data_ptr(), q2c.data_ptr(), scratch.data_ptr() if scratch.numel() else None,
            B, Lc, Lq, D, plan["stage_cols"], plan["out_cols"], plan["scores_shared"],
            plan["shared_bytes"], _stream(context), *extra)
    _raise_on(err, "vmr_cq_attention")
    return (c2q, q2c), (context, query, w4C, w4Q, w4mlu, c_mask, q_mask)


def fused_cq_attention(context, query, w4C, w4Q, w4mlu, c_mask, q_mask):
    """(c2q, q2c), both (B, Lc, D): the two attention outputs CQAttention
    concatenates.  context (B, Lc, D), query (B, Lq, D), w4C/w4Q (D, 1),
    w4mlu (1, 1, D), c_mask (B, Lc), q_mask (B, Lq)."""
    if context.device.type == "cpu":
        return plain_route("fused_cq_attention", cq_attention_plain, context, query, w4C, w4Q,
                           w4mlu, c_mask, q_mask)
    refuse_detached((context, query, w4C, w4Q, w4mlu), "fused_cq_attention")
    out, read = _cq_launch(load_kernels().vmr_cq_attention, context, query, w4C, w4Q, w4mlu,
                           c_mask, q_mask)
    fused_cq_attention.launches += 1
    count_plain(cq_attention_plain, *read, name="fused_cq_attention")
    return out


def cq_phase_clocks(context, query, w4C, w4Q, w4mlu, c_mask, q_mask) -> torch.Tensor:
    """A measurement, off the main path (not counted as a launch): one launch
    of #3's kernel that also returns each block's SM clocks per phase,
    (B, len(CQ_PHASES)) int64."""
    clocks = torch.zeros(context.shape[0], len(CQ_PHASES), dtype=torch.int64,
                         device=context.device)
    _cq_launch(load_kernels().vmr_cq_attention_clocked, context, query, w4C, w4Q, w4mlu, c_mask,
               q_mask, clocks.data_ptr())
    return clocks


# ------------------------------------------------ the train route's Functions


RECOMPUTE_SPAN = "vmr_attention_recompute_backward"  # the profiler's name for the backward


def _recompute_vjp(ctx, reference, grads):
    """The gradients of ``reference`` at the saved inputs for the
    cotangents ``grads``, None for an input that needs none (the masks);
    a ``RECOMPUTE_SPAN`` range for ``torch.profiler``."""
    needs = ctx.needs_input_grad
    with torch.enable_grad(), torch.profiler.record_function(RECOMPUTE_SPAN):
        xs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        outs = reference(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        got = iter(torch.autograd.grad(outs, [x for x, n in zip(xs, needs) if n], grads))
    return tuple(next(got) if n else None for n in needs)


class MaskedAttentionFunction(torch.autograd.Function):
    """Kernel #1 forward; backward the VJP of ``masked_attention_reference``."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return fused_masked_attention(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        return _recompute_vjp(ctx, masked_attention_reference, (g,))


class DualAttentionFunction(torch.autograd.Function):
    """Kernel #2 forward; backward the VJP of ``dual_attention_reference``."""

    @staticmethod
    def forward(ctx, q, f_k, f_v, t_k, t_v, s_mask, x_mask):
        ctx.save_for_backward(q, f_k, f_v, t_k, t_v, s_mask, x_mask)
        return fused_dual_attention(q, f_k, f_v, t_k, t_v, s_mask, x_mask)

    @staticmethod
    def backward(ctx, g_s, g_x):
        return _recompute_vjp(ctx, dual_attention_reference, (g_s, g_x))


class CQAttentionFunction(torch.autograd.Function):
    """Kernel #3 forward; backward the VJP of ``cq_attention_reference``."""

    @staticmethod
    def forward(ctx, context, query, w4C, w4Q, w4mlu, c_mask, q_mask):
        ctx.save_for_backward(context, query, w4C, w4Q, w4mlu, c_mask, q_mask)
        return fused_cq_attention(context, query, w4C, w4Q, w4mlu, c_mask, q_mask)

    @staticmethod
    def backward(ctx, g_c2q, g_q2c):
        return _recompute_vjp(ctx, cq_attention_reference, (g_c2q, g_q2c))


def masked_attention(q, k, v, mask):
    """``fused_masked_attention``, differentiable in q, k and v."""
    return MaskedAttentionFunction.apply(q, k, v, mask)


def dual_attention(q, f_k, f_v, t_k, t_v, s_mask, x_mask):
    """``fused_dual_attention``, differentiable in q and the four keys and values."""
    return DualAttentionFunction.apply(q, f_k, f_v, t_k, t_v, s_mask, x_mask)


def cq_attention(context, query, w4C, w4Q, w4mlu, c_mask, q_mask):
    """``fused_cq_attention``, differentiable in everything but the masks."""
    return CQAttentionFunction.apply(context, query, w4C, w4Q, w4mlu, c_mask, q_mask)


KERNELS = (fused_masked_attention, fused_dual_attention, fused_cq_attention)
for _fn in KERNELS:
    _fn.launches = 0
