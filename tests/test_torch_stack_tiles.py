"""Kernel #4's schedule, emulated in torch on the CPU against the plain
version (``dual_attention_stack_plain``).

``csrc/dual_stack.cu`` (its body ``dual_stack.cuh``) cannot run here.
``emulate_stack`` repeats its schedule at each width D with the kernel's
rounding points (``SCHEDULES[D]``: the rows of a tile, the most keys of one
stage, the keys of a longer side's chunk): every call first projects both sides' keys and values a tile of
rows at a time and keeps them in the compute type, then walks the from-rows
in tiles (64 rows at D 128, 32 at D 256, 16 at D 384 and 512).  Its
attention (``_attend``) is the kernel's mma tasks: ``TASK_ROWS`` query rows
and one head (rows past the tile's length invalid, computed and dropped),
the head dim padded with zeros to the instruction's k (16 for bf16's
m16n8k16, 8 for f32's m16n8k8) and P.V's n to 8 (the wider widths' shared
kernels pad it further, to 16-128, with more zeros: the same sums; the
narrow heads, 1, 2, 3 and 6, take one k-step and one n-tile, ``NARROW_HD``;
the wide ones, 192-512, are multiples of 16 and padded not at all).  A side
of at most a stage's keys is one stage (the chunk's keys or the stage's,
-inf past the side) and one walk; a longer one goes in chunks: bf16 walks
twice (the max and sum over stage-sized chunks with rescaling, then p =
exp(s - max) (1 / sum) rounded to bf16 and P.V over chunks, summed in f32
and rounded after the last), f32 once (chunks, the max and sum rescaled as
they grow and the context with them, times 1 / sum after the last).  At the
wider D a long self attention stages its values in the buffer of fn, which
the tile takes again from LN1 of its rows: the same values.  bf16 products are exact in f32 (bf16 operands, f32 sums);
f32 products are 3xTF32 in steps of 8 (``tests/_tf32.py``).  A planted
fault (``quad_max=False``: each lane's row max over its own columns, not
reduced over the quad of lanes that holds the row) must fail.

At D 640, 768, 896 and 1024 the kernel is a cluster of D / 128 CTAs a
sample (``csrc/dual_stack_cluster.cu``); ``emulate_stack(..., cluster=True)``
repeats that schedule: rows in tiles of 32, keys in stages and chunks of 32
(``CLUSTER_SCHEDULE``), every product summed over the 128-row k-chunks of W
in rank order (the BiLinear's two operands into one sum, fn's chunks
first), each LayerNorm's mean and variance from the 128-column slices'
partial sums added in rank order, and each head's scores as the sum, in
rank order, of its pieces' partial products (a head cut at the 128-column
slice edges), before one softmax and P.V.

Cases: lengths at and past tile and chunk edges (65, 129, 256 video rows;
30 and 257 text rows), a wholly masked sample, a valid video facing an empty
text side, 8 heads of 16, 16 heads of 8, 32 heads of 4 and 64 and 128 heads
of 2 and 1 (head dims padded to the instruction's k and n); at D 256, 384
and 512 the video side past a tile of 32 or 16 rows, a short pair in one
stage, 4 and 8 heads (head dims 32-128; 48 and 12 at D 384), and every
wide and narrow head dim (192-512; 1, 2, 3, 6) with a side longer than a
stage, so that the max and sum of each (row, head) are carried between
chunks.  Inputs and weights are made with numpy from a seed.  Tolerances: f32 1e-5 (the same products, summed in another order,
3xTF32 within ~2^-22 of each); bf16 2**-6 of the largest output (a few bf16
ulps: a p rounded on either side of a bf16 boundary where the two sums
differ in their last bit).  The schedule's constants, the widths and the
narrow and the longest head dims and the narrow heads' statistics are read
back from the CUDA source.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import math
import re
from pathlib import Path

import _tf32
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vmrframe_tpu_torch.kernels import dual_stack as S
from vmrframe_tpu_torch.ops.masking import MASK_VALUE

D = 128
CSRC = Path(S.__file__).resolve().parent / "csrc" / "dual_stack.cuh"  # the body
CLUSTER_SRC = CSRC.with_name("dual_stack_cluster.cu")  # the body at D 640-1024
# the kernel's schedule at each width (Lay<D>'s kTile, kStage, kKeys in the
# source): rows per tile; the most keys one stage holds; keys per chunk of a
# longer side; and (kRows) query rows per warp task
SCHEDULES = {128: (64, 64, 32), 256: (32, 32, 32), 384: (16, 16, 16), 512: (16, 16, 16)}
TILE_ROWS, STAGE_KEYS, CHUNK_KEYS = SCHEDULES[D]
# the cluster's (kCTile, kCStage, kCStage) and the columns a CTA owns (kSlice)
CLUSTER_SCHEDULE, SLICE = (32, 32, 32), 128
TASK_ROWS = 16
MMA_K = {torch.bfloat16: 16, torch.float32: 8}  # m16n8k16 bf16, m16n8k8 tf32
MMA_N = 8
NARROW_HD = 8  # the narrow heads' body (kNarrowHD): one k-step and one n-tile


def _up(n, m):
    return -(-n // m) * m


def _pieces(h, hd):
    """Head h's global columns cut at the slice edges, in rank order."""
    a, end = h * hd, (h + 1) * hd
    while a < end:
        b = min(end, (a // SLICE + 1) * SLICE)
        yield a, b
        a = b


def _chunk_dot(w, *operands):
    """The cluster's product: each operand (..., D) in the compute type
    against w (D, D), summed in f32 over the 128-row k-chunks in rank order,
    the operands one after another into the same sum."""
    acc = 0
    for x in operands:
        for k0 in range(0, x.shape[-1], SLICE):
            acc = acc + x[..., k0:k0 + SLICE].float() @ w[k0:k0 + SLICE].float()
    return acc


def _cluster_ln(x, s, b, eps=1e-6):
    """LayerNorm as the cluster takes it: the slices' partial sums added in
    rank order, times 1 / D, for the mean, then the same for the squared
    deviations."""
    x = x.float()
    D = x.shape[-1]

    def total(t):
        acc = 0
        for r0 in range(0, D, SLICE):
            acc = acc + t[..., r0:r0 + SLICE].sum(-1, keepdim=True)
        return acc

    mu = total(x) * (1.0 / D)
    var = total((x - mu).square()) * (1.0 / D)
    return (x - mu) * torch.rsqrt(var + eps) * s + b


def _attend(q, k, v, fm, km, H, cd, quad_max=True, cluster=False):
    """The kernel's attention of q (B, M, D) over k, v (B, T, D), all in
    cd; fm (B, M) and km (B, T) validities; the context (B, M, D) in cd.
    With ``cluster`` each head's scores are its pieces' partial products
    added in rank order."""
    B, M, Dq = q.shape
    T, hd = k.shape[1], Dq // H
    _, STAGE_KEYS, CHUNK_KEYS = CLUSTER_SCHEDULE if cluster else SCHEDULES[Dq]
    Mp = _up(M, TASK_ROWS)  # whole tasks: the rows past M invalid
    f32 = cd == torch.float32
    prod = _tf32.product if f32 else torch.matmul

    def heads(x, rows, cols):  # (B, H, rows, cols): zero rows and head columns past x's
        x = x.float().unflatten(-1, (H, hd))
        return F.pad(x, (0, cols - hd, 0, 0, 0, rows - x.shape[1])).transpose(1, 2)

    Tp = _up(T, CHUNK_KEYS if T <= CHUNK_KEYS else STAGE_KEYS)  # the stages' keys
    qh = heads(q, Mp, _up(hd, MMA_K[cd]))
    kh = heads(k, Tp, _up(hd, MMA_K[cd]))
    vh = heads(v, Tp, _up(hd, MMA_N))
    fmp = F.pad(fm.float(), (0, Mp - M))[:, None, :, None]
    kmp = F.pad(km.float(), (0, Tp - T))[:, None, None, :]

    qp = F.pad(q.float(), (0, 0, 0, Mp - M))
    kp = F.pad(k.float(), (0, 0, 0, Tp - T))

    def products(c0, c1):  # q k^T over keys [c0, c1): (B, H, Mp, c1 - c0)
        if not cluster:
            return prod(qh, kh[:, :, c0:c1].transpose(-1, -2))
        heads_ = []
        for h in range(H):
            s = 0
            for a, b in _pieces(h, hd):
                s = s + prod(qp[..., a:b], kp[:, c0:c1, a:b].transpose(-1, -2))
            heads_.append(s)
        return torch.stack(heads_, 1)

    def scores(c0, c1):  # keys [c0, c1) of the side: scaled, masked, -inf past T
        s = products(c0, c1) * (1.0 / math.sqrt(hd))
        s = s + MASK_VALUE * (1.0 - fmp * kmp[..., c0:c1])
        return s.masked_fill(torch.arange(c0, c1) >= T, -math.inf)

    def row_max(s):  # over the quad: lane t of a row holds columns 8 j + 2 t, + 1
        if quad_max:
            return s.amax(-1, keepdim=True)
        lane = torch.arange(s.shape[-1]) % MMA_N // 2
        m = torch.empty_like(s)
        for t in range(4):
            m[..., lane == t] = s[..., lane == t].amax(-1, keepdim=True)
        return m

    if T <= STAGE_KEYS:  # one stage, one walk
        s = scores(0, Tp)
        e = torch.exp(s - row_max(s))
        p = (e * (1.0 / e.sum(-1, keepdim=True))).to(cd).float()
        ctx = prod(p, vh)
    elif f32:  # one walk, the max and sum rescaled as they grow
        # with the fault each lane rescales by its own max, and lane 0's max
        # and sum are what the next chunk reads back: the output column c is
        # held by the lane of key column 2 ((c mod 8) / 2)
        lane = (lambda x: x) if quad_max else \
            (lambda x: x[..., torch.arange(vh.shape[-1]) % MMA_N // 2 * 2])  # noqa: E731
        m = torch.full((B, H, Mp, 1), -math.inf)
        l = torch.zeros(B, H, Mp, 1)
        ctx = torch.zeros(B, H, Mp, vh.shape[-1])
        for c0 in range(0, T, CHUNK_KEYS):
            s = scores(c0, c0 + CHUNK_KEYS)
            m_new = torch.maximum(m, row_max(s))
            f = torch.exp(m - m_new)
            e = torch.exp(s - m_new)
            l_new = l * f + e.sum(-1, keepdim=True)
            ctx = ctx * lane(f) + prod(e, vh[:, :, c0:c0 + CHUNK_KEYS])
            m, l = m_new[..., :1], l_new[..., :1]
        ctx = ctx * (1.0 / lane(l_new))
    else:  # bf16: max and sum first, then p rounded and P.V
        m = torch.full((B, H, Mp, 1), -math.inf)
        l = torch.zeros(B, H, Mp, 1)
        for c0 in range(0, T, STAGE_KEYS):
            s = scores(c0, c0 + STAGE_KEYS)
            m_new = torch.maximum(m, row_max(s))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
            m = m_new
        ctx = torch.zeros(B, H, Mp, vh.shape[-1])
        inv = 1.0 / l
        for c0 in range(0, T, CHUNK_KEYS):
            p = (torch.exp(scores(c0, c0 + CHUNK_KEYS) - m) * inv).to(cd).float()
            ctx = ctx + p @ vh[:, :, c0:c0 + CHUNK_KEYS]
    return ctx[:, :, :M, :hd].transpose(1, 2).reshape(B, M, Dq).to(cd)


def _dab_tiles(x, y, fm, tm, W, b, ln, xb, H, cd, quad_max=True, cluster=False):
    """One DualAttentionBlock call in the kernel's schedule (with
    ``cluster``, the cluster's); (B, F, D) f32."""
    if cluster:
        dot, ln_, TILE_ROWS = (lambda a, w: _chunk_dot(w, a)), _cluster_ln, CLUSTER_SCHEDULE[0]
        dot2 = lambda a, c, w: _chunk_dot(w, a, c)  # noqa: E731
    else:
        dot, ln_, TILE_ROWS = S._dot, S._ln, SCHEDULES[x.shape[2]][0]
        dot2 = lambda a, c, w: S._dot(a, w) + S._dot(c, w)  # noqa: E731

    def keys_values(src, lns, lnb, wk, wv):
        ks, vs = [], []
        for r0 in range(0, src.shape[1], TILE_ROWS):
            n = ln_(src[:, r0:r0 + TILE_ROWS], ln[lns], ln[lnb]).to(cd)
            ks.append((dot(n, W[wk]) + b[wk]).to(cd))
            vs.append((dot(n, W[wv]) + b[wv]).to(cd))
        return torch.cat(ks, 1), torch.cat(vs, 1)

    tk, tv = keys_values(y, S.LNT_S, S.LNT_B, S.W_TK, S.W_TV)
    fk, fv = keys_values(x, S.LN1_S, S.LN1_B, S.W_FK, S.W_FV)
    out = []
    for r0 in range(0, x.shape[1], TILE_ROWS):
        xt, fmt = x[:, r0:r0 + TILE_ROWS].float(), fm[:, r0:r0 + TILE_ROWS]
        fn = ln_(xt, ln[S.LN1_S], ln[S.LN1_B]).to(cd)
        q = (dot(fn, W[S.W_Q]) + b[S.W_Q]).to(cd)
        x_att = _attend(q, tk, tv, fmt, tm, H, cd, quad_max, cluster)
        s_att = _attend(q, fk, fv, fmt, fm, H, cd, quad_max, cluster)
        x_value = dot(x_att, W[S.W_XD]) + b[S.W_XD]
        s_value = dot(s_att, W[S.W_SD]) + b[S.W_SD]
        x_score = dot(x_value.to(cd), W[S.W_XG]) + b[S.W_XG]
        s_score = dot(s_value.to(cd), W[S.W_SG]) + b[S.W_SG]
        gc = (dot((s_score * x_value + x_score * s_value).to(cd), W[S.W_GD]) + b[S.W_GD]).to(cd)
        scores = dot2(fn, gc, W[S.W_BL1]) + 2.0 * b[S.W_BL1] + xb[0]
        values = dot2(fn, gc, W[S.W_BL2]) + 2.0 * b[S.W_BL2] + xb[1]
        dma = torch.sigmoid(scores + MASK_VALUE * (1.0 - fmt[:, :, None])) * values
        residual = dot(dma.to(cd), W[S.W_D1]) + b[S.W_D1] + xt
        z = ln_(residual, ln[S.LN2_S], ln[S.LN2_B])
        out.append(dot(z.to(cd), W[S.W_D2]) + b[S.W_D2] + residual)
    return torch.cat(out, 1)


def emulate_stack(vfeat, tfeat, vmask, tmask, p1, p2, num_heads, quad_max=True, cluster=False):
    """The 2-layer stack in the kernel's schedule (nothing rounded between
    the layers; with ``cluster``, the schedule of a cluster of D / 128
    CTAs); ``quad_max=False`` plants the fault of a row max not reduced
    over the quad."""
    cd = p1["W"].dtype
    vm, tm = vmask.float(), tmask.float()
    v, t = vfeat, tfeat
    for p in (p1, p2):
        args = (p["W"], p["b"].float(), p["ln"].float(), p["xb"].float(), num_heads, cd,
                quad_max, cluster)
        v, t = _dab_tiles(v, t, vm, tm, *args), _dab_tiles(t, v, tm, vm, *args)
    return v.to(vfeat.dtype), t.to(tfeat.dtype)


def _stacks(rng, dtype, D=D):
    """One layer's stacks at width D with every leaf random."""
    W = rng.standard_normal((14, D, D)).astype(np.float32) / math.sqrt(D)
    ln = 0.1 * rng.standard_normal((6, D)).astype(np.float32)
    ln[0::2] += 1.0  # the scales
    return {"W": torch.from_numpy(W).to(dtype),
            "b": torch.from_numpy(0.1 * rng.standard_normal((14, D)).astype(np.float32)),
            "ln": torch.from_numpy(ln),
            "xb": torch.from_numpy(0.1 * rng.standard_normal((2, D)).astype(np.float32))}


def _case(seed, B, Lv, Lt, dtype, empty_to_side=False, D=D):
    """Features, masks of random lengths (the last sample wholly masked when
    B > 2; sample 0's text side empty with empty_to_side) and two layers'
    stacks, at width D."""
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.standard_normal((B, Lv, D)).astype(np.float32)).to(dtype)
    t = torch.from_numpy(rng.standard_normal((B, Lt, D)).astype(np.float32)).to(dtype)
    vlens, tlens = rng.integers(Lv // 2, Lv + 1, B), rng.integers(1, Lt + 1, B)
    if B > 2:
        vlens[-1] = tlens[-1] = 0
    if empty_to_side:
        vlens[0], tlens[0] = Lv, 0
    vm = torch.from_numpy((np.arange(Lv)[None] < vlens[:, None]).astype(np.float32))
    tm = torch.from_numpy((np.arange(Lt)[None] < tlens[:, None]).astype(np.float32))
    return v, t, vm, tm, _stacks(rng, dtype, D), _stacks(rng, dtype, D)


CASES = [  # B, Lv, Lt, heads, empty_to_side
    (2, 65, 30, 4, False),    # one row past a tile
    (2, 129, 30, 4, False),   # past two tiles and four chunks
    (3, 256, 30, 4, False),   # TACoS length, a wholly masked sample
    (2, 30, 257, 4, False),   # the text side walks 257 video keys
    (3, 129, 257, 8, False),  # 8 heads of 16, both sides long
    (2, 256, 30, 4, True),    # a valid video facing an empty text side
    (2, 64, 30, 16, False),   # 16 heads of 8, one stage each way (8 and 4 key tiles)
    (2, 30, 100, 32, False),  # 32 heads of 4, one stage and chunks
    (2, 70, 30, 64, False),   # 64 heads of 2: the video side past a stage
    (3, 30, 70, 128, True),   # 128 heads of 1: the text side past a stage; an empty one
]
HEAD_CASES = CASES[-4:]  # head dims 8, 4, 2, 1: k and n padded in registers
WIDE_CASES = [  # D, B, Lv, Lt, heads, empty_to_side: the wider widths' tiles and chunks
    (256, 3, 40, 30, 4, False),   # past a 32-row tile; the text side in one stage
    (256, 2, 30, 33, 8, True),    # the video side one past a stage; an empty text side
    (384, 3, 20, 17, 8, False),   # head dim 48; both sides past a 16-row tile
    (384, 2, 13, 5, 32, False),   # head dim 12; one stage each way
    (512, 3, 33, 9, 4, False),    # head dim 128; past two tiles
    (512, 2, 17, 16, 8, True),    # head dim 64; an empty text side
    # the wide and the narrow heads, a side longer than a stage
    (256, 2, 40, 33, 1, False),   # head dim 256; both sides past a stage of 32
    (256, 3, 20, 34, 128, False),  # head dim 2
    (384, 2, 17, 20, 2, False),   # head dim 192
    (384, 3, 20, 5, 128, True),   # head dim 3; an empty text side
    (384, 2, 18, 17, 64, False),  # head dim 6
    (384, 2, 17, 9, 1, False),    # head dim 384
    (512, 2, 20, 17, 1, False),   # head dim 512
    (512, 3, 9, 18, 512, False),  # head dim 1
]
# D, B, Lv, Lt, heads, empty_to_side: the cluster's widths (kCTile 32, kCStage 32)
CLUSTER_CASES = [
    (640, 3, 40, 30, 4, False),    # heads of 160 across slice edges; the video side past a tile
    (768, 2, 33, 9, 4, True),      # heads of 192; past a stage; an empty text side
    (640, 2, 20, 34, 128, False),  # head dim 5 (narrow), across edges; the text side past a stage
    (768, 3, 17, 12, 64, False),   # head dim 12 (exact), across edges; a wholly masked sample
    (768, 2, 9, 35, 1, False),     # head dim 768 over all six slices
    (640, 2, 12, 5, 10, False),    # head dim 64: no head crosses an edge
]


@pytest.mark.parametrize("B,Lv,Lt,H,empty", CASES)
def test_emulated_schedule_matches_plain_f32(B, Lv, Lt, H, empty):
    v, t, vm, tm, p1, p2 = _case(B * Lv + Lt, B, Lv, Lt, torch.float32, empty)
    with torch.no_grad():
        got = emulate_stack(v, t, vm, tm, p1, p2, H)
        want = S.dual_attention_stack_plain(v, t, vm, tm, p1, p2, H)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,Lv,Lt,H,empty",
                         [c for c in CASES if c[1] > 64 or c[2] > 64][:4] + HEAD_CASES)
def test_emulated_schedule_matches_plain_bf16(B, Lv, Lt, H, empty):
    v, t, vm, tm, p1, p2 = _case(7 + B * Lv + Lt, B, Lv, Lt, torch.bfloat16, empty)
    with torch.no_grad():
        got = emulate_stack(v, t, vm, tm, p1, p2, H)
        want = S.dual_attention_stack_plain(v, t, vm, tm, p1, p2, H)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        tol = 2.0 ** -6 * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,B,Lv,Lt,H,empty", WIDE_CASES)
def test_emulated_schedule_matches_plain_at_wider_d(D, B, Lv, Lt, H, empty, dtype):
    v, t, vm, tm, p1, p2 = _case(D + B * Lv + Lt, B, Lv, Lt, dtype, empty, D)
    with torch.no_grad():
        got = emulate_stack(v, t, vm, tm, p1, p2, H)
        want = S.dual_attention_stack_plain(v, t, vm, tm, p1, p2, H)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol


def test_chunked_softmax_walks_differ_from_one_softmax_only_in_rounding():
    """The f32 walk over chunks, its max and sum and context rescaled as
    they grow, gives the one-pass softmax over the same 3xTF32 products: at
    257 keys with -1e30 masks in the middle of a chunk, at 1e-6."""
    g = np.random.default_rng(3)
    B, M, T, H = 2, 5, 257, 4
    q, k, v = (torch.from_numpy(g.standard_normal((B, n, D)).astype(np.float32))
               for n in (M, T, T))
    fm = torch.ones(B, M)
    km = torch.from_numpy((g.random((B, T)) > 0.3).astype(np.float32))
    km[1, 40:100] = 0.0
    got = _attend(q, k, v, fm, km, H, torch.float32)
    qh, kh, vh = (x.unflatten(-1, (H, D // H)).transpose(1, 2) for x in (q, k, v))
    s = _tf32.product(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(D // H))
    s = s + MASK_VALUE * (1 - km[:, None, None])
    want = _tf32.product(torch.softmax(s, -1), vh).transpose(1, 2).reshape(B, M, D)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,B,Lv,Lt,H,empty", CLUSTER_CASES)
def test_emulated_cluster_schedule_matches_plain(D, B, Lv, Lt, H, empty, dtype):
    v, t, vm, tm, p1, p2 = _case(D + B * Lv + Lt + H, B, Lv, Lt, dtype, empty, D)
    with torch.no_grad():
        got = emulate_stack(v, t, vm, tm, p1, p2, H, cluster=True)
        want = S.dual_attention_stack_plain(v, t, vm, tm, p1, p2, H)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", sorted(SCHEDULES) + [640])
def test_a_row_max_not_reduced_over_the_quad_fails(dtype, D):
    """The planted fault: each lane's row max taken over its own columns
    only, not over the quad of lanes that holds the row, breaks the softmax,
    and the comparison with the plain version at the stated tolerance
    catches it, at every width's row tile and in the cluster's schedule (D
    640); the same case without the fault passes it."""
    v, t, vm, tm, p1, p2 = _case(11, 3, 64 if D == 128 else 40, 30, dtype, D=D)
    with torch.no_grad():
        want = S.dual_attention_stack_plain(v, t, vm, tm, p1, p2, 4)
        errs = [max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
                for got in (emulate_stack(v, t, vm, tm, p1, p2, 4, quad_max=quad_max,
                                          cluster=D > max(SCHEDULES))
                            for quad_max in (True, False))]
    scale = max(w.float().abs().max().item() for w in want)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * max(1.0, scale)
    assert errs[0] <= tol < errs[1], (errs, tol)


def test_schedule_constants_are_the_kernels():
    """Each width's tile, stage and chunk, the widths themselves (the set
    ``takes`` accepts), the narrow heads' body and statistics (room for a
    max and a sum of every (row, head) of a tile at every width, as the
    wrapper allocates them) and the longest head dim, as the source states
    them."""
    src = CSRC.read_text()
    layouts = dict(re.findall(r"template <> struct Lay<(\d+)> \{ (static constexpr int [^}]*)\};",
                              src))
    assert sorted(int(w) for w in layouts) == sorted(SCHEDULES)
    for width, (tile, stage, keys) in SCHEDULES.items():
        fields = dict((k, int(v)) for k, v in re.findall(r"(k\w+) = (\d+)", layouts[str(width)]))
        assert (fields["kTile"], fields["kStage"], fields["kKeys"]) == (tile, stage, keys), width
        assert fields["kShare"] == (2 * keys <= stage), width  # K and V of a chunk in one buffer
    widths = re.search(r"constexpr int kWidths\[\] = \{([\d, ]+)\};", src)
    assert widths and tuple(int(w) for w in widths.group(1).split(",")) == S.KERNEL_WIDTHS
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))  # noqa: E731
    assert const("kRows") == TASK_ROWS and const("kNarrowHD") == NARROW_HD
    assert NARROW_HD == MMA_N <= min(MMA_K.values())
    assert const("kMaxHeadDim") >= max(S.KERNEL_WIDTHS)  # one head of the widest D
    assert const("kNarrowStat") == S.NARROW_STAT_FLOATS
    assert all(2 * tile * width <= S.NARROW_STAT_FLOATS
               for width, (tile, _, _) in SCHEDULES.items())
    # the cluster part: its tile and stage, the columns a CTA owns, the
    # cluster sizes (the widths ``takes`` accepts past D 512), the narrow and
    # the longest head dims, and room for every piece's statistics
    src = CLUSTER_SRC.read_text()
    const = lambda name: int(  # noqa: E731
        re.search(rf"constexpr int {name} = (\w+);", src).group(1))
    assert (const("kCTile"), const("kCStage"), const("kCStage")) == CLUSTER_SCHEDULE
    assert const("kSlice") == SLICE and TASK_ROWS == 16
    assert tuple(range(const("kMinCluster") * SLICE, const("kMaxCluster") * SLICE + 1, SLICE)) \
        == S.CLUSTER_WIDTHS
    assert const("kMaxCluster") <= 8  # the portable cluster size: no non-portable attribute
    assert const("kCNarrowHD") == 16 >= max(w // h for w in S.CLUSTER_WIDTHS
                                            for h in range(1, w + 1) if w % h == 0 and (w // h) % 4)
    assert re.search(r"constexpr int kCMaxHeadDim = kSlice \* kMaxCluster;", src)
    assert re.search(r"constexpr int kCMaxPieces = kSlice;", src)  # head dim 1: 128 pieces
