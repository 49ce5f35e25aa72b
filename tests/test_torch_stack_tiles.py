"""Kernel #4's schedule on long sides, emulated in torch on the CPU against
the plain version (``dual_attention_stack_plain``).

``csrc/dual_stack.cu`` cannot run here.  ``emulate_stack`` repeats its
schedule with the kernel's rounding points: every call first projects both
sides' keys and values ``TILE_ROWS`` rows at a time and keeps them in the
compute type, then walks the from-rows in tiles of ``TILE_ROWS``; a side of
at most ``STAGE_KEYS`` keys is attended in one walk, a longer one in
chunks of ``CHUNK_KEYS`` keys and two walks (running max and sum with
rescaling first, then p = exp(s - max) / sum rounded to the compute type and
p v accumulated in f32, rounded after the last chunk).  Cases: lengths at
and past tile and chunk edges (65, 129, 256 video rows; 30 and 257 text
rows), a wholly masked sample, a valid video facing an empty text side, 8
heads of 16.  Inputs and weights are made with numpy from a seed.
Tolerances: f32 1e-5 (the same products, summed in another order); bf16
2**-6 of the largest output (a few bf16 ulps: a p rounded on either side of
a bf16 boundary where the two sums differ in their last bit).  The
schedule's constants are read back from the CUDA source.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vmrframe_tpu_torch.kernels import dual_stack as S
from vmrframe_tpu_torch.ops.masking import MASK_VALUE

D = 128
CSRC = Path(S.__file__).resolve().parent / "csrc" / "dual_stack.cu"
# the kernel's schedule (kTile, kStage, kKeys in the source): rows per tile;
# the most keys one attention stage holds; keys per chunk of the two walks
TILE_ROWS, STAGE_KEYS, CHUNK_KEYS = 64, 64, 32


def _attend(q, k, v, fm, km, H, cd):
    """The kernel's attention of q (B, M, D) over k, v (B, T, D), all in
    cd; fm (B, M) and km (B, T) validities; the context (B, M, D) in cd."""
    B, M, _ = q.shape
    T, hd = k.shape[1], D // H
    heads = lambda x: x.float().unflatten(-1, (H, hd)).transpose(1, 2)  # noqa: E731
    qh, kh, vh = heads(q), heads(k), heads(v)

    def scores(c0, c1):
        s = qh @ kh[:, :, c0:c1].transpose(-1, -2) * (1.0 / math.sqrt(hd))
        return s + MASK_VALUE * (1.0 - fm[:, None, :, None] * km[:, None, None, c0:c1])

    if T <= STAGE_KEYS:  # one stage, one walk
        s = scores(0, T)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        ctx = (e / e.sum(-1, keepdim=True)).to(cd).float() @ vh
    else:  # chunks, two walks
        chunks = [(c0, min(T, c0 + CHUNK_KEYS)) for c0 in range(0, T, CHUNK_KEYS)]
        m = torch.full((B, H, M, 1), -math.inf)
        l = torch.zeros(B, H, M, 1)
        for c0, c1 in chunks:
            s = scores(c0, c1)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
            m = m_new
        ctx = torch.zeros(B, H, M, hd)
        for c0, c1 in chunks:
            p = (torch.exp(scores(c0, c1) - m) / l).to(cd).float()
            ctx = ctx + p @ vh[:, :, c0:c1]
    return ctx.transpose(1, 2).reshape(B, M, D).to(cd)


def _dab_tiles(x, y, fm, tm, W, b, ln, xb, H, cd):
    """One DualAttentionBlock call in the kernel's schedule; (B, F, D) f32."""
    dot = S._dot

    def keys_values(src, lns, lnb, wk, wv):
        ks, vs = [], []
        for r0 in range(0, src.shape[1], TILE_ROWS):
            n = S._ln(src[:, r0:r0 + TILE_ROWS], ln[lns], ln[lnb]).to(cd)
            ks.append((dot(n, W[wk]) + b[wk]).to(cd))
            vs.append((dot(n, W[wv]) + b[wv]).to(cd))
        return torch.cat(ks, 1), torch.cat(vs, 1)

    tk, tv = keys_values(y, S.LNT_S, S.LNT_B, S.W_TK, S.W_TV)
    fk, fv = keys_values(x, S.LN1_S, S.LN1_B, S.W_FK, S.W_FV)
    out = []
    for r0 in range(0, x.shape[1], TILE_ROWS):
        xt, fmt = x[:, r0:r0 + TILE_ROWS].float(), fm[:, r0:r0 + TILE_ROWS]
        fn = S._ln(xt, ln[S.LN1_S], ln[S.LN1_B]).to(cd)
        q = (dot(fn, W[S.W_Q]) + b[S.W_Q]).to(cd)
        x_att = _attend(q, tk, tv, fmt, tm, H, cd)
        s_att = _attend(q, fk, fv, fmt, fm, H, cd)
        x_value = dot(x_att, W[S.W_XD]) + b[S.W_XD]
        s_value = dot(s_att, W[S.W_SD]) + b[S.W_SD]
        x_score = dot(x_value.to(cd), W[S.W_XG]) + b[S.W_XG]
        s_score = dot(s_value.to(cd), W[S.W_SG]) + b[S.W_SG]
        gc = (dot((s_score * x_value + x_score * s_value).to(cd), W[S.W_GD]) + b[S.W_GD]).to(cd)
        scores = dot(fn, W[S.W_BL1]) + dot(gc, W[S.W_BL1]) + 2.0 * b[S.W_BL1] + xb[0]
        values = dot(fn, W[S.W_BL2]) + dot(gc, W[S.W_BL2]) + 2.0 * b[S.W_BL2] + xb[1]
        dma = torch.sigmoid(scores + MASK_VALUE * (1.0 - fmt[:, :, None])) * values
        residual = dot(dma.to(cd), W[S.W_D1]) + b[S.W_D1] + xt
        z = S._ln(residual, ln[S.LN2_S], ln[S.LN2_B])
        out.append(dot(z.to(cd), W[S.W_D2]) + b[S.W_D2] + residual)
    return torch.cat(out, 1)


def emulate_stack(vfeat, tfeat, vmask, tmask, p1, p2, num_heads):
    """The 2-layer stack in the kernel's schedule (nothing rounded between
    the layers)."""
    cd = p1["W"].dtype
    vm, tm = vmask.float(), tmask.float()
    v, t = vfeat, tfeat
    for p in (p1, p2):
        args = (p["W"], p["b"].float(), p["ln"].float(), p["xb"].float(), num_heads, cd)
        v, t = _dab_tiles(v, t, vm, tm, *args), _dab_tiles(t, v, tm, vm, *args)
    return v.to(vfeat.dtype), t.to(tfeat.dtype)


def _stacks(rng, dtype):
    """One layer's stacks with every leaf random."""
    W = rng.standard_normal((14, D, D)).astype(np.float32) / math.sqrt(D)
    ln = 0.1 * rng.standard_normal((6, D)).astype(np.float32)
    ln[0::2] += 1.0  # the scales
    return {"W": torch.from_numpy(W).to(dtype),
            "b": torch.from_numpy(0.1 * rng.standard_normal((14, D)).astype(np.float32)),
            "ln": torch.from_numpy(ln),
            "xb": torch.from_numpy(0.1 * rng.standard_normal((2, D)).astype(np.float32))}


def _case(seed, B, Lv, Lt, dtype, empty_to_side=False):
    """Features, masks of random lengths (the last sample wholly masked when
    B > 2; sample 0's text side empty with empty_to_side) and two layers'
    stacks."""
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
    return v, t, vm, tm, _stacks(rng, dtype), _stacks(rng, dtype)


CASES = [  # B, Lv, Lt, heads, empty_to_side
    (2, 65, 30, 4, False),    # one row past a tile
    (2, 129, 30, 4, False),   # past two tiles and four chunks
    (3, 256, 30, 4, False),   # TACoS length, a wholly masked sample
    (2, 30, 257, 4, False),   # the text side walks 257 video keys
    (3, 129, 257, 8, False),  # 8 heads of 16, both sides long
    (2, 256, 30, 4, True),    # a valid video facing an empty text side
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


@pytest.mark.parametrize("B,Lv,Lt,H,empty", [c for c in CASES if c[1] > 64 or c[2] > 64][:4])
def test_emulated_schedule_matches_plain_bf16(B, Lv, Lt, H, empty):
    v, t, vm, tm, p1, p2 = _case(7 + B * Lv + Lt, B, Lv, Lt, torch.bfloat16, empty)
    with torch.no_grad():
        got = emulate_stack(v, t, vm, tm, p1, p2, H)
        want = S.dual_attention_stack_plain(v, t, vm, tm, p1, p2, H)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        tol = 2.0 ** -6 * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol


def test_chunked_softmax_walks_differ_from_one_softmax_only_in_rounding():
    """The two walks' max and sum over chunks give the one-pass softmax: at
    257 keys with -1e30 masks in the middle of a chunk, in f32 at 1e-6."""
    g = np.random.default_rng(3)
    B, M, T, H = 2, 5, 257, 4
    q, k, v = (torch.from_numpy(g.standard_normal((B, n, D)).astype(np.float32))
               for n in (M, T, T))
    fm = torch.ones(B, M)
    km = torch.from_numpy((g.random((B, T)) > 0.3).astype(np.float32))
    km[1, 40:100] = 0.0
    got = _attend(q, k, v, fm, km, H, torch.float32)
    qh, kh, vh = (x.unflatten(-1, (H, D // H)).transpose(1, 2) for x in (q, k, v))
    s = qh @ kh.transpose(-1, -2) / math.sqrt(D // H) + MASK_VALUE * (1 - km[:, None, None])
    want = (torch.softmax(s, -1) @ vh).transpose(1, 2).reshape(B, M, D)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_schedule_constants_are_the_kernels():
    src = CSRC.read_text()
    for name, value in (("kTile", TILE_ROWS), ("kStage", STAGE_KEYS), ("kKeys", CHUNK_KEYS),
                        ("kD", S.KERNEL_D)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
