"""Kernel #3's schedule, emulated in torch on the CPU, against the plain
version (``cq_attention_plain``) and the JAX package's Pallas kernel in
interpret mode.

``csrc/attention.cu``'s ``cq_kernel`` cannot run here.  ``emulate_cq``
repeats its schedule with its rounding points: both lengths padded to tiles
of 16, the padding -inf in both softmaxes and 0 in every product, while a
masked position adds -1e30 and still takes part; D staged in chunks of
``stage_cols`` (the scores summed over the chunks) and the outputs made in
chunks of ``out_cols`` within each (every output column needs only the same
columns of c and q, so the kernel chunks D where a long query side would
otherwise overflow shared memory), as ``cq_plan`` lays them out or
narrower, forced, to walk several chunks at small grids.  In bf16: the
scores from c * w4mlu (exact in f32) as hi + lo bf16, S_t rounded to bf16,
S_t^T c kept as hi + lo bf16, c2q from bf16(S_), q2c as hi.hi + lo.hi +
hi.lo.  Cases: lengths of 1, 30, 64, 65, 100 and 257 on either side
(both orientations), D 128 and 24, B <= 3, sample 0 wholly masked and
sample 1's query side wholly masked.  Inputs are made with numpy from a
seed.  Tolerances: f32 1e-5 (the same products summed in another order);
bf16 2**-6 of the largest output (a few bf16 ulps), and 2**-11 of it before
the outputs' last rounding, which a dropped lo term exceeds.  The
schedule's constants are read back from the CUDA source.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vmrframe_tpu.kernels.attention import fused_cq_attention as jax_cq
from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.ops.masking import MASK_VALUE

CSRC = Path(K.__file__).resolve().parent / "csrc" / "attention.cu"
TILE = 16  # rows of c and of q are padded to the mma's 16
BF16_ULPS, UNROUNDED = 2.0 ** -6, 2.0 ** -11


def _ceil(n, m):
    return -(-n // m) * m


def _pad(x, rows, cols):
    """(B, R, C) zero-padded to (B, rows, cols)."""
    return F.pad(x, (0, cols - x.shape[2], 0, rows - x.shape[1]))


def _split(x):
    """x (f32) as hi + lo, both bf16 values held in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _softmax(x, dim):
    """exp(x - max) times 1 / sum, as the kernel takes it."""
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e * (1.0 / e.sum(dim, keepdim=True))


def emulate_cq(c, q, w4C, w4Q, w4mlu, c_mask, q_mask, stage_cols, out_cols, rounded=True):
    """(c2q, q2c) in the kernel's schedule; ``rounded=False`` returns them in
    f32, before the last rounding to the input type."""
    dtype = c.dtype
    bf = dtype == torch.bfloat16
    B, Lc, D = c.shape
    Lq = q.shape[1]
    lcp, lqp, dp = _ceil(Lc, TILE), _ceil(Lq, TILE), _ceil(D, K.CQ_COLS[dtype])
    cp, qp = _pad(c.float(), lcp, dp), _pad(q.float(), lqp, dp)
    wm, wc, wq = (F.pad(w.float().reshape(D), (0, dp - D)) for w in (w4mlu, w4C, w4Q))
    chunks = [(d0, min(d0 + stage_cols, dp)) for d0 in range(0, D, stage_cols)]

    score = torch.zeros(B, lcp, lqp)
    s0, s1 = torch.zeros(B, lcp), torch.zeros(B, lqp)
    for d0, d1 in chunks:  # pass 1: the scores over the staged chunks
        cc, qq = cp[:, :, d0:d1], qp[:, :, d0:d1]
        s0, s1 = s0 + cc @ wc[d0:d1], s1 + qq @ wq[d0:d1]
        x = cc * wm[d0:d1]
        parts = _split(x) if bf else (x,)
        score = score + sum(p @ qq.transpose(1, 2) for p in parts)
    score = score + s0[:, :, None] + s1[:, None, :]

    real_c, real_q = torch.arange(lcp) < Lc, torch.arange(lqp) < Lq
    cmt = _pad(((1.0 - c_mask.float()) * MASK_VALUE)[:, :, None], lcp, 1)[:, :, 0]
    qmt = _pad(((1.0 - q_mask.float()) * MASK_VALUE)[:, :, None], lqp, 1)[:, :, 0]
    row = (score + qmt[:, None, :]).masked_fill(~real_q[None, None, :], -math.inf)
    col = (score + cmt[:, :, None]).masked_fill(~real_c[None, :, None], -math.inf)
    s_ = _softmax(row, 2) * real_c[None, :, None]
    s_t = (_softmax(col, 1) * real_q[None, None, :]).to(dtype).float()

    c2q, q2c = torch.zeros(B, lcp, dp), torch.zeros(B, lcp, dp)
    for d0, d1 in chunks:  # pass 2: S_t^T c, then the outputs, out_cols at a time
        for e0 in range(d0, d1, out_cols):
            e = slice(e0, min(e0 + out_cols, d1))
            stc = s_t.transpose(1, 2) @ cp[:, :, e]
            if bf:
                (ph, pl), (sh, sl) = _split(s_), _split(stc)
                c2q[:, :, e] = ph @ qp[:, :, e]
                q2c[:, :, e] = ph @ sh + pl @ sh + ph @ sl
            else:
                c2q[:, :, e] = s_ @ qp[:, :, e]
                q2c[:, :, e] = s_ @ stc
    out = c2q[:, :Lc, :D], q2c[:, :Lc, :D]
    return tuple(o.to(dtype) for o in out) if rounded else out


def plain_unrounded(c, q, w4C, w4Q, w4mlu, c_mask, q_mask):
    """``cq_attention_plain`` before its outputs' last rounding."""
    cf, qf = c.float(), q.float()
    score = (cf * w4mlu.float()) @ qf.transpose(1, 2) + cf @ w4C.float() \
        + (qf @ w4Q.float()).transpose(1, 2)
    s_ = torch.softmax(score + (1.0 - q_mask.float()[:, None, :]) * MASK_VALUE, dim=2)
    s_t = torch.softmax(score + (1.0 - c_mask.float()[:, :, None]) * MASK_VALUE, dim=1)
    stc = s_t.to(c.dtype).float().transpose(1, 2) @ cf
    return s_.to(c.dtype).float() @ qf, s_ @ stc


def _case(seed, B, Lc, Lq, D):
    """c, q, w4C, w4Q, w4mlu, c_mask, q_mask as numpy f32: random lengths,
    sample 0 wholly masked, sample 1's query side wholly masked."""
    rng = np.random.default_rng(seed)
    bound = math.sqrt(6.0 / (D + 1))
    w = [((rng.random(s) * 2 - 1) * bound).astype(np.float32) for s in ((D, 1), (D, 1), (1, 1, D))]
    masks = []
    for L in (Lc, Lq):
        lens = rng.integers(1, L + 1, B)
        lens[0] = 0
        masks.append((np.arange(L)[None] < lens[:, None]).astype(np.float32))
    if B > 1:
        masks[1][1] = 0.0
    return (rng.standard_normal((B, Lc, D)).astype(np.float32),
            rng.standard_normal((B, Lq, D)).astype(np.float32), *w, *masks)


def _torch(case, dtype):
    return tuple(torch.from_numpy(a).to(dtype) for a in case)


# B, Lc, Lq, D, forced (stage_cols, out_cols) or None for cq_plan's
CASES = [
    (2, 1, 1, 24, None), (3, 1, 30, 128, None), (3, 30, 1, 128, None),
    (3, 64, 30, 128, None), (3, 30, 64, 128, None), (2, 65, 100, 24, None),
    (2, 100, 65, 128, None), (2, 257, 30, 128, None), (2, 30, 257, 128, None),
    (2, 65, 257, 24, None), (2, 257, 64, 128, None), (2, 100, 100, 128, None),
    # several staged chunks and output chunks at small grids
    (3, 30, 65, 128, (48, 16)), (3, 65, 30, 24, (16, 16)), (2, 100, 257, 128, (64, 32)),
]


def _chunks(dtype, Lc, Lq, D, forced):
    if forced:
        return forced
    plan = K.cq_plan(Lc, Lq, D, dtype)
    return plan["stage_cols"], plan["out_cols"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Lc,Lq,D,forced", CASES)
def test_emulated_schedule_matches_plain(dtype, B, Lc, Lq, D, forced):
    args = _torch(_case(Lc * 1000 + Lq + D, B, Lc, Lq, D), dtype)
    got = emulate_cq(*args, *_chunks(dtype, Lc, Lq, D, forced))
    want = K.cq_attention_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, Lc, D) and g.dtype == dtype
        assert torch.isfinite(g.float()).all()
        tol = 1e-5 if dtype == torch.float32 else BF16_ULPS * max(1.0, w.float().abs().max())
        assert (g.float() - w.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:  # the split products keep f32 accuracy before the last rounding
        got = emulate_cq(*args, *_chunks(dtype, Lc, Lq, D, forced), rounded=False)
        for g, w in zip(got, plain_unrounded(*args)):
            assert (g - w).abs().max().item() <= UNROUNDED * max(1.0, w.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Lc,Lq,D", [(3, 64, 30, 128), (2, 30, 257, 24), (2, 65, 100, 128)])
def test_emulated_schedule_matches_pallas(dtype, B, Lc, Lq, D):
    """Against ``vmrframe_tpu``'s ``fused_cq_attention`` in interpret mode (in
    bf16 the TPU kernel rounds c * w4mlu to bf16 where the port keeps it
    exact: the bf16 bound covers it)."""
    case = _case(7 + Lc + Lq, B, Lc, Lq, D)
    args = _torch(case, dtype)
    got = emulate_cq(*args, *_chunks(dtype, Lc, Lq, D, None))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_cq(*(jnp.asarray(a, jdt) for a in case[:5]), jnp.asarray(case[5]),
                  jnp.asarray(case[6]), interpret=True)
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        tol = 1e-5 if dtype == torch.float32 else BF16_ULPS * max(1.0, w.abs().max())
        assert (g.float() - w).abs().max().item() <= tol


def test_wholly_masked_rows_average_and_padding_takes_no_part():
    """A wholly masked sample's c2q is the plain mean of its Lq query rows
    (not of the 16-padded tile), and its q2c the mean of c's Lc rows: -1e30
    masks take part, padding does not."""
    args = _torch(_case(5, 2, 30, 30, 24), torch.float32)
    c2q, q2c = emulate_cq(*args, stage_cols=24, out_cols=8)
    c, q = args[0], args[1]
    torch.testing.assert_close(c2q[0], q[0].mean(0).expand(30, 24), rtol=0, atol=1e-5)
    torch.testing.assert_close(q2c[0], c[0].mean(0).expand(30, 24), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plan_chunks_tile_d_in_granules(dtype):
    """The plan's chunks are whole granules, the output chunk within the
    staged one, and together they cover every column of D."""
    gran = K.CQ_COLS[dtype]
    for Lc, Lq, D in ((64, 30, 128), (30, 256, 128), (1024, 1024, 128), (30, 1024, 24),
                      (1, 1, 8192), (300, 30, 1000)):
        plan = K.cq_plan(Lc, Lq, D, dtype)
        stage, out = plan["stage_cols"], plan["out_cols"]
        assert stage % gran == 0 and out % gran == 0 and gran <= out <= stage <= _ceil(D, gran)
        cols = [e for d0 in range(0, D, stage)
                for e0 in range(d0, min(d0 + stage, _ceil(D, gran)), out)
                for e in range(e0, min(e0 + out, d0 + stage))]
        assert sorted(cols)[:D] == list(range(D)) and len(set(cols)) == len(cols)


def test_schedule_constants_are_the_kernels():
    src = CSRC.read_text()
    for name, value in (("kCqScorePad", K.CQ_SCORE_PAD), ("kCqMmaCols", K.CQ_COLS[torch.bfloat16]),
                        ("kCqF32Cols", K.CQ_COLS[torch.float32])):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
    assert f"constexpr int PAD = {K.CQ_ROW_PAD_BYTES} / sizeof(T)" in src
    phases = re.search(r"enum CqPhase \{([^}]*)\}", src).group(1).replace(" ", "").split(",")
    assert [f"k{name.capitalize()}" for name in K.CQ_PHASES] + ["kCqPhases"] == phases
    assert "(Lc + 15) & ~15, Lqp = (Lq + 15) & ~15" in src  # tiles of TILE rows
