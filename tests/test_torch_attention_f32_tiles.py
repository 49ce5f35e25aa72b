"""The f32 body of #1/#2 (``attention_tf32`` in ``csrc/attention.cu``)
emulated in torch on the CPU against the plain versions
(``masked_attention_plain``, ``dual_attention_plain``).

The CUDA body cannot run here.  ``emulate`` repeats its schedule with its
rounding points: both products on TF32 operands (as ``cvt.rna`` rounds: to
nearest, ties away from zero, to 10 mantissa bits) in the 3xTF32 split, each
operand x as big = tf32(x) and small = tf32(x - big), and per 8-wide step
of the product big.small, then small.big, then big.big added to an f32
accumulator; keys in ``CHUNK_KEYS``-key chunks; walk 1 takes each row's
running max and sum with rescaling, walk 2 p = exp(s - max) * (1 / sum)
times V, summed over every chunk (the kernel reads walk 1's scores back
where it keeps them; recomputed, they are the same values).  Masking as the kernel's: -1e30 for a
masked key (a wholly masked row comes out as the uniform average), keys
past Lk take no part.

Cases: Lk 1, 30, 64, 65 and 256 (one chunk, one past, four) against 37
queries, head dims 1, 32, 192 and 256, a wholly masked sample and wholly
masked rows; #2 at SeqPAN's shapes and at head dim 192.  Inputs are made
with numpy from a seed.  Tolerance ``TOL`` (1.7e-6 measured at most): the
split keeps ~22 of f32's 24 bits of each operand, the sums run in another
order.  The same schedule with one TF32 pass (big.big alone) misses it by
far (2.8e-4 to 1.7e-3 at these cases), which is why the kernel splits.
Also: the schedule's constants read back from the CUDA source, the staged
rows' bank pattern, and ``attention_takes`` in f32 holding every shape the
former f32 body took.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _tf32 import product, split, tf32

from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.ops.masking import MASK_VALUE

CSRC = Path(K.__file__).resolve().parent / "csrc" / "attention.cu"
HEADER = CSRC.with_name("mma_tf32.cuh")  # the TF32 helpers both f32 tensor-core sources include
# the kernel's schedule (kTfChunk, kTfRowPad, kTfQRegs, kTfOutTiles,
# kTfWarps in the source): keys a chunk; floats after each staged row; Q in
# registers up to this many 8-column steps; output tiles a pass; warps a block
CHUNK_KEYS, ROW_PAD, Q_REGS, OUT_TILES, MAX_WARPS = 64, 4, 8, 16, 8
TOL = 1e-5


def emulate(q, k, v, mask, passes: int = 3) -> torch.Tensor:
    """#1 in the kernel's schedule: q (B, H, Lq, hd), k, v (B, H, Lk, hd),
    mask (B, Lq, Lk); f32."""
    Lk, hd = k.shape[2], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    chunks = [(c0, min(Lk, c0 + CHUNK_KEYS)) for c0 in range(0, Lk, CHUNK_KEYS)]

    def scores(c0, c1):
        s = product(q, k[:, :, c0:c1].transpose(-1, -2), passes) * scale
        return s + (1.0 - mask[:, None, :, c0:c1]) * MASK_VALUE

    m = torch.full((*q.shape[:3], 1), -math.inf)
    l = torch.zeros(*q.shape[:3], 1)
    for c0, c1 in chunks:  # walk 1
        s = scores(c0, c1)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
        m = m_new
    inv = 1.0 / l
    out = torch.zeros(q.shape)
    for c0, c1 in chunks:  # walk 2
        p = torch.exp(scores(c0, c1) - m) * inv
        out = out + product(p, v[:, :, c0:c1], passes)
    return out


def _inputs(seed, B, H, Lq, Lks, hd):
    """q, then (k, v, mask) per branch, as torch f32 from numpy: lengths at
    random, sample 0 wholly masked, the second half of sample 1's query
    rows wholly masked."""
    rng = np.random.default_rng(seed)
    heads = lambda L: torch.from_numpy(  # noqa: E731
        rng.standard_normal((B, H, L, hd)).astype(np.float32))

    def lengths_mask(L):
        lens = rng.integers(1, L + 1, B)
        lens[0] = 0
        return (np.arange(L)[None] < lens[:, None]).astype(np.float32)

    qm = lengths_mask(Lq)
    qm[1, Lq // 2:] = 0.0
    branches = []
    for Lk in Lks:
        mask = torch.from_numpy(qm[:, :, None] * lengths_mask(Lk)[:, None, :])
        branches.append((heads(Lk), heads(Lk), mask))
    return heads(Lq), branches


def _err(got, want) -> float:
    assert got.shape == want.shape and torch.isfinite(got).all()
    return (got - want).abs().max().item()


@pytest.mark.parametrize("hd", [1, 32, 192, 256])
@pytest.mark.parametrize("Lk", [1, 30, 64, 65, 256])
def test_emulated_schedule_matches_masked_attention_plain(Lk, hd):
    q, [(k, v, mask)] = _inputs(Lk * 1000 + hd, 3, 2, 37, (Lk,), hd)
    assert _err(emulate(q, k, v, mask), K.masked_attention_plain(q, k, v, mask)) <= TOL


@pytest.mark.parametrize("L,M,hd", [(64, 30, 32), (30, 64, 32), (64, 30, 192), (256, 30, 32)])
def test_emulated_schedule_matches_dual_attention_plain(L, M, hd):
    q, [(fk, fv, s_mask), (tk, tv, x_mask)] = _inputs(L + M + hd, 3, 2, L, (L, M), hd)
    got = (emulate(q, fk, fv, s_mask), emulate(q, tk, tv, x_mask))
    want = K.dual_attention_plain(q, fk, fv, tk, tv, s_mask, x_mask)
    for g_, w_ in zip(got, want):
        assert _err(g_, w_) <= TOL


@pytest.mark.parametrize("Lk,hd", [(64, 32), (256, 192)])
def test_one_tf32_pass_misses_the_tolerance(Lk, hd):
    """big.big alone keeps 11 bits of each operand: the f32 result moves by
    far more than ``TOL``."""
    q, [(k, v, mask)] = _inputs(Lk + hd, 3, 2, 37, (Lk,), hd)
    want = K.masked_attention_plain(q, k, v, mask)
    assert _err(emulate(q, k, v, mask, passes=1), want) > 10 * TOL


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 neighbours of 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -12, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one, 3.0]
    big, small = split(torch.tensor([math.pi], dtype=torch.float32))
    assert abs((big + small).item() - math.pi) < 2.0 ** -20 < abs(big.item() - math.pi)


def test_schedule_constants_are_the_kernels():
    src = CSRC.read_text()
    for name, value in (("kTfChunk", CHUNK_KEYS), ("kTfRowPad", ROW_PAD), ("kTfQRegs", Q_REGS),
                        ("kTfOutTiles", OUT_TILES), ("kTfWarps", MAX_WARPS),
                        ("kSharedBytes", K.SHARED_BYTES)):
        found = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
    assert (K.F32_CHUNK, K.F32_ROW_PAD, K.F32_Q_REGS, K.F32_MAX_WARPS) == \
        (CHUNK_KEYS, ROW_PAD, Q_REGS, MAX_WARPS)
    modes = re.search(r"constexpr int kTfBoth = (\d+), kTfAlt = (\d+), kTfChunked = (\d+);", src)
    assert modes and [int(x) for x in modes.groups()] == list(range(len(K.F32_MODES)))
    assert '#include "mma_tf32.cuh"' in src
    helpers = HEADER.read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in helpers
    # the kernel's rounding is ``tf32`` here: half of the 13 dropped bits added, then cleared
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in helpers and \
        ~0x1FFF & 0xFFFFFFFF == 0xFFFFE000


def test_staged_rows_fall_on_distinct_banks():
    """Rows of 8 * hd8 + ``ROW_PAD`` floats: the 32 lanes' K loads (row g,
    column t) and V loads (rows 2t and 2t + 1 of the 8 keys, column g) hit
    32 distinct banks at every head dim; so do the score tile's pairs."""
    for hd8 in range(1, 33):
        rs = 8 * hd8 + ROW_PAD
        k_banks = {(g * rs + t) % 32 for g in range(8) for t in range(4)}
        v_banks = {(2 * t * rs + g) % 32 for g in range(8) for t in range(4)}
        v1_banks = {((2 * t + 1) * rs + g) % 32 for g in range(8) for t in range(4)}
        assert len(k_banks) == len(v_banks) == len(v1_banks) == 32, hd8
    # walk 1's score tile, rows of 64 n + 8 floats, written and read as float2:
    # each half-warp's 16 lanes (g < 4 or g >= 4) on 16 distinct 8-byte words
    for n in (2, 4, 16):
        ss = 64 * n + 8
        for half in (range(4), range(4, 8)):
            words = {(g * ss // 2 + t) % 16 for g in half for t in range(4)}
            assert len(words) == 16, n


def _former_f32_bytes(hd: int) -> int:
    """The former f32 body's shared memory: a 32-key chunk of K (rows
    padded by 1) and V, a Q row for each of 4 warps, 16 rows' max and sum."""
    return 4 * (32 * (2 * hd + 1) + 4 * hd + 2 * 16)


def test_f32_takes_every_shape_the_former_body_took():
    f32 = torch.float32
    for hd in (1, 4, 24, 32, 33, 64, 65, 96, 128, 136, 192, 255, 256):
        for Lq in (1, 16, 30, 64, 129, 256, 1024):
            for Lks in ((1,), (30,), (65,), (256,), (1024,), (Lq, 30), (Lq, 1024)):
                if _former_f32_bytes(hd) <= K.SHARED_BYTES:
                    assert K.attention_takes(f32, Lq, Lks, hd), (Lq, Lks, hd)
                    plan = K.attention_f32_plan(Lq, Lks, hd)
                    assert plan["warps"] >= min(5, -(-Lq // 16))
                    assert plan["shared_bytes"] <= K.SHARED_BYTES
    assert not K.attention_takes(f32, 64, (64,), 257)


_CTYPE = {"float": K._F, "int": K._I, "long long": K._L}


@pytest.mark.parametrize("entry", ["vmr_masked_attention", "vmr_dual_attention"])
def test_entries_take_the_plan_the_wrapper_computes(entry):
    """The C entries compute no f32 plan of their own: after the scale they
    take ``attention_f32_plan``'s five numbers, and the wrapper's ctypes
    list has the C type of every parameter."""
    src = CSRC.read_text()
    assert "tf32_plan(" not in src
    sig = re.search(rf'extern "C" int {entry}\((.*?)\) {{', src, re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names[-7:] == ["scale", "mode", "nwarp", "kv_rows", "ss", "shared_bytes", "stream"]
    types = [K._P if "*" in p else _CTYPE[p.rsplit(" ", 1)[0]] for p in params]
    assert types == K._ARGTYPES[entry]


def test_plan_args_follow_the_staged_modes(monkeypatch):
    """At head dim 192 (SeqPAN's sentence variants, L 64 and M 30) K and V
    whole leave one block an SM: the plan shares one buffer ("alt");
    narrowed to "both" it keeps K and V whole.  bf16 passes its own plan
    (``attention_bf16_plan``) in the same five numbers."""
    alt = K._plan_args(torch.float32, 64, (64, 30), 192)
    assert K.F32_MODES[alt[0]] == "alt" and alt[4] <= K.SHARED_BYTES // 2
    monkeypatch.setattr(K, "F32_STAGED_MODES", ("both",))
    both = K._plan_args(torch.float32, 64, (64, 30), 192)
    assert K.F32_MODES[both[0]] == "both" and K.SHARED_BYTES // 2 < both[4] <= K.SHARED_BYTES
    bf16 = K.attention_bf16_plan(64, (64, 30), 192)
    assert K._plan_args(torch.bfloat16, 64, (64, 30), 192) == \
        (0, bf16["warps"], bf16["round_rows"], 0, bf16["shared_bytes"])
