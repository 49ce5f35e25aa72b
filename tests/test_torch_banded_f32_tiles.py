"""The f32 bodies of #5, #6 and #7 (``banded_tf32``, ``dq_tf32``,
``dkv_tf32`` in ``csrc/window_attention.cu``) emulated in torch on the CPU
against the plain versions (``banded_attention_plain``,
``banded_attention_dq_plain``, ``banded_attention_dkv_plain``).

The CUDA bodies cannot run here.  ``emulate_fwd``, ``emulate_dq`` and
``emulate_dkv`` repeat their schedule with its rounding points: every
product on TF32 operands in the 3xTF32 split, summed in 8-wide steps in the
kernels' order (``tests/_tf32.py``); the forward's 16 rows walking their
key span, ``warp_key_span``, in steps of ``CHUNK_KEYS`` keys with a running
max and sum and O rescaled each step, p unrounded, a padding row's output V
summed over its 128-row tile's K_WIN slice over K_WIN; the statistics of
each 16 rows (m, l and sum(e dp)) taken over their key span in the same
steps; dq's 16 rows walking their span, dk/dv's 16 own keys walking their
query span in 16-row steps.  A padding row's p is the
constant 1/K_WIN (dq, every key of the slice) or 1/K2 (dk/dv, every own
key), so its products go through one hd x hd matrix a 128-row tile: its dq
is (scale / K_WIN) g N with N the sum over the slice of (v - cs / K_WIN)
k^T, its dk terms (scale / K2) M (v - cs / K2) with M the sum over the
window's padding rows of q g^T (cs: V summed over the slice), its dv terms
one sum of g.

Cases: B 2, 2 heads, T 300-640, windows 9, 19 and 37, head dims 1, 24 and
128, sample 0 wholly masked and sample 1 with a hole wider than the band.
Inputs are made with numpy from a seed.  Tolerance ``ATOL`` of the compared
tensor's largest magnitude (at least 1): the split keeps ~22 of f32's 24
bits of each operand and the sums run in another order (4.9e-7 measured at
most for the forward, 4.1e-7 for the backward, against 1.7e-6 for #1/#2's
emulation); the same schedule with one TF32 pass (big.big alone) misses it
by far (3.1e-4 to 1.3e-3 at these cases), which is why the kernels split.
Also: the schedule's constants read back from the CUDA source.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _tf32 import product

from vmrframe_tpu_torch.kernels import window_attention as W
from vmrframe_tpu_torch.ops.masking import MASK_VALUE

CSRC = Path(W.__file__).resolve().parent / "csrc" / "window_attention.cu"
# the schedule (kTfChunk, kTfRowPad, kMmaWarps in the source): keys of a
# warp's score step; floats after each staged row; warps of 16 rows (or own
# keys) a 128-row block, in all three f32 bodies
CHUNK_KEYS, ROW_PAD, WARPS = 48, 4, 8
ATOL = 2e-6


def _inputs(seed, T, window, hd, B=2, H=2):
    """q, k, v, cotangent (B, H, T, hd) and a (B, T) {0,1} mask: sample 0
    wholly masked, sample 1 of a random length with a hole wider than the
    band."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, T, hd)).astype(np.float32))
                  for _ in range(4))
    mask = np.zeros((B, T), np.float32)
    mask[1:, :int(rng.integers(T // 2, T + 1))] = 1.0
    mask[1, T // 4:T // 4 + window + 40] = 0.0
    return q, k, v, torch.from_numpy(mask), g


def _padding_rows(valid, half):
    """(T_pad,) bool for one sample: rows below T with no valid key in
    their band."""
    T = valid.shape[0]
    c = torch.nn.functional.pad(valid.float().cumsum(0), (1, 0))
    i = torch.arange(T)
    return (c[(i + half + 1).clamp(max=T)] - c[(i - half).clamp(min=0)]) == 0


class _Sample:
    """One sample's tensors zero-padded to T_pad, its key validity and
    padding rows, and the schedule's spans."""

    def __init__(self, q, k, v, g, mask, window):
        self.T, self.hd = q.shape[-2], q.shape[-1]
        self.window, self.half = window, window // 2
        self.k_win, self.T_pad = W.key_window(window), W.padded_len(self.T)
        self.scale = 1.0 / math.sqrt(self.hd)
        pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, self.T_pad - self.T))  # noqa: E731
        self.q, self.k, self.v = pad(q), pad(k), pad(v)  # (H, T_pad, hd)
        self.g = None if g is None else pad(g)  # the forward has none
        self.valid = torch.nn.functional.pad(mask > 0, (0, self.T_pad - self.T))
        self.pad_rows = torch.nn.functional.pad(_padding_rows(mask > 0, self.half),
                                                (0, self.T_pad - self.T))

    def span(self, r0):
        return W.warp_key_span(self.T, self.window, r0)

    def scores(self, rows, keys, passes):
        """Scaled, band- and key-masked scores (H, 16, n) in 3xTF32."""
        s = product(self.q[:, rows], self.k[:, keys].transpose(-1, -2), passes) * self.scale
        ok = ((rows[:, None] - keys[None, :]).abs() <= self.half) & self.valid[keys][None, :]
        return s.masked_fill(~ok, MASK_VALUE)

    def stats(self, r0, passes):
        """m, l and sum(e dp) / l of the 16 rows from r0 over their key
        span, CHUNK_KEYS keys a step with a running max: each (H, 16, 1)."""
        rows, (lo, hi) = torch.arange(r0, r0 + 16), self.span(r0)
        m = torch.full((self.q.shape[0], 16, 1), -math.inf)
        l, a = torch.zeros_like(m), torch.zeros_like(m)
        for j0 in range(lo, hi, CHUNK_KEYS):
            keys = torch.arange(j0, min(j0 + CHUNK_KEYS, hi))
            s = self.scores(rows, keys, passes)
            dp = product(self.g[:, rows], self.v[:, keys].transpose(-1, -2), passes)
            n = torch.maximum(m, s.amax(-1, keepdim=True))
            f, e = torch.exp(m - n), torch.exp(s - n)
            l, a, m = l * f + e.sum(-1, keepdim=True), a * f + (e * dp).sum(-1, keepdim=True), n
        return m, l, a / l

    def colsum_v(self, j0, j1):
        """V summed over the keys [j0, j1) below T, (H, 1, hd)."""
        return self.v[:, j0:min(j1, self.T)].sum(1, keepdim=True)


def emulate_fwd(q, k, v, mask, window, passes=3):
    out = torch.zeros_like(q)
    for b in range(q.shape[0]):
        x = _Sample(q[b], k[b], v[b], None, mask[b], window)
        o_all = torch.zeros_like(x.q)
        for r0 in range(0, x.T_pad, 16):
            rows, (lo, hi) = torch.arange(r0, r0 + 16), x.span(r0)
            m = torch.full((x.q.shape[0], 16, 1), -math.inf)
            l, o = torch.zeros_like(m), torch.zeros_like(x.q[:, rows])
            for j0 in range(lo, hi, CHUNK_KEYS):
                keys = torch.arange(j0, min(j0 + CHUNK_KEYS, hi))
                s = x.scores(rows, keys, passes)
                n = torch.maximum(m, s.amax(-1, keepdim=True))
                f, e = torch.exp(m - n), torch.exp(s - n)  # p unrounded
                l = l * f + e.sum(-1, keepdim=True)
                o, m = o * f + product(e, x.v[:, keys], passes), n
            start = W.slice_start(r0 // W.TILE * W.TILE, x.T, window)
            pad = x.pad_rows[rows][None, :, None]
            o_all[:, rows] = torch.where(pad, x.colsum_v(start, start + x.k_win) / x.k_win,
                                         o / l)
        out[b] = o_all[:, :x.T]
    return out


def emulate_dq(q, k, v, mask, g, window, passes=3):
    out = torch.zeros_like(q)
    for b in range(q.shape[0]):
        x = _Sample(q[b], k[b], v[b], g[b], mask[b], window)
        dq = torch.zeros_like(x.q)
        for q0 in range(0, x.T_pad, W.TILE):
            start = W.slice_start(q0, x.T, window)
            if x.pad_rows[q0:q0 + W.TILE].any():
                # the padding rows' matrix: N = sum over the slice of (v - cs / K_WIN) k^T
                keys = torch.arange(start, start + x.k_win)
                vs = x.v[:, keys] - x.colsum_v(start, start + x.k_win) / x.k_win
                n = product(vs.transpose(-1, -2), x.k[:, keys], passes) * (x.scale / x.k_win)
            for r0 in range(q0, q0 + W.TILE, 16):
                rows = torch.arange(r0, r0 + 16)
                pad = x.pad_rows[rows][None, :, None]
                if pad.any():
                    dq[:, rows] = product(x.g[:, rows] * pad, n, passes)
                m, l, row = x.stats(r0, passes)
                lo, hi = x.span(r0)
                for j0 in range(lo, hi, CHUNK_KEYS):
                    keys = torch.arange(j0, min(j0 + CHUNK_KEYS, hi))
                    p = torch.exp(x.scores(rows, keys, passes) - m) / l
                    dp = product(x.g[:, rows], x.v[:, keys].transpose(-1, -2), passes)
                    ds = torch.where(pad, 0.0, p * (dp - row)) * x.scale
                    dq[:, rows] += product(ds, x.k[:, keys], passes)
        out[b] = dq[:, :x.T]
    return out


def emulate_dkv(q, k, v, mask, g, window, passes=3):
    dk_out, dv_out = torch.zeros_like(q), torch.zeros_like(q)
    for b in range(q.shape[0]):
        x = _Sample(q[b], k[b], v[b], g[b], mask[b], window)
        stats = [x.stats(r0, passes) for r0 in range(0, x.T_pad, 16)]
        m, l, row = (torch.cat([s[i] for s in stats], 1) for i in range(3))  # (H, T_pad, 1)
        dk, dv = torch.zeros_like(x.q), torch.zeros_like(x.q)
        k2 = min(2 * x.k_win - W.TILE, x.T_pad)
        T16 = (x.T + 15) // 16 * 16
        for k0 in range(0, x.T_pad, W.TILE):
            start = W.slice_start(k0, x.T, window)
            n_start = max(0, min(start - (x.k_win - W.TILE) // 2, x.T_pad - k2))
            window_rows = torch.arange(start, min(start + x.k_win, T16))
            pads = x.pad_rows[window_rows]
            own = torch.arange(k0, k0 + W.TILE)
            if pads.any():
                # the padding rows' matrix: M = sum over them of q g^T; their ds^T q
                # on a key is (scale / K2) M (v - cs / K2); their dv terms g / K2
                qp = x.q[:, window_rows] * pads[None, :, None]
                mm = product(qp.transpose(-1, -2), x.g[:, window_rows], passes) * (x.scale / k2)
                cs = x.colsum_v(n_start, n_start + k2) / k2
                dk[:, own] = product(x.v[:, own] - cs, mm.transpose(-1, -2), passes)
            for kw0 in range(k0, k0 + W.TILE, 16):
                own = torch.arange(kw0, kw0 + 16)
                lo, hi = x.span(kw0)
                for r0 in range(lo, min(hi, T16), 16):
                    rows = torch.arange(r0, r0 + 16)
                    st = product(x.k[:, own], x.q[:, rows].transpose(-1, -2), passes) * x.scale
                    ok = ((rows[None, :] - own[:, None]).abs() <= x.half) & \
                        x.valid[own][:, None] & (rows < x.T)[None, :] & \
                        ~x.pad_rows[rows][None, :]
                    p = torch.where(ok, torch.exp(st - m[:, rows, 0][:, None, :]) /
                                    l[:, rows, 0][:, None, :], torch.zeros(()))
                    dpt = product(x.v[:, own], x.g[:, rows].transpose(-1, -2), passes)
                    ds = p * (dpt - row[:, rows, 0][:, None, :]) * x.scale
                    dv[:, own] += product(p, x.g[:, rows], passes)
                    dk[:, own] += product(ds, x.q[:, rows], passes)
                if pads.any():
                    dv[:, own] += x.g[:, window_rows[pads]].sum(1, keepdim=True) / k2
        dk_out[b], dv_out[b] = dk[:, :x.T], dv[:, :x.T]
    return dk_out, dv_out


def _err(got, want) -> float:
    """The largest difference over the larger of 1 and want's largest
    magnitude."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


CASES = [(300, 9, 24), (513, 19, 128), (640, 37, 1), (384, 19, 24), (640, 37, 128)]


@pytest.mark.parametrize("T,window,hd", CASES)
def test_emulated_fwd_schedule_matches_plain(T, window, hd):
    q, k, v, mask, _ = _inputs(T + window + hd, T, window, hd)
    assert _err(emulate_fwd(q, k, v, mask, window),
                W.banded_attention_plain(q, k, v, mask, window)) <= ATOL


@pytest.mark.parametrize("T,window,hd", CASES)
def test_emulated_dq_schedule_matches_dq_plain(T, window, hd):
    q, k, v, mask, g = _inputs(T + window + hd, T, window, hd)
    want = W.banded_attention_dq_plain(q, k, v, mask, g, window)
    assert _err(emulate_dq(q, k, v, mask, g, window), want) <= ATOL


@pytest.mark.parametrize("T,window,hd", CASES)
def test_emulated_dkv_schedule_matches_dkv_plain(T, window, hd):
    q, k, v, mask, g = _inputs(T + window + hd, T, window, hd)
    got, want = emulate_dkv(q, k, v, mask, g, window), \
        W.banded_attention_dkv_plain(q, k, v, mask, g, window)
    for got_, want_ in zip(got, want):
        assert _err(got_, want_) <= ATOL


@pytest.mark.parametrize("T,window,hd", [(300, 19, 24), (384, 19, 128)])
def test_one_tf32_pass_misses_the_tolerance(T, window, hd):
    """big.big alone keeps 11 bits of each operand: dq, dk and dv move by far
    more than ``ATOL``."""
    q, k, v, mask, g = _inputs(T + hd, T, window, hd)
    assert _err(emulate_dq(q, k, v, mask, g, window, passes=1),
                W.banded_attention_dq_plain(q, k, v, mask, g, window)) > 20 * ATOL
    for got, want in zip(emulate_dkv(q, k, v, mask, g, window, passes=1),
                         W.banded_attention_dkv_plain(q, k, v, mask, g, window)):
        assert _err(got, want) > 20 * ATOL


@pytest.mark.parametrize("T,window,hd", [(300, 19, 24), (384, 19, 128)])
def test_one_tf32_pass_misses_the_tolerance_in_the_forward(T, window, hd):
    """big.big alone keeps 11 bits of each operand: the output moves by far
    more than ``ATOL``."""
    q, k, v, mask, _ = _inputs(T + hd, T, window, hd)
    assert _err(emulate_fwd(q, k, v, mask, window, passes=1),
                W.banded_attention_plain(q, k, v, mask, window)) > 20 * ATOL


def test_schedule_constants_are_the_kernels():
    src = CSRC.read_text()
    for name, value in (("kTfChunk", CHUNK_KEYS), ("kTfRowPad", ROW_PAD), ("kTile", W.TILE)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
    assert re.search(r"constexpr int kMmaWarps = kTile / 16;", src) and W.TILE // 16 == WARPS
    assert '#include "mma_tf32.cuh"' in src
    # the f32 entries launch the tensor-core bodies, one per head-dim bucket
    for body in ("banded_tf32", "dq_tf32", "dkv_tf32"):
        buckets = re.findall(rf"launch_{body}<(\d+)>\(", src)
        assert sorted(set(map(int, buckets))) == [4, 8, 16], body
    assert "banded_f32" not in src and "dq_f32" not in src and "dkv_f32" not in src
