"""The schedules of the banded backward kernels (#6 dq, #7 dk/dv), on the CPU.

``csrc/window_attention.cu`` walks, for each 16 rows (dq) or 16 own keys
(dk/dv), only the 16-aligned span of the band, ``warp_key_span``, plus a pass
over the padding rows (rows with no valid key in their band) in the blocks
that hold one.  These tests emulate that schedule in torch and hold it to the
plain versions, which reproduce the TPU kernels on every row:

- (a) ``warp_key_span`` read as the query span of 16 own keys: for every T
  from 130 to 1000 and windows 9, 19, 37 and 300 it holds every row whose
  band reaches one of the keys, lies inside the key tile's K_WIN query
  window, and the key span of each of its rows lies inside the tile's K2
  statistics slice; a block's union fits what the launch plans for;
- (b) #7's schedule (span statistics, span products, the padding-row pass)
  equals ``banded_attention_dkv_plain`` on every row, in f32;
- (c) #6's schedule equals ``banded_attention_dq_plain`` the same way;
- (d) the span statistics (max, normaliser, sum of dp p) of every row with a
  valid key in its band equal the plain dk/dv's K2 statistics.

Inputs: a wholly masked sample, a hole wider than the band, a masked tail,
and a random cotangent on every row.  Tolerance 1e-6 of the compared
tensor's largest magnitude (at least 1e-6): the schedules differ from the
plain versions only in the order of f32 sums, over up to a few hundred terms.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import numpy as np
import pytest
import torch

from vmrframe_tpu_torch.kernels import window_attention as W
from vmrframe_tpu_torch.ops.masking import MASK_VALUE

WINDOWS = (9, 19, 37, 300)
CASES = [(T, w) for T in (300, 513, 1000) for w in (9, 19, 37)] + [(640, 300), (1000, 300)]
ATOL = 1e-6


def _close(got, want, msg=None):
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL * max(1.0, float(want.abs().max())),
                               msg=msg)


def _inputs(seed, T, window, hd, B=2, H=2):
    """q, k, v, cotangent (B, H, T, hd) and a (B, T) {0,1} mask: sample 0
    wholly masked, sample 1 of a random length with a hole wider than the
    band; the cotangent is random on every row."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, T, hd)).astype(np.float32))
                  for _ in range(4))
    mask = np.zeros((B, T), np.float32)
    mask[1:, :int(rng.integers(T // 2, T + 1))] = 1.0
    mask[1, T // 4:T // 4 + window + 40] = 0.0
    return q, k, v, torch.from_numpy(mask), g


def _padding_rows(mask, window):
    """(B, T) bool: the rows with no valid key in their band."""
    half, T = window // 2, mask.shape[1]
    c = torch.nn.functional.pad((mask > 0).float().cumsum(1), (1, 0))
    i = torch.arange(T)
    return (c[:, (i + half + 1).clamp(max=T)] - c[:, (i - half).clamp(min=0)]) == 0


def _span_stats(q, k, v, mask, g, window):
    """Per row: max m, normaliser l and sum(dp p) over its 16 rows' key span,
    each (B, H, T); and the padding-row flags (B, T)."""
    B, H, T, hd = q.shape
    half, scale = window // 2, hd ** -0.5
    valid = mask > 0
    m, l, row = (torch.zeros(B, H, T) for _ in range(3))
    for row0 in range(0, T, 16):
        lo, hi = W.warp_key_span(T, window, row0)
        rows, keys = torch.arange(row0, min(row0 + 16, T)), torch.arange(lo, min(hi, T))
        ok = ((rows[:, None] - keys[None, :]).abs() <= half)[None] & valid[:, None, keys]
        s = (q[:, :, rows] @ k[:, :, keys].transpose(-1, -2) * scale).masked_fill(
            ~ok[:, None], MASK_VALUE)
        mx = s.amax(-1, keepdim=True)
        e = torch.exp(s - mx)
        dp = g[:, :, rows] @ v[:, :, keys].transpose(-1, -2)
        m[:, :, rows], l[:, :, rows] = mx[..., 0], e.sum(-1)
        row[:, :, rows] = (e * dp).sum(-1) / e.sum(-1)
    return m, l, row, _padding_rows(mask, window)


def _emulate_dkv(q, k, v, mask, g, window, dtype=torch.float32):
    """#7's schedule: per 16 own keys, the non-padding rows of its query span
    with span statistics; per key tile, every padding row of its K_WIN query
    window with p = 1/K2 on each own key."""
    B, H, T, hd = q.shape
    half, k_win, T_pad, scale = window // 2, W.key_window(window), W.padded_len(T), hd ** -0.5
    k2 = min(2 * k_win - W.TILE, T_pad)
    rnd = lambda x: x.to(dtype).float()  # noqa: E731
    m, l, row, pad = _span_stats(q, k, v, mask, g, window)
    valid = mask > 0
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, T, W.TILE):
        start = W.slice_start(k0, T, window)
        n_start = max(0, min(start - (k_win - W.TILE) // 2, T_pad - k2))
        for kk0 in range(k0, min(k0 + W.TILE, T), 16):
            keys = torch.arange(kk0, min(kk0 + 16, T))
            lo, hi = W.warp_key_span(T, window, kk0)
            rows = torch.arange(lo, min(hi, T))
            ok = ((rows[:, None] - keys[None, :]).abs() <= half)[None] & valid[:, None, keys]
            ok = ok & ~pad[:, rows, None]
            s = q[:, :, rows] @ k[:, :, keys].transpose(-1, -2) * scale
            p = torch.exp(s - m[:, :, rows, None]) / l[:, :, rows, None]
            p = torch.where(ok[:, None], p, torch.zeros(()))
            dp = g[:, :, rows] @ v[:, :, keys].transpose(-1, -2)
            ds = p * (dp - row[:, :, rows, None]) * scale
            dv[:, :, keys] += rnd(p).transpose(-1, -2) @ g[:, :, rows]
            dk[:, :, keys] += rnd(ds).transpose(-1, -2) @ q[:, :, rows]
        # the padding-row pass: every padding row of the query window, every own key
        rows = torch.arange(start, min(start + k_win, T))
        keys = torch.arange(k0, min(k0 + W.TILE, T))
        is_pad = pad[:, None, rows, None].float()  # (B, 1, R, 1)
        colsum = v[:, :, n_start:min(n_start + k2, T)].sum(2)  # (B, H, hd)
        row_pad = (g[:, :, rows] @ colsum[..., None]) / k2  # (B, H, R, 1)
        dp = g[:, :, rows] @ v[:, :, keys].transpose(-1, -2)
        ds = (1.0 / k2) * (dp - row_pad) * scale * is_pad
        p = rnd(torch.tensor(1.0 / k2)) * is_pad.expand_as(dp)
        dv[:, :, keys] += p.transpose(-1, -2) @ g[:, :, rows]
        dk[:, :, keys] += rnd(ds).transpose(-1, -2) @ q[:, :, rows]
    return dk, dv


def _emulate_dq(q, k, v, mask, g, window, dtype=torch.float32):
    """#6's schedule: per 16 rows, the non-padding rows over their key span
    with span statistics; a padding row over its tile's K_WIN slice with
    p = 1/K_WIN on each key."""
    B, H, T, hd = q.shape
    half, k_win, scale = window // 2, W.key_window(window), hd ** -0.5
    rnd = lambda x: x.to(dtype).float()  # noqa: E731
    m, l, row, pad = _span_stats(q, k, v, mask, g, window)
    valid = mask > 0
    dq = torch.zeros_like(q)
    for row0 in range(0, T, 16):
        rows = torch.arange(row0, min(row0 + 16, T))
        lo, hi = W.warp_key_span(T, window, row0)
        keys = torch.arange(lo, min(hi, T))
        ok = ((rows[:, None] - keys[None, :]).abs() <= half)[None] & valid[:, None, keys]
        s = q[:, :, rows] @ k[:, :, keys].transpose(-1, -2) * scale
        p = torch.exp(s - m[:, :, rows, None]) / l[:, :, rows, None]
        p = torch.where(ok[:, None], p, torch.zeros(()))
        dp = g[:, :, rows] @ v[:, :, keys].transpose(-1, -2)
        ds = p * (dp - row[:, :, rows, None]) * scale
        normal = rnd(ds) @ k[:, :, keys]
        # padding rows: the whole K_WIN slice of their tile, p = 1/K_WIN
        start = W.slice_start(row0 // W.TILE * W.TILE, T, window)
        skeys = torch.arange(start, min(start + k_win, T))
        colsum = v[:, :, skeys].sum(2)
        row_pad = (g[:, :, rows] @ colsum[..., None]) / k_win
        dp = g[:, :, rows] @ v[:, :, skeys].transpose(-1, -2)
        padded = rnd((1.0 / k_win) * (dp - row_pad) * scale) @ k[:, :, skeys]
        dq[:, :, rows] = torch.where(pad[:, None, rows, None], padded, normal)
    return dq


# ------------------------------------------------- (a) the query spans


@pytest.mark.parametrize("window", WINDOWS)
def test_query_span_holds_every_row_that_reaches_its_keys(window):
    """For 16 own keys from kk0, ``warp_key_span(T, window, kk0)`` is their
    query span: whole 16-row tiles holding every row (below T_pad) whose band
    reaches one of the keys, inside the key tile's K_WIN query window; each
    row of it reads a key span inside the tile's K2 statistics slice; and the
    8 spans of a block stage no more rows than min(K_WIN, 128 + 2 reach)."""
    half, k_win = window // 2, W.key_window(window)
    reach = (half + 15) // 16 * 16
    checked = 0
    for T in range(130, 1001):
        T_pad = W.padded_len(T)
        if T_pad < k_win:
            continue
        k2 = min(2 * k_win - W.TILE, T_pad)
        for k0 in range(0, T_pad, W.TILE):
            start = W.slice_start(k0, T, window)
            n_start = max(0, min(start - (k_win - W.TILE) // 2, T_pad - k2))
            spans = [W.warp_key_span(T, window, kk0) for kk0 in range(k0, k0 + W.TILE, 16)]
            for i, (lo, hi) in enumerate(spans):
                kk0 = k0 + 16 * i
                assert lo % 16 == 0 and hi % 16 == 0
                assert start <= lo and hi <= start + k_win
                assert lo <= max(0, kk0 - half) and min(T_pad, kk0 + 16 + half) <= hi
                first, last = W.warp_key_span(T, window, lo), W.warp_key_span(T, window, hi - 16)
                assert n_start <= first[0] and last[1] <= n_start + k2
                checked += 1
            assert spans[-1][1] - spans[0][0] <= min(k_win, W.TILE + 2 * reach)
    assert checked > 20_000


# ------------------------------------------- (b), (c) the schedules


@pytest.mark.parametrize("T,window", CASES)
def test_dkv_schedule_equals_plain_on_every_row(T, window):
    hd = 16 if T % 2 else 24
    q, k, v, mask, g = _inputs(T * window + 1, T, window, hd)
    got = _emulate_dkv(q, k, v, mask, g, window)
    want = W.banded_attention_dkv_plain(q, k, v, mask, g, window)
    for name, a, b in zip(("dk", "dv"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("T,window", CASES)
def test_dq_schedule_equals_plain_on_every_row(T, window):
    hd = 24 if T % 2 else 16
    q, k, v, mask, g = _inputs(T * window + 2, T, window, hd)
    got = _emulate_dq(q, k, v, mask, g, window)
    want = W.banded_attention_dq_plain(q, k, v, mask, g, window)
    _close(got, want)


# --------------------------------- (d) span statistics against K2's


@pytest.mark.parametrize("T,window", [(300, 19), (1000, 9), (513, 37), (1000, 300)])
def test_span_statistics_equal_the_k2_statistics(T, window):
    """The plain dk/dv takes each query row's statistics over its key tile's
    K2 slice; on a row with a valid key in its band they are the span's."""
    q, k, v, mask, g = _inputs(T + window, T, window, 16)
    half, k_win, T_pad, scale = window // 2, W.key_window(window), W.padded_len(T), 16 ** -0.5
    k2 = min(2 * k_win - W.TILE, T_pad)
    m, l, row, pad = _span_stats(q, k, v, mask, g, window)
    qf, kf, vf, gf = W._padded(T, q, k, v, g)
    mf = torch.nn.functional.pad(mask, (0, T_pad - T))
    compared = 0
    for k0 in range(0, T_pad, W.TILE):
        start = W.slice_start(k0, T, window)
        n_start = max(0, min(start - (k_win - W.TILE) // 2, T_pad - k2))
        rows = torch.arange(start, min(start + k_win, T))
        keys = torch.arange(n_start, n_start + k2)
        s = W._masked_scores(qf, kf, rows[None], keys[None], mf, half, scale)[:, :, 0]
        mx = s.amax(-1, keepdim=True)
        e = torch.exp(s - mx)
        dp = gf[:, :, rows] @ vf[:, :, keys].transpose(-1, -2)
        want = (mx[..., 0], e.sum(-1), (dp * e / e.sum(-1, keepdim=True)).sum(-1))
        keep = ~pad[:, None, rows].expand(-1, q.shape[1], -1)
        for name, a, b in zip(("m", "l", "row"), (m, l, row), want):
            _close(a[:, :, rows][keep], b[keep], name)
        compared += int(keep.sum())
    assert compared > 0
