"""ActionFormer's banded (sliding-window) attention, forward and backward:
three hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and the ``torch.autograd.Function`` that joins them.

- ``banded_attention`` -> CUDA ``vmr_banded_attention`` (``csrc/window_attention.cu``,
  where bounds and designs are noted); replaces the forward of
  ``vmrframe_tpu/kernels/window_attention.py::banded_attention`` (``_fwd_kernel``).
  It is differentiable: its backward runs the two kernels below.
- ``banded_attention_dq`` -> CUDA ``vmr_banded_attention_dq``; replaces
  ``_banded_bwd``'s ``_dq_kernel`` there.
- ``banded_attention_dkv`` -> CUDA ``vmr_banded_attention_dkv``; replaces
  ``_banded_bwd``'s ``_dkv_kernel`` there.

The forward: for each query row i, softmax over the keys j with
|i - j| <= window // 2 and kv_mask[j] > 0, of q_i . k_j / sqrt(hd) in f32,
times V; the probabilities are rounded to v's type before the value product.
As on the TPU, each 128-row query tile works on one K_WIN-key slice with
masked scores REPLACED by -1e30, so a row with no valid key in its band (a
padding row) is the uniform average of V over its slice, and T is treated as
padded to a multiple of 128 with zero keys and values that are masked out.
Callers multiply the output by the query mask.

The backward reproduces the TPU kernels' backward on every row, padding rows
included, where it is not the exact gradient of the forward (masked
positions carry ``ds``; a padding row's normaliser counts keys):

- dq: per 128-row query tile, the softmax recomputed over the tile's K_WIN
  slice, ``ds = p (dp - sum(dp p)) / sqrt(hd)`` rounded to k's type,
  ``dq = ds k``;
- dk, dv: per 128-key tile, over the K_WIN query rows that can reach it;
  each row's maximum, normaliser and ``sum(dp p)`` are taken over a
  K2 = min(2 K_WIN - 128, T_pad) key slice (equal to the forward's on every
  row with a valid key; a padding row's normaliser is K2), ``dv = p^T g``
  with p rounded to g's type, ``dk = ds^T q`` with ds rounded to q's type.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises, and counts the launch in ``<wrapper>.launches``
(``banded_attention.launches`` counts the forward kernel).  Inputs are
(B, H, T, hd) in the JAX layout, any strides with a unit last stride; every
output is (B, H, T, hd) over (B, T, H, hd) memory, ready for the head merge
(and, for the gradients, for the head-split projections' backward).  Every
kernel takes each head dim from 1 to 128, zero-filling the columns it stages
up to the next multiple of 16 (bf16) or 8 (f32, on the tensor cores in
3xTF32).
"""

from __future__ import annotations

import ctypes
import math

import torch

from vmrframe_tpu_torch.kernels import count_plain, launch_range, plain_route

from vmrframe_tpu_torch.kernels.attention import (
    _DTYPE_CODE, _as, _check_cuda, _head_major_out, _raise_on, _stream, _view)
from vmrframe_tpu_torch.ops.masking import MASK_VALUE

TILE = 128
MAX_HEAD_DIM = 128  # every kernel, both types
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_VIEW = [_P, _L, _L, _L]
_TAIL = [_I] * 5 + [_F, _P]  # B, H, T, hd, window, scale, stream
_ARGTYPES = {
    "vmr_banded_attention": [_I] + _VIEW * 3 + [_P] + _VIEW + _TAIL,
    "vmr_banded_attention_dq": [_I] + _VIEW * 3 + [_P] + _VIEW * 2 + _TAIL,
    "vmr_banded_attention_dkv": [_I] + _VIEW * 3 + [_P] + _VIEW * 3 + _TAIL,
}
_lib = None


def load_kernels() -> ctypes.CDLL:
    """The compiled ``csrc/window_attention.cu`` (built on first use)."""
    global _lib
    if _lib is None:
        from vmrframe_tpu_torch.kernels import build

        lib = build.load("window_attention")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def key_window(window: int) -> int:
    """K_WIN: the keys one 128-row query tile can reach, in whole tiles."""
    half = window // 2
    return TILE + 2 * ((half + TILE - 1) // TILE) * TILE


def padded_len(T: int) -> int:
    return (T + TILE - 1) // TILE * TILE


def slice_start(q0: int, T: int, window: int) -> int:
    """The first key of the K_WIN slice of the 128-row tile from ``q0``."""
    k_win = key_window(window)
    return max(0, min(q0 - (k_win - TILE) // 2, padded_len(T) - k_win))


def warp_key_span(T: int, window: int, row0: int):
    """[lo, hi): the keys that the forward and dq kernels read for the 16
    query rows from ``row0`` (a multiple of 16): their band [row0 - half,
    row0 + 15 + half] rounded out to 16-key tiles, clipped to the K_WIN slice
    of their 128-row tile.  The band is symmetric, so read with ``row0`` the
    first of 16 keys it is also their query span, the rows that the dk/dv
    kernel reads for them: the rows whose band reaches one of the keys,
    rounded out the same way and clipped to the key tile's K_WIN query
    window, which starts where the slice of the same 128-row tile does.
    ``csrc/window_attention.cu::warp_key_span`` computes the same."""
    start = slice_start(row0 // TILE * TILE, T, window)
    reach = (window // 2 + 15) // 16 * 16
    return max(start, row0 - reach), min(start + key_window(window), row0 + 16 + reach)


def _check_len(T: int, window: int) -> None:
    if padded_len(T) < key_window(window):
        raise ValueError(f"T={T} too small for the banded kernel "
                         f"(needs a padded length >= {key_window(window)})")


def takes(T: int, hd: int, window: int) -> bool:
    """Whether #5-#7 take these shapes (both types alike): head dims 1 to
    ``MAX_HEAD_DIM`` and one key window within the padded length.  The
    band gate reads it before a launch (``layers/actionformer.py``); the
    wrappers raise on what it refuses."""
    return 1 <= hd <= MAX_HEAD_DIM and T >= 1 and padded_len(T) >= key_window(window)


# ------------------------------------------------------------ plain versions


def _padded(T: int, *tensors):
    """Each (B, H, T, hd) tensor in f32, zero-padded to the padded length."""
    pad = padded_len(T) - T
    return [torch.nn.functional.pad(t.float(), (0, 0, 0, pad)) for t in tensors]


def _slice_starts(n: int, k_win: int, T_pad: int, device) -> torch.Tensor:
    """Per 128-row tile, the first row of its K_WIN slice (the TPU's ``start``;
    ``slice_start`` of each tile, computed on ``device``)."""
    return (torch.arange(n, device=device) * TILE - (k_win - TILE) // 2).clamp(0, T_pad - k_win)


def _masked_scores(qf, kf, qidx, kidx, mf, half: int, scale: float):
    """Band-masked scores of the rows ``qidx`` (n, R) against the keys
    ``kidx`` (n, K), masked entries replaced by -1e30: (B, H, n, R, K)."""
    band = (qidx[:, :, None] - kidx[:, None, :]).abs() <= half  # (n, R, K)
    ok = band[None] & (mf[:, kidx] > 0)[:, :, None, :]  # (B, n, R, K)
    s = torch.einsum("bhnrd,bhnkd->bhnrk", qf[:, :, qidx], kf[:, :, kidx]) * scale
    return s.masked_fill(~ok[:, None], MASK_VALUE)


def banded_attention_plain(q, k, v, kv_mask, window: int):
    """The TPU kernel's forward in plain PyTorch, tile by tile over each
    tile's K_WIN slice, so padding rows come out as the kernel gives them.

    q/k/v: (B, H, T, hd); kv_mask: (B, T) {0,1}.  Returns (B, H, T, hd) in
    q's type.
    """
    B, H, T, hd = q.shape
    _check_len(T, window)
    half, k_win, T_pad = window // 2, key_window(window), padded_len(T)
    n = T_pad // TILE
    qf, kf = _padded(T, q, k)
    vf = torch.nn.functional.pad(v, (0, 0, 0, T_pad - T))
    mf = torch.nn.functional.pad(kv_mask.float(), (0, T_pad - T))
    ar = lambda m: torch.arange(m, device=q.device)  # noqa: E731
    kidx = _slice_starts(n, k_win, T_pad, q.device)[:, None] + ar(k_win)  # (n, K_WIN)
    qidx = ar(n)[:, None] * TILE + ar(TILE)  # (n, TILE)
    s = _masked_scores(qf, kf, qidx, kidx, mf, half, 1.0 / math.sqrt(hd))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhnqk,bhnkd->bhnqd", p, vf[:, :, kidx].float())
    return out.reshape(B, H, T_pad, hd)[:, :, :T].to(q.dtype)


def banded_attention_dq_plain(q, k, v, kv_mask, g, window: int):
    """``_dq_kernel`` in plain PyTorch: per 128-row query tile, the softmax
    over its K_WIN slice, ``ds = p (dp - sum(dp p)) scale`` rounded to k's
    type, ``dq = ds k``.  g: the output's cotangent, (B, H, T, hd).  Returns
    dq (B, H, T, hd) in q's type."""
    B, H, T, hd = q.shape
    _check_len(T, window)
    half, k_win, T_pad = window // 2, key_window(window), padded_len(T)
    n, scale = T_pad // TILE, 1.0 / math.sqrt(hd)
    qf, kf, vf, gf = _padded(T, q, k, v, g)
    mf = torch.nn.functional.pad(kv_mask.float(), (0, T_pad - T))
    ar = lambda m: torch.arange(m, device=q.device)  # noqa: E731
    kidx = _slice_starts(n, k_win, T_pad, q.device)[:, None] + ar(k_win)  # (n, K_WIN)
    qidx = ar(n)[:, None] * TILE + ar(TILE)  # (n, TILE)
    p = torch.softmax(_masked_scores(qf, kf, qidx, kidx, mf, half, scale), dim=-1)
    dp = torch.einsum("bhnrd,bhnkd->bhnrk", gf[:, :, qidx], vf[:, :, kidx])
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhnrk,bhnkd->bhnrd", ds.to(k.dtype).float(), kf[:, :, kidx])
    return dq.reshape(B, H, T_pad, hd)[:, :, :T].to(q.dtype)


def banded_attention_dkv_plain(q, k, v, kv_mask, g, window: int):
    """``_dkv_kernel`` in plain PyTorch: per 128-key tile, the K_WIN query
    rows that can reach it, each row's statistics over the tile's K2 key
    slice, ``dv = p^T g`` (p rounded to g's type) and ``dk = ds^T q`` (ds
    rounded to q's type).  Returns (dk, dv), (B, H, T, hd) in q's type."""
    B, H, T, hd = q.shape
    _check_len(T, window)
    half, k_win, T_pad = window // 2, key_window(window), padded_len(T)
    n, scale = T_pad // TILE, 1.0 / math.sqrt(hd)
    k2 = min(2 * k_win - TILE, T_pad)
    qf, kf, vf, gf = _padded(T, q, k, v, g)
    mf = torch.nn.functional.pad(kv_mask.float(), (0, T_pad - T))
    ar = lambda m: torch.arange(m, device=q.device)  # noqa: E731
    start = _slice_starts(n, k_win, T_pad, q.device)  # each key tile's query window
    n_start = (start - (k_win - TILE) // 2).clamp(0, T_pad - k2)
    qidx = start[:, None] + ar(k_win)  # (n, K_WIN) query rows
    k2idx = n_start[:, None] + ar(k2)  # (n, K2) keys of the statistics
    own = ar(n)[:, None] * TILE + ar(TILE)  # (n, TILE) the tile's own keys
    s_full = _masked_scores(qf, kf, qidx, k2idx, mf, half, scale)
    mx = s_full.amax(-1, keepdim=True)
    e_full = torch.exp(s_full - mx)
    denom = e_full.sum(-1, keepdim=True)
    gq = gf[:, :, qidx]  # (B, H, n, K_WIN, hd)
    dp_full = torch.einsum("bhnrd,bhnkd->bhnrk", gq, vf[:, :, k2idx])
    row = (dp_full * (e_full / denom)).sum(-1, keepdim=True)
    p = torch.exp(_masked_scores(qf, kf, qidx, own, mf, half, scale) - mx) / denom
    dp = torch.einsum("bhnrd,bhnkd->bhnrk", gq, vf[:, :, own])
    ds = p * (dp - row) * scale
    dv = torch.einsum("bhnrk,bhnrd->bhnkd", p.to(g.dtype).float(), gq)
    dk = torch.einsum("bhnrk,bhnrd->bhnkd", ds.to(q.dtype).float(), qf[:, :, qidx])
    unpad = lambda x: x.reshape(B, H, T_pad, hd)[:, :, :T].to(q.dtype)  # noqa: E731
    return unpad(dk), unpad(dv)


# ------------------------------------------------------------------ wrappers


def _check_args(tensors, what: str, window: int):
    """(dtype, B, H, T, hd) of CUDA (B, H, T, hd) tensors the kernels take."""
    dtype = _check_cuda(tensors, what)
    q = tensors[0]
    B, H, T, hd = q.shape
    if any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in tensors]} disagree")
    if not takes(T, hd, window):
        if not 1 <= hd <= MAX_HEAD_DIM:
            raise ValueError(f"{what}: the kernels take head dims 1 to {MAX_HEAD_DIM}, got {hd}")
        _check_len(T, window)
    return dtype, B, H, T, hd


def _forward(q, k, v, kv_mask, window: int):
    if q.device.type == "cpu":
        return plain_route("banded_attention", banded_attention_plain, q, k, v, kv_mask, window)
    dtype, B, H, T, hd = _check_args((q, k, v), "banded_attention", window)
    mask = _as(kv_mask, q, (B, T))
    out = _head_major_out(q, T)
    with launch_range("banded_attention"):
        err = load_kernels().vmr_banded_attention(
            _DTYPE_CODE[dtype], *_view(q), *_view(k), *_view(v), mask.data_ptr(), *_view(out),
            B, H, T, hd, window, 1.0 / math.sqrt(hd), _stream(q))
    _raise_on(err, "vmr_banded_attention")
    banded_attention.launches += 1
    count_plain(banded_attention_plain, q, k, v, mask, window, name="banded_attention")
    return out


def banded_attention_dq(q, k, v, kv_mask, g, window: int):
    """dq of the banded attention, (B, H, T, hd); g is the output's cotangent."""
    if q.device.type == "cpu":
        return plain_route("banded_attention_dq", banded_attention_dq_plain, q, k, v, kv_mask, g,
                           window)
    dtype, B, H, T, hd = _check_args((q, k, v, g), "banded_attention_dq", window)
    mask = _as(kv_mask, q, (B, T))
    dq = _head_major_out(q, T)
    with launch_range("banded_attention_dq"):
        err = load_kernels().vmr_banded_attention_dq(
            _DTYPE_CODE[dtype], *_view(q), *_view(k), *_view(v), mask.data_ptr(), *_view(g),
            *_view(dq), B, H, T, hd, window, 1.0 / math.sqrt(hd), _stream(q))
    _raise_on(err, "vmr_banded_attention_dq")
    banded_attention_dq.launches += 1
    count_plain(banded_attention_dq_plain, q, k, v, mask, g, window, name="banded_attention_dq")
    return dq


def banded_attention_dkv(q, k, v, kv_mask, g, window: int):
    """(dk, dv) of the banded attention, each (B, H, T, hd)."""
    if q.device.type == "cpu":
        return plain_route("banded_attention_dkv", banded_attention_dkv_plain, q, k, v, kv_mask,
                           g, window)
    dtype, B, H, T, hd = _check_args((q, k, v, g), "banded_attention_dkv", window)
    mask = _as(kv_mask, q, (B, T))
    dk, dv = _head_major_out(q, T), _head_major_out(q, T)
    with launch_range("banded_attention_dkv"):
        err = load_kernels().vmr_banded_attention_dkv(
            _DTYPE_CODE[dtype], *_view(q), *_view(k), *_view(v), mask.data_ptr(), *_view(g),
            *_view(dk), *_view(dv), B, H, T, hd, window, 1.0 / math.sqrt(hd), _stream(q))
    _raise_on(err, "vmr_banded_attention_dkv")
    banded_attention_dkv.launches += 1
    count_plain(banded_attention_dkv_plain, q, k, v, mask, g, window,
                name="banded_attention_dkv")
    return dk, dv


class BandedAttention(torch.autograd.Function):
    """Kernel #5 forward, kernels #6/#7 backward; kv_mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, window: int):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.window = window
        return _forward(q, k, v, kv_mask, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        if g.stride(-1) != 1:
            g = g.contiguous()
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = banded_attention_dq(q, k, v, kv_mask, g, ctx.window)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = banded_attention_dkv(q, k, v, kv_mask, g, ctx.window)
        return dq, dk, dv, None, None


def banded_attention(q, k, v, kv_mask, window: int):
    """Banded attention over (B, H, T, hd) tensors; kv_mask (B, T) {0,1}.
    Differentiable in q, k and v."""
    return BandedAttention.apply(q, k, v, kv_mask, window)


KERNELS = (banded_attention, banded_attention_dq, banded_attention_dkv)
for _fn in KERNELS:
    _fn.launches = 0
