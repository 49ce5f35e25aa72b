"""ActionFormer's banded (sliding-window) attention: a hand-written CUDA kernel
for Hopper beside its plain PyTorch version.

- ``banded_attention`` -> CUDA ``vmr_banded_attention`` (``csrc/window_attention.cu``,
  where its bound and design are noted); replaces the forward of
  ``vmrframe_tpu/kernels/window_attention.py::banded_attention`` (``_fwd_kernel``).

The function: for each query row i, softmax over the keys j with
|i - j| <= window // 2 and kv_mask[j] > 0, of q_i . k_j / sqrt(hd) in f32,
times V; the probabilities are rounded to v's type before the value product.
As on the TPU, each 128-row query tile works on one K_WIN-key slice with
masked scores REPLACED by -1e30, so a row with no valid key in its band (a
padding row) is the uniform average of V over its slice, and T is treated as
padded to a multiple of 128 with zero keys and values that are masked out.
Callers multiply the output by the query mask.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises, and counts the launch in
``banded_attention.launches``.  Inputs are (B, H, T, hd) in the JAX layout,
any strides with a unit last stride; the output is (B, H, T, hd) over
(B, T, H, hd) memory, ready for the head merge.  The CUDA kernel takes head
dims 32, 64 and 128.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vmrframe_tpu_torch.kernels.attention import (
    _DTYPE_CODE, _as, _check_cuda, _head_major_out, _raise_on, _stream, _view)
from vmrframe_tpu_torch.ops.masking import MASK_VALUE

TILE = 128
KERNEL_HEAD_DIMS = (32, 64, 128)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_VIEW = [_P, _L, _L, _L]
_ARGTYPES = [_I] + _VIEW * 3 + [_P] + _VIEW + [_I] * 5 + [_F, _P]
_lib = None


def load_kernels() -> ctypes.CDLL:
    """The compiled ``csrc/window_attention.cu`` (built on first use)."""
    global _lib
    if _lib is None:
        from vmrframe_tpu_torch.kernels import build

        lib = build.load("window_attention")
        lib.vmr_banded_attention.argtypes = _ARGTYPES
        lib.vmr_banded_attention.restype = ctypes.c_int
        _lib = lib
    return _lib


def key_window(window: int) -> int:
    """K_WIN: the keys one 128-row query tile can reach, in whole tiles."""
    half = window // 2
    return TILE + 2 * ((half + TILE - 1) // TILE) * TILE


def padded_len(T: int) -> int:
    return (T + TILE - 1) // TILE * TILE


def _check_len(T: int, window: int) -> None:
    if padded_len(T) < key_window(window):
        raise ValueError(f"T={T} too small for the banded kernel "
                         f"(needs a padded length >= {key_window(window)})")


def banded_attention_plain(q, k, v, kv_mask, window: int):
    """The TPU kernel's function in plain PyTorch, tile by tile over each
    tile's K_WIN slice, so padding rows come out as the kernel gives them.

    q/k/v: (B, H, T, hd); kv_mask: (B, T) {0,1}.  Returns (B, H, T, hd) in q's type.
    """
    B, H, T, hd = q.shape
    _check_len(T, window)
    half, k_win, T_pad = window // 2, key_window(window), padded_len(T)
    n = T_pad // TILE
    pad = T_pad - T
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, pad))
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v, (0, 0, 0, pad))
    mf = torch.nn.functional.pad(kv_mask.float(), (0, pad))
    q_start = torch.arange(n, device=q.device) * TILE
    start = (q_start - (k_win - TILE) // 2).clamp(0, T_pad - k_win)
    kidx = start[:, None] + torch.arange(k_win, device=q.device)  # (n, K_WIN)
    qi = q_start[:, None] + torch.arange(TILE, device=q.device)  # (n, TILE)
    band = (qi[:, :, None] - kidx[:, None, :]).abs() <= half  # (n, TILE, K_WIN)
    ok = band[None] & (mf[:, kidx] > 0)[:, :, None, :]  # (B, n, TILE, K_WIN)
    s = torch.einsum("bhnqd,bhnkd->bhnqk", qf.reshape(B, H, n, TILE, hd), kf[:, :, kidx])
    s = (s * (1.0 / math.sqrt(hd))).masked_fill(~ok[:, None], MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhnqk,bhnkd->bhnqd", p, vf[:, :, kidx].float())
    return out.reshape(B, H, T_pad, hd)[:, :, :T].to(q.dtype)


def banded_attention(q, k, v, kv_mask, window: int):
    """Banded attention over (B, H, T, hd) tensors; kv_mask (B, T) {0,1}."""
    if q.device.type == "cpu":
        return banded_attention_plain(q, k, v, kv_mask, window)
    dtype = _check_cuda((q, k, v), "banded_attention")
    B, H, T, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"banded_attention: the kernel takes head dims {KERNEL_HEAD_DIMS}, "
                         f"got {hd}")
    _check_len(T, window)
    mask = _as(kv_mask, q, (B, T))
    out = _head_major_out(q, T)
    err = load_kernels().vmr_banded_attention(
        _DTYPE_CODE[dtype], *_view(q), *_view(k), *_view(v), mask.data_ptr(), *_view(out),
        B, H, T, hd, window, 1.0 / math.sqrt(hd), _stream(q))
    _raise_on(err, "vmr_banded_attention")
    banded_attention.launches += 1
    return out


KERNELS = (banded_attention,)
banded_attention.launches = 0
