"""SeqPAN's attention cores: three hand-written CUDA kernels for Hopper, each
beside its plain PyTorch version.

- ``fused_masked_attention`` -> CUDA ``vmr_masked_attention``; replaces
  ``vmrframe_tpu/kernels/attention.py::fused_masked_attention`` (``_attn_kernel``).
- ``fused_dual_attention`` -> CUDA ``vmr_dual_attention``; replaces
  ``fused_dual_attention`` (``_dual_attn_kernel``) there.
- ``fused_cq_attention`` -> CUDA ``vmr_cq_attention``; replaces
  ``fused_cq_attention`` (``_cq_kernel``) there.

The sources are ``csrc/attention.cu`` (bounds and design are noted there).
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises, and counts the launch in ``<wrapper>.launches``.
The public layout is the JAX one, (B, H, L, hd): the attention kernels take
any strides with a unit last stride, so head-split views of (B, L, D)
projections go in without a copy, and their outputs are (B, L, H, hd) in
memory, ready for the head merge.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from vmrframe_tpu_torch.ops.masking import MASK_VALUE

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_VIEW = [_P, _L, _L, _L]
_ARGTYPES = {
    "vmr_masked_attention": [_I] + _VIEW * 3 + [_P] + _VIEW + [_I] * 5 + [_F, _P],
    "vmr_dual_attention": [_I] + _VIEW * 5 + [_P, _P] + _VIEW * 2 + [_I] * 5 + [_F, _P],
    "vmr_cq_attention": [_I] + [_P] * 9 + [_I] * 4 + [_P],
}
_lib = None


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


# ------------------------------------------------------------------ wrappers


def fused_masked_attention(q, k, v, mask):
    """softmax(q k^T / sqrt(hd) masked) v over (B, H, L, hd) tensors.

    mask: (B, Lq, Lk) {0,1}, shared by the heads.
    """
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, mask)
    dtype = _check_cuda((q, k, v), "fused_masked_attention")
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    mask = _as(mask, q, (B, Lq, Lk))
    out = _head_major_out(q, Lq)
    err = load_kernels().vmr_masked_attention(
        _DTYPE_CODE[dtype], *_view(q), *_view(k), *_view(v), mask.data_ptr(), *_view(out),
        B, H, Lq, Lk, hd, 1.0 / math.sqrt(hd), _stream(q))
    _raise_on(err, "vmr_masked_attention")
    fused_masked_attention.launches += 1
    return out


def fused_dual_attention(q, f_k, f_v, t_k, t_v, s_mask, x_mask):
    """SeqPAN's dual attention core: (s_value, x_value), both (B, H, L, hd).

    q/f_k/f_v: (B, H, L, hd); t_k/t_v: (B, H, M, hd);
    s_mask: (B, L, L); x_mask: (B, L, M), {0,1}.
    """
    if q.device.type == "cpu":
        return dual_attention_plain(q, f_k, f_v, t_k, t_v, s_mask, x_mask)
    dtype = _check_cuda((q, f_k, f_v, t_k, t_v), "fused_dual_attention")
    B, H, L, hd = q.shape
    M = t_k.shape[2]
    if f_k.shape != q.shape or f_v.shape != q.shape or t_k.shape != (B, H, M, hd) \
            or t_v.shape != t_k.shape:
        raise ValueError("fused_dual_attention: q/f_k/f_v must be (B, H, L, hd) and "
                         "t_k/t_v (B, H, M, hd)")
    s_mask = _as(s_mask, q, (B, L, L))
    x_mask = _as(x_mask, q, (B, L, M))
    s_out, x_out = _head_major_out(q, L), _head_major_out(q, L)
    err = load_kernels().vmr_dual_attention(
        _DTYPE_CODE[dtype], *_view(q), *_view(f_k), *_view(f_v), *_view(t_k), *_view(t_v),
        s_mask.data_ptr(), x_mask.data_ptr(), *_view(s_out), *_view(x_out),
        B, H, L, M, hd, 1.0 / math.sqrt(hd), _stream(q))
    _raise_on(err, "vmr_dual_attention")
    fused_dual_attention.launches += 1
    return s_out, x_out


def fused_cq_attention(context, query, w4C, w4Q, w4mlu, c_mask, q_mask):
    """(c2q, q2c), both (B, Lc, D): the two attention outputs CQAttention
    concatenates.  context (B, Lc, D), query (B, Lq, D), w4C/w4Q (D, 1),
    w4mlu (1, 1, D), c_mask (B, Lc), q_mask (B, Lq)."""
    if context.device.type == "cpu":
        return cq_attention_plain(context, query, w4C, w4Q, w4mlu, c_mask, q_mask)
    dtype = _check_cuda((context, query), "fused_cq_attention")
    B, Lc, D = context.shape
    Lq = query.shape[1]
    if query.shape != (B, Lq, D):
        raise ValueError(f"context {tuple(context.shape)} and query {tuple(query.shape)} disagree")
    context, query = context.contiguous(), query.contiguous()
    w4C, w4Q = _as(w4C, context, (D, 1)), _as(w4Q, context, (D, 1))
    w4mlu = _as(w4mlu, context, (1, 1, D))
    c_mask, q_mask = _as(c_mask, context, (B, Lc)), _as(q_mask, context, (B, Lq))
    c2q, q2c = torch.empty_like(context), torch.empty_like(context)
    err = load_kernels().vmr_cq_attention(
        _DTYPE_CODE[dtype], context.data_ptr(), query.data_ptr(), w4C.data_ptr(),
        w4Q.data_ptr(), w4mlu.data_ptr(), c_mask.data_ptr(), q_mask.data_ptr(),
        c2q.data_ptr(), q2c.data_ptr(), B, Lc, Lq, D, _stream(context))
    _raise_on(err, "vmr_cq_attention")
    fused_cq_attention.launches += 1
    return c2q, q2c


KERNELS = (fused_masked_attention, fused_dual_attention, fused_cq_attention)
for _fn in KERNELS:
    _fn.launches = 0
