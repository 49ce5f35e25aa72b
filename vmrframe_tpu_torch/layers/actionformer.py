"""ActionFormer's layers (counterpart of ``vmrframe_tpu/layers/actionformer.py``).

Channel-last (B, T, C) as in the JAX package; masks are (B, T) {0,1}.
Parameter names follow the flax tree (``weights.py`` maps one onto the
other): a conv or dense ``kernel`` is a torch ``weight``, and the scalars of
``Scale`` and ``AffineDropPath``, ``scale`` in flax, are ``weight`` here.
In train mode (``module.train()``) ``AffineDropPath`` applies stochastic
depth (``drop_path``) with uniforms drawn from the ``torch.Generator`` the
caller threads through ``forward``, and so does dropout (``proj_pdrop``,
after the attention's projection and around the MLP's second dense, the
JAX package's four sites).  Besides the conv-transformer backbone and the
identity neck, the conv-only backbone (``ConvBlock``, ``ConvBackbone``) and
the feature-pyramid neck (``FPN1D``).

``MaskedMHCA`` with ``window_size > 0`` runs the banded attention kernels
(``kernels/window_attention.py``: the forward, and in backward the dq and
dk/dv kernels) when one key window fits the padded length and T reaches the
mode's threshold: ``pallas_min_len`` in train mode, ``pallas_min_len_eval``
in eval mode (the config keys keep the JAX package's names), as the JAX
gate does; otherwise it computes the full (T, T) scores with a band mask.
With ``use_rel_pe`` a learned (n_head, window_size) relative position term
is added to the in-window scores (its offsets clipped to the window); the
kernels do not add it, so such a layer never takes them, as in the JAX gate.
Both routes give the same values on every valid row.  An unset
``pallas_min_len_eval`` means the same threshold as ``pallas_min_len``: the
JAX model routes eval away from its TPU kernel by default because of a TPU
measurement, and the port does not inherit that.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vmrframe_tpu_torch.kernels import counting
from vmrframe_tpu_torch.kernels.window_attention import banded_attention
from vmrframe_tpu_torch.kernels.window_attention import takes as banded_takes
from vmrframe_tpu_torch.layers.dropout import Dropout, draw_rows
from vmrframe_tpu_torch.ops.precision import promoted_call


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels, eps 1e-5, statistics in f32 (f64 for an
    f64 input), the result in x's type.  Ones and zeros at init
    (``weights.init_weights`` reads ``init_value`` and zeroes the bias)."""

    init_value = 1.0

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.full((dim,), self.init_value))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        wide = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.layer_norm(wide, x.shape[-1:], self.weight, self.bias, self.eps).to(x.dtype)


class Dense(nn.Linear):
    """flax ``Dense(dtype=x.dtype)``: the bias is cast to the input's type.
    Zero bias at init (``weights.init_weights`` reads ``zero_bias_init``)."""

    zero_bias_init = True

    def forward(self, x):
        return F.linear(x, self.weight, self.bias.to(x.dtype))


class _Conv1d(nn.Conv1d):
    zero_bias_init = True


class MaskedConv1D(nn.Module):
    """Conv over (B, T, C) with symmetric k//2 padding; the output is masked
    and the mask nearest-downsampled (``mask[:, ::stride]``) when strided."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, use_bias: bool = True):
        super().__init__()
        self.stride = stride
        self.conv = _Conv1d(in_ch, out_ch, kernel_size, stride=stride,
                            padding=kernel_size // 2, groups=groups, bias=use_bias)

    def forward(self, x, mask):
        c = self.conv
        bias = None if c.bias is None else c.bias.to(x.dtype)
        y = F.conv1d(x.transpose(1, 2), c.weight, bias, c.stride, c.padding, 1, c.groups)
        out_mask = mask[:, ::self.stride] if self.stride > 1 else mask
        return y.transpose(1, 2) * out_mask[..., None], out_mask


@functools.lru_cache(maxsize=None)
def get_sinusoid_encoding(n_position: int, d_hid: int) -> np.ndarray:
    """(n_position, d_hid) sinusoid table."""
    pos = np.arange(n_position)[:, None]
    idx = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (idx // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


# MaskedMHCA parameters that shift every key's score in a row by the same
# amount: the softmax ignores them, so their gradients are zero up to rounding
SHIFT_INVARIANT = ("key.bias", "key_norm.bias")


class MaskedMHCA(nn.Module):
    """Multi-head conv attention: depthwise (strided) convs and channel LN on
    q/k/v, 1x1 projections, masked attention; ``window_size > 0`` limits it
    to the band |i - j| <= window_size // 2."""

    def __init__(self, n_embd: int, n_head: int, n_qx_stride: int = 1, n_kv_stride: int = 1,
                 window_size: int = -1, use_rel_pe: bool = False, pallas_min_len: int = 512,
                 pallas_min_len_eval: Optional[int] = None, proj_pdrop: float = 0.0):
        super().__init__()
        self.n_embd, self.n_head = n_embd, n_head
        self.window_size = window_size
        # the JAX layer creates rel_pe only inside its window branch
        self.use_rel_pe = use_rel_pe and window_size > 0
        if self.use_rel_pe:  # truncated normal, std sqrt(2 / n_embd) (weights.init_weights)
            self.rel_pe = nn.Parameter(torch.zeros(n_head, window_size))
            self.rel_pe_std = math.sqrt(2.0 / n_embd)
        self.min_len_train = pallas_min_len
        self.min_len = pallas_min_len if pallas_min_len_eval is None else pallas_min_len_eval
        q_ks = n_qx_stride + 1 if n_qx_stride > 1 else 3
        kv_ks = n_kv_stride + 1 if n_kv_stride > 1 else 3
        # as in the JAX package, the query conv is strided by n_kv_stride
        self.query_conv = MaskedConv1D(n_embd, n_embd, q_ks, n_kv_stride, n_embd, use_bias=False)
        self.key_conv = MaskedConv1D(n_embd, n_embd, kv_ks, n_kv_stride, n_embd, use_bias=False)
        self.value_conv = MaskedConv1D(n_embd, n_embd, kv_ks, n_kv_stride, n_embd, use_bias=False)
        self.query_norm = ChannelLayerNorm(n_embd)
        self.key_norm = ChannelLayerNorm(n_embd)
        self.value_norm = ChannelLayerNorm(n_embd)
        self.query = Dense(n_embd, n_embd)
        self.key = Dense(n_embd, n_embd)
        self.value = Dense(n_embd, n_embd)
        self.proj = Dense(n_embd, n_embd)
        self.proj_drop = Dropout(proj_pdrop)

    def use_banded_kernel(self, Tq: int, Tk: int) -> bool:
        """The kernel route: a window without rel-PE, T at or above the
        mode's threshold (train: ``min_len_train``, eval: ``min_len``; -1
        disables), Tq == Tk, and shapes the kernels take
        (``kernels/window_attention.py::takes``: one key window within the
        padded length, head dims to 128).  Inside ``kernels.counting_route``
        the thresholds are not read: the band's work is counted at every
        length, whichever route a threshold picks."""
        min_len = self.min_len_train if self.training else self.min_len
        if counting():
            min_len = 0
        if self.window_size <= 0 or self.use_rel_pe or min_len < 0:
            return False
        if Tq != Tk or Tq < min_len:
            return False
        return banded_takes(Tq, self.n_embd // self.n_head, self.window_size)

    def forward(self, x, mask, generator: Optional[torch.Generator] = None):
        B = x.shape[0]
        hd = self.n_embd // self.n_head
        q, qx_mask = self.query_conv(x, mask)
        k, kv_mask = self.key_conv(x, mask)
        v, _ = self.value_conv(x, mask)
        q = self.query(self.query_norm(q))
        k = self.key(self.key_norm(k))
        v = self.value(self.value_norm(v))
        Tq, Tk = q.shape[1], k.shape[1]
        heads = lambda t: t.unflatten(-1, (self.n_head, hd)).transpose(1, 2)  # noqa: E731
        qh, kh, vh = heads(q), heads(k), heads(v)

        if self.use_banded_kernel(Tq, Tk):
            out = banded_attention(qh, kh, vh, kv_mask, self.window_size)
        else:
            att = (qh * (1.0 / math.sqrt(hd))) @ kh.transpose(-1, -2)
            neg = torch.finfo(att.dtype).min
            att = att.masked_fill(~(kv_mask[:, None, None, :] > 0), neg)
            if self.window_size > 0:
                qi = torch.arange(Tq, device=x.device)[:, None]
                kj = torch.arange(Tk, device=x.device)[None, :]
                half = self.window_size // 2
                outside = (qi - kj).abs() > half
                if self.use_rel_pe:  # (n_head, Tq, Tk), 0 outside the band
                    offset = (kj - qi + half).clamp(0, self.window_size - 1)
                    att = att + self.rel_pe[:, offset].masked_fill(outside, 0.0)
                att = att.masked_fill(outside, neg)
            att = torch.softmax(att, dim=-1)
            out = att @ (vh * kv_mask[:, None, :, None])
        out = self.proj(out.transpose(1, 2).reshape(B, Tq, self.n_embd))
        return self.proj_drop(out, generator) * qx_mask[..., None], qx_mask


def drop_path(x, drop_prob: float, u: torch.Tensor):
    """Stochastic depth per sample, given its uniforms ``u`` of shape
    (B, 1, ..., 1): ``keep = floor(1 - drop_prob + u)``, ``x / keep_prob * keep``."""
    keep_prob = 1.0 - drop_prob
    return x / keep_prob * torch.floor(keep_prob + u)


class AffineDropPath(nn.Module):
    """Per-channel scale (``init_value`` at init), then stochastic depth in
    train mode, its uniforms drawn in x's type from ``generator``."""

    init_value = 1e-4

    def __init__(self, num_dim: int, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob
        self.weight = nn.Parameter(torch.full((1, 1, num_dim), self.init_value))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = self.weight * x
        if not self.training or self.drop_prob == 0.0:
            return y
        u = draw_rows(lambda s: torch.rand(s, generator=generator, device=y.device,
                                           dtype=y.dtype), (y.shape[0],) + (1,) * (y.dim() - 1))
        return drop_path(y, self.drop_prob, u)


def _maxpool1d(x, kernel_size: int, stride: int, padding: int):
    """torch ``MaxPool1d`` over (B, T, C) (-inf padding)."""
    return F.max_pool1d(x.transpose(1, 2), kernel_size, stride, padding).transpose(1, 2)


class TransformerBlock(nn.Module):
    """Pre-LN transformer block with optional stride-2 downsampling and a
    max-pooled skip path; exact GELU."""

    def __init__(self, n_embd: int, n_head: int, n_ds_stride: int = 1, path_pdrop: float = 0.0,
                 mha_win_size: int = -1, use_rel_pe: bool = False, pallas_min_len: int = 512,
                 pallas_min_len_eval: Optional[int] = None, proj_pdrop: float = 0.0):
        super().__init__()
        self.n_ds_stride = n_ds_stride
        self.ln1 = ChannelLayerNorm(n_embd)
        self.attn = MaskedMHCA(n_embd, n_head, n_ds_stride, n_ds_stride, mha_win_size,
                               use_rel_pe, pallas_min_len, pallas_min_len_eval, proj_pdrop)
        self.ln2 = ChannelLayerNorm(n_embd)
        self.mlp_fc1 = Dense(n_embd, 4 * n_embd)
        self.mlp_fc2 = Dense(4 * n_embd, n_embd)
        self.proj_drop = Dropout(proj_pdrop)
        self.path_pdrop = path_pdrop
        if path_pdrop > 0.0:
            self.drop_path_attn = AffineDropPath(n_embd, path_pdrop)
            self.drop_path_mlp = AffineDropPath(n_embd, path_pdrop)

    def forward(self, x, mask, generator: Optional[torch.Generator] = None):
        out, out_mask = self.attn(self.ln1(x), mask, generator)
        s = self.n_ds_stride
        skip = _maxpool1d(x, s + 1, s, (s + 1) // 2) if s > 1 else x
        mf = out_mask[..., None]
        out = skip * mf + (self.drop_path_attn(out, generator) if self.path_pdrop > 0.0 else out)
        h = self.proj_drop(F.gelu(self.mlp_fc1(self.ln2(out))), generator)
        h = self.proj_drop(self.mlp_fc2(h), generator) * mf
        return out + (self.drop_path_mlp(h, generator) if self.path_pdrop > 0.0 else h), out_mask


class ConvTransformerBackbone(nn.Module):
    """Embedding convs, stem transformer blocks, then stride-2 branch blocks
    producing the pyramid; returns per-level (feats, masks)."""

    def __init__(self, n_in: int, n_embd: int, n_head: int, n_embd_ks: int, max_len: int,
                 arch: Tuple[int, int, int] = (2, 2, 5), mha_win_size: Sequence[int] = (-1,) * 6,
                 scale_factor: int = 2, with_ln: bool = True, path_pdrop: float = 0.0,
                 use_abs_pe: bool = False, use_rel_pe: bool = False, pallas_min_len: int = 512,
                 pallas_min_len_eval: Optional[int] = None, proj_pdrop: float = 0.0):
        super().__init__()
        self.arch, self.with_ln = tuple(arch), with_ln
        self.n_embd, self.max_len, self.use_abs_pe = n_embd, max_len, use_abs_pe
        for idx in range(self.arch[0]):
            setattr(self, f"embd_{idx}", MaskedConv1D(n_in if idx == 0 else n_embd, n_embd,
                                                      n_embd_ks, use_bias=not with_ln))
            if with_ln:
                setattr(self, f"embd_norm_{idx}", ChannelLayerNorm(n_embd))
        block = functools.partial(TransformerBlock, n_embd, n_head, path_pdrop=path_pdrop,
                                  use_rel_pe=use_rel_pe, pallas_min_len=pallas_min_len,
                                  pallas_min_len_eval=pallas_min_len_eval, proj_pdrop=proj_pdrop)
        for idx in range(self.arch[1]):
            setattr(self, f"stem_{idx}", block(1, mha_win_size=mha_win_size[0]))
        for idx in range(self.arch[2]):
            setattr(self, f"branch_{idx}", block(scale_factor, mha_win_size=mha_win_size[1 + idx]))

    def forward(self, x, mask, generator: Optional[torch.Generator] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        for idx in range(self.arch[0]):
            x, mask = getattr(self, f"embd_{idx}")(x, mask)
            if self.with_ln:
                x = getattr(self, f"embd_norm_{idx}")(x)
            x = torch.relu(x)
        if self.use_abs_pe:
            # as in JAX: the f32 table added to a bf16 x makes x f32, and every
            # block after it runs in f32 on its bf16 weights promoted
            # (flax's promotion; ``ops/precision.py::promoted_call``)
            T = x.shape[1]
            pe = torch.from_numpy(get_sinusoid_encoding(self.max_len, self.n_embd)).to(x.device)
            x = x.to(torch.promote_types(x.dtype, pe.dtype)) \
                + pe[None, :T] / (self.n_embd ** 0.5) * mask[..., None]
        for idx in range(self.arch[1]):
            x, mask = promoted_call(getattr(self, f"stem_{idx}"), x.dtype, x, mask, generator)
        feats, masks = [x], [mask]
        for idx in range(self.arch[2]):
            x, mask = promoted_call(getattr(self, f"branch_{idx}"), x.dtype, x, mask, generator)
            feats.append(x)
            masks.append(mask)
        return feats, masks


class ConvBlock(nn.Module):
    """ResNet-style basic block: a (strided) conv to ``expansion_factor``
    times the width, ReLU, a conv back; a strided 1x1 conv on the skip when
    strided; ReLU of the sum."""

    def __init__(self, n_embd: int, kernel_size: int = 3, n_ds_stride: int = 1,
                 expansion_factor: int = 2):
        super().__init__()
        width = n_embd * expansion_factor
        self.conv1 = MaskedConv1D(n_embd, width, kernel_size, n_ds_stride)
        self.conv2 = MaskedConv1D(width, n_embd, kernel_size, 1)
        if n_ds_stride > 1:
            self.downsample = MaskedConv1D(n_embd, n_embd, 1, n_ds_stride)

    def forward(self, x, mask):
        out, out_mask = self.conv1(x, mask)
        out, out_mask = self.conv2(torch.relu(out), out_mask)
        identity = self.downsample(x, mask)[0] if hasattr(self, "downsample") else x
        return torch.relu(out + identity), out_mask


class ConvBackbone(nn.Module):
    """The conv-only pyramid: embedding convs, stem ``ConvBlock``s, then
    stride ``scale_factor`` branch blocks; per-level (feats, masks)."""

    def __init__(self, n_in: int, n_embd: int, n_embd_ks: int,
                 arch: Tuple[int, int, int] = (2, 2, 5), scale_factor: int = 2,
                 with_ln: bool = True):
        super().__init__()
        self.arch, self.with_ln = tuple(arch), with_ln
        for idx in range(self.arch[0]):
            setattr(self, f"embd_{idx}", MaskedConv1D(n_in if idx == 0 else n_embd, n_embd,
                                                      n_embd_ks, use_bias=not with_ln))
            if with_ln:
                setattr(self, f"embd_norm_{idx}", ChannelLayerNorm(n_embd))
        for idx in range(self.arch[1]):
            setattr(self, f"stem_{idx}", ConvBlock(n_embd, 3, 1))
        for idx in range(self.arch[2]):
            setattr(self, f"branch_{idx}", ConvBlock(n_embd, 3, scale_factor))

    def forward(self, x, mask, generator: Optional[torch.Generator] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        for idx in range(self.arch[0]):
            x, mask = getattr(self, f"embd_{idx}")(x, mask)
            if self.with_ln:
                x = getattr(self, f"embd_norm_{idx}")(x)
            x = torch.relu(x)
        for idx in range(self.arch[1]):
            x, mask = getattr(self, f"stem_{idx}")(x, mask)
        feats, masks = [x], [mask]
        for idx in range(self.arch[2]):
            x, mask = getattr(self, f"branch_{idx}")(x, mask)
            feats.append(x)
            masks.append(mask)
        return feats, masks


class FPN1D(nn.Module):
    """Feature-pyramid neck: lateral 1x1 convs, a top-down pathway of
    nearest upsampling by ``scale_factor`` (cut to the finer level's length),
    then depthwise 3-tap convs and channel LN per level."""

    def __init__(self, num_levels: int, in_channel: int, out_channel: int,
                 scale_factor: int = 2, with_ln: bool = True):
        super().__init__()
        self.num_levels, self.scale_factor, self.with_ln = num_levels, scale_factor, with_ln
        for i in range(num_levels):
            setattr(self, f"lateral_{i}", MaskedConv1D(in_channel, out_channel, 1,
                                                       use_bias=not with_ln))
            setattr(self, f"fpn_conv_{i}", MaskedConv1D(out_channel, out_channel, 3,
                                                        groups=out_channel,
                                                        use_bias=not with_ln))
            if with_ln:
                setattr(self, f"fpn_norm_{i}", ChannelLayerNorm(out_channel))

    def forward(self, feats, masks):
        laterals = [getattr(self, f"lateral_{i}")(feats[i], masks[i])[0]
                    for i in range(self.num_levels)]
        for i in range(self.num_levels - 1, 0, -1):
            up = laterals[i].repeat_interleave(self.scale_factor, dim=1)
            laterals[i - 1] = laterals[i - 1] + up[:, : laterals[i - 1].shape[1]]
        out_feats, out_masks = [], []
        for i in range(self.num_levels):
            x, m = getattr(self, f"fpn_conv_{i}")(laterals[i], masks[i])
            out_feats.append(getattr(self, f"fpn_norm_{i}")(x) if self.with_ln else x)
            out_masks.append(m)
        return out_feats, out_masks


class FPNIdentity(nn.Module):
    """Per-level channel LN."""

    def __init__(self, num_levels: int, dim: int, with_ln: bool = True):
        super().__init__()
        self.num_levels, self.with_ln = num_levels, with_ln
        if with_ln:
            for i in range(num_levels):
                setattr(self, f"fpn_norm_{i}", ChannelLayerNorm(dim))

    def forward(self, feats, masks):
        if self.with_ln:
            feats = [getattr(self, f"fpn_norm_{i}")(f) for i, f in enumerate(feats)]
        return feats, masks


def generate_points(max_seq_len: int, fpn_strides: Sequence[int],
                    regression_range: Sequence[Sequence[float]]) -> List[np.ndarray]:
    """Per-level point buffers (t, reg_min, reg_max, stride)."""
    out = []
    for stride, rng_l in zip(fpn_strides, regression_range):
        ts = np.arange(0, max_seq_len, stride, dtype=np.float32)
        out.append(np.stack([ts, np.full_like(ts, rng_l[0]), np.full_like(ts, rng_l[1]),
                             np.full_like(ts, float(stride))], axis=1))
    return out


class ConvHead(nn.Module):
    """Shared per-level conv tower -> per-point outputs (``out_dim`` classes or
    2 offsets); ``final_bias_init`` (the class prior) is added to the output."""

    def __init__(self, in_dim: int, feat_dim: int, out_dim: int, num_layers: int = 3,
                 kernel_size: int = 3, with_ln: bool = True, final_bias_init: float = 0.0):
        super().__init__()
        self.n_hidden, self.with_ln = num_layers - 1, with_ln
        self.final_bias_init = final_bias_init
        for i in range(self.n_hidden):
            setattr(self, f"head_{i}", MaskedConv1D(in_dim if i == 0 else feat_dim, feat_dim,
                                                    kernel_size, use_bias=not with_ln))
            if with_ln:
                setattr(self, f"norm_{i}", ChannelLayerNorm(feat_dim))
        self.final = MaskedConv1D(feat_dim if self.n_hidden else in_dim, out_dim, kernel_size)

    def forward(self, feats, masks) -> List[torch.Tensor]:
        outs = []
        for cur, m in zip(feats, masks):
            for i in range(self.n_hidden):
                cur, _ = getattr(self, f"head_{i}")(cur, m)
                cur = torch.relu(getattr(self, f"norm_{i}")(cur) if self.with_ln else cur)
            cur, _ = self.final(cur, m)
            if self.final_bias_init != 0.0:
                cur = cur + self.final_bias_init
            outs.append(cur)
        return outs


class Scale(nn.Module):
    """Learnable scalar multiplier.  JAX promotes ``bf16 * f32[()]`` to f32;
    torch would keep bf16 (a 0-dim tensor does not lift the result), so the
    input is upcast explicitly."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.init_value = float(init_value)
        self.weight = nn.Parameter(torch.tensor(self.init_value))

    def forward(self, x):
        return x.to(torch.promote_types(x.dtype, self.weight.dtype)) * self.weight
