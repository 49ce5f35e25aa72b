"""Attention blocks (counterpart of ``vmrframe_tpu/layers/attention.py``):
SeqPAN's dual self/cross attention and QANet's CQAttention, with their
softmax-attention cores in the CUDA kernels of ``kernels/attention.py``.

As in the JAX package, ``BiLinear`` applies its one ``dense_1`` to both
inputs, and the unused sub-layers of the reference are not created.

Routes, as the JAX package takes them: in eval mode, or at droprate 0, the
attention cores are the kernels' autograd Functions (the kernel forward, a
recomputed backward).  In train mode at a droprate above 0 the JAX package
drops the attention probabilities (``head_attention``), which no kernel
does, and CQAttention computes its scores from dropped inputs and its
products from the undropped ones, which #3's one (c, q) pair cannot: there
the cores are plain torch.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vmrframe_tpu_torch.kernels.attention import (attention_takes, cq_attention, cq_takes,
                                                  dual_attention, masked_attention)
from vmrframe_tpu_torch.layers.basic import Conv1D, LayerNorm, fused_linear
from vmrframe_tpu_torch.layers.dropout import Dropout
from vmrframe_tpu_torch.ops.masking import MASK_VALUE, attention_mask_2d, mask_logits


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, D) -> (B, H, L, hd) as a view (no copy)."""
    return x.unflatten(-1, (num_heads, x.shape[-1] // num_heads)).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, hd) -> (B, L, H * hd); free when x is (B, L, H, hd) in memory,
    as the kernels write it."""
    B, H, L, hd = x.shape
    return x.transpose(1, 2).reshape(B, L, H * hd)


def head_attention(q, k, v, mask_add, scale: float, num_heads: int, drop: Dropout, generator):
    """Multi-head attention over (B, L, D) q and (B, M, D) k, v with the
    probabilities dropped (the JAX package's ``head_attention``): mask_add is
    an additive (B, L or 1, M) mask shared by the heads."""
    s = split_heads(q, num_heads) @ split_heads(k, num_heads).transpose(-1, -2) * scale
    if mask_add is not None:
        s = s + mask_add[:, None]
    p = drop(torch.softmax(s, dim=-1), generator)
    return merge_heads(p @ split_heads(v, num_heads))


def kernel_route(module: nn.Module, droprate: float, takes: bool) -> bool:
    """The kernels' Functions serve eval mode and droprate 0, at shapes the
    kernel takes (``takes``: its limit function, read before any launch);
    elsewhere the plain torch route runs, on the card too."""
    return (not module.training or droprate == 0.0) and takes


class BiLinear(nn.Module):
    """The reference's BiLinear: W(x1) + W(x2) + bias_value with one shared
    ``dense_1``.  Holds the parameters; ``DualMultiAttention`` applies the
    pair of them as one matmul."""

    def __init__(self, dim: int):
        super().__init__()
        self.dense_1 = Conv1D(dim, dim)
        self.bias_value = nn.Parameter(torch.zeros(dim))

    def folded(self):
        """(W, b) with W(x1) + W(x2) + bias_value = W(x1 + x2) + b."""
        return self.dense_1.weight, 2.0 * self.dense_1.bias + self.bias_value


def _composite(dense: Conv1D, gate: Conv1D):
    """gate(dense(h)) as one (W, b): nothing lies between the two in the
    reference, so W = Wg Wd and b = Wg bd + bg."""
    w = gate.weight @ dense.weight
    b = gate.weight.float() @ dense.bias.float() + gate.bias
    return w, b


class DualMultiAttention(nn.Module):
    """One shared query attends over its own sequence (f_key/f_value) and
    over the other modality (t_key/t_value); the two outputs cross-gate each
    other, then two BiLinears gate the result against the block input.  In
    train mode at a droprate above 0 the probabilities are dropped."""

    def __init__(self, dim: int, num_heads: int, droprate: float = 0.0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        for name in ("query", "f_key", "f_value", "t_key", "t_value",
                     "s_dense", "x_dense", "s_gate", "x_gate", "guided_dense"):
            setattr(self, name, Conv1D(dim, dim))
        self.bilinear_1 = BiLinear(dim)
        self.bilinear_2 = BiLinear(dim)
        self.dropout = Dropout(droprate)

    def forward(self, from_tensor, to_tensor, from_mask, to_mask, generator=None):
        H = self.num_heads
        pair = lambda m: (m.weight, m.bias)  # noqa: E731
        q, f_k, f_v = fused_linear(from_tensor, [pair(self.query), pair(self.f_key),
                                                 pair(self.f_value)])
        t_k, t_v = fused_linear(to_tensor, [pair(self.t_key), pair(self.t_value)])
        s_mask, x_mask = attention_mask_2d(from_mask, from_mask), attention_mask_2d(from_mask,
                                                                                    to_mask)
        L, M, hd = from_tensor.shape[1], to_tensor.shape[1], q.shape[-1] // self.num_heads
        if kernel_route(self, self.dropout.rate, attention_takes(q.dtype, L, (L, M), hd)):
            s_val, x_val = dual_attention(
                split_heads(q, H), split_heads(f_k, H), split_heads(f_v, H),
                split_heads(t_k, H), split_heads(t_v, H), s_mask, x_mask)
            s_val, x_val = merge_heads(s_val), merge_heads(x_val)
        else:
            scale = 1.0 / math.sqrt(self.dim // H)
            s_val = head_attention(q, f_k, f_v, (1.0 - s_mask) * MASK_VALUE, scale, H,
                                   self.dropout, generator)
            x_val = head_attention(q, t_k, t_v, (1.0 - x_mask) * MASK_VALUE, scale, H,
                                   self.dropout, generator)
        s_value, s_score = fused_linear(s_val, [
            pair(self.s_dense), _composite(self.s_dense, self.s_gate)])
        x_value, x_score = fused_linear(x_val, [
            pair(self.x_dense), _composite(self.x_dense, self.x_gate)])
        outputs = self.guided_dense(s_score * x_value + x_score * s_value)
        # both bilinears read the same (from_tensor + outputs): one matmul
        scores, values = fused_linear(from_tensor + outputs,
                                      [self.bilinear_1.folded(), self.bilinear_2.folded()])
        return torch.sigmoid(mask_logits(scores, from_mask[:, :, None])) * values


class DualAttentionBlock(nn.Module):
    """LN -> DualMultiAttention -> dense + residual -> FFN + residual, with
    dropout after the first LN, each dense and the second LN."""

    def __init__(self, dim: int, num_heads: int, droprate: float = 0.0):
        super().__init__()
        self.layer_norm_1 = LayerNorm(dim)
        self.layer_norm_t = LayerNorm(dim)
        self.dual_multihead_attention = DualMultiAttention(dim, num_heads, droprate)
        self.dense_1 = Conv1D(dim, dim)
        self.layer_norm_2 = LayerNorm(dim)
        self.dense_2 = Conv1D(dim, dim)
        self.dropout = Dropout(droprate)

    def forward(self, from_tensor, to_tensor, from_mask, to_mask, generator=None):
        drop = lambda t: self.dropout(t, generator)  # noqa: E731
        outputs = self.dual_multihead_attention(
            drop(self.layer_norm_1(from_tensor)), self.layer_norm_t(to_tensor), from_mask,
            to_mask, generator)
        residual = drop(self.dense_1(outputs)) + from_tensor
        return drop(self.dense_2(drop(self.layer_norm_2(residual)))) + residual

    def stacks(self):
        """The block's own parameters as the stacks the whole-stack kernel
        reads (``kernels/dual_stack.py``; counterpart of the JAX package's
        ``DualAttentionBlockParams``): ``W (14, D, D)``, ``b (14, D)``,
        ``ln (6, D)``, ``xb (2, D)``, in the JAX order: query, f_key,
        f_value, t_key, t_value, s_dense, x_dense, s_gate, x_gate,
        guided_dense, bilinear_1, bilinear_2, dense_1, dense_2; LN1, LNt, LN2
        scale then bias; the two BiLinear extra biases.  Each matrix of ``W``
        is (in, out), flax's kernel layout: the transpose of torch's
        ``Conv1D.weight`` (out, in).  Under the bf16 policy ``W`` is bf16 and
        the rest f32."""
        dma = self.dual_multihead_attention
        dense = [getattr(dma, name) for name in (
            "query", "f_key", "f_value", "t_key", "t_value", "s_dense", "x_dense", "s_gate",
            "x_gate", "guided_dense")]
        dense += [dma.bilinear_1.dense_1, dma.bilinear_2.dense_1, self.dense_1, self.dense_2]
        norms = (self.layer_norm_1, self.layer_norm_t, self.layer_norm_2)
        return {"W": torch.stack([m.weight.T for m in dense]),
                "b": torch.stack([m.bias for m in dense]),
                "ln": torch.stack([t for n in norms for t in (n.weight, n.bias)]),
                "xb": torch.stack([dma.bilinear_1.bias_value, dma.bilinear_2.bias_value])}


class MultiHeadAttentionBlock(nn.Module):
    """Pre-LN multi-head self-attention with a dense tail: LN -> q, k, v ->
    masked attention (kernel ``fused_masked_attention``) + residual -> LN ->
    dense + residual, with dropout after each LN, on the probabilities, and
    after the attention and the dense."""

    def __init__(self, dim: int, num_heads: int, droprate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.layer_norm1 = LayerNorm(dim)
        self.query = Conv1D(dim, dim)
        self.key = Conv1D(dim, dim)
        self.value = Conv1D(dim, dim)
        self.layer_norm2 = LayerNorm(dim)
        self.out_layer = Conv1D(dim, dim)
        self.dropout = Dropout(droprate)

    def forward(self, x, mask=None, generator=None):
        H = self.num_heads
        drop = lambda t: self.dropout(t, generator)  # noqa: E731
        q, k, v = fused_linear(drop(self.layer_norm1(x)), [(m.weight, m.bias) for m in
                                                           (self.query, self.key, self.value)])
        B, L, D = x.shape
        keys = x.new_ones(B, L) if mask is None else mask
        if kernel_route(self, self.dropout.rate, attention_takes(q.dtype, L, (L,), D // H)):
            # the mask is on keys only: every query row attends
            out = merge_heads(masked_attention(split_heads(q, H), split_heads(k, H),
                                               split_heads(v, H), keys[:, None, :].expand(B, L, L)))
        else:
            mask_add = None if mask is None else (1.0 - mask[:, None, :].to(q.dtype)) * MASK_VALUE
            out = head_attention(q, k, v, mask_add, 1.0 / math.sqrt(D // H), H, self.dropout,
                                 generator)
        residual = drop(out) + x
        return drop(self.out_layer(drop(self.layer_norm2(residual)))) + residual


class CQAttention(nn.Module):
    """QANet context-query attention: [c, c2q, c*c2q, c*q2c] -> Conv1D.  In
    train mode at a droprate above 0 the trilinear scores read dropped copies
    of the context and the query, while c2q, q2c and the concatenation read
    the undropped ones, as in the JAX package."""

    def __init__(self, dim: int, droprate: float = 0.0):
        super().__init__()
        self.w4C = nn.Parameter(torch.empty(dim, 1))
        self.w4Q = nn.Parameter(torch.empty(dim, 1))
        self.w4mlu = nn.Parameter(torch.empty(1, 1, dim))
        self.cqa_linear = Conv1D(4 * dim, dim)
        self.dropout = Dropout(droprate)

    def forward(self, context, query, c_mask, q_mask, generator=None):
        takes = cq_takes(context.shape[1], query.shape[1], context.shape[2], context.dtype)
        if kernel_route(self, self.dropout.rate, takes):
            c2q, q2c = cq_attention(context, query, self.w4C, self.w4Q, self.w4mlu, c_mask,
                                    q_mask)
        else:
            ctx, qry = self.dropout(context, generator), self.dropout(query, generator)
            score = ctx @ self.w4C + (qry @ self.w4Q).transpose(1, 2) \
                + (ctx * self.w4mlu) @ qry.transpose(1, 2)
            score_ = torch.softmax(mask_logits(score, q_mask[:, None, :]), dim=2)
            score_t = torch.softmax(mask_logits(score, c_mask[:, :, None]), dim=1).transpose(1, 2)
            c2q = score_ @ query
            q2c = (score_ @ score_t) @ context
        return self.cqa_linear(torch.cat([context, c2q, context * c2q, context * q2c], dim=2))


class WeightedPool(nn.Module):
    """Learned attention pooling of (B, L, D) to (B, D)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1))

    def forward(self, x, mask):
        alpha = mask_logits(x @ self.weight, mask[:, :, None])  # (B, L, 1)
        alphas = torch.softmax(alpha, dim=1)
        return torch.einsum("bld,blo->bd", x, alphas)


class CQConcatenate(nn.Module):
    """Pooled query broadcast over the context, concatenated, Conv1D."""

    def __init__(self, dim: int):
        super().__init__()
        self.weighted_pool = WeightedPool(dim)
        self.conv1d = Conv1D(2 * dim, dim)

    def forward(self, context, query, q_mask):
        pooled = self.weighted_pool(query, q_mask)[:, None, :].expand_as(context)
        return self.conv1d(torch.cat([context, pooled], dim=2))

