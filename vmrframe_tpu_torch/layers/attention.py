"""Attention blocks (counterpart of ``vmrframe_tpu/layers/attention.py``):
SeqPAN's dual self/cross attention and QANet's CQAttention, with their
softmax-attention cores in the CUDA kernels of ``kernels/attention.py``.

As in the JAX package, ``BiLinear`` applies its one ``dense_1`` to both
inputs, and the unused sub-layers of the reference are not created.
"""

from __future__ import annotations

import torch
from torch import nn

from vmrframe_tpu_torch.kernels.attention import fused_cq_attention, fused_dual_attention
from vmrframe_tpu_torch.layers.basic import Conv1D, LayerNorm, fused_linear
from vmrframe_tpu_torch.ops.masking import attention_mask_2d, mask_logits


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, D) -> (B, H, L, hd) as a view (no copy)."""
    return x.unflatten(-1, (num_heads, x.shape[-1] // num_heads)).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, hd) -> (B, L, H * hd); free when x is (B, L, H, hd) in memory,
    as the kernels write it."""
    B, H, L, hd = x.shape
    return x.transpose(1, 2).reshape(B, L, H * hd)


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
    other, then two BiLinears gate the result against the block input."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        for name in ("query", "f_key", "f_value", "t_key", "t_value",
                     "s_dense", "x_dense", "s_gate", "x_gate", "guided_dense"):
            setattr(self, name, Conv1D(dim, dim))
        self.bilinear_1 = BiLinear(dim)
        self.bilinear_2 = BiLinear(dim)

    def forward(self, from_tensor, to_tensor, from_mask, to_mask):
        H = self.num_heads
        pair = lambda m: (m.weight, m.bias)  # noqa: E731
        q, f_k, f_v = fused_linear(from_tensor, [pair(self.query), pair(self.f_key),
                                                 pair(self.f_value)])
        t_k, t_v = fused_linear(to_tensor, [pair(self.t_key), pair(self.t_value)])
        s_val, x_val = fused_dual_attention(
            split_heads(q, H), split_heads(f_k, H), split_heads(f_v, H),
            split_heads(t_k, H), split_heads(t_v, H),
            attention_mask_2d(from_mask, from_mask), attention_mask_2d(from_mask, to_mask))
        s_value, s_score = fused_linear(merge_heads(s_val), [
            pair(self.s_dense), _composite(self.s_dense, self.s_gate)])
        x_value, x_score = fused_linear(merge_heads(x_val), [
            pair(self.x_dense), _composite(self.x_dense, self.x_gate)])
        outputs = self.guided_dense(s_score * x_value + x_score * s_value)
        # both bilinears read the same (from_tensor + outputs): one matmul
        scores, values = fused_linear(from_tensor + outputs,
                                      [self.bilinear_1.folded(), self.bilinear_2.folded()])
        return torch.sigmoid(mask_logits(scores, from_mask[:, :, None])) * values


class DualAttentionBlock(nn.Module):
    """LN -> DualMultiAttention -> dense + residual -> FFN + residual."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.layer_norm_1 = LayerNorm(dim)
        self.layer_norm_t = LayerNorm(dim)
        self.dual_multihead_attention = DualMultiAttention(dim, num_heads)
        self.dense_1 = Conv1D(dim, dim)
        self.layer_norm_2 = LayerNorm(dim)
        self.dense_2 = Conv1D(dim, dim)

    def forward(self, from_tensor, to_tensor, from_mask, to_mask):
        outputs = self.dual_multihead_attention(
            self.layer_norm_1(from_tensor), self.layer_norm_t(to_tensor), from_mask, to_mask)
        residual = self.dense_1(outputs) + from_tensor
        return self.dense_2(self.layer_norm_2(residual)) + residual


class CQAttention(nn.Module):
    """QANet context-query attention: [c, c2q, c*c2q, c*q2c] -> Conv1D."""

    def __init__(self, dim: int):
        super().__init__()
        self.w4C = nn.Parameter(torch.empty(dim, 1))
        self.w4Q = nn.Parameter(torch.empty(dim, 1))
        self.w4mlu = nn.Parameter(torch.empty(1, 1, dim))
        self.cqa_linear = Conv1D(4 * dim, dim)

    def forward(self, context, query, c_mask, q_mask):
        c2q, q2c = fused_cq_attention(context, query, self.w4C, self.w4Q, self.w4mlu,
                                      c_mask, q_mask)
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

