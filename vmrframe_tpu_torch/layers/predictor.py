"""SeqPAN predictor head (counterpart of ``vmrframe_tpu/layers/predictor.py``).

``TopSelfAttention`` is per-sample masked self-attention with an output
projection, as in the JAX package (the reference's version attends across
the batch by a layout slip).  Its core is the ``fused_masked_attention``
CUDA kernel in eval mode and at droprate 0; in train mode at a droprate
above 0 it drops the probabilities (``layers/attention.py::head_attention``),
as the JAX package does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vmrframe_tpu_torch.kernels.attention import attention_takes, masked_attention
from vmrframe_tpu_torch.layers.attention import (head_attention, kernel_route, merge_heads,
                                                 split_heads)
from vmrframe_tpu_torch.layers.basic import (Conv1D, DepthwiseSeparableConvBlock, LayerNorm,
                                             PositionalEmbedding, fused_linear)
from vmrframe_tpu_torch.layers.dropout import Dropout
from vmrframe_tpu_torch.ops.masking import MASK_VALUE, attention_mask_2d


class TopSelfAttention(nn.Module):
    """Masked multi-head self-attention with output projection."""

    def __init__(self, dim: int, num_heads: int, droprate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.query = Conv1D(dim, dim)
        self.key = Conv1D(dim, dim)
        self.value = Conv1D(dim, dim)
        self.out_proj = Conv1D(dim, dim)
        self.dropout = Dropout(droprate)

    def forward(self, x, mask, generator=None):
        H = self.num_heads
        q, k, v = fused_linear(x, [(m.weight, m.bias) for m in (self.query, self.key, self.value)])
        attn_mask = attention_mask_2d(mask, mask)
        L, hd = x.shape[1], x.shape[-1] // H
        if kernel_route(self, self.dropout.rate, attention_takes(q.dtype, L, (L,), hd)):
            out = merge_heads(masked_attention(split_heads(q, H), split_heads(k, H),
                                               split_heads(v, H), attn_mask))
        else:
            out = head_attention(q, k, v, (1.0 - attn_mask) * MASK_VALUE,
                                 1.0 / math.sqrt(x.shape[-1] // H), H, self.dropout, generator)
        return self.out_proj(out)


class FeatureEncoderPredict(nn.Module):
    """pos-emb + conv block + self-attention + FFN, with dropout after each
    LN, the attention and the dense."""

    def __init__(self, dim: int, num_heads: int, max_pos_len: int, droprate: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        self.pos_embedding = PositionalEmbedding(max_pos_len, dim)
        self.conv_block = DepthwiseSeparableConvBlock(dim, 7, 4, droprate)
        self.layer_norm_1 = LayerNorm(dim)
        self.top_self_attention = TopSelfAttention(dim, num_heads, attn_drop)
        self.layer_norm_2 = LayerNorm(dim)
        self.dense = Conv1D(dim, dim)
        self.dropout = Dropout(droprate)

    def forward(self, x, mask, generator=None):
        drop = lambda t: self.dropout(t, generator)  # noqa: E731
        features = self.conv_block(x + self.pos_embedding(x), generator)
        outputs = self.top_self_attention(drop(self.layer_norm_1(features)), mask, generator)
        residual = drop(outputs) + features
        return drop(self.dense(drop(self.layer_norm_2(residual)))) + residual


class SeqPANPredictor(nn.Module):
    """The shared encoder applied twice (start, then end), LN,
    [feat ‖ input] -> hidden -> one logit per position."""

    def __init__(self, dim: int, max_pos_len: int, num_heads: int = 4, droprate: float = 0.0):
        super().__init__()
        self.feature_encoder = FeatureEncoderPredict(dim, num_heads, max_pos_len, droprate,
                                                     droprate)
        self.start_layer_norm = LayerNorm(dim)
        self.end_layer_norm = LayerNorm(dim)
        self.start_hidden = Conv1D(2 * dim, dim)
        self.end_hidden = Conv1D(2 * dim, dim)
        self.start_dense = Conv1D(dim, 1)
        self.end_dense = Conv1D(dim, 1)

    def forward(self, x, mask, generator=None):
        start_feat = self.feature_encoder(x, mask, generator)
        end_feat = self.feature_encoder(start_feat, mask, generator)
        start_feat = self.start_hidden(torch.cat([self.start_layer_norm(start_feat), x], dim=-1))
        end_feat = self.end_hidden(torch.cat([self.end_layer_norm(end_feat), x], dim=-1))
        return self.start_dense(start_feat).squeeze(-1), self.end_dense(end_feat).squeeze(-1)
