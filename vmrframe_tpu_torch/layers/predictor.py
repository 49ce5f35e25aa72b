"""SeqPAN predictor head (counterpart of ``vmrframe_tpu/layers/predictor.py``).

``TopSelfAttention`` is per-sample masked self-attention with an output
projection, as in the JAX package (the reference's version attends across
the batch by a layout slip).  Its core is the ``fused_masked_attention``
CUDA kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from vmrframe_tpu_torch.kernels.attention import fused_masked_attention
from vmrframe_tpu_torch.layers.attention import merge_heads, split_heads
from vmrframe_tpu_torch.layers.basic import (Conv1D, DepthwiseSeparableConvBlock, LayerNorm,
                                             PositionalEmbedding, fused_linear)
from vmrframe_tpu_torch.ops.masking import attention_mask_2d


class TopSelfAttention(nn.Module):
    """Masked multi-head self-attention with output projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Conv1D(dim, dim)
        self.key = Conv1D(dim, dim)
        self.value = Conv1D(dim, dim)
        self.out_proj = Conv1D(dim, dim)

    def forward(self, x, mask):
        H = self.num_heads
        q, k, v = fused_linear(x, [(m.weight, m.bias) for m in (self.query, self.key, self.value)])
        out = fused_masked_attention(split_heads(q, H), split_heads(k, H), split_heads(v, H),
                                     attention_mask_2d(mask, mask))
        return self.out_proj(merge_heads(out))


class FeatureEncoderPredict(nn.Module):
    """pos-emb + conv block + self-attention + FFN."""

    def __init__(self, dim: int, num_heads: int, max_pos_len: int):
        super().__init__()
        self.pos_embedding = PositionalEmbedding(max_pos_len, dim)
        self.conv_block = DepthwiseSeparableConvBlock(dim, 7, 4)
        self.layer_norm_1 = LayerNorm(dim)
        self.top_self_attention = TopSelfAttention(dim, num_heads)
        self.layer_norm_2 = LayerNorm(dim)
        self.dense = Conv1D(dim, dim)

    def forward(self, x, mask):
        features = self.conv_block(x + self.pos_embedding(x))
        residual = self.top_self_attention(self.layer_norm_1(features), mask) + features
        return self.dense(self.layer_norm_2(residual)) + residual


class SeqPANPredictor(nn.Module):
    """The shared encoder applied twice (start, then end), LN,
    [feat ‖ input] -> hidden -> one logit per position."""

    def __init__(self, dim: int, max_pos_len: int, num_heads: int = 4):
        super().__init__()
        self.feature_encoder = FeatureEncoderPredict(dim, num_heads, max_pos_len)
        self.start_layer_norm = LayerNorm(dim)
        self.end_layer_norm = LayerNorm(dim)
        self.start_hidden = Conv1D(2 * dim, dim)
        self.end_hidden = Conv1D(2 * dim, dim)
        self.start_dense = Conv1D(dim, 1)
        self.end_dense = Conv1D(dim, 1)

    def forward(self, x, mask):
        start_feat = self.feature_encoder(x, mask)
        end_feat = self.feature_encoder(start_feat, mask)
        start_feat = self.start_hidden(torch.cat([self.start_layer_norm(start_feat), x], dim=-1))
        end_feat = self.end_hidden(torch.cat([self.end_layer_norm(end_feat), x], dim=-1))
        return self.start_dense(start_feat).squeeze(-1), self.end_dense(end_feat).squeeze(-1)
