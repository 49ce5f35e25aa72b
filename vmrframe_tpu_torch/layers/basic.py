"""Basic layers (counterpart of ``vmrframe_tpu/layers/basic.py``).

Parameter names follow the flax tree (``weights.py`` maps one onto the
other): a flax ``kernel`` is a torch ``weight`` in torch's layout, a
LayerNorm ``scale`` is its ``weight``.  Eval only: dropout waits for the
training slice.  Under the bf16 policy (``ops/precision.py``) rank >= 2
weights are bf16 and biases f32; ``biased`` keeps the activations bf16.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vmrframe_tpu_torch.ops.precision import biased


class Conv1D(nn.Linear):
    """The reference's pointwise Conv1D over (B, L, D): a Linear."""

    def forward(self, x):
        y = F.linear(x, self.weight)
        return y if self.bias is None else biased(y, self.bias)


def fused_linear(x: torch.Tensor, pairs) -> Sequence[torch.Tensor]:
    """One matmul for several (weight, bias) pairs over the same input; the
    outputs are views into one (…, sum out) tensor."""
    w = torch.cat([w for w, _ in pairs], dim=0)
    b = torch.cat([b for _, b in pairs], dim=0)
    y = biased(F.linear(x, w), b)
    return y.split([w.shape[0] for w, _ in pairs], dim=-1)


class LayerNorm(nn.Module):
    """LayerNorm with eps 1e-6 inside the sqrt; statistics in f32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps).to(x.dtype)


class WordEmbedding(nn.Module):
    """[zero PAD row, trainable UNK row, frozen GloVe] lookup.  GloVe is a
    buffer, not a parameter."""

    def __init__(self, word_dim: int, word_vectors):
        super().__init__()
        self.unk_vec = nn.Parameter(torch.empty(1, word_dim))
        self.register_buffer("glove_vec", torch.tensor(np.asarray(word_vectors, np.float32)))

    def forward(self, word_ids):
        glove = self.glove_vec
        pad = torch.zeros(1, glove.shape[1], dtype=glove.dtype, device=glove.device)
        table = torch.cat([pad, self.unk_vec.to(glove.dtype), glove], dim=0)
        return F.embedding(word_ids, table)


class CharacterEmbedding(nn.Module):
    """Char table, then four VALID convs of widths 1-4 over each word's chars,
    each max-pooled over its own valid range, then ReLU.  PAD chars (id 0)
    embed to zero.  Output width 10+20+30+40 = 100."""

    def __init__(self, num_chars: int, char_dim: int, kernels=(1, 2, 3, 4),
                 channels=(10, 20, 30, 40)):
        super().__init__()
        self.kernels = tuple(kernels)
        self.out_dim = sum(channels)
        self.char_table = nn.Parameter(torch.empty(num_chars, char_dim))
        for k, ch in zip(kernels, channels):
            setattr(self, f"conv_k{k}", nn.Conv1d(char_dim, ch, k))

    def forward(self, char_ids):
        B, W, C = char_ids.shape
        flat = char_ids.reshape(B * W, C)
        emb = F.embedding(flat, self.char_table)
        emb = emb * (flat != 0).to(emb.dtype)[..., None]
        x = emb.transpose(1, 2)  # (B*W, char_dim, C)
        pooled = []
        for k in self.kernels:
            conv = getattr(self, f"conv_k{k}")
            z = biased(F.conv1d(x, conv.weight), conv.bias[:, None])
            pooled.append(z.amax(dim=2))
        return torch.relu(torch.cat(pooled, dim=1)).reshape(B, W, -1)


class Embedding(nn.Module):
    """word ‖ char -> Conv1D -> LayerNorm."""

    def __init__(self, out_dim: int, word_dim: int, char_dim: int, num_chars: int, word_vectors):
        super().__init__()
        self.word_emb = WordEmbedding(word_dim, word_vectors)
        self.char_emb = CharacterEmbedding(num_chars, char_dim)
        self.query_conv1d = Conv1D(word_dim + self.char_emb.out_dim, out_dim)
        self.q_layer_norm = LayerNorm(out_dim)

    def forward(self, word_ids, char_ids):
        emb = torch.cat([self.word_emb(word_ids), self.char_emb(char_ids)], dim=2)
        return self.q_layer_norm(self.query_conv1d(emb))


class PositionalEmbedding(nn.Module):
    """Learned absolute positions."""

    def __init__(self, num_embeddings: int, dim: int):
        super().__init__()
        self.position_embeddings = nn.Parameter(torch.empty(num_embeddings, dim))

    def forward(self, x):
        B, L, D = x.shape
        return self.position_embeddings[None, :L, :].expand(B, L, D)


class VisualProjection(nn.Module):
    """Conv1D -> LayerNorm."""

    def __init__(self, vdim: int, dim: int):
        super().__init__()
        self.video_conv1d = Conv1D(vdim, dim)
        self.v_layer_norm = LayerNorm(dim)

    def forward(self, visual_features):
        return self.v_layer_norm(self.video_conv1d(visual_features))


class DepthwiseConv1D(nn.Module):
    """Depthwise k-tap conv over (B, L, D) with SAME padding and no bias, as
    a grouped ``conv1d``; weight (D, 1, k)."""

    def __init__(self, dim: int, kernel_size: int = 7):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1, kernel_size))

    def forward(self, x):
        k = self.weight.shape[-1]
        pad_lo = (k - 1) // 2
        xt = F.pad(x.transpose(1, 2), (pad_lo, k - 1 - pad_lo))
        return F.conv1d(xt, self.weight, groups=x.shape[-1]).transpose(1, 2)


class DepthwiseSeparableConvBlock(nn.Module):
    """N x (LN -> depthwise k=7 -> pointwise -> ReLU -> residual)."""

    def __init__(self, dim: int, kernel_size: int = 7, num_layers: int = 4):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer_norm_{i}", LayerNorm(dim))
            setattr(self, f"depthwise_{i}", DepthwiseConv1D(dim, kernel_size))
            setattr(self, f"pointwise_{i}", Conv1D(dim, dim))

    def forward(self, x):
        output = x
        for i in range(self.num_layers):
            residual = output
            output = getattr(self, f"layer_norm_{i}")(output)
            output = getattr(self, f"depthwise_{i}")(output)
            output = torch.relu(getattr(self, f"pointwise_{i}")(output))
            output = output + residual
        return output


class FeatureEncoder(nn.Module):
    """Positional embedding + depthwise-separable conv block."""

    def __init__(self, dim: int, max_pos_len: int, kernel_size: int = 7, num_layers: int = 4):
        super().__init__()
        self.pos_embedding = PositionalEmbedding(max_pos_len, dim)
        self.conv_block = DepthwiseSeparableConvBlock(dim, kernel_size, num_layers)

    def forward(self, x):
        return self.conv_block(x + self.pos_embedding(x))
