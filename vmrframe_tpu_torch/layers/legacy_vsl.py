"""VSLNet's legacy predictor layers (counterpart of
``vmrframe_tpu/layers/legacy_vsl.py``; the reference's ``models/layers.py``).

The reference keeps ``HighLightLayer``, ``DynamicRNN`` and
``ConditionedPredictor`` from its VSLNet ancestry, called only from
commented-out model code; no registered model uses them.  They are the
building blocks of a VSLNet-style variant.  Their parameters carry the
flax tree's names (``conv1d``, ``lstm``, ``start_encoder``,
``start_block_hidden``, ...), so ``weights.from_jax_params`` carries a JAX
tree across by its rules.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vmrframe_tpu_torch.layers.basic import Conv1D, FeatureEncoder, LayerNorm
from vmrframe_tpu_torch.layers.recurrent import LSTM
from vmrframe_tpu_torch.ops.masking import mask_logits


class HighLightLayer(nn.Module):
    """A per-frame sigmoid highlighting score and its weighted BCE loss."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1d = Conv1D(dim, 1)

    def forward(self, x, mask):
        return torch.sigmoid(mask_logits(self.conv1d(x).squeeze(-1), mask))

    @staticmethod
    def compute_loss(scores, labels, mask, epsilon: float = 1e-12):
        labels = labels.float()
        weights = torch.where(labels == 0.0, labels + 1.0, 2.0 * labels)
        s = scores.clamp(1e-7, 1 - 1e-7)
        per = -(labels * torch.log(s) + (1 - labels) * torch.log(1 - s))
        per = per * weights * mask.float()
        return per.sum() / (mask.sum() + epsilon)


class DynamicRNN(nn.Module):
    """A one-layer unidirectional LSTM over all T steps, outputs masked."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.lstm = LSTM(in_dim, dim, num_layers=1, bidirectional=False)

    def forward(self, x, mask):
        return self.lstm(x, None) * mask[..., None]


class ConditionedPredictor(nn.Module):
    """VSLNet's start/end predictor: two stacked RNNs (``predictor="rnn"``)
    or one shared feature encoder applied twice with a LayerNorm after each,
    then [features | input] -> hidden -> one logit a frame, masked.  The
    input is (B, T, dim)."""

    def __init__(self, dim: int, max_pos_len: int, num_heads: int = 4, droprate: float = 0.0,
                 predictor: str = "rnn"):
        super().__init__()
        self.predictor = predictor
        if predictor == "rnn":
            self.start_encoder = DynamicRNN(dim, dim)
            self.end_encoder = DynamicRNN(dim, dim)
        else:
            self.encoder = FeatureEncoder(dim, max_pos_len, droprate=droprate)
            self.start_layer_norm = LayerNorm(dim)
            self.end_layer_norm = LayerNorm(dim)
        for name in ("start_block", "end_block"):
            setattr(self, f"{name}_hidden", Conv1D(2 * dim, dim))
            setattr(self, f"{name}_out", Conv1D(dim, 1))

    def _block(self, name: str, feat, x):
        h = torch.relu(getattr(self, f"{name}_hidden")(torch.cat([feat, x], dim=2)))
        return getattr(self, f"{name}_out")(h).squeeze(-1)

    def forward(self, x, mask, generator: Optional[torch.Generator] = None):
        if self.predictor == "rnn":
            start = self.start_encoder(x, mask)
            end = self.end_encoder(start, mask)
        else:
            start = self.encoder(x, generator)
            end = self.encoder(start, generator)
            start, end = self.start_layer_norm(start), self.end_layer_norm(end)
        return (mask_logits(self._block("start_block", start, x), mask),
                mask_logits(self._block("end_block", end, x), mask))
