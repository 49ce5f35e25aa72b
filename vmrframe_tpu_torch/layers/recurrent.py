"""LSTM layers (counterpart of ``vmrframe_tpu/layers/recurrent.py``).

The JAX package scans a masked LSTM to reproduce torch's packed-sequence
semantics with static shapes; here torch's own ``nn.LSTM`` over a packed
sequence gives them directly:

- with ``lengths``: steps past a sample's length give zero outputs and do
  not advance its state, and the reverse direction runs reversed within
  each sample's length (``pack_padded_sequence(enforce_sorted=False)``, the
  outputs padded back to the input's T);
- ``lengths=None``: the plain LSTM over all T steps (BAN's
  ``TemporalDifference`` runs its LSTMs over the padded sequence).

The parameters are ``nn.LSTM``'s (``weight_ih_l{k}`` (4H, D),
``weight_hh_l{k}`` (4H, H), ``bias_ih_l{k}``, ``bias_hh_l{k}``, and
``_reverse``; gates in the order i, f, g, o), which are the flax leaves
``w_ih_l{k}``, ``w_hh_l{k}``, ``b_ih_l{k}``, ``b_hh_l{k}`` renamed
(``weights.py``).  On the card cuDNN runs the recurrence.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class LSTM(nn.LSTM):
    """(Stacked, optionally bidirectional) batch-first LSTM; ``forward``
    returns the outputs only, (B, T, H or 2H)."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1,
                 bidirectional: bool = True):
        super().__init__(input_dim, hidden_dim, num_layers, batch_first=True,
                         bidirectional=bidirectional)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lengths is None:
            return super().forward(x)[0]
        packed = pack_padded_sequence(x, lengths.to("cpu", torch.int64), batch_first=True,
                                      enforce_sorted=False)
        out, _ = super().forward(packed)
        return pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])[0]


def masked_mean(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean of (B, T, D) over each sample's first ``lengths`` steps."""
    mask = (torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]).to(x.dtype)
    return (x * mask[..., None]).sum(dim=1) / lengths.clamp(min=1)[:, None].to(x.dtype)
