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

The LSTM runs in its input's dtype, as the JAX scan does: under the bf16
policy its rank-2 weights arrive in bf16 and its biases in f32
(``ops/precision.py``), and the JAX layer adds both biases to the input
projection in f32 and rounds the sum once to the input's type before the
scan, whose state stays in that type.  Here the two biases of a gate are
summed in f32 and rounded once into one bias in the input's type (the
other zero), and torch's LSTM runs on weights and biases of that type.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import _VF, nn
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence


class LSTM(nn.LSTM):
    """(Stacked, optionally bidirectional) batch-first LSTM; ``forward``
    returns the outputs only, (B, T, H or 2H)."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1,
                 bidirectional: bool = True):
        super().__init__(input_dim, hidden_dim, num_layers, batch_first=True,
                         bidirectional=bidirectional)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        weights = self._flat_weights
        if any(w.dtype != x.dtype for w in weights):
            weights = self._in_dtype(x.dtype)
        dirs = 2 if self.bidirectional else 1
        if lengths is None:
            h0 = x.new_zeros(self.num_layers * dirs, x.shape[0], self.hidden_size)
            return _VF.lstm(x, (h0, h0), weights, True, self.num_layers, 0.0, self.training,
                            self.bidirectional, True)[0]
        packed = pack_padded_sequence(x, lengths.to("cpu", torch.int64), batch_first=True,
                                      enforce_sorted=False)
        h0 = x.new_zeros(self.num_layers * dirs, int(packed.batch_sizes[0]), self.hidden_size)
        data = _VF.lstm(packed.data, packed.batch_sizes, (h0, h0), weights, True,
                        self.num_layers, 0.0, self.training, self.bidirectional)[0]
        out = PackedSequence(data, packed.batch_sizes, packed.sorted_indices,
                             packed.unsorted_indices)
        return pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])[0]

    def _in_dtype(self, dtype: torch.dtype):
        """The flat weights in ``dtype`` (differentiably): each weight cast,
        each gate's two biases summed in f32 into ``bias_ih`` and rounded
        once, ``bias_hh`` zero."""
        params = dict(zip(self._flat_weights_names, self._flat_weights))
        out = []
        for name, p in params.items():
            if name.startswith("bias_ih"):
                hh = params[name.replace("bias_ih", "bias_hh")]
                out.append((p.float() + hh.float()).to(dtype))
            elif name.startswith("bias_hh"):
                out.append(torch.zeros_like(p, dtype=dtype))
            else:
                out.append(p.to(dtype))
        return out


def masked_mean(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean of (B, T, D) over each sample's first ``lengths`` steps."""
    mask = (torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]).to(x.dtype)
    return (x * mask[..., None]).sum(dim=1) / lengths.clamp(min=1)[:, None].to(x.dtype)
