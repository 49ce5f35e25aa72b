"""Dropout (counterpart of ``vmrframe_tpu/layers/dropout.py``).

The JAX package draws one byte per element by default (``bits=8``) and
drops where the byte is below t = round(rate * 256), so the realized drop
rate is t / 256 (0.2 -> 51/256) and survivors are scaled by 256 / (256 - t),
the realized keep rate's inverse; ``bits=32`` keeps with probability
1 - rate and scales by 1 / (1 - rate), as flax's ``nn.Dropout``.  The port
matches the keep rate and the scaling, not the bits: torch's generator
cannot draw JAX's stream.  The width is ``train.dropout_bits`` (default 8),
set on a built model by ``set_dropout_bits``.

A ``Dropout`` draws from the ``torch.Generator`` passed to ``forward`` and
raises without one in train mode at a rate above 0, as flax raises without
``deterministic``.  In eval mode, or at rate 0, it is the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def dropout_bits(cfg) -> int:
    """``train.dropout_bits`` of a config, 8 when it has none."""
    train = cfg.get("train")
    return int(train.get("dropout_bits", 8)) if train is not None else 8


class Dropout(nn.Module):
    def __init__(self, rate: float, bits: int = 8):
        super().__init__()
        self.rate, self.bits = float(rate), int(bits)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("Dropout in train mode needs the step's torch.Generator")
        t = int(round(self.rate * 256.0))
        if self.bits == 8 and 0 < t < 256:
            draw = torch.randint(0, 256, x.shape, generator=generator, device=x.device,
                                 dtype=torch.uint8)
            scale = torch.tensor(256.0 / (256 - t), dtype=x.dtype).item()  # in x's type, as JAX
            return torch.where(draw >= t, x * scale, x.new_zeros(()))
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, x.new_zeros(()))


def set_dropout_bits(module: nn.Module, bits: int) -> nn.Module:
    """Sets the mask width of every ``Dropout`` in ``module``."""
    for sub in module.modules():
        if isinstance(sub, Dropout):
            sub.bits = int(bits)
    return module
