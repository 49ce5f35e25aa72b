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

Under data parallelism (``parallel/mesh.py``) a process runs the forward on
its rows of the global batch.  ``draw_rows`` is the one place every random
draw of a forward goes through (the masks here, the gumbel noise,
stochastic depth): inside ``batch_rows`` a draw whose first dimension is k
times the process's row count (k = 1, or the positions of a sample-major
(B * T, ...) tensor: the char embedding's, CPL's proposals) is made at the
global batch's size and cut to the process's rows, so the stream advances
as on one process and each process gets the rows of the one-process draw.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence

import torch
from torch import nn

# (start, size, total): this process's rows of the global batch
_rows = contextvars.ContextVar("batch_rows", default=None)


@contextlib.contextmanager
def batch_rows(start: int, size: int, total: int):
    """Draws inside are of the global batch, rows [start, start + size) kept."""
    token = _rows.set((int(start), int(size), int(total)))
    try:
        yield
    finally:
        _rows.reset(token)


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)``, or inside ``batch_rows`` for a sample-major shape the
    process's rows of ``draw`` at the global batch's shape."""
    shape = tuple(shape)
    rows = _rows.get()
    if rows is None or not shape or shape[0] % rows[1] or rows[1] == rows[2]:
        return draw(shape)
    start, size, total = rows
    k = shape[0] // size
    return draw((total * k,) + shape[1:])[start * k:(start + size) * k]


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
            draw = draw_rows(lambda s: torch.randint(0, 256, s, generator=generator,
                                                     device=x.device, dtype=torch.uint8), x.shape)
            scale = torch.tensor(256.0 / (256 - t), dtype=x.dtype).item()  # in x's type, as JAX
            return torch.where(draw >= t, x * scale, x.new_zeros(()))
        keep_prob = 1.0 - self.rate
        keep = draw_rows(lambda s: torch.rand(s, generator=generator, device=x.device),
                         x.shape) < keep_prob
        return torch.where(keep, x / keep_prob, x.new_zeros(()))


def set_dropout_bits(module: nn.Module, bits: int) -> nn.Module:
    """Sets the mask width of every ``Dropout`` in ``module``."""
    for sub in module.modules():
        if isinstance(sub, Dropout):
            sub.bits = int(bits)
    return module
