"""Mixed-precision cast policy (counterpart of ``vmrframe_tpu/ops/precision.py``).

Under a bfloat16 compute policy the matmul/conv operands (activations and
rank >= 2 weights) are cast down; rank <= 1 floating tensors (biases,
LayerNorm scales, per-sample weights) stay f32.  ``biased`` adds an f32
bias in f32 and casts the result back, so f32 vectors never promote the
activations that the next matmul reads.

The JAX trainer casts its f32 params on every step; a serving process has
no f32 master copy to keep, so the port casts a module once, in place.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if t.is_floating_point() and t.dim() >= 2:
        return t.to(dtype)
    return t


@torch.no_grad()
def cast_module_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the module's rank >= 2 floating params and buffers to ``dtype``."""
    for sub in module.modules():
        for p in sub.parameters(recurse=False):
            p.data = _cast(p.data, dtype)
        for name, b in sub.named_buffers(recurse=False):
            setattr(sub, name, _cast(b, dtype))
    return module


def cast_batch(batch: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The same policy over a batch: ids and rank <= 1 vectors pass through."""
    if dtype == torch.float32:
        return batch
    return {k: _cast(v, dtype) for k, v in batch.items()}


def biased(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``y + bias`` in the wider dtype, result cast back to ``y.dtype``."""
    return (y + bias).to(y.dtype)
