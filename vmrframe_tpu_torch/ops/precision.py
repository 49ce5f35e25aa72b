"""Mixed-precision cast policy (counterpart of ``vmrframe_tpu/ops/precision.py``).

Under a bfloat16 compute policy the matmul/conv operands (activations and
rank >= 2 weights) are cast down; rank <= 1 floating tensors (biases,
LayerNorm scales, per-sample weights) stay f32.  ``biased`` adds an f32
bias in f32 and casts the result back, so f32 vectors never promote the
activations that the next matmul reads.

The JAX trainer casts its f32 params on every step, and so does the port's
(``cast_params``: the f32 masters stay, and the forward reads cast copies
of them, and of the buffers such as SeqPAN's GloVe table, through
``torch.func.functional_call``, so the gradients land on the masters in
f32); a serving process has no f32 master copy to keep, so the port casts
its module once, in place (``cast_module_``).

On ActionFormer's tree the rule puts conv kernels (rank 3), dense kernels
and ``AffineDropPath``'s (1, 1, D) scale in bf16, and keeps
``ChannelLayerNorm``, the biases and ``Scale``'s rank-0 scalar in f32.
JAX promotes ``bf16 * f32[()]`` to f32 where torch keeps bf16, so ``Scale``
upcasts its input itself (``layers/actionformer.py``).

Where the JAX model adds an f32 tensor to bf16 activations (ActionFormer's
absolute position table), flax's promotion runs every layer after it in f32,
each reading its bf16 weights promoted to f32.  torch refuses a bf16 weight
against an f32 input, so such a layer runs through ``promoted_call``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.func import functional_call


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


def cast_params(module: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The module's parameters and buffers by name, rank >= 2 floating ones
    cast to ``dtype`` (the parameters differentiably), as the JAX trainer
    casts its params and constants; for ``torch.func.functional_call``."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    return {name: _cast(t, dtype) for name, t in tensors.items()}


def cast_batch(batch: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The same policy over a batch: ids and rank <= 1 vectors pass through."""
    if dtype == torch.float32:
        return batch
    return {k: _cast(v, dtype) for k, v in batch.items()}


def biased(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``y + bias`` in the wider dtype, result cast back to ``y.dtype``."""
    return (y + bias).to(y.dtype)


def promoted_call(module: nn.Module, dtype: torch.dtype, *args):
    """``module(*args)`` with its floating parameters and buffers narrower
    than ``dtype`` promoted to it (differentiably): the weights flax's
    promotion reads when a bf16 weight meets an activation of ``dtype``.
    A plain call when nothing is narrower."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    wide = {name: t.to(dtype) for name, t in tensors.items()
            if t.is_floating_point() and torch.promote_types(t.dtype, dtype) == dtype
            and t.dtype != dtype}
    if not wide:
        return module(*args)
    return functional_call(module, wide, args)
