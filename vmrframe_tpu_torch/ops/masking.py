"""Masking primitives: additive -1e30 masking, as the JAX package does.

A fully masked row of logits becomes a row of equal values (-1e30 swallows
every logit in f32), so its softmax is the uniform average: the port keeps
that, and never uses ``-inf``.
"""

from __future__ import annotations

import torch

MASK_VALUE = -1e30


def mask_logits(inputs: torch.Tensor, mask: torch.Tensor, mask_value: float = MASK_VALUE) -> torch.Tensor:
    """Additive masking: logits + mask_value * (1 - mask)."""
    return inputs + mask_value * (1.0 - mask.to(inputs.dtype))


def length_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) float {0,1} mask."""
    return (torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]).float()


def attention_mask_2d(from_mask: torch.Tensor, to_mask: torch.Tensor) -> torch.Tensor:
    """Outer product of (B, Lf) and (B, Lt) masks -> (B, Lf, Lt)."""
    return from_mask[:, :, None] * to_mask[:, None, :]
