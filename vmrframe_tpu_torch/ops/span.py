"""Span inference (counterpart of ``vmrframe_tpu/ops/span.py::infer_span_1d``).

Masked softmax of start/end logits, outer product restricted to s <= e,
row/column argmax, then fractions of the number of VALID frames.  Both
frameworks' argmax return the first maximum, so ties resolve alike.
"""

from __future__ import annotations

import torch

from vmrframe_tpu_torch.ops.masking import mask_logits


def infer_span_1d(start_logits: torch.Tensor, end_logits: torch.Tensor,
                  vmask: torch.Tensor) -> torch.Tensor:
    """(B, L) start/end logits + (B, L) mask -> (B, 2) fractional spans."""
    start_prob = torch.softmax(mask_logits(start_logits, vmask), dim=1)
    end_prob = torch.softmax(mask_logits(end_logits, vmask), dim=1)
    outer = torch.triu(start_prob[:, :, None] * end_prob[:, None, :])
    start_idx = torch.argmax(outer.amax(dim=2), dim=1)
    end_idx = torch.argmax(outer.amax(dim=1), dim=1)
    denom = vmask.sum(dim=1)
    return torch.stack([start_idx.float() / denom, end_idx.float() / denom], dim=1)
