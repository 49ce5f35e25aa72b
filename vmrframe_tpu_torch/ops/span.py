"""Span inference (counterpart of ``vmrframe_tpu/ops/span.py``).

``infer_span_1d``: masked softmax of start/end logits, outer product
restricted to s <= e, row/column argmax, then fractions of the number of
VALID frames.  ``infer_span_2d``: the same row/column argmax over a 2D
proposal map's sigmoid scores times its validity mask (CCA).  Both
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
    return triu_argmax_spans(start_prob[:, :, None] * end_prob[:, None, :], vmask.sum(dim=1))


def triu_argmax_spans(outer: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """(B, 2) fractions: over (B, L, L) ``outer`` restricted to s <= e (zero
    below the diagonal), the argmax of the row maxima (start) and of the
    column maxima (end), each over ``denom`` (B,), the valid length."""
    outer = torch.triu(outer)
    start_idx = torch.argmax(outer.amax(dim=2), dim=1)
    end_idx = torch.argmax(outer.amax(dim=1), dim=1)
    denom = denom.float()
    return torch.stack([start_idx.float() / denom, end_idx.float() / denom], dim=1)


def infer_span_2d(scores2d: torch.Tensor, mask2d: torch.Tensor,
                  vmask: torch.Tensor) -> torch.Tensor:
    """(B, L, L) proposal scores + (L, L) validity mask -> (B, 2) fractions."""
    return triu_argmax_spans(torch.sigmoid(scores2d) * mask2d.to(scores2d.dtype),
                             vmask.sum(dim=1))
