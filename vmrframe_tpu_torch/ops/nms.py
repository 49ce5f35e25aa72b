"""Segment voting (counterpart of ``vmrframe_tpu/ops/nms.py::seg_voting``).

The fast top-1 path of ``models/actionformer.py::actionformer_infer`` needs
only voting; the (soft-)NMS scan of the full protocol
(``nms_1d``/``actionformer_infer_full``) is not ported yet.
"""

from __future__ import annotations

import torch


def seg_voting(nms_segs: torch.Tensor, all_segs: torch.Tensor, all_scores: torch.Tensor,
               iou_threshold: float, score_offset: float = 1.5) -> torch.Tensor:
    """Box voting: each kept segment becomes the score-and-IoU weighted mean
    of its >= threshold neighbours among ALL candidates.

    As in the JAX package (and the code it follows), ``score_offset`` is dead:
    the weights use the raw scores.  Rows with no neighbour are returned
    unchanged.  nms_segs (..., K, 2); all_segs (..., N, 2); all_scores (..., N).
    """
    del score_offset
    left = torch.maximum(nms_segs[..., :, None, 0], all_segs[..., None, :, 0])
    right = torch.minimum(nms_segs[..., :, None, 1], all_segs[..., None, :, 1])
    inter = (right - left).clamp_min(0.0)
    lens = (nms_segs[..., 1] - nms_segs[..., 0])[..., :, None] \
        + (all_segs[..., 1] - all_segs[..., 0])[..., None, :]
    iou = inter / (lens - inter).clamp_min(1e-12)
    weights = (iou >= iou_threshold).to(all_scores.dtype) * all_scores[..., None, :] * iou
    denom = weights.sum(dim=-1, keepdim=True)
    refined = (weights @ all_segs) / denom.clamp_min(1e-12)
    return torch.where(denom > 0, refined, nms_segs)


# seg_voting broadcasts over leading dims, so the batched form (JAX's vmap)
# is the same function
batched_seg_voting = seg_voting
