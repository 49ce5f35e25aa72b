"""1D NMS / soft-NMS and segment voting, on the tensors' device
(counterpart of ``vmrframe_tpu/ops/nms.py``).

Greedy max-score selection with

- method 0: hard IoU suppression,
- method 1: linear decay ``s *= 1 - iou`` where iou > threshold,
- method 2: gaussian decay ``s *= exp(-iou^2 / sigma)`` (always applied),

for a fixed ``max_keep`` steps, each a few batched tensor operations over
the whole batch (the JAX package's scan, vmapped), so the eval batch stays
on its device; a pick below ``min_score`` is marked invalid.  ``seg_voting``
is the box-voting refinement of the class-agnostic path.
``vmrframe_tpu_torch/native`` holds the C++ twin, a per-video CPU loop that
stops at ``min_score``, which cross-checks these semantics.
"""

from __future__ import annotations

import torch


def _iou_1d(seg: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
    """IoU of (..., 2) segments against (..., N, 2) segments: (..., N)."""
    inter = torch.minimum(seg[..., None, 1], segs[..., 1]) \
        - torch.maximum(seg[..., None, 0], segs[..., 0])
    inter = inter.clamp_min(0.0)
    union = (seg[..., None, 1] - seg[..., None, 0]) + (segs[..., 1] - segs[..., 0]) - inter
    return inter / union.clamp_min(1e-8)


def batched_nms_1d(segs: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                   max_keep: int, min_score: float = 0.001, method: int = 2,
                   sigma: float = 0.5):
    """Greedy (soft-)NMS over each row's (N, 2) segments; ``method`` as in
    the module docstring.  segs (B, N, 2), scores (B, N).  Returns (kept_segs
    (B, max_keep, 2), kept_scores (B, max_keep), valid (B, max_keep)) in
    pick order; a pick is the first maximum among the segments still alive
    (the JAX ``argmax``)."""
    B, N = scores.shape
    rows = torch.arange(B, device=scores.device)
    cols = torch.arange(N, device=scores.device)
    cur = scores
    alive = torch.ones(B, N, dtype=torch.bool, device=scores.device)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    kept_segs, kept_scores, valid = [], [], []
    for _ in range(max_keep):
        cand = torch.where(alive, cur, neg_inf)
        idx = torch.argmax(cand, dim=1)
        best_score, best_seg = cand[rows, idx], segs[rows, idx]
        ious = _iou_1d(best_seg, segs)
        if method == 0:
            alive = alive & ~(ious > iou_threshold)
        else:
            decay = torch.where(ious > iou_threshold, 1.0 - ious, torch.ones_like(ious)) \
                if method == 1 else torch.exp(-torch.square(ious) / sigma)
            cur = torch.where(alive, cur * decay, cur)
        alive = alive & (cols[None] != idx[:, None])
        kept_segs.append(best_seg)
        kept_scores.append(best_score)
        valid.append(best_score >= min_score)
    return torch.stack(kept_segs, 1), torch.stack(kept_scores, 1), torch.stack(valid, 1)


def nms_1d(segs: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_keep: int,
           min_score: float = 0.001, method: int = 2, sigma: float = 0.5):
    """``batched_nms_1d`` of one video: segs (N, 2), scores (N,); returns
    (kept_segs (max_keep, 2), kept_scores (max_keep,), valid (max_keep,))."""
    out = batched_nms_1d(segs[None], scores[None], iou_threshold, max_keep, min_score, method,
                         sigma)
    return tuple(t[0] for t in out)


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
