"""Evaluation metrics (counterpart of ``vmrframe_tpu/metrics.py``): per-sample
temporal IoU on the device, then R1@{0.3,0.5,0.7} and mIoU on the host."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch


def iou_device(gt_se: torch.Tensor, pred_se: torch.Tensor) -> torch.Tensor:
    """IoU of (B, 2) fractional spans; a zero union gives 0."""
    inter = torch.minimum(gt_se[:, 1], pred_se[:, 1]) - torch.maximum(gt_se[:, 0], pred_se[:, 0])
    union = torch.maximum(gt_se[:, 1], pred_se[:, 1]) - torch.minimum(gt_se[:, 0], pred_se[:, 0])
    safe = torch.where(union == 0.0, torch.ones_like(union), union)
    iou = torch.where(union == 0.0, torch.zeros_like(inter), inter / safe)
    return iou.clamp_min(0.0)


def calculate_iou(i0: Sequence[float], i1: Sequence[float]) -> float:
    """Scalar temporal IoU of two spans; a zero union gives 0."""
    union = (min(i0[0], i1[0]), max(i0[1], i1[1]))
    inter = (max(i0[0], i1[0]), min(i0[1], i1[1]))
    if (union[1] - union[0]) == 0.0:
        return 0.0
    return max(0.0, 1.0 * (inter[1] - inter[0]) / (union[1] - union[0]))


def append_ious(ious: List[float], se_gts, se_props) -> List[float]:
    """Appends each sample's IoU of (B, 2) gt and predicted spans to ``ious``."""
    for gt_se, prop_se in zip(np.asarray(se_gts), np.asarray(se_props)):
        ious.append(calculate_iou(gt_se, prop_se))
    return ious


def calculate_iou_accuracy(ious: Iterable[float], threshold: float) -> float:
    ious = list(ious)
    if not ious:
        return 0.0
    return sum(1 for iou in ious if iou >= threshold) / len(ious) * 100.0


def get_i345_mi(ious: Sequence[float]) -> Tuple[float, float, float, float, float]:
    """R1@{0.3,0.5,0.7} + mIoU, with r1i5 duplicated as the reference returns it."""
    r1i3 = calculate_iou_accuracy(ious, threshold=0.3)
    r1i5 = calculate_iou_accuracy(ious, threshold=0.5)
    r1i7 = calculate_iou_accuracy(ious, threshold=0.7)
    mi = float(np.mean(ious) * 100.0) if len(ious) else 0.0
    return r1i3, r1i5, r1i5, r1i7, mi


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def time_idx(t, duration, vlen):
    if isinstance(t, (list, tuple)):
        return [time_idx(i, duration, vlen) for i in t]
    return round(t / duration * (vlen - 1))


def frac_idx(frac, vlen):
    if isinstance(frac, (list, tuple)):
        return [frac_idx(i, vlen) for i in frac]
    return round(frac * (vlen - 1))


def idx_time(t, duration, vlen):
    if isinstance(t, (list, tuple)):
        return [idx_time(i, duration, vlen) for i in t]
    return round(t / (vlen - 1) * duration, 2)
