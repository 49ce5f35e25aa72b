"""Train-time video augmentation and fixed-grid resampling (counterpart of
``vmrframe_tpu/data/augment.py``).

``video_augmentation`` builds a 0/1 frame label from the fractional span,
then applies one augmentation drawn from the config's keys: ``unchanged``,
``dilation`` (negative-segment frames prepended and appended) or
``erosion`` (a random crop that keeps the span).  They draw from Python's
``random.Random`` and numpy exactly as the JAX package does, so one seed
gives identical arrays in both."""

from __future__ import annotations

import random
from typing import Dict, Tuple

import numpy as np

from vmrframe_tpu_torch.metrics import frac_idx


def select_negative_segment(seglen: int, vfeat: np.ndarray, label: np.ndarray,
                            rng: random.Random) -> np.ndarray:
    """A random contiguous slice of ``seglen`` out-of-moment frames, the
    frames tiled while too few (random features when there are none)."""
    neg = vfeat[label == 0]
    if neg.shape[0] == 0:
        neg = np.random.default_rng(rng.randrange(2**32)).random(vfeat.shape, dtype=np.float32)
    while len(neg) < seglen:
        neg = np.concatenate([neg, neg])
    r = rng.randint(0, len(neg) - seglen)
    return neg[r:r + seglen]


def feature_dilation(vfeat: np.ndarray, label: np.ndarray, p: float, rng: random.Random):
    """Up to ``p * len`` negative frames before and after the video."""
    vlen = vfeat.shape[0]
    head_len = int(round(rng.random() * p * vlen))
    tail_len = int(round(rng.random() * p * vlen))
    head_vfeat = select_negative_segment(head_len, vfeat, label, rng)
    tail_vfeat = select_negative_segment(tail_len, vfeat, label, rng)
    new_vfeat = np.concatenate([head_vfeat, vfeat, tail_vfeat])
    new_label = np.concatenate([np.zeros(head_len, np.float32), label,
                                np.zeros(tail_len, np.float32)])
    return new_vfeat, new_label


def feature_erosion(vfeat: np.ndarray, label: np.ndarray, p: float, rng: random.Random):
    """A crop of up to ``p * len`` frames off each end that keeps every
    labelled frame: each end draws at most 100 times, and takes no crop if
    none of its draws keeps the span."""
    hit = np.where(label >= 0.01)[0]
    ori_sidx, ori_eidx = int(hit.min()), int(hit.max())
    vlen = vfeat.shape[0]
    head_len = 0
    for _ in range(100):
        cand = int(round(rng.random() * p * vlen))
        if 0 <= cand <= ori_sidx:
            head_len = cand
            break
    tail_len = vlen - 1
    for _ in range(100):
        cand = vlen - 1 - int(round(rng.random() * p * vlen))
        if ori_eidx <= cand <= vlen - 1:
            tail_len = cand
            break
    return vfeat[head_len:tail_len + 1], label[head_len:tail_len + 1]


def video_augmentation(sfrac: float, efrac: float, vfeat: np.ndarray, aug: Dict[str, float],
                       rng: random.Random) -> Tuple[np.ndarray, np.ndarray]:
    """(features, 0/1 label over the frames of [sfrac, efrac]) after one
    augmentation drawn from ``aug``'s keys with ``rng``."""
    label = np.zeros(vfeat.shape[0], dtype=np.float32)
    sidx, eidx = frac_idx([sfrac, efrac], vfeat.shape[0])
    label[sidx:eidx + 1] = 1.0
    k = rng.choice(list(aug.keys()))
    if k == "unchanged":
        return vfeat, label
    if k == "dilation":
        return feature_dilation(vfeat, label, aug[k], rng)
    if k == "erosion":
        return feature_erosion(vfeat, label, aug[k], rng)
    raise ValueError(f"unknown augmentation {k!r}")


def _segment_bounds(vlen: int, size: int) -> np.ndarray:
    """round(arange(size)/size*(vlen-1)) ++ [vlen], half-to-even like torch.round."""
    idxs = np.arange(0, size, 1.0) / size * (vlen - 1)
    idxs = np.concatenate([idxs, [float(vlen)]])
    return np.round(idxs).astype(np.int64)


def interpolate_average(x: np.ndarray, size: int) -> np.ndarray:
    """Mean-pool (T, ...) onto ``size`` points; an empty segment takes the
    frame at its start, as the reference's loop does."""
    vlen = x.shape[0]
    bounds = _segment_bounds(vlen, size)
    starts, ends = bounds[:-1], bounds[1:]
    counts = ends - starts
    flat = np.ascontiguousarray(x.reshape(vlen, -1), dtype=np.float32)
    idx = np.minimum(starts, vlen - 1)
    sums = np.add.reduceat(flat, idx, axis=0)
    seg_mean = sums / np.maximum(counts, 1)[:, None].astype(np.float32)
    out = np.where((counts > 0)[:, None], seg_mean, flat[idx])
    return out.reshape((size,) + x.shape[1:]).astype(np.float32)


def sample_vfeat_linear(vfeat: np.ndarray, label: np.ndarray, max_vlen: int, sample_method: str):
    if sample_method == "original":
        return vfeat, label
    if sample_method == "truncation":
        if vfeat.shape[0] <= max_vlen:
            return vfeat, label
        return interpolate_average(vfeat, max_vlen), interpolate_average(label, max_vlen)
    if sample_method == "samelen":
        return interpolate_average(vfeat, max_vlen), interpolate_average(label, max_vlen)
    raise ValueError(f"unknown sample_method {sample_method!r}")
