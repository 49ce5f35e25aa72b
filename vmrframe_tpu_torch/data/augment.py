"""Fixed-grid resampling and the augmentation choice (counterpart of
``vmrframe_tpu/data/augment.py``'s ``interpolate_average``,
``sample_vfeat_linear`` and ``video_augmentation``).  Of the augmentations
only ``unchanged`` is ported: ``dilation`` and ``erosion`` come with SeqPAN
training."""

from __future__ import annotations

import random
from typing import Dict, Tuple

import numpy as np

from vmrframe_tpu_torch.metrics import frac_idx


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
    if k in ("dilation", "erosion"):
        raise NotImplementedError(f"augmentation {k!r} is not ported yet; it comes with "
                                  "SeqPAN training")
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
