"""Labels (counterpart of ``vmrframe_tpu/data/labels.py``), trimmed to
what a batch needs, and the Gaussian splat of the distillation batchers'
synthetic teacher."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def dist_idx_label(sidx: int, eidx: int, vlen: int) -> np.ndarray:
    """(2, vlen) clipped-Gaussian start/end distributions."""
    dist_idx = np.zeros((2, vlen), dtype=np.float32)
    gt_length = eidx - sidx + 1
    grid = np.arange(vlen)
    for row, center in ((0, sidx), (1, eidx)):
        p = np.exp(-0.5 * np.square((grid - center) / (0.1 * gt_length)))
        q = p.copy()
        q[q >= 0.8] = 1.0
        q[q < 0.1353] = 0.0
        if (q > 0.4).sum() == 0:
            # degenerate long spans: force a single 1 at the Gaussian argmax
            q[np.argsort(p)[-1]] = 1.0
        dist_idx[row] = q
    return dist_idx


def ner_label(sidx: int, eidx: int, cur_len: int, vlen: int, ext_len: int = 1) -> np.ndarray:
    """(vlen,) int labels: 0=O, 1=B, 2=I, 3=E, boundaries extended +-ext_len
    and clamped to the valid clip [0, cur_len-1]."""
    out = np.zeros([vlen], dtype=np.int64)
    new_st_l = max(0, sidx - ext_len)
    new_st_r = min(sidx + ext_len, cur_len - 1)
    new_et_l = max(0, eidx - ext_len)
    new_et_r = min(eidx + ext_len, cur_len - 1)
    if new_st_r >= new_et_l:
        new_st_r = max(sidx, new_et_l - 1)
    out[new_st_l : new_st_r + 1] = 1
    out[new_st_r + 1 : new_et_l] = 2
    out[new_et_l : new_et_r + 1] = 3
    return out


def gaussian_weight(center: int, vlen: int, L: int, alpha: float) -> np.ndarray:
    """Max-normalised Gaussian splat on a length-L grid, zeroed past vlen."""
    x = np.linspace(-1, 1, num=L, dtype=np.float32)
    sig = (vlen / L) * alpha
    u = (center / L) * 2 - 1
    weight = np.exp(-((x - u) ** 2) / (2 * sig**2)) / (math.sqrt(2 * math.pi) * sig)
    weight /= np.max(weight)
    weight[vlen:] = 0.0
    return weight


def label_span_from_curve(label: np.ndarray, threshold: float = 0.01) -> Tuple[int, int]:
    """First/last index where the resampled frame-label curve >= threshold."""
    hit = np.where(label >= threshold)[0]
    if hit.size == 0:
        raise ValueError("label curve empty after resampling")
    return int(hit.min()), int(hit.max())
