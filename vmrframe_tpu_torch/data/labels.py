"""Labels (counterpart of ``vmrframe_tpu/data/labels.py``), trimmed to
what a batch needs: the 1D labels, the Gaussian splat of the distillation
batchers' synthetic teacher, and BAN's 2D labels (the IoU map, the sparse
validity mask, the contrastive masks and the start/end offsets)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

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


def soft_label(sidx: int, eidx: int, vlen: int, L: int, alpha: float):
    """Soft O/S/I/E labels: (Ssoft, Esoft, (L, 4) Msoft)."""
    s_soft = gaussian_weight(sidx, vlen, L, alpha)
    e_soft = gaussian_weight(eidx, vlen, L, alpha)
    io_soft = 1 - s_soft - e_soft
    mask_i = np.zeros(L)
    mask_i[sidx : eidx + 1] = 1
    mask_o = np.zeros(L)
    mask_o[:sidx] = 1
    mask_o[eidx + 1 : vlen] = 1
    m_soft = np.stack([io_soft * mask_o, s_soft, io_soft * mask_i, e_soft]).T
    return s_soft, e_soft, m_soft


def label_span_from_curve(label: np.ndarray, threshold: float = 0.01) -> Tuple[int, int]:
    """First/last index where the resampled frame-label curve >= threshold."""
    hit = np.where(label >= threshold)[0]
    if hit.size == 0:
        raise ValueError("label curve empty after resampling")
    return int(hit.min()), int(hit.max())


def iou_1d(candidates: np.ndarray, gt: Sequence[float]) -> np.ndarray:
    """IoU of (N, 2) candidate spans with one gt span."""
    start, end = candidates[:, 0], candidates[:, 1]
    s, e = float(gt[0]), float(gt[1])
    inter = np.minimum(end, e) - np.maximum(start, s)
    union = np.maximum(end, e) - np.minimum(start, s)
    return np.clip(inter, 0, None) / union


def iou2d_label(stime: float, etime: float, duration: float, num_clips: int,
                end_plus_one: bool = True) -> np.ndarray:
    """(L, L) IoU of cell (i, j)'s span with the gt moment: the span is
    [i, j + 1] * duration / L, or [i, j] * duration / L without
    ``end_plus_one`` (BAN's batches use that one)."""
    i = np.arange(num_clips, dtype=np.float64)
    starts = np.repeat(i, num_clips) * duration / num_clips
    ends = (np.tile(i, num_clips) + (1 if end_plus_one else 0)) * duration / num_clips
    cand = np.stack([starts, ends], axis=1)
    return iou_1d(cand, [stime, etime]).reshape(num_clips, num_clips).astype(np.float32)


def mask2d(L: int, pooling_counts: Optional[Sequence[int]] = None) -> np.ndarray:
    """(L, L) bool validity of the sparse 2D map: the diagonal, then
    ``pooling_counts[k]`` diagonals at stride 2**k each."""
    if pooling_counts is None:
        pooling_counts = [L // 4, L // 8, L // 8]
    out = np.zeros((L, L), dtype=bool)
    out[np.arange(L), np.arange(L)] = True
    stride, offset = 1, 0
    for c in pooling_counts:
        for _ in range(c):
            offset += stride
            if offset >= L:
                break
            idx = np.arange(0, L - offset)
            out[idx, idx + offset] = True
        stride *= 2
    return out


def map2d_contrast(sidx: int, eidx: int, num_clips: int) -> np.ndarray:
    """(2, L, L) bool positive and negative cells of BAN's contrastive loss:
    spans that contain the gt, and spans wholly before or after it."""
    x = np.arange(0, sidx + 1, dtype=int)
    y = np.arange(max(eidx - 1, 0), num_clips, dtype=int)
    pos = np.zeros((num_clips, num_clips), dtype=bool)
    pos[np.ix_(x, y)] = True

    neg = np.zeros((num_clips, num_clips), dtype=bool)
    for offset in range(sidx):
        i = np.arange(0, sidx - offset)
        neg[i, i + offset] = True
    for offset in range(eidx):
        i = np.arange(eidx, num_clips - offset)
        j = i + offset
        keep = j < num_clips
        neg[i[keep], j[keep]] = True
    if neg.sum() == 0:
        neg[0, 0] = True
        neg[num_clips - 1, num_clips - 1] = True
    return np.stack([pos, neg])


def se_offset_label(stime: float, etime: float, duration: float, num_clips: int) -> np.ndarray:
    """(L, L, 2) start and end offsets, as fractions of the duration, from
    cell (i, j)'s span [i, j + 1] * duration / L to the gt moment."""
    i = np.arange(num_clips, dtype=np.float64)
    starts = np.repeat(i, num_clips) * duration / num_clips
    ends = (np.tile(i, num_clips) + 1) * duration / num_clips
    off = np.empty((num_clips * num_clips, 2), dtype=np.float32)
    off[:, 0] = (stime - starts) / duration
    off[:, 1] = (etime - ends) / duration
    return off.reshape(num_clips, num_clips, 2)
