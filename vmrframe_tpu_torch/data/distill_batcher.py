"""Batchers for the distillation models (counterpart of
``vmrframe_tpu/data/distill_batcher.py``).

``MultiTeacherBatcher`` loads up to three teacher pickles
(``loss.t{0,1,2}_path``: an index-aligned list of ``[vid, (2, T) array]``, as
``tools/export_labels.py`` writes it), resamples each curve to the sample's
clip length (linear, ``align_corners=True``) and zero-pads it to ``vlen``,
as ``label1d_t{0,1,2}s`` (B, 2, vlen).  Teacher curves are train-only: a
``test`` batcher ships none.

``CCAPreTrainBatcher`` ships one teacher's curves time-major as
``label1ds_t0`` (B, vlen, 2), in every mode, from
``paths.result_model1_path`` or else ``loss.t0_path``.

Where no pickle is named or found, a seeded synthetic teacher stands in:
Gaussian curves at the gt span with a little index-seeded jitter, the same
as the JAX package's.

Both subclass ``Batcher`` (its ``num_workers`` pool included).  They read
the clip length from the host batch's ``vmasks``, which the device
pipeline's raw batch does not have (``dataprocess.device_pipeline``): the
JAX batchers fail there with a ``KeyError`` in ``make_batch``, so these
refuse that combination when they are built.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Dict, List, Optional

import numpy as np

from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.data.labels import gaussian_weight
from vmrframe_tpu_torch.metrics import frac_idx


def linear_resample_ac(x: np.ndarray, size: int) -> np.ndarray:
    """``F.interpolate(mode="linear", align_corners=True)`` over the last axis."""
    T = x.shape[-1]
    if T == size:
        return x.astype(np.float32)
    if size == 1:
        return x[..., :1].astype(np.float32)
    src = np.arange(size) * (T - 1) / (size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, T - 1)
    w = (src - lo).astype(np.float32)
    return (x[..., lo] * (1.0 - w) + x[..., hi] * w).astype(np.float32)


def _load_teacher_pickle(path: Optional[str]):
    if path and os.path.exists(str(path)):
        with open(path, "rb") as f:
            data = pickle.load(f)
        return [(vid, np.asarray(logit, dtype=np.float32)) for vid, logit in data]
    return None


def _synthetic_teacher_curve(record: dict, index: int, vlen: int) -> np.ndarray:
    """Deterministic plausible teacher curves from the gt span."""
    rng = np.random.default_rng(1000 + index)
    sfrac, efrac = record["se_frac"]
    sidx, eidx = frac_idx([sfrac, efrac], vlen)
    s = gaussian_weight(sidx, vlen, vlen, alpha=0.2) + rng.random(vlen) * 0.05
    e = gaussian_weight(eidx, vlen, vlen, alpha=0.2) + rng.random(vlen) * 0.05
    return np.stack([s, e]).astype(np.float32)


class _TeacherCurves:
    def __init__(self, path: Optional[str], fallback_len: int):
        self.data = _load_teacher_pickle(path)
        self.fallback_len = fallback_len

    def get(self, index: int, record: dict, cur_len: int, max_vlen: int) -> np.ndarray:
        """(2, max_vlen): record ``index``'s curves resampled to ``cur_len``."""
        if self.data is not None:
            vid, logit = self.data[index]
            if str(vid) != str(record["vid"]):
                raise ValueError(f"teacher pickle misaligned at record {index}: "
                                 f"{vid} vs {record['vid']}")
        else:
            logit = _synthetic_teacher_curve(record, index, self.fallback_len)
        out = np.zeros((2, max_vlen), dtype=np.float32)
        out[:, :cur_len] = linear_resample_ac(logit, cur_len)
        return out


def _refuse_device_pipeline(batcher: Batcher) -> None:
    if batcher.device_pipeline:
        raise ValueError(f"{type(batcher).__name__} ships teacher curves at each sample's clip "
                         "length, which the device pipeline's raw batch does not have: turn "
                         "dataprocess.device_pipeline off for this model")


class MultiTeacherBatcher(Batcher):
    def __init__(self, dataset, feature_store, cfg, derived, loadertype: str = "test",
                 batch_size: Optional[int] = None, num_workers: Optional[int] = None):
        super().__init__(dataset, feature_store, cfg, derived, loadertype, batch_size,
                         num_workers)
        self.teachers = []
        if loadertype == "train":
            _refuse_device_pipeline(self)
            loss = cfg.get("loss")
            for t in ("t0", "t1", "t2"):
                path = loss.get(f"{t}_path") if loss else None
                self.teachers.append(_TeacherCurves(path, fallback_len=self.vlen))

    def make_batch(self, indices: List[int],
                   rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        batch = super().make_batch(indices, rng)
        B, L = self.batch_size, self.vlen
        for t_i, teacher in enumerate(self.teachers):
            curves = np.zeros((B, 2, L), dtype=np.float32)
            for slot, idx in enumerate(indices):
                cur_len = int(batch["vmasks"][slot].sum())
                curves[slot] = teacher.get(idx, self.dataset[idx], cur_len, L)
            batch[f"label1d_t{t_i}s"] = curves
        return batch


class CCAPreTrainBatcher(Batcher):
    def __init__(self, dataset, feature_store, cfg, derived, loadertype: str = "test",
                 batch_size: Optional[int] = None, num_workers: Optional[int] = None):
        super().__init__(dataset, feature_store, cfg, derived, loadertype, batch_size,
                         num_workers)
        _refuse_device_pipeline(self)
        paths, loss = cfg.get("paths"), cfg.get("loss")
        path = (paths.get("result_model1_path") if paths else None) or (
            loss.get("t0_path") if loss else None)
        self.teacher = _TeacherCurves(path, fallback_len=self.vlen)

    def make_batch(self, indices: List[int],
                   rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        batch = super().make_batch(indices, rng)
        B, L = self.batch_size, self.vlen
        curves = np.zeros((B, L, 2), dtype=np.float32)
        for slot, idx in enumerate(indices):
            cur_len = int(batch["vmasks"][slot].sum())
            curves[slot] = self.teacher.get(idx, self.dataset[idx], cur_len, L).T  # time-major
        batch["label1ds_t0"] = curves
        return batch
