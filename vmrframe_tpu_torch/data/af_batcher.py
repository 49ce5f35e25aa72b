"""ActionFormer batch assembly (counterpart of ``vmrframe_tpu/data/af_batcher.py``).

With ``force_upsampling`` every clip is linearly resized (torch
``F.interpolate``, ``align_corners=False``) to ``max_seq_len`` and its feature
stride recomputed; the gt segment goes to feature-grid coordinates; the
batch carries fps, duration, feat_stride and num_frames so spans decode back
to seconds on the device.  Under the identity augmentation (a test batcher,
or a train config of ``unchanged`` only) a video's grid features depend on
the vid alone and are cached with the base ``Batcher``'s resampled
features; a train batcher with ``dilation`` or ``erosion`` assembles them
anew each time, drawing from the epoch's stream as the JAX package does.  The
JAX package's ``truncate_feats`` is called nowhere there and is not ported.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from vmrframe_tpu_torch.data.batcher import Batcher


def linear_resize(x: np.ndarray, size: int) -> np.ndarray:
    """torch ``F.interpolate(mode='linear', align_corners=False)`` over axis 0."""
    T = x.shape[0]
    if T == size:
        return x.astype(np.float32)
    src = np.clip((np.arange(size) + 0.5) * (T / size) - 0.5, 0.0, T - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, T - 1)
    w = (src - lo).astype(np.float32)[:, None]
    return (x[lo] * (1.0 - w) + x[hi] * w).astype(np.float32)


class ActionFormerBatcher(Batcher):
    def __init__(self, dataset, feature_store, cfg, derived, loadertype="test", batch_size=None):
        super().__init__(dataset, feature_store, cfg, derived, loadertype, batch_size)
        dp = cfg.get("dataprocess")
        self.default_fps = float(dp.get("default_fps", 30)) if dp else 30.0
        self.feat_stride_cfg = float(dp.get("feat_stride", 16)) if dp else 16.0
        self.num_frames_cfg = float(dp.get("num_frames", 16)) if dp else 16.0
        self.force_upsampling = bool(dp.get("force_upsampling", True)) if dp else True
        self.downsample_rate = int(dp.get("downsample_rate", 1)) if dp else 1
        self.max_seq_len = cfg.actionformer.max_seq_len

    def _grid_feats(self, record: dict, rng: random.Random):
        """(features on the grid, valid length, feature stride, frames per feature)."""
        T = self.max_seq_len
        key = f"{record['vid']}/grid"
        if self.aug_is_identity and key in self._resample_cache:
            return self._resample_cache[key]
        vfeat, _ = self._get_vfeat_label(record, rng)
        t0 = vfeat.shape[0]
        if self.force_upsampling:
            stride = ((t0 - 1) * self.feat_stride_cfg + self.num_frames_cfg) / T
            nframes = stride
            vfeat = linear_resize(vfeat, T)
        else:
            stride, nframes = self.feat_stride_cfg, self.num_frames_cfg
            if self.downsample_rate > 1:
                vfeat = vfeat[:: self.downsample_rate]
                stride *= self.downsample_rate
            vfeat = vfeat[:T]
        grid = (vfeat, vfeat.shape[0], stride, nframes)
        if self.aug_is_identity:
            self._resample_cache[key] = grid
        return grid

    def make_batch(self, indices: List[int],
                   rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        rng = rng or random.Random(0)
        B, T = self.batch_size, self.max_seq_len
        C = self.cfg.actionformer.input_dim
        feats = np.zeros((B, T, C), dtype=np.float32)
        masks = np.zeros((B, T), dtype=np.float32)
        gt_segments = np.zeros((B, 2), dtype=np.float32)
        fps_v = np.full((B,), self.default_fps, dtype=np.float32)
        duration = np.ones((B,), dtype=np.float32)
        feat_stride = np.ones((B,), dtype=np.float32)
        feat_num_frames = np.ones((B,), dtype=np.float32)
        se_fracs = np.zeros((B, 2), dtype=np.float32)
        sample_mask = np.zeros((B,), dtype=np.float32)

        for slot, idx in enumerate(indices):
            record = self.dataset[idx]
            vfeat, cur_len, stride, nframes = self._grid_feats(record, rng)
            offset = 0.5 * nframes / stride
            s_time, e_time = record["se_time"]
            feats[slot, :cur_len] = vfeat
            masks[slot, :cur_len] = 1.0
            gt_segments[slot] = [s_time * self.default_fps / stride - offset,
                                 e_time * self.default_fps / stride - offset]
            duration[slot] = record["duration"]
            feat_stride[slot] = stride
            feat_num_frames[slot] = nframes
            se_fracs[slot] = record["se_frac"]
            sample_mask[slot] = 1.0

        return {
            "feats": feats,
            "masks": masks,
            "gt_segments": gt_segments,
            "fps": fps_v,
            "duration": duration,
            "feat_stride": feat_stride,
            "feat_num_frames": feat_num_frames,
            "se_fracs": se_fracs,
            "sample_mask": sample_mask,
            "num_valid": np.int32(len(indices)),
        }
