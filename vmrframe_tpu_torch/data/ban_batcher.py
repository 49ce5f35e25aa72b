"""BAN's batch assembly (counterpart of ``vmrframe_tpu/data/ban_batcher.py``).

Per batch: word ids and their lengths, the features padded to vlen and
their lengths, the start/end distributions (``dist_idxs``), the (L, L)
IoU map built without the +1 on the end (``iou2d_label(end_plus_one=False)``,
as the JAX package and the reference's collate build it), the (L, L, 2)
start/end offsets and the (2, L, L) contrastive masks.  The samples are
assembled one after another from the batch's random stream, as in the JAX
batcher, from any feature store (synthetic, ``.npy`` or ``.h5`` files).
``dataprocess.device_pipeline`` does not apply: the batch is always the
host's.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.data.labels import (dist_idx_label, iou2d_label, label_span_from_curve,
                                            map2d_contrast, se_offset_label)


class BANBatcher(Batcher):
    def make_batch(self, indices: List[int],
                   rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        rng = rng or random.Random(0)
        B, L, T = self.batch_size, self.vlen, self.tlen
        vfeats = np.zeros((B, L, self.vdim), dtype=np.float32)
        vlens = np.ones((B,), dtype=np.int32)
        words_ids = np.zeros((B, T), dtype=np.int32)
        tlens = np.ones((B,), dtype=np.int32)
        dist_idxs = np.zeros((B, 2, L), dtype=np.float32)
        iou2ds = np.zeros((B, L, L), dtype=np.float32)
        start_end_offset = np.zeros((B, L, L, 2), dtype=np.float32)
        map2d_contrasts = np.zeros((B, 2, L, L), dtype=bool)
        se_times = np.zeros((B, 2), dtype=np.float32)
        se_fracs = np.zeros((B, 2), dtype=np.float32)
        sample_mask = np.zeros((B,), dtype=np.float32)

        for slot, idx in enumerate(indices):
            record = self.dataset[idx]
            vfeat, label = self._get_vfeat_label(record, rng)
            cur_len = vfeat.shape[0]
            sidx, eidx = label_span_from_curve(label)
            vfeats[slot, :cur_len] = vfeat
            vlens[slot] = cur_len
            wids = record["wids"][:T]
            words_ids[slot, : len(wids)] = wids
            tlens[slot] = max(len(wids), 1)
            dist_idxs[slot] = dist_idx_label(sidx, eidx, L)
            stime, etime = record["se_time"]
            duration = record["duration"]
            iou2ds[slot] = iou2d_label(stime, etime, duration, L, end_plus_one=False)
            start_end_offset[slot] = se_offset_label(stime, etime, duration, L)
            map2d_contrasts[slot] = map2d_contrast(sidx, eidx, L)
            se_times[slot] = record["se_time"]
            se_fracs[slot] = record["se_frac"]
            sample_mask[slot] = 1.0

        return {
            "words_ids": words_ids,
            "tlens": tlens,
            "vfeats": vfeats,
            "vlens": vlens,
            "dist_idxs": dist_idxs,
            "iou2ds": iou2ds,
            "start_end_offset": start_end_offset,
            "map2d_contrasts": map2d_contrasts,
            "se_times": se_times,
            "se_fracs": se_fracs,
            "sample_mask": sample_mask,
            "num_valid": np.int32(len(indices)),
        }
