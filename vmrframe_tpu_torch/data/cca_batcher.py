"""CCA's batch assembly (counterpart of ``vmrframe_tpu/data/cca_batcher.py``):
the base batch plus ``label2ds``, each sample's (L, L) IoU map of cell
(i, j)'s span [i, j + 1] * duration / L with the gt moment
(``iou2d_label(end_plus_one=True)``)."""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.data.labels import iou2d_label


class CCABatcher(Batcher):
    def make_batch(self, indices: List[int],
                   rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        batch = super().make_batch(indices, rng)
        L = self.vlen
        label2ds = np.zeros((self.batch_size, L, L), dtype=np.float32)
        for slot, idx in enumerate(indices):
            record = self.dataset[idx]
            stime, etime = record["se_time"]
            label2ds[slot] = iou2d_label(stime, etime, record["duration"], L, end_plus_one=True)
        batch["label2ds"] = label2ds
        return batch
