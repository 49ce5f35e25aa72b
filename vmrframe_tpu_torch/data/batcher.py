"""Static-shape batch assembly (counterpart of ``vmrframe_tpu/data/batcher.py``
in test mode).

Every batch has the same shapes: (B, vlen, vdim) features, (B, tlen) word
ids, (B, tlen, char_len) char ids, plus masks and labels.  A partial batch is
padded and carries a ``sample_mask``.  Serving applies no augmentation, so a
video's resampled features depend on the vid alone and are cached.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from vmrframe_tpu_torch.data.augment import sample_vfeat_linear
from vmrframe_tpu_torch.data.labels import dist_idx_label, label_span_from_curve, ner_label
from vmrframe_tpu_torch.metrics import frac_idx


class Batcher:
    """Assemble fixed-shape numpy batches from records + a feature store."""

    def __init__(self, dataset: List[dict], feature_store, cfg, derived,
                 batch_size: Optional[int] = None):
        self.cfg = cfg
        self.dataset = dataset
        self.features = feature_store
        self.batch_size = batch_size or cfg.train.batch_size
        self.vlen = cfg.model.vlen
        self.tlen = cfg.model.get("tlen", 30)
        self.vdim = cfg.model.vdim
        self.char_len = derived.char_len
        dp = cfg.get("dataprocess")
        self.sample_type = dp.get("sample_type", "truncation") if dp else "truncation"
        self._resample_cache: Dict[str, tuple] = {}

    def _get_vfeat_label(self, record: dict):
        vid = record["vid"]
        if vid not in self._resample_cache:
            raw = self.features[vid]
            vfeat, _ = sample_vfeat_linear(raw, np.zeros(raw.shape[0], np.float32),
                                           self.vlen, self.sample_type)
            self._resample_cache[vid] = (vfeat, raw.shape[0])
        vfeat, raw_len = self._resample_cache[vid]
        label = np.zeros(raw_len, dtype=np.float32)
        sidx0, eidx0 = frac_idx(list(record["se_frac"]), raw_len)
        label[sidx0:eidx0 + 1] = 1.0
        _, label = sample_vfeat_linear(np.zeros((raw_len, 1), np.float32), label,
                                       self.vlen, self.sample_type)
        return vfeat, label

    def make_batch(self, indices: List[int]) -> Dict[str, np.ndarray]:
        B, vlen, tlen, clen = self.batch_size, self.vlen, self.tlen, self.char_len
        vfeats = np.zeros((B, vlen, self.vdim), dtype=np.float32)
        vmasks = np.zeros((B, vlen), dtype=np.float32)
        words_ids = np.zeros((B, tlen), dtype=np.int32)
        char_ids = np.zeros((B, tlen, clen), dtype=np.int32)
        label1ds = np.zeros((B, 2, vlen), dtype=np.float32)
        ner_labels = np.zeros((B, vlen), dtype=np.int32)
        se_times = np.zeros((B, 2), dtype=np.float32)
        se_fracs = np.zeros((B, 2), dtype=np.float32)
        sample_mask = np.zeros((B,), dtype=np.float32)

        for slot, idx in enumerate(indices):
            record = self.dataset[idx]
            vfeat, label = self._get_vfeat_label(record)
            cur_len = vfeat.shape[0]
            sidx, eidx = label_span_from_curve(label)
            vfeats[slot, :cur_len] = vfeat
            vmasks[slot, :cur_len] = 1.0
            label1ds[slot] = dist_idx_label(sidx, eidx, vlen)
            ner_labels[slot] = ner_label(sidx, eidx, cur_len, vlen)
            wids = record["wids"][:tlen]
            words_ids[slot, : len(wids)] = wids
            for wi, cids in enumerate(record["cids"][:tlen]):
                cids = cids[:clen]
                char_ids[slot, wi, : len(cids)] = cids
            se_times[slot] = record["se_time"]
            se_fracs[slot] = record["se_frac"]
            sample_mask[slot] = 1.0

        return {
            "vfeats": vfeats,
            "vmasks": vmasks,
            "words_ids": words_ids,
            "char_ids": char_ids,
            "tmasks": (words_ids != 0).astype(np.float32),
            "label1ds": label1ds,
            "NER_labels": ner_labels,
            "se_times": se_times,
            "se_fracs": se_fracs,
            "sample_mask": sample_mask,
            "num_valid": np.int32(len(indices)),
        }

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        """The dataset in order, one batch at a time; the last may be partial."""
        for i in range(0, len(self.dataset), self.batch_size):
            yield self.make_batch(list(range(i, min(i + self.batch_size, len(self.dataset)))))
