"""Static-shape batch assembly and host-side prefetch (counterpart of
``vmrframe_tpu/data/batcher.py``).

Every batch has the same shapes: (B, vlen, vdim) features, (B, tlen) word
ids, (B, tlen, char_len) char ids, plus masks and labels.  A partial batch is
padded and carries a ``sample_mask``.  A ``train`` batcher shuffles each
epoch with ``random.Random(seed)`` and draws the config's augmentations
(``unchanged``, ``dilation``, ``erosion``) from the same stream, so its
batches are the JAX package's; a ``test`` batcher (serving, evaluation)
applies none.  Under the identity augmentation with ``truncation``/``samelen``
sampling a video's resampled features depend on the vid alone and are
cached, as in the JAX package.

Two routes take the per-sample work off the one host thread, both opt-in
as in the JAX package:

- ``num_workers`` (default ``train.num_workers``, 0): with more than one, the
  samples of a batch are augmented and resampled on a pool of that many
  threads (numpy releases the interpreter's lock in its larger operations),
  each with ``random.Random(seed)`` for a seed drawn from the epoch's
  stream, one a sample in slot order, so a batch does not depend on the
  threads' timing and equals the JAX ``Batcher``'s;
- ``dataprocess.device_pipeline: true``: the batch carries each sample's
  raw features padded to the dataset's longest video (``raw_vfeats``,
  ``raw_lens``, ``pipeline_seed``) and the step runs augmentation,
  resampling and labels on the card (``ops/input_pipeline.py``).  As in the
  JAX package it applies only to a config of one augmentation and a
  ``truncation``/``samelen`` sampling; otherwise the host route runs.

``BatchPrefetcher`` assembles the next batches on a thread while the device
runs the current step.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from vmrframe_tpu_torch.data.augment import sample_vfeat_linear, video_augmentation
from vmrframe_tpu_torch.data.labels import dist_idx_label, label_span_from_curve, ner_label
from vmrframe_tpu_torch.metrics import frac_idx


class Batcher:
    """Assemble fixed-shape numpy batches from records + a feature store."""

    def __init__(self, dataset: List[dict], feature_store, cfg, derived,
                 loadertype: str = "test", batch_size: Optional[int] = None,
                 num_workers: Optional[int] = None):
        self.cfg = cfg
        self.dataset = dataset
        self.features = feature_store
        self.loadertype = loadertype
        self.batch_size = batch_size or cfg.train.batch_size
        self.vlen = cfg.model.vlen
        self.tlen = cfg.model.get("tlen", 30)
        self.vdim = cfg.model.vdim
        self.char_len = derived.char_len
        dp = cfg.get("dataprocess")
        self.sample_type = dp.get("sample_type", "truncation") if dp else "truncation"
        aug = dp.get("video_augmentation") if dp else None
        cfg_aug = dict(aug.to_dict() if hasattr(aug, "to_dict") else aug) if aug else {}
        self.aug = cfg_aug if loadertype == "train" and cfg_aug else {"unchanged": None}
        self.aug_is_identity = set(self.aug) == {"unchanged"}
        self._resample_cache: Dict[str, tuple] = {}
        if num_workers is None:
            train = cfg.get("train")
            num_workers = int(train.get("num_workers", 0)) if train else 0
        self.num_workers = num_workers
        # the JAX gate: one augmentation in the config, and not 'original'
        self.device_pipeline = (bool(dp.get("device_pipeline", False)) if dp else False) \
            and len(cfg_aug or {"unchanged": None}) == 1 and self.sample_type != "original"
        self._max_raw_len = 0
        if self.device_pipeline:
            lens = feature_store.lengths()
            self._max_raw_len = max(lens[record["vid"]] for record in dataset)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self) -> int:
        return len(self.dataset)

    def _get_vfeat_label(self, record: dict, rng: random.Random):
        sfrac, efrac = record["se_frac"]
        vid = record["vid"]
        if not self.aug_is_identity or self.sample_type not in ("truncation", "samelen"):
            vfeat, label = video_augmentation(sfrac, efrac, self.features[vid], self.aug, rng)
            if not label.any():
                raise ValueError(f"{vid}: no labelled frame after the augmentation")
            vfeat, label = sample_vfeat_linear(vfeat, label, self.vlen, self.sample_type)
            if not label.any():
                raise ValueError(f"{vid}: no labelled frame after resampling")
            return vfeat, label
        if vid not in self._resample_cache:  # identity augmentation: cacheable per vid
            raw = self.features[vid]
            vfeat, _ = sample_vfeat_linear(raw, np.zeros(raw.shape[0], np.float32),
                                           self.vlen, self.sample_type)
            self._resample_cache[vid] = (vfeat, raw.shape[0])
        vfeat, raw_len = self._resample_cache[vid]
        label = np.zeros(raw_len, dtype=np.float32)
        sidx0, eidx0 = frac_idx([sfrac, efrac], raw_len)
        label[sidx0:eidx0 + 1] = 1.0
        _, label = sample_vfeat_linear(np.zeros((raw_len, 1), np.float32), label,
                                       self.vlen, self.sample_type)
        return vfeat, label

    def _make_raw_batch(self, indices: List[int], rng: random.Random) -> Dict[str, np.ndarray]:
        """The device pipeline's batch: raw features padded to the dataset's
        longest video, their lengths, the text and the pipeline's seed."""
        B, tlen, clen = self.batch_size, self.tlen, self.char_len
        raw = np.zeros((B, self._max_raw_len, self.vdim), dtype=np.float32)
        raw_lens = np.ones((B,), dtype=np.int32)
        words_ids = np.zeros((B, tlen), dtype=np.int32)
        char_ids = np.zeros((B, tlen, clen), dtype=np.int32)
        se_times = np.zeros((B, 2), dtype=np.float32)
        se_fracs = np.zeros((B, 2), dtype=np.float32)
        sample_mask = np.zeros((B,), dtype=np.float32)
        for slot, idx in enumerate(indices):
            record = self.dataset[idx]
            f = self.features[record["vid"]]
            raw[slot, : f.shape[0]] = f
            raw_lens[slot] = f.shape[0]
            self._put_text(record, slot, words_ids, char_ids)
            se_times[slot] = record["se_time"]
            se_fracs[slot] = record["se_frac"]
            sample_mask[slot] = 1.0
        return {
            "raw_vfeats": raw,
            "raw_lens": raw_lens,
            "words_ids": words_ids,
            "char_ids": char_ids,
            "tmasks": (words_ids != 0).astype(np.float32),
            "se_times": se_times,
            "se_fracs": se_fracs,
            "sample_mask": sample_mask,
            "pipeline_seed": np.int32(rng.randrange(2**31)),
            "num_valid": np.int32(len(indices)),
        }

    def _put_text(self, record: dict, slot: int, words_ids: np.ndarray,
                  char_ids: np.ndarray) -> None:
        tlen, clen = self.tlen, self.char_len
        wids = record["wids"][:tlen]
        words_ids[slot, : len(wids)] = wids
        for wi, cids in enumerate(record["cids"][:tlen]):
            cids = cids[:clen]
            char_ids[slot, wi, : len(cids)] = cids

    def _vfeats_labels(self, indices: List[int], rng: random.Random) -> list:
        """Each sample's (features, label curve), on ``num_workers`` threads
        when there are more than one.  The pool lives for one batch: a
        service builds a batcher per micro-batch."""
        if self.num_workers <= 1:
            return [self._get_vfeat_label(self.dataset[idx], rng) for idx in indices]
        seeds = [rng.randrange(2**32) for _ in indices]
        with ThreadPoolExecutor(max_workers=self.num_workers,
                                thread_name_prefix="batcher") as pool:
            return list(pool.map(
                lambda job: self._get_vfeat_label(self.dataset[job[0]], random.Random(job[1])),
                zip(indices, seeds)))

    def make_batch(self, indices: List[int],
                   rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        rng = rng or random.Random(0)
        if self.device_pipeline:
            return self._make_raw_batch(indices, rng)
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

        results = self._vfeats_labels(indices, rng)
        for slot, idx in enumerate(indices):
            record = self.dataset[idx]
            vfeat, label = results[slot]
            cur_len = vfeat.shape[0]
            sidx, eidx = label_span_from_curve(label)
            vfeats[slot, :cur_len] = vfeat
            vmasks[slot, :cur_len] = 1.0
            label1ds[slot] = dist_idx_label(sidx, eidx, vlen)
            ner_labels[slot] = ner_label(sidx, eidx, cur_len, vlen)
            self._put_text(record, slot, words_ids, char_ids)
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

    def epoch(self, seed: int = 0, shuffle: Optional[bool] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
        """One pass over the dataset, one batch at a time; the last may be
        partial.  Shuffled with ``random.Random(seed)`` when ``shuffle`` (by
        default: a ``train`` batcher), which also draws the augmentations."""
        shuffle = (self.loadertype == "train") if shuffle is None else shuffle
        rng = random.Random(seed)
        order = list(range(len(self.dataset)))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            yield self.make_batch(order[i:i + self.batch_size], rng)


class BatchPrefetcher:
    """Iterates ``batch_iter`` on a background thread, ``depth`` batches
    ahead.  An error in the thread is raised to the consumer.  ``close()``
    stops the thread early."""

    def __init__(self, batch_iter: Iterator[Dict[str, Any]], depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, args=(batch_iter,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, batch_iter):
        try:
            for batch in batch_iter:
                if not self._put(batch):
                    return
        except BaseException as e:  # raised again in the consumer
            self._err = e
        finally:
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is None:
            self._thread.join(timeout=10)
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
