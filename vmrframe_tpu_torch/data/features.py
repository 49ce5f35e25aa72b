"""Video feature stores (counterpart of ``vmrframe_tpu/data/features.py``).

``VideoFeatureStore`` globs ``root/*.npy`` (eager or lazy);
``SyntheticFeatureStore`` makes deterministic random features per vid, the
same numbers as the JAX package's store for the same vids and seed.
"""

from __future__ import annotations

import glob
import os
import zlib
from typing import Dict

import numpy as np


class VideoFeatureStore:
    def __init__(self, root: str, max_vlen: int, lazy: bool = False):
        self.lazy = lazy
        self.max_vlen = max_vlen
        self.path_dict: Dict[str, str] = {}
        self.features: Dict[str, np.ndarray] = {}
        for filename in glob.glob(os.path.join(root, "*.npy")):
            vid = os.path.basename(filename).split(".")[0]
            self.path_dict[vid] = filename
            if not lazy:
                self.features[vid] = np.asarray(np.load(filename), dtype=np.float32)

    def __contains__(self, vid: str) -> bool:
        return vid in self.path_dict

    def __getitem__(self, vid: str) -> np.ndarray:
        if self.lazy:
            return np.asarray(np.load(self.path_dict[vid]), dtype=np.float32)
        return self.features[vid]

    def lengths(self) -> Dict[str, int]:
        if self.lazy:
            return {vid: np.load(path, mmap_mode="r").shape[0]
                    for vid, path in self.path_dict.items()}
        return {vid: feat.shape[0] for vid, feat in self.features.items()}


class SyntheticFeatureStore:
    """Deterministic random features keyed by vid (for tests and smoke runs)."""

    def __init__(self, vids, vdim: int, min_len: int = 16, max_len: int = 256, seed: int = 0):
        self.vdim = vdim
        rng = np.random.default_rng(seed)
        self._lens = {str(vid): int(rng.integers(min_len, max_len + 1)) for vid in vids}
        self._seed = seed

    def __contains__(self, vid: str) -> bool:
        return str(vid) in self._lens

    def __getitem__(self, vid: str) -> np.ndarray:
        vid = str(vid)
        # crc32, not hash(): stable across processes
        rng = np.random.default_rng(zlib.crc32(f"{vid}/{self._seed}".encode()))
        return rng.standard_normal((self._lens[vid], self.vdim)).astype(np.float32)

    def lengths(self) -> Dict[str, int]:
        return dict(self._lens)
