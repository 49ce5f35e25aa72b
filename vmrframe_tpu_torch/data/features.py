"""Video feature stores (counterpart of ``vmrframe_tpu/data/features.py``).

``VideoFeatureStore`` globs ``root/*.npy`` (the reference's main layout),
read eagerly into RAM or lazily per item; in lazy mode ``lengths`` reads the
files' headers only (once).  ``H5FeatureStore`` reads ``file[vid]`` out of
one HDF5 file (``transpose`` for channel-first files), eagerly or per item;
h5py is imported only when one is opened.  ``open_feature_store`` picks the
store from the path.  ``SyntheticFeatureStore`` makes deterministic random
features per vid, the same numbers as the JAX package's store for the same
vids and seed.  Features stay float32 numpy on the host.
"""

from __future__ import annotations

import glob
import os
import zlib
from typing import Dict, Optional

import numpy as np

from vmrframe_tpu_torch.data.datasets import npy_length


class VideoFeatureStore:
    def __init__(self, root: str, max_vlen: int, lazy: bool = False):
        self.lazy = lazy
        self.max_vlen = max_vlen
        self.path_dict: Dict[str, str] = {}
        self.features: Dict[str, np.ndarray] = {}
        self._lengths: Optional[Dict[str, int]] = None
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
        if not self.lazy:
            return {vid: feat.shape[0] for vid, feat in self.features.items()}
        if self._lengths is None:  # the files do not change under a running store
            self._lengths = {vid: npy_length(path) for vid, path in self.path_dict.items()}
        return dict(self._lengths)


class H5FeatureStore:
    """Features in one HDF5 file: ``file[vid]`` is a (T, D) dataset, or
    (D, T) with ``transpose``.  Eager mode decodes every video once and
    closes the file; lazy mode keeps it open and reads per item."""

    def __init__(self, path: str, lazy: bool = False, transpose: bool = False):
        import h5py

        self.path = path
        self.lazy = lazy
        self.transpose = transpose
        self._file = h5py.File(path, "r")
        self._keys = set(self._file.keys())
        self.features: Dict[str, np.ndarray] = {}
        if not lazy:
            for vid in self._keys:
                self.features[vid] = self._decode(self._file[vid])
            self._file.close()
            self._file = None

    def _decode(self, dset) -> np.ndarray:
        arr = np.asarray(dset, dtype=np.float32)
        return arr.T if self.transpose else arr

    def __contains__(self, vid: str) -> bool:
        return str(vid) in self._keys

    def __getitem__(self, vid: str) -> np.ndarray:
        vid = str(vid)
        if self.lazy:
            return self._decode(self._file[vid])
        return self.features[vid]

    def lengths(self) -> Dict[str, int]:
        if self.lazy:
            ax = 1 if self.transpose else 0
            return {vid: int(self._file[vid].shape[ax]) for vid in self._keys}
        return {vid: feat.shape[0] for vid, feat in self.features.items()}


def open_feature_store(path: str, max_vlen: int, lazy: bool = False):
    """An ``.h5``/``.hdf5`` file opens as an ``H5FeatureStore``; a directory
    as a ``VideoFeatureStore`` of its ``*.npy`` files."""
    if os.path.isfile(path) and path.endswith((".h5", ".hdf5")):
        return H5FeatureStore(path, lazy=lazy)
    return VideoFeatureStore(path, max_vlen, lazy=lazy)


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
