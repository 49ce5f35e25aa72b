"""The C++ twin of the port's NMS (``nms_1d.cpp``), bound with ctypes.

It cross-checks ``ops/nms.py::batched_nms_1d``, the on-device (soft-)NMS of
``models/actionformer.py::actionformer_infer_full``, one video at a time on
the CPU.  The shared library is built with ``g++`` at first use into
``vmrframe_tpu_torch/kernels/_build/`` (beside the CUDA kernels' libraries,
listed in ``.gitignore``), named by a hash of the source and the flags, so
an edited source builds anew.  Without ``g++``, or when the build fails,
``load`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "nms_1d.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "kernels" / "_build"
FLAGS = ("-O2", "-shared", "-fPIC")
_F, _I = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnms_1d-{digest}.so"


def load() -> ctypes.CDLL:
    """The built library (built on first use), its entries' C signatures set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            compiler = shutil.which("g++")
            if compiler is None:
                raise RuntimeError("g++ not found: the C++ NMS twin cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run([compiler, *FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: another process never loads a partial file
        lib = ctypes.CDLL(str(out))
        lib.nms_1d.restype = ctypes.c_int
        lib.nms_1d.argtypes = [_F, _F, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                               ctypes.c_int, ctypes.c_float, ctypes.c_int, _I, _F]
        _lib = lib
        return lib


def nms_1d_cpu(segs: np.ndarray, scores: np.ndarray, iou_threshold: float,
               min_score: float = 0.001, method: int = 2, sigma: float = 0.5,
               max_keep: int = 100) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The C++ NMS of one video: (N, 2) segments and (N,) scores as float32;
    method 0 hard, 1 linear, 2 gaussian.  Returns (kept_segs, kept_scores,
    kept_idx), the picks above ``min_score``, at most ``max_keep``."""
    lib = load()
    segs = np.ascontiguousarray(segs, dtype=np.float32)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    keep_idx = np.zeros(max_keep, dtype=np.int32)
    keep_scores = np.zeros(max_keep, dtype=np.float32)
    count = lib.nms_1d(segs.ctypes.data_as(_F), scores.ctypes.data_as(_F), segs.shape[0],
                       iou_threshold, min_score, method, sigma, max_keep,
                       keep_idx.ctypes.data_as(_I), keep_scores.ctypes.data_as(_F))
    idx = keep_idx[:count]
    return segs[idx], keep_scores[:count], idx
