"""Builds the port's CUDA sources into shared libraries at first use.

One ``nvcc`` per source, for ``sm_90a``, into ``kernels/_build/`` (listed in
``.gitignore``); ``build_all`` starts the compilers of several sources
together.  The library's name carries a hash of the source, the ``csrc``
headers it includes and the flags, so an edited source or header builds anew
and an unchanged one is reused.  The libraries
have a plain C interface and are loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_lock = threading.Lock()  # one build at a time: builds in a process share a temp name


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to; the name hashes the source, each
    ``csrc`` header it includes (``#include "x.cuh"``) and the flags."""
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source)
    for header in _INCLUDE.findall(source.decode()):
        digest.update((CSRC / header).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` for each, all started together.  A compiler's report
    (registers, shared memory, spills) goes to a ``.log`` beside its
    library."""
    outs = {name: library_path(name) for name in names}
    with _lock:
        running = []
        for name, out in outs.items():
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            with open(out.with_suffix(".log"), "w") as report:
                proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                         str(CSRC / f"{name}.cu")],
                                        stdout=report, stderr=subprocess.STDOUT)
            running.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in running:
            if proc.wait() != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{out.with_suffix('.log').read_text()}")
            else:
                os.replace(tmp, out)  # atomic: another process never loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built on first use, loaded."""
    return ctypes.CDLL(str(build_all([name])[name]))
