"""Builds the port's CUDA sources into shared libraries at first use.

One ``nvcc`` per source, for ``sm_90a``, into ``kernels/_build/`` (listed in
``.gitignore``); ``build_all`` starts the compilers of several sources
together.  A library of several sources (``PARTS``: the first holds the C
entry, the others one share each of the instances) compiles each to an
object, all at once with the rest, and links them.  The library's name
carries a hash of its sources, the ``csrc`` headers they include (and those
include) and the flags, so an edited source or header builds anew and an
unchanged one is reused.  The libraries
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
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the libraries built from several sources, entry first: #4's widths (D
# 640-1024 in the cluster part)
PARTS = {"dual_stack": ("dual_stack", "dual_stack_256", "dual_stack_384", "dual_stack_512",
                        "dual_stack_cluster")}

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


def _headers(text: str, seen: set) -> list:
    """The ``csrc`` headers ``text`` includes (``#include "x.cuh"``), and
    theirs, each once, in the order they are first met."""
    out = []
    for header in _INCLUDE.findall(text):
        if header not in seen:
            seen.add(header)
            out += [header] + _headers((CSRC / header).read_text(), seen)
    return out


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` (and its ``PARTS``) builds to; the name hashes
    each source, the ``csrc`` headers it includes and the flags."""
    digest = hashlib.sha256()
    for part in PARTS.get(name, (name,)):
        source = (CSRC / f"{part}.cu").read_bytes()
        digest.update(source)
        for header in _headers(source.decode(), set()):
            digest.update((CSRC / header).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` for each source (each of a library's ``PARTS``), all started
    together; then link the parts.  The compilers' report (registers, shared
    memory, spills) and each source's seconds go to a ``.log`` beside each
    library."""
    outs = {name: library_path(name) for name in names}
    with _lock:
        running = []  # (name, library, its temporary file, its nvcc jobs, objects)
        for name, out in outs.items():
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            parts = PARTS.get(name, (name,))
            if len(parts) == 1:
                jobs = [_nvcc_job([*NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                  out.with_suffix(".log"), f"{name}.cu")]
                running.append((name, out, tmp, jobs, []))
                continue
            objs = [out.with_name(f"{out.stem}.{part}.{os.getpid()}.o") for part in parts]
            compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
            jobs = [_nvcc_job([*compile_flags, "-c", "-o", str(obj), str(CSRC / f"{part}.cu")],
                              obj.with_suffix(".log"), f"{part}.cu") for part, obj in zip(parts, objs)]
            running.append((name, out, tmp, jobs, objs))
        _finish([job for *_, jobs, _ in running for job in jobs])
        failed = []
        for name, out, tmp, jobs, objs in running:
            if objs and not any(job["code"] for job in jobs):  # link the parts
                jobs.append(_nvcc_job([*NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                                      out.with_name(f"{out.stem}.link.log"), "the link"))
                _finish(jobs[-1:])
            out.with_suffix(".log").write_text(
                "".join(job["report"].read_text() for job in jobs)
                + "".join(f"built {job['source']} in {job['seconds']:.1f} s\n" for job in jobs))
            if objs:
                for f in objs + [job["report"] for job in jobs]:
                    f.unlink(missing_ok=True)
            codes = [job["code"] for job in jobs]
            if any(codes):
                failed.append(f"nvcc failed on {name}.cu:\n{out.with_suffix('.log').read_text()}")
            else:
                os.replace(tmp, out)  # atomic: another process never loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def _nvcc_job(args: list, report: Path, source: str) -> dict:
    """One ``nvcc`` on ``source`` started, its output into ``report``."""
    with open(report, "w") as f:
        proc = subprocess.Popen([_nvcc(), *args], stdout=f, stderr=subprocess.STDOUT)
    return {"proc": proc, "report": report, "source": source, "t0": time.monotonic(),
            "code": None, "seconds": None}


def _finish(jobs) -> None:
    """Waits for every job, noting its exit code and its seconds from its
    start."""
    while any(job["code"] is None for job in jobs):
        for job in jobs:
            if job["code"] is None and job["proc"].poll() is not None:
                job["code"], job["seconds"] = job["proc"].returncode, time.monotonic() - job["t0"]
        time.sleep(0.05)


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built on first use, loaded."""
    return ctypes.CDLL(str(build_all([name])[name]))


def ptxas_report(name: str) -> list:
    """From the compilers' report of ``name``'s library (built first): one
    line for each kernel (its registers) and each function ptxas lists (its
    spill stores and loads in bytes), names demangled where ``c++filt`` is
    found; then the seconds each source took to build."""
    text = build_all([name])[name].with_suffix(".log").read_text()
    filt = shutil.which("c++filt")

    def readable(mangled):
        if filt:
            mangled = subprocess.run([filt, mangled], capture_output=True, text=True).stdout
        name = re.sub(r"_INTERNAL_\w+::|\(anonymous namespace\)::|^void ", "", mangled.strip())
        return name.split("(")[0]

    lines, kernel = [], None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernel = readable(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and kernel:
            lines.append(f"{kernel}: {m.group(1)} registers")
            kernel = None
        elif m := re.search(r"Function properties for (\S+)", line):
            lines.append(readable(m.group(1)))
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and lines:
            lines[-1] += f": spills {m.group(1)} / {m.group(2)} bytes (stores / loads)"
        elif line.startswith("built "):
            lines.append(line)
    return lines


if __name__ == "__main__":
    import sys

    # python -m vmrframe_tpu_torch.kernels.build NAME: build csrc/NAME.cu, print its report
    print("\n".join(ptxas_report(sys.argv[1])))
