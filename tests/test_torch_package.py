"""Rules of the port as a package: it imports nothing of JAX nor of the JAX
package, and ``chip_smoke.py`` runs only on a card and only beside the port.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vmrframe_tpu"}


def _port_files():
    files = sorted((REPO / "vmrframe_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    offenders = [f"{p.relative_to(REPO)}: {root}" for p in _port_files()
                 for root in _imported_roots(p) if root in FORBIDDEN]
    assert offenders == []


# modules added by the later slices (the sentence variants and ActionFormer's
# rest; CCA and CPL; the zoo's tools and data parallelism; chunked evaluation
# and the profiling and roofline tools), held to the rule
# above: each keeps its own copy of what it needs of the JAX package
SLICE_MODULES = ("data/sentence_encoder.py", "models/sentence_variants.py",
                 "models/backbone_actionformer.py", "native/__init__.py", "data/concepts.py",
                 "data/cca_batcher.py", "models/cca.py", "models/cpl.py",
                 "layers/cpl_decoder.py", "compat.py", "layers/legacy_vsl.py",
                 "parallel/__init__.py", "parallel/mesh.py", "tools/bench_zoo.py",
                 "tools/bench_kernels.py", "tools/bench_pipeline.py", "tools/flag_sweep.py",
                 "tools/convert_torch.py", "tools/clean_data.py", "tools/similar_sentence.py",
                 "ops/chunked.py", "tools/h100.py", "tools/roofline.py", "tools/trace_profile.py",
                 "tools/roofline_trace.py", "tools/profile_batch.py", "tools/profile_seqpan.py",
                 "tools/profile_model.py")


def test_the_slice_modules_are_held_to_the_rule():
    checked = {p.relative_to(REPO / "vmrframe_tpu_torch").as_posix() for p in _port_files()
               if p.is_relative_to(REPO / "vmrframe_tpu_torch")}
    assert set(SLICE_MODULES) <= checked


def test_the_nms_twin_is_the_ports_own_copy():
    """The C++ NMS twin is built from the port's copy, never from the JAX
    package's ``vmrframe_tpu/native``, which no port file names."""
    import vmrframe_tpu_torch.native as N

    assert N.SOURCE == REPO / "vmrframe_tpu_torch" / "native" / "nms_1d.cpp"
    assert "extern \"C\"" in N.SOURCE.read_text()
    assert N.library_path().parent == REPO / "vmrframe_tpu_torch" / "kernels" / "_build"
    offenders = [str(p.relative_to(REPO)) for p in _port_files() + [N.SOURCE]
                 if "vmrframe_tpu.native" in p.read_text()
                 or "vmrframe_tpu/native" in p.read_text()]
    assert offenders == []


def _run_smoke(cwd: Path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
