"""Kernel #5's schedule and the banded kernels' head dims, on the CPU.

- (a) the plain forward and backwards of the banded attention against the
  JAX ``banded_attention`` and its ``jax.vjp`` (the Pallas kernels in
  interpret mode) at head dims 24 and 96, f32 at atol 1e-5;
- (b) ``warp_key_span``, the keys the CUDA forward reads for each 16 query
  rows (``csrc/window_attention.cu`` computes the same): for every T from
  130 to 1000 and windows 9, 19, 37 and 300 it holds the band of its rows
  and lies inside their tile's K_WIN slice; and the schedule emulated in
  torch (span keys only, plus the padding-row rule) equals
  ``banded_attention_plain`` on every row at 1e-6, padding rows included;
- ``kernels/build.py`` names a library by its source and its headers (a
  library of several parts by every part and the headers their headers
  include), builds the parts apart and links them, and reads back each
  kernel's registers, each function's spills and each source's seconds.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmrframe_tpu.kernels.window_attention import banded_attention as jbanded_attention
from vmrframe_tpu_torch.kernels import build
from vmrframe_tpu_torch.kernels import window_attention as W
from vmrframe_tpu_torch.ops.masking import MASK_VALUE

WINDOWS = (9, 19, 37, 300)


def _inputs(seed, B, H, T, hd, window):
    """q, k, v, cotangent (B, H, T, hd) and a {0,1} mask: sample 0 wholly
    masked, sample 1 of a random length with a hole wider than the band."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, T, hd)).astype(np.float32) for _ in range(4))
    mask = np.zeros((B, T), np.float32)
    mask[1:, :int(rng.integers(T // 2, T + 1))] = 1.0
    hole = T // 4
    mask[1, hole:hole + window + 40] = 0.0
    return q, k, v, g, mask


# ------------------------------------------------ (a) against the JAX package


@pytest.mark.parametrize("T,window,hd", [(384, 19, 24), (700, 9, 96), (1000, 37, 24),
                                         (640, 300, 96)])
def test_plain_forward_and_backwards_match_pallas_interpret(T, window, hd):
    q, k, v, g, mask = _inputs(T + hd, 2, 2, T, hd, window)
    fn = lambda q_, k_, v_: jbanded_attention(q_, k_, v_, jnp.asarray(mask), window,  # noqa: E731
                                              interpret=True)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = (out,) + vjp(jnp.asarray(g))
    args = [torch.from_numpy(a) for a in (q, k, v, mask, g)]
    got = (W.banded_attention_plain(*args[:4], window),
           W.banded_attention_dq_plain(*args, window)) + W.banded_attention_dkv_plain(*args,
                                                                                      window)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)


# ---------------------------------------------- (b) the forward's key spans


def test_warp_key_span_holds_the_band_inside_the_slice():
    """Every T from 130 to 1000, every 16-row group: the span is whole
    16-key tiles, holds the band of all 16 rows (clipped to [0, T_pad)) and
    lies inside the rows' K_WIN slice; a block's 8 spans stage no more rows
    than the launch plans for (min(K_WIN, 128 + 2 * reach))."""
    checked = 0
    for window in WINDOWS:
        half, k_win = window // 2, W.key_window(window)
        reach = (half + 15) // 16 * 16
        for T in range(130, 1001):
            T_pad = W.padded_len(T)
            if T_pad < k_win:
                with pytest.raises(ValueError, match="too small"):
                    W._check_len(T, window)
                continue
            for q0 in range(0, T_pad, W.TILE):
                start = W.slice_start(q0, T, window)
                spans = [W.warp_key_span(T, window, row0) for row0 in range(q0, q0 + W.TILE, 16)]
                for i, (lo, hi) in enumerate(spans):
                    row0 = q0 + 16 * i
                    assert lo % 16 == 0 and hi % 16 == 0
                    assert start <= lo and hi <= start + k_win
                    assert lo <= max(0, row0 - half) and min(T_pad, row0 + 16 + half) <= hi
                    checked += 1
                assert spans[-1][1] - spans[0][0] <= min(k_win, W.TILE + 2 * reach)
    assert checked > 100_000


def _emulate_schedule(q, k, v, mask, window):
    """The CUDA forward's schedule in torch: each 16-row group softmaxes over
    its span's keys only; a row whose span maximum is still -1e30 (no valid
    key in its band) gets round(1/K_WIN) times V summed over its tile's
    slice keys below T."""
    B, H, T, hd = q.shape
    half, k_win, T_pad = window // 2, W.key_window(window), W.padded_len(T)
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, T_pad - T))  # noqa: E731
    kp, vp = pad(k), pad(v)
    valid = torch.nn.functional.pad(mask, (0, T_pad - T)) > 0
    pad_p = torch.tensor(1.0 / k_win).to(v.dtype).float()
    out = torch.empty_like(q)
    for row0 in range(0, T, 16):
        lo, hi = W.warp_key_span(T, window, row0)
        rows, keys = torch.arange(row0, min(row0 + 16, T)), torch.arange(lo, hi)
        ok = ((rows[:, None] - keys[None, :]).abs() <= half)[None] & valid[:, None, keys]
        s = q[:, :, rows] @ kp[:, :, keys].transpose(-1, -2) / math.sqrt(hd)
        s = s.masked_fill(~ok[:, None], MASK_VALUE)
        p = torch.softmax(s, dim=-1).to(v.dtype).float()
        o = p @ vp[:, :, keys].float()
        start = W.slice_start(row0 // W.TILE * W.TILE, T, window)
        colsum = v[:, :, start:min(start + k_win, T)].float().sum(2, keepdim=True)
        is_pad = (s.amax(-1, keepdim=True) == MASK_VALUE)
        out[:, :, rows] = torch.where(is_pad, pad_p * colsum, o).to(q.dtype)
    return out


@pytest.mark.parametrize("T,window", [(T, w) for T in (300, 513, 1000) for w in (9, 19, 37)]
                         + [(640, 300), (1000, 300)])
def test_span_schedule_equals_plain_on_every_row(T, window):
    """A wholly masked sample, a hole wider than the band and a masked tail:
    padding rows in every tile kind (all rows, some rows, rows past T)."""
    q, k, v, _, mask = (torch.from_numpy(a) for a in _inputs(T * window, 2, 2, T, 16, window))
    got = _emulate_schedule(q, k, v, mask, window)
    want = W.banded_attention_plain(q, k, v, mask, window)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# -------------------------------------------------------------- build names


def test_library_name_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "h.cuh"\nint x;\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert build.library_path("k") == first  # a header it does not include
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.library_path("k") != first
    assert build.library_path("k").parent == build.BUILD_DIR


def test_library_name_hashes_every_part_and_the_headers_headers_include(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint x;\n')
    (tmp_path / "k_2.cu").write_text('#include "h.cuh"\nint y;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "PARTS", {"k": ("k", "k_2")})
    first = build.library_path("k")
    (tmp_path / "g.cuh").write_text("// two\n")  # included by a header
    second = build.library_path("k")
    assert second != first
    (tmp_path / "k_2.cu").write_text('#include "h.cuh"\nint z;\n')  # a part that is not first
    assert build.library_path("k") not in (first, second)
    assert build.library_path("k").name.startswith("libk-")


_FAKE_NVCC = """#!/usr/bin/env python3
import subprocess, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
inputs = [a for a in args if a.endswith((".cu", ".o")) and a != out]
print("ptxas info    : Used 1 registers (" + " ".join(inputs) + ")")
cu = ["-x", "c++"] if any(a.endswith(".cu") for a in inputs) else []
mode = ["-c"] if "-c" in args else ["-shared"]
sys.exit(subprocess.call(["g++", "-fPIC", *mode, "-o", out, *cu, *inputs]))
"""


def test_build_all_compiles_the_parts_apart_and_links_them(tmp_path, monkeypatch):
    """A library of two parts (a C++ compiler in nvcc's place, which this
    machine lacks): each part compiled to an object, linked into one
    library whose entry calls the other part; both reports in its log; no
    object left behind."""
    import ctypes

    fake = tmp_path / "nvcc"
    fake.write_text(_FAKE_NVCC)
    fake.chmod(0o755)
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('extern "C" int part();\nextern "C" int entry() { return 40 + part(); }\n')
    (src / "k_2.cu").write_text('extern "C" int part() { return 2; }\n')
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "PARTS", {"k": ("k", "k_2")})
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    lib = build.build_all(["k"])["k"]
    assert ctypes.CDLL(str(lib)).entry() == 42
    log = lib.with_suffix(".log").read_text()
    assert "k.cu" in log and "k_2.cu" in log and ".o" in log  # the parts, then the link
    assert sorted(p.suffix for p in lib.parent.iterdir()) == [".log", ".so"]
    built = [line for line in log.splitlines() if line.startswith("built ")]
    assert [line.split(" in ")[0] for line in built] == ["built k.cu", "built k_2.cu",
                                                         "built the link"]
    assert build.ptxas_report("k") == built  # the fake reports no kernel or function


def test_ptxas_report_names_registers_spills_and_seconds(tmp_path, monkeypatch):
    """The compilers' report read back: a kernel's spills and registers and
    a device function's spills, one line each, then each source's
    seconds."""
    (tmp_path / "libk.log").write_text(
        "ptxas info    : Compiling entry function 'stack' for 'sm_90a'\n"
        "ptxas info    : Function properties for stack\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"
        "ptxas info    : Function properties for body\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "built k.cu in 3.5 s\n")
    monkeypatch.setattr(build, "build_all", lambda names: {names[0]: tmp_path / "libk.so"})
    assert build.ptxas_report("k") == [
        "stack: spills 8 / 12 bytes (stores / loads)", "stack: 128 registers",
        "body: spills 0 / 0 bytes (stores / loads)", "built k.cu in 3.5 s"]
