#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``vmrframe_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out record.json]

Phases, in order; any failure exits non-zero:

1. card: fails without CUDA; prints ``nvidia-smi``'s name and power limit.
2. build: compiles the CUDA kernels from ``vmrframe_tpu_torch/kernels/csrc``.
3. check: each kernel against its plain PyTorch version on the card, at the
   shapes SeqPAN's Charades forward gives it (B=128, 4 heads of 32, L=64
   video and 30 text positions, D=128), in f32 and bf16, with random
   lengths and wholly masked rows.
4. time: each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (``library_ms``), in bf16, timed
   with CUDA events; beside each, the least time the card could take.
5. serve: SeqPAN at the full width of its Charades config, seeded random
   weights, bf16, behind the port's ``MomentRetrievalService``; a few
   hundred concurrent ``predict`` calls; the kernels' launch counts must be
   4 dual, 2 CQ and 2 masked per forward.
6. verify: one f32 batch through the kernels on the card and through the
   plain versions on the CPU; the logits must agree.

Prints one ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  ``--out`` also writes the full record
(every timing with its spread) to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense tensor-core bf16; f32 CUDA cores
B, H, HD, LV, LT, D = 128, 4, 32, 64, 30, 128
TOL_F32 = 1e-4  # f32 sums taken in another order, expf against torch.exp
BF16_ULPS = 2.0 ** -6  # bf16 check: 2-4 ulps of the output's largest magnitude
TOL_MODEL_F32 = 1e-3  # whole f32 forward, card against CPU: ~40 layers of reordered f32 sums
N_REQUESTS, CONCURRENCY, NUM_WORDS = 1024, 256, 1000
SLEEP_CYCLES = 100_000_000  # ~50 ms of GPU clock: the host queues a timed run meanwhile
REPLACES = {
    "fused_masked_attention": "vmrframe_tpu/kernels/attention.py:65",
    "fused_dual_attention": "vmrframe_tpu/kernels/attention.py:116",
    "fused_cq_attention": "vmrframe_tpu/kernels/attention.py:188",
}
SOURCE = "vmrframe_tpu_torch/kernels/csrc/attention.cu"


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs


def lengths_mask(g: torch.Generator, L: int) -> torch.Tensor:
    """(B, L) {0,1} mask of random valid lengths; sample 0 is wholly padded."""
    lens = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
    lens[0] = 0
    return (torch.arange(L, device="cuda")[None] < lens[:, None]).float()


def kernel_cases(g: torch.Generator):
    """name -> list of argument tuples, one per shape the forward launches."""
    vm, tm = lengths_mask(g, LV), lengths_mask(g, LT)
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731
    heads = lambda L: torch.randn(B, H, L, HD, generator=g, device="cuda")  # noqa: E731
    rows = lambda L: torch.randn(B, L, D, generator=g, device="cuda")  # noqa: E731
    bound = math.sqrt(6.0 / (D + 1))
    vec = lambda *s: (torch.rand(*s, generator=g, device="cuda") * 2 - 1) * bound  # noqa: E731
    w4C, w4Q, w4mlu = vec(D, 1), vec(D, 1), vec(1, 1, D)
    return {
        "fused_masked_attention": [(heads(LV), heads(LV), heads(LV), outer(vm, vm))],
        "fused_dual_attention": [
            (heads(LV), heads(LV), heads(LV), heads(LT), heads(LT), outer(vm, vm), outer(vm, tm)),
            (heads(LT), heads(LT), heads(LT), heads(LV), heads(LV), outer(tm, tm), outer(tm, vm)),
        ],
        "fused_cq_attention": [(rows(LV), rows(LT), w4C, w4Q, w4mlu, vm, tm),
                               (rows(LT), rows(LV), w4C, w4Q, w4mlu, tm, vm)],
    }


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# ------------------------------------------------------------ bounds


def work(name: str, args) -> tuple:
    """(bytes, operations) the function needs: each input read once, each
    output written once; the operations are its matrix products."""
    size = args[0].element_size()
    if name == "fused_cq_attention":
        c, q = args[0], args[1]
        Lc, Lq = c.shape[1], q.shape[1]
        elems = B * Lc * D + B * Lq * D + 3 * D + B * (Lc + Lq) + 2 * B * Lc * D
        ops = B * (8 * Lc * Lq * D + 2 * (Lc + Lq) * D + Lc * D)
        return elems * size, ops
    L = args[0].shape[2]
    # Lk of each branch: (q, k, v, mask) or (q, f_k, f_v, t_k, t_v, s_mask, x_mask)
    keys = [args[1].shape[2]] if name == "fused_masked_attention" else \
        [args[1].shape[2], args[3].shape[2]]
    elems = B * H * L * HD * (1 + len(keys))  # q, and one output per branch
    elems += sum(2 * B * H * Lk * HD + B * L * Lk for Lk in keys)  # k, v, mask
    ops = sum(4 * B * H * L * Lk * HD for Lk in keys)
    return elems * size, ops


def bound_ms(name: str, args) -> tuple:
    nbytes, ops = work(name, args)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[args[0].dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ timing


def device_ms(fn, n: int = 20, reps: int = 5) -> dict:
    """Per-call device time of ``fn``: CUDA events around ``n`` calls queued
    behind a sleep kernel, so host overhead does not show; median of reps."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def sdpa_masked(q, k, v, mask):
    add = ((1.0 - mask) * -1e30).to(q.dtype)[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add)


def library_call(name: str, args):
    """One PyTorch call computing the same function, or None; timed only."""
    if name == "fused_masked_attention":
        return sdpa_masked(*args)
    if name == "fused_dual_attention":
        q, fk, fv, tk, tv, s_mask, x_mask = args
        s, x = sdpa_masked(q, fk, fv, s_mask), sdpa_masked(q, tk, tv, x_mask)
        return lambda: (s(), x())
    return None  # CQ attention: no single PyTorch call computes it


# ------------------------------------------------------------ phases


def phase_build() -> dict:
    from vmrframe_tpu_torch.kernels import attention as K
    from vmrframe_tpu_torch.kernels import build

    t0 = time.perf_counter()
    K.load_kernels()
    seconds = time.perf_counter() - t0
    log(f"[build] {SOURCE} built and loaded in {seconds:.1f} s")
    report = build.library_path("attention").with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "Function properties" in line or "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    return {"seconds": seconds}


def phase_check(K, cases) -> dict:
    plain = {"fused_masked_attention": K.masked_attention_plain,
             "fused_dual_attention": K.dual_attention_plain,
             "fused_cq_attention": K.cq_attention_plain}
    results = {}
    for name, shapes in cases.items():
        wrapper = getattr(K, name)
        for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            err, tol = 0.0, 0.0
            for args in shapes:
                args = tuple(a.to(dtype) for a in args)
                got = as_tuple(wrapper(*args))
                want = as_tuple(plain[name](*args))
                torch.cuda.synchronize()
                for g_, w_ in zip(got, want):
                    if g_.shape != w_.shape or not torch.isfinite(g_.float()).all():
                        raise SmokeFailure(f"{name} {key}: bad output {tuple(g_.shape)}")
                    err = max(err, (g_.float() - w_.float()).abs().max().item())
                    scale = max(1.0, w_.float().abs().max().item())
                    tol = max(tol, TOL_F32 if dtype == torch.float32 else BF16_ULPS * scale)
            ok = err <= tol
            log(f"[check] {name:24s} {key:5s} max_abs_err {err:.3e}  tol {tol:.3e}  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SmokeFailure(f"{name} {key}: kernel and plain version disagree")
            results.setdefault(name, {})[key] = {"max_abs_err": err, "tol": tol}
    return results


def phase_time(K, cases, card: str) -> dict:
    plain = {"fused_masked_attention": K.masked_attention_plain,
             "fused_dual_attention": K.dual_attention_plain,
             "fused_cq_attention": K.cq_attention_plain}
    log(f"[time] bf16, per call, on {card}")
    results = {}
    for name, shapes in cases.items():
        wrapper = getattr(K, name)
        rows = []
        for args in shapes:
            args = tuple(a.to(torch.bfloat16) for a in args)
            lib = library_call(name, args)
            row = {
                "shape": [list(a.shape) for a in args[:2]],
                "ms": device_ms(lambda: wrapper(*args)),
                "plain_ms": device_ms(lambda: plain[name](*args)),
                "library_ms": device_ms(lib) if lib else None,
            }
            row["bound_ms"], row["bound_by"] = bound_ms(name, args)
            rows.append(row)
            lib_txt = f"{row['library_ms']['median']:.4f}" if lib else \
                "none (no single PyTorch call computes it)"
            log(f"[time] {name:24s} {row['shape']}  kernel {row['ms']['median']:.4f} ms  "
                f"plain {row['plain_ms']['median']:.4f}  library {lib_txt}  "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
        mean = lambda key: statistics.mean(r[key]["median"] for r in rows)  # noqa: E731
        results[name] = {
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "library_ms": mean("library_ms") if rows[0]["library_ms"] else None,
            "bound_ms": statistics.mean(r["bound_ms"] for r in rows),
            "bound_by": rows[0]["bound_by"], "shapes": rows,
        }
    return results


def charades_vocab(dataset, num_words: int, seed: int) -> None:
    """Pads the synthetic vocabulary to ``num_words`` entries with seeded
    GloVe-like vectors, the table size of the Charades benchmark config."""
    words, vectors = dataset["word_dict"], dataset["word_vector"]
    rng = np.random.default_rng(seed)
    extra = num_words - len(words)
    for i in range(extra):
        words[f"<filler{i}>"] = len(words)
    filler = rng.standard_normal((extra, vectors.shape[1])).astype(np.float32) * 0.1
    dataset["word_vector"] = np.concatenate([vectors, filler])
    dataset["n_words"] = len(words)


def phase_serve(K, card: str):
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.tools.serve import MomentRetrievalService, make_cfg

    cfg = make_cfg()  # SeqPAN at Charades width, batch 128, bf16
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=B, n_test=2 * B)
    charades_vocab(dataset, NUM_WORDS, seed=0)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    service = MomentRetrievalService(cfg, derived, dataset["word_dict"], dataset["char_dict"],
                                     dataset["word_vector"], store, device="cuda", seed=0)
    boot_s = time.perf_counter() - t0
    records = dataset["test_set"]
    lat, results = [], []
    lock = threading.Lock()

    def one(i):
        rec = records[i % len(records)]
        t = time.perf_counter()
        out = service.predict(rec["vid"], rec["sentence"], rec["duration"])
        dt = time.perf_counter() - t
        with lock:
            lat.append(dt)
            results.append(out["pred_frac"])

    try:
        batches0 = service.metrics()["batches"]
        for fn in K.KERNELS:
            fn.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=CONCURRENCY) as ex:
            list(ex.map(one, range(N_REQUESTS)))
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in K.KERNELS}
        metrics = service.metrics()
    finally:
        service.close()
    forwards = metrics["batches"] - batches0
    peak = torch.cuda.max_memory_allocated()
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    fracs = np.asarray(results)
    stats = {
        "card": card, "model": "SeqPAN", "batch_size": service.batch_size, "dtype": "bfloat16",
        "vlen": LV, "tlen": LT, "vdim": int(cfg.model.vdim), "dim": D, "heads": H,
        "num_words": dataset["n_words"], "requests": N_REQUESTS, "concurrency": CONCURRENCY,
        "forwards": forwards, "boot_s": boot_s, "wall_s": wall, "qps": N_REQUESTS / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
        "peak_device_mem_bytes": peak, "launches": launches,
    }
    log(f"[serve] {json.dumps(stats)}")
    if metrics["requests_ok"] < N_REQUESTS or metrics["requests_error"]:
        raise SmokeFailure(f"serve: {metrics}")
    if fracs.shape != (N_REQUESTS, 2) or not np.isfinite(fracs).all() \
            or fracs.min() < 0 or fracs.max() > 1:
        raise SmokeFailure("serve: predicted fractions are not finite spans in [0, 1]")
    want = {"fused_dual_attention": 4, "fused_cq_attention": 2, "fused_masked_attention": 2}
    for name, per_forward in want.items():
        if forwards < 1 or launches[name] != per_forward * forwards:
            raise SmokeFailure(f"serve: {launches[name]} launches of {name} in {forwards} "
                               f"forwards, want {per_forward} per forward")
    log("[serve] launches per forward: " +
        ", ".join(f"{k} {v // forwards}" for k, v in launches.items()))
    return stats, dataset, store, derived, cfg


def phase_verify(cfg, derived, dataset, store) -> dict:
    """One f32 batch: kernels on the card against the plain versions on the CPU."""
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    cfg32 = cfg.updated({"train.compute_dtype": "float32"})
    batch = Batcher(dataset["test_set"], store, cfg32, derived).make_batch(list(range(B)))
    outs = {}
    for device in ("cuda", "cpu"):
        ev = Evaluator(cfg32, derived, dataset["word_vector"], device=device, seed=0)
        out = ev.forward(ev.to_device(batch))
        outs[device] = {k: out[k].cpu() for k in ("slogits", "elogits")}
    errs = {}
    for key in ("slogits", "elogits"):
        got, want = outs["cuda"][key], outs["cpu"][key]
        if got.shape != (B, LV) or not torch.isfinite(got).all():
            raise SmokeFailure(f"verify: {key} is not a finite ({B}, {LV}) tensor")
        errs[key] = (got - want).abs().max().item()
    ok = max(errs.values()) <= TOL_MODEL_F32
    log(f"[verify] f32 forward, kernels on the card vs plain on the CPU: "
        f"{json.dumps(errs)}  tol {TOL_MODEL_F32}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("verify: kernel path and plain path disagree")
    return {"max_abs_err": errs, "tol": TOL_MODEL_F32}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the full record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    from vmrframe_tpu_torch.kernels import attention as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    record = {"card": card, "build": phase_build()}
    cases = kernel_cases(torch.Generator(device="cuda").manual_seed(0))
    record["check"] = phase_check(K, cases)
    record["time"] = phase_time(K, cases, card)
    record["serve"], dataset, store, derived, cfg = phase_serve(K, card)
    record["verify"] = phase_verify(cfg, derived, dataset, store)

    kernels = []
    for fn in K.KERNELS:
        name, t = fn.__name__, record["time"][fn.__name__]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": record["serve"]["launches"][name],
            "max_abs_err": record["check"][name]["bf16"]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "dtype": "bfloat16", "tol": record["check"][name]["bf16"]["tol"],
            "max_abs_err_f32": record["check"][name]["f32"]["max_abs_err"],
            "card": card,
        })
    record["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
