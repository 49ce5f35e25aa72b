"""Train steps fed by the host batcher against the on-device input pipeline
(counterpart of ``vmrframe_tpu/tools/bench_pipeline.py``).

An augmented configuration (erosion: the reference's TACoS SeqPAN config
ships 0.05) pays the batcher's resampling and labelling on the host, or,
with ``dataprocess.device_pipeline``, ships raw features and does that work
in the step on the device (``ops/input_pipeline.py``).  For each case and
each route: the host's assembly time of the first batches of an epoch, then
train steps fed as ``fit`` feeds them (the batcher on a prefetch thread),
host clock per step from taking the batch to the loss on the host, the
median over ``--steps`` after ``--warmup``, and on the card the busy share
of a step from ``torch.profiler``.  ``chip_smoke.py``'s pipeline phase
times its routes with ``time_route``.

Cases, from the repository's SeqPAN config at Charades width
(``configs/charades_seqpan_fused.yaml``, batch 128, bf16), on synthetic
data: ``tacos_seqpan_erosion`` at TACoS's video length (vlen 256) with
erosion 0.05, and ``charades_seqpan_erosion`` at Charades width with erosion
0.05.

Writes ``--out`` (JSON) and one JSON line a case to stdout; never the JAX
package's ``docs/*.json``.

    python -m vmrframe_tpu_torch.tools.bench_pipeline --out chiprun_out/bench_pipeline.json
    python -m vmrframe_tpu_torch.tools.bench_pipeline --device cpu --batch-size 4 --steps 2
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Callable, Optional

import torch

EROSION = {"erosion": 0.05}
CASES = {
    "tacos_seqpan_erosion": ("configs/charades_seqpan_fused.yaml",
                             {"task": "tacos", "model.vlen": 256,
                              "dataprocess.video_augmentation": EROSION}),
    "charades_seqpan_erosion": ("configs/charades_seqpan_fused.yaml",
                                {"dataprocess.video_augmentation": EROSION}),
}
ROUTES = {"host": False, "device": True}  # dataprocess.device_pipeline
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_route(cfg, derived, dataset, store, device, n_warmup: int = 2, n_timed: int = 10,
               n_assembled: int = 4, n_profiled: int = 4,
               after_timed: Optional[Callable[[], object]] = None) -> dict:
    """One route of batch assembly: the host's assembly ms of the first
    ``n_assembled`` batches of an epoch; then ``n_warmup + n_timed`` train
    steps fed through a ``BatchPrefetcher``, host clock per step ending in
    the loss on the host; ``after_timed`` runs after them (a caller's
    launch-count check); on the card the busy share of ``n_profiled`` more.
    The losses are returned for the caller to check."""
    from vmrframe_tpu_torch.data.batcher import Batcher, BatchPrefetcher
    from vmrframe_tpu_torch.train.trainer import Trainer

    batcher = Batcher(dataset["train_set"], store, cfg, derived, "train")
    epoch = batcher.epoch(seed=0)
    assembly = []
    for _ in range(n_assembled):
        t0 = time.perf_counter()
        batch = next(epoch)
        assembly.append((time.perf_counter() - t0) * 1e3)
    trainer = Trainer(cfg, derived, dataset["word_vector"], device=device)

    def stream():
        for seed in range(1, 1000):
            yield from batcher.epoch(seed=seed)

    feed = BatchPrefetcher(stream())
    step = lambda: float(trainer.train_step(trainer.to_device(next(feed)))["loss"])  # noqa: E731
    times, losses, profiled = [], [], {}
    try:
        for _ in range(n_warmup + n_timed):
            t0 = time.perf_counter()
            losses.append(step())
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        if after_timed is not None:
            after_timed()
        if n_profiled and torch.device(device).type == "cuda":
            from vmrframe_tpu_torch.tools.profile_serve import _device_profile

            profiled = _device_profile(step, n_profiled)
    finally:
        feed.close()
    timed = times[n_warmup:]
    median = statistics.median(timed)
    busy = profiled.get("device_busy_ms_per_step")
    return {"device_pipeline": "raw_vfeats" in batch, "num_workers": batcher.num_workers,
            "augmentation": list(batcher.aug), "batch_size": int(cfg.train.batch_size),
            "assembly_ms_median": statistics.median(assembly), "assembly_ms": assembly,
            "step_ms_median": median, "step_ms_min": min(timed), "step_ms_max": max(timed),
            "steps": len(timed), "samples_per_s": int(cfg.train.batch_size) / (median / 1e3),
            "device_busy_ms_per_step": busy,
            "device_ops_per_step": profiled.get("device_ops_per_step"),
            "top_device_ops": profiled.get("top_kernels", [])[:6],
            "device_busy_share": busy / median if busy else None, "losses": losses}


def bench_case(name: str, device, n_warmup: int, n_timed: int,
               batch_size: Optional[int] = None) -> dict:
    """Both routes of one case on the same synthetic data."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.testing import make_synthetic_data

    path, overrides = CASES[name]
    base = load_config(os.path.join(REPO, path)).updated(overrides)
    if batch_size:
        base = base.updated({"train.batch_size": int(batch_size)})
    B = int(base.train.batch_size)
    dataset, store = make_synthetic_data(base, seed=0, n_train=4 * B, n_test=B)
    out = {"case": name, "config": path, "overrides": overrides, "on": str(device)}
    for route, flag in ROUTES.items():
        cfg = base.updated({"dataprocess.device_pipeline": flag})
        derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"],
                          num_train_steps=1000, steps_per_epoch=4)
        out[route] = time_route(cfg, derived, dataset, store, device, n_warmup, n_timed)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    out["speedup"] = out["host"]["step_ms_median"] / out["device"]["step_ms_median"]
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=None, help="override train.batch_size")
    ap.add_argument("--out", default="chiprun_out/bench_pipeline.json")
    args = ap.parse_args(argv)

    from vmrframe_tpu_torch.device import resolve_device, strict_f32

    device = resolve_device(args.device)
    strict_f32()
    results = []
    for name in (n.strip() for n in args.cases.split(",") if n.strip()):
        res = bench_case(name, device, args.warmup, args.steps, args.batch_size)
        print(json.dumps(res), flush=True)
        results.append(res)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": str(device), "card": torch.cuda.get_device_name(0)
                       if device.type == "cuda" else "cpu", "results": results}, f, indent=1)
    return results


if __name__ == "__main__":
    main()
