"""Where the time of one served batch, or of one train step, goes, on the card.

    python -m vmrframe_tpu_torch.tools.profile_serve [--batch-size 128] [--steps 10]
    python -m vmrframe_tpu_torch.tools.profile_serve --config configs/tacos_actionformer_long.yaml
    python -m vmrframe_tpu_torch.tools.profile_serve --batch-size 128 \
        --config configs/charades_seqpan_fused.yaml
    python -m vmrframe_tpu_torch.tools.profile_serve --train \
        --config configs/tacos_actionformer_long.yaml
    python -m vmrframe_tpu_torch.tools.profile_serve --train \
        --config configs/charades_seqpan_fused.yaml [--droprate 0]
    python -m vmrframe_tpu_torch.tools.profile_serve --train \
        --config configs/charades_oneteacher_softlabel.yaml [--droprate 0]
    python -m vmrframe_tpu_torch.tools.profile_serve [--train] \
        --config configs/charades_seqpan_fused.yaml --data-dir DIR [--workers 8 | --device-pipeline]

``--data-dir DIR`` reads the dataset files that
``testing.write_dataset_files`` wrote under DIR (its ``config.json``'s
``paths``; serving through a lazy store, training through an eager one)
instead of synthetic data; ``--workers N`` assembles each batch on N threads
(``train.num_workers``), ``--device-pipeline`` ships raw features and
resamples them on the card (``dataprocess.device_pipeline``), so that the
host-assembly stage can be profiled under each route.

With ``--train`` (the config's batch, compute type and droprate unless
``--batch-size`` or ``--droprate`` says otherwise): host assembly of one
train batch (the train batcher: its first assembly, which reads and resizes
the videos, and the median of later ones, which find each video's grid
cached), the copy to the card, the train step (forward, loss, backward,
clipping, AdamW, spans, IoU) on the host's clock, and the card's busy time
and device operations per train step from ``torch.profiler``, with the
hand-written kernels' time and launches per step and the device time of the
recomputed backward of #1-#3 (``kernels/attention.py::RECOMPUTE_SPAN``).
Otherwise:

Builds the serving path (bf16, seeded random weights, synthetic data:
``tools/serve.py::build_service``) at SeqPAN's Charades width, or for the
model and widths of ``--config`` (batch 8 unless ``--batch-size`` says
otherwise; ``configs/charades_seqpan_fused.yaml`` is SeqPAN at the same width
with the dual-attention stack as one kernel launch), and times, for one
batch of ``batch-size`` requests, each stage a micro-batch passes through:

- host: request records (tokenize, vocabulary lookup), batch assembly (the
  model's batcher: features, resampling, labels, padding), of which the
  reads of the batch's videos from the store (``host_store_reads_ms``; the
  synthetic store draws them on each read), the copy to the card;
- the eval step (forward, loss, spans, IoU) from its first launch to the
  spans on the host, which waits for the card;
- on the card (``torch.profiler``): busy time per step, the count of device
  operations (kernels and copies) per step, and the kernels that take the
  most time; and each hand-written kernel's launches in one step.

Host times are medians over ``--reps`` runs, from the host's clock.  Prints
one JSON object; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from collections import defaultdict
from typing import Optional

import torch

from vmrframe_tpu_torch.config import load_config
from vmrframe_tpu_torch.tools.serve import build_service, make_cfg


def _median_ms(fn, reps: int):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


# device names of the hand-written kernels' bodies (csrc/*.cu)
HAND_WRITTEN = ("attention_mma", "attention_tf32", "mask_bits_kernel", "cq_kernel",
                "stack_kernel", "banded_", "dq_mma", "dq_tf32", "dkv_mma", "dkv_tf32")


# passes of a profile on the card while the profiler sees no device time, and
# the pause before each further pass (the misses come a few passes in a row)
PROFILE_TRIES, PROFILE_PAUSE_S = 5, 0.2


def _device_profile(step, steps: int, ops: bool = False, device: str = "cuda") -> dict:
    """Busy time and device operations (kernels and copies) per step, the
    kernels that take the most time, and the hand-written ones, over
    ``steps`` steps; and the device time inside ``RECOMPUTE_SPAN`` ranges,
    both as the kernels the profiler attributes to them and as the span the
    range covers on the card.  Ranges (``RECOMPUTE_SPAN``, the kernels'
    ``vmr::`` launch ranges) are kept out of the busy time.

    On the card, a pass in which the profiler recorded no device operation
    at all (CUPTI now and then delivers none) is run again, up to
    ``PROFILE_TRIES`` passes, ``PROFILE_PAUSE_S`` apart; ``profile_passes``
    says how many ran.

    With ``ops``: shapes recorded, and ``ops`` lists each device operation
    per step (``_device_ops``).  On the CPU (``device``), where there is no
    card, the operations are the host's: each ATen operation's own time."""
    from torch.profiler import ProfilerActivity, profile

    on_cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    for passes in range(1, PROFILE_TRIES + 1):
        if passes > 1:
            time.sleep(PROFILE_PAUSE_S)
        with profile(activities=activities, record_shapes=ops, with_flops=ops) as prof:
            for _ in range(steps):
                step()
            if on_cuda:
                torch.cuda.synchronize()
        if not on_cuda:
            return _host_profile(prof, steps)
        report = _card_report(prof, steps, ops)
        if report["device_busy_ms_per_step"] is not None:
            break
    return {**report, "profile_passes": passes}


def _card_report(prof, steps: int, ops: bool) -> dict:
    """``_device_profile``'s report of one pass on the card."""
    from vmrframe_tpu_torch.kernels.attention import RECOMPUTE_SPAN

    per_kernel = defaultdict(lambda: [0.0, 0])
    span_kernels_ms = span_device_ms = 0.0
    for evt in prof.events():
        on_card = evt.device_type == torch.autograd.DeviceType.CUDA
        if evt.name == RECOMPUTE_SPAN:  # a range, not a kernel: kept out of the busy time
            if on_card:
                span_device_ms += evt.device_time_total / 1e3
            else:
                span_kernels_ms += evt.device_time_total / 1e3
        elif on_card and not evt.name.startswith(LAUNCH_RANGE):
            slot = per_kernel[evt.name]
            slot[0] += evt.device_time_total / 1e3  # us -> ms
            slot[1] += 1
    if not per_kernel:
        return {"device_busy_ms_per_step": None, "note": "the profiler saw no device time"}
    busy = sum(ms for ms, _ in per_kernel.values()) / steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    row = lambda name, ms, n: {"name": name[:90], "ms_per_step": ms / steps,  # noqa: E731
                               "calls_per_step": n / steps}
    report = {
        "device_busy_ms_per_step": busy,
        "device_ops_per_step": sum(n for _, n in per_kernel.values()) / steps,
        "top_kernels": [row(name, ms, n) for name, (ms, n) in top],
        "hand_written_kernels": [row(name, ms, n) for name, (ms, n) in per_kernel.items()
                                 if any(k in name for k in HAND_WRITTEN)],
        "recompute_backward_kernels_ms_per_step": span_kernels_ms / steps,
        "recompute_backward_device_span_ms_per_step": span_device_ms / steps,
    }
    if ops:
        report["ops"] = _device_ops(prof, steps)
    return report


LAUNCH_RANGE = "vmr::"  # kernels.launch_range's prefix
CHAIN_DEPTH = 12  # enclosing operations kept per device operation


def _chain(evt) -> list:
    """[name, input shapes] of ``evt`` and the operations and ranges that
    enclose it, innermost first (ATen operations and ``vmr::`` ranges)."""
    out = []
    while evt is not None and len(out) < CHAIN_DEPTH:
        if evt.name.startswith(("aten::", LAUNCH_RANGE)):
            out.append([evt.name, [list(s) for s in (evt.input_shapes or [])]])
        evt = evt.cpu_parent
    return out


def _device_ops(prof, steps: int) -> list:
    """Each device operation (a kernel, copy or memset) per step: its name,
    the chain of ATen operations that launched it (through the profiler's
    correlation ids), its device ms and launches per step.  Ranges are not
    operations.  A hand-written kernel, launched outside any ATen operation,
    takes the ``vmr::`` range whose span on the card holds it (a range
    links no launch through the correlation ids)."""
    from bisect import bisect_right

    from vmrframe_tpu_torch.kernels.attention import RECOMPUTE_SPAN

    by_id = {evt.id: evt for evt in prof.events()
             if evt.device_type == torch.autograd.DeviceType.CPU}
    events = [evt for evt in prof.profiler.kineto_results.events()
              if evt.device_type() == torch.autograd.DeviceType.CUDA]
    spans = sorted((evt.start_ns(), evt.end_ns(), evt.name()) for evt in events
                   if evt.name().startswith(LAUNCH_RANGE))
    starts = [s for s, _, _ in spans]

    def launch_range(evt):
        i = bisect_right(starts, evt.start_ns()) - 1
        if i >= 0 and evt.end_ns() <= spans[i][1]:
            return [[spans[i][2], []]]
        return []

    rows = {}
    for evt in events:
        name = evt.name()
        if name == RECOMPUTE_SPAN or name.startswith(LAUNCH_RANGE) \
                or getattr(evt, "is_user_annotation", lambda: False)():
            continue
        chain = _chain(by_id.get(evt.linked_correlation_id())) or launch_range(evt)
        row = rows.setdefault(json.dumps([name, chain]), {"name": name, "chain": chain,
                                                          "ns": 0, "launches": 0})
        row["ns"] += evt.duration_ns()
        row["launches"] += 1
    return sorted(({"name": r["name"], "chain": r["chain"], "ms_per_step": r["ns"] / 1e6 / steps,
                    "launches_per_step": r["launches"] / steps} for r in rows.values()),
                  key=lambda r: -r["ms_per_step"])


def _host_profile(prof, steps: int) -> dict:
    """``_device_profile`` on the CPU: each ATen operation's own host time
    (its time less its children's) as a device operation; the operations
    inside a kernel's ``vmr::`` range (its plain version) as one launch of
    that range."""
    rows = {}
    for evt in prof.events():
        if not evt.name.startswith("aten::") or evt.self_cpu_time_total <= 0:
            continue
        op = evt
        while op is not None and not op.name.startswith(LAUNCH_RANGE):
            op = op.cpu_parent
        op = op or evt
        chain = _chain(op)
        row = rows.setdefault(json.dumps([op.name, chain]), {
            "name": op.name, "chain": chain, "ms_per_step": 0.0, "ids": set()})
        row["ms_per_step"] += evt.self_cpu_time_total / 1e3 / steps
        row["ids"].add(op.id)
    ops = sorted(({**{k: v for k, v in r.items() if k != "ids"},
                   "launches_per_step": len(r["ids"]) / steps} for r in rows.values()),
                 key=lambda r: -r["ms_per_step"])
    return {"device_busy_ms_per_step": sum(r["ms_per_step"] for r in ops),
            "device_ops_per_step": sum(r["launches_per_step"] for r in ops),
            "top_kernels": [{"name": r["name"][:90], "ms_per_step": r["ms_per_step"],
                             "calls_per_step": r["launches_per_step"]} for r in ops[:15]],
            "hand_written_kernels": [], "ops": ops,
            "note": "the CPU: host time of each ATen operation, no card"}


def with_routes(cfg, data_dir: Optional[str] = None, workers: Optional[int] = None,
                device_pipeline: bool = False):
    """``cfg`` with the paths of the dataset files under ``data_dir`` and the
    batch assembly's route."""
    updates = {}
    if data_dir:
        updates["paths"] = {**(cfg.get("paths").to_dict() if cfg.get("paths") else {}),
                            **load_config(os.path.join(data_dir, "config.json")).paths.to_dict()}
    if workers is not None:
        updates["train.num_workers"] = workers
    if device_pipeline:
        updates["dataprocess.device_pipeline"] = True
    return cfg.updated(updates)


def _route(cfg, batch) -> dict:
    """Where the data came from and how the batch was assembled (the batcher
    keeps the host route where the device pipeline does not apply)."""
    return {"data": "files" if (cfg.get("paths") or {}).get("feature_path") else "synthetic",
            "num_workers": int(cfg.train.get("num_workers", 0)),
            "device_pipeline": "raw_vfeats" in batch}


def profile_serve(batch_size: int = 128, steps: int = 10, reps: int = 20,
                  config: Optional[str] = None, data_dir: Optional[str] = None,
                  workers: Optional[int] = None, device_pipeline: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve measures the card: no CUDA device is available")
    if config:
        cfg = load_config(config).updated({"train.compute_dtype": "bfloat16",
                                           "train.batch_size": batch_size})
    else:
        cfg = make_cfg(batch_size=batch_size)
    cfg = with_routes(cfg, data_dir, workers, device_pipeline)
    service, dataset = build_service(cfg, n_synthetic=batch_size, device="cuda",
                                     synthetic=not data_dir)
    try:
        ev = service.evaluator
        reqs = dataset["test_set"][:batch_size]
        make = lambda: [service._make_record(r["vid"], r["sentence"], r["duration"])  # noqa: E731
                        for r in reqs]
        record_ms, records = _median_ms(make, reps)
        vids = sorted({r["vid"] for r in records})  # a batch reads each video once
        reads_ms, _ = _median_ms(lambda: [service.store[v] for v in vids], reps)
        assemble_ms, batch = _median_ms(lambda: service._assemble(records), reps)
        h2d_ms, dbatch = _median_ms(lambda: ev.to_device(batch), reps)
        step = lambda: ev.eval_step(dbatch)["props"].cpu()  # noqa: E731
        step_ms, _ = _median_ms(step, reps)
        from vmrframe_tpu_torch.kernels import attention, dual_stack, window_attention

        kernels = attention.KERNELS + dual_stack.KERNELS + window_attention.KERNELS
        counts = [fn.launches for fn in kernels]
        step()
        report = {
            "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
            "model": str(cfg.model.name), "config": config or "tools/serve.py::make_cfg",
            **_route(cfg, batch),
            "fused_dual_stack": bool(cfg.model.get("fused_dual_stack", False)),
            "launches_per_step": {fn.__name__: fn.launches - c for fn, c in zip(kernels, counts)},
            "batch_size": batch_size, "dtype": "bfloat16",
            "host_records_ms": record_ms, "host_assemble_ms": assemble_ms,
            "host_store_reads_ms": reads_ms,
            "h2d_ms": h2d_ms, "eval_step_ms": step_ms,
            "batch_total_ms": record_ms + assemble_ms + h2d_ms + step_ms,
            **_device_profile(step, steps),
        }
        busy = report["device_busy_ms_per_step"]
        report["device_busy_share_of_eval_step"] = busy / step_ms if busy else None
        return report
    finally:
        service.close()


def profile_train(config: str, batch_size: Optional[int] = None, steps: int = 10,
                  reps: int = 20, droprate: Optional[float] = None,
                  data_dir: Optional[str] = None, workers: Optional[int] = None,
                  device_pipeline: bool = False) -> dict:
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.device import strict_f32
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve measures the card: no CUDA device is available")
    strict_f32()  # as the CLI trains
    cfg = load_config(config)
    if batch_size:
        cfg = cfg.updated({"train.batch_size": batch_size})
    if droprate is not None:  # a distillation config's teacher too
        cfg = cfg.updated({"model.droprate": droprate, **(
            {"teacher0.model.droprate": droprate} if cfg.get("teacher0") else {})})
    cfg = with_routes(cfg, data_dir, workers, device_pipeline)
    B = int(cfg.train.batch_size)
    if data_dir:
        from vmrframe_tpu_torch.data.datasets import load_dataset
        from vmrframe_tpu_torch.data.features import open_feature_store

        store = open_feature_store(cfg.paths.feature_path, cfg.model.vlen)
        dataset = load_dataset(cfg, Derived(), vfeat_lens=store.lengths())
    else:
        dataset, store = make_synthetic_data(cfg, seed=0, n_train=max(64, B))
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    batcher = (get_model_entry(cfg.model.name).batcher_cls or Batcher)(
        dataset["train_set"], store, cfg, derived, "train")
    derived.num_train_steps = derived.steps_per_epoch = len(batcher)
    trainer = Trainer(cfg, derived, dataset["word_vector"], device="cuda")
    indices = list(range(B))
    first_ms, _ = _median_ms(lambda: batcher.make_batch(indices), 1)  # reads and resizes
    assemble_ms, batch = _median_ms(lambda: batcher.make_batch(indices), reps)  # cached grids
    h2d_ms, dbatch = _median_ms(lambda: trainer.to_device(batch), reps)
    step = lambda: float(trainer.train_step(dbatch)["loss"])  # noqa: E731
    step()  # warm-up: cuDNN's and the allocator's first calls
    step_ms, _ = _median_ms(step, reps)
    from vmrframe_tpu_torch.kernels import attention, dual_stack, window_attention

    kernels = attention.KERNELS + dual_stack.KERNELS + window_attention.KERNELS
    counts = [fn.launches for fn in kernels]
    step()
    report = {
        "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "model": str(cfg.model.name), "config": config, "mode": "train", "batch_size": B,
        **_route(cfg, batch), "augmentation": list(batcher.aug),
        "dtype": str(cfg.train.get("compute_dtype", "float32")),
        "droprate": cfg.model.get("droprate"),
        "launches_per_step": {fn.__name__: fn.launches - c for fn, c in zip(kernels, counts)},
        "host_assemble_first_ms": first_ms, "host_assemble_ms": assemble_ms,
        "h2d_ms": h2d_ms, "train_step_ms": step_ms,
        "samples_per_s": B / (step_ms / 1e3),
        **_device_profile(step, steps),
    }
    busy = report["device_busy_ms_per_step"]
    report["device_busy_share_of_train_step"] = busy / step_ms if busy else None
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="YAML config to serve (default: SeqPAN at Charades width)")
    ap.add_argument("--train", action="store_true",
                    help="profile a train step of --config instead of a served batch")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="requests per batch (default: 128, or 8 with --config)")
    ap.add_argument("--droprate", type=float, default=None,
                    help="--train: override model.droprate (0 puts #1-#3 on the train route)")
    ap.add_argument("--data-dir", default=None,
                    help="the dataset files testing.write_dataset_files wrote here")
    ap.add_argument("--workers", type=int, default=None,
                    help="assemble batches on this many threads (train.num_workers)")
    ap.add_argument("--device-pipeline", action="store_true",
                    help="resample and label on the card (dataprocess.device_pipeline)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.train:
        if not args.config:
            ap.error("--train needs --config")
        report = profile_train(args.config, args.batch_size, args.steps, args.reps,
                               args.droprate, args.data_dir, args.workers, args.device_pipeline)
    else:
        batch_size = args.batch_size or (8 if args.config else 128)
        report = profile_serve(batch_size, args.steps, args.reps, args.config, args.data_dir,
                               args.workers, args.device_pipeline)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
