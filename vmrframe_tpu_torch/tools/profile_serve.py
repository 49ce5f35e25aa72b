"""Where the time of one served batch goes, on the card.

    python -m vmrframe_tpu_torch.tools.profile_serve [--batch-size 128] [--steps 10]

Builds the serving path at SeqPAN's Charades width (bf16, seeded random
weights, synthetic data: ``tools/serve.py::build_service``) and times, for one
batch of ``batch-size`` requests, each stage a micro-batch passes through:

- host: request records (tokenize, vocabulary lookup), batch assembly
  (``Batcher``: resampling, labels, padding), the copy to the card;
- the eval step (forward, loss, spans, IoU) from its first launch to the
  spans on the host, which waits for the card;
- on the card (``torch.profiler``): busy time per step, the count of device
  operations (kernels and copies) per step, and the kernels that take the
  most time.

Host times are medians over ``--reps`` runs, from the host's clock.  Prints
one JSON object; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import torch

from vmrframe_tpu_torch.tools.serve import build_service, make_cfg


def _median_ms(fn, reps: int):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _device_profile(step, steps: int) -> dict:
    """Busy time and device operations (kernels and copies) per step, and
    the kernels that take the most time, over ``steps`` eval steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            slot = per_kernel[evt.name]
            slot[0] += evt.device_time_total / 1e3  # us -> ms
            slot[1] += 1
    if not per_kernel:
        return {"device_busy_ms_per_step": None, "note": "the profiler saw no device time"}
    busy = sum(ms for ms, _ in per_kernel.values()) / steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "device_busy_ms_per_step": busy,
        "device_ops_per_step": sum(n for _, n in per_kernel.values()) / steps,
        "top_kernels": [{"name": name[:90], "ms_per_step": ms / steps, "calls_per_step": n / steps}
                        for name, (ms, n) in top],
    }


def profile_serve(batch_size: int = 128, steps: int = 10, reps: int = 20) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve measures the card: no CUDA device is available")
    cfg = make_cfg(batch_size=batch_size)
    service, dataset = build_service(cfg, n_synthetic=batch_size, device="cuda")
    try:
        ev = service.evaluator
        reqs = dataset["test_set"][:batch_size]
        make = lambda: [service._make_record(r["vid"], r["sentence"], r["duration"])  # noqa: E731
                        for r in reqs]
        record_ms, records = _median_ms(make, reps)
        assemble_ms, batch = _median_ms(lambda: service._assemble(records), reps)
        h2d_ms, dbatch = _median_ms(lambda: ev.to_device(batch), reps)
        step = lambda: ev.eval_step(dbatch)["props"].cpu()  # noqa: E731
        step_ms, _ = _median_ms(step, reps)
        report = {
            "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
            "batch_size": batch_size, "dtype": "bfloat16",
            "host_records_ms": record_ms, "host_assemble_ms": assemble_ms,
            "h2d_ms": h2d_ms, "eval_step_ms": step_ms,
            "batch_total_ms": record_ms + assemble_ms + h2d_ms + step_ms,
            **_device_profile(step, steps),
        }
        busy = report["device_busy_ms_per_step"]
        report["device_busy_share_of_eval_step"] = busy / step_ms if busy else None
        return report
    finally:
        service.close()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    report = profile_serve(args.batch_size, args.steps, args.reps)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
