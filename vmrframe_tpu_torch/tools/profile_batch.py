"""How SeqPAN's eval step scales with the batch (counterpart of
``vmrframe_tpu/tools/profile_batch.py``).

For each batch size (128, 256, 512 and 1024 by default), SeqPAN at
Charades width in bf16 (``tools/roofline.py::seqpan_eval``, one world
built at the largest batch, each batch its first rows), with the video
features rolled by one more frame each step (new data every step, as a
server sees it):

- ``roll_only``: the roll alone;
- ``fwd_only``: the roll and the forward;
- ``fwd_infer``: the roll, the forward and span inference, through
  ``ops/chunked.py::chunked_batch_apply`` with ``--chunk N``;

each timed by ``bench_zoo.time_steps`` (steps queued between two
synchronizes, median of reps), with queries a second, and, of
``fwd_infer``, the counted GFLOP and bytes (``roofline.count_traffic``)
and the device operations (``profile_serve._device_profile``).  Whether
the step slows down per query past some batch on the card is what this
measures.

    python -m vmrframe_tpu_torch.tools.profile_batch --out chiprun_out/profile_batch.json
    python -m vmrframe_tpu_torch.tools.profile_batch --chunk 256 \\
        --out chiprun_out/profile_batch_chunk256.json
    python -m vmrframe_tpu_torch.tools.profile_batch --device cpu \\
        --config tests/configs/charades_seqpan.yaml --batches 4,8 --steps 1 --reps 1

Writes ``--out`` (JSON) and one JSON line a batch; never the JAX package's
``docs/*.json``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch


def batch_rows(batches, device: str, chunk: int = 0, config: Optional[str] = None,
               steps: int = 10, reps: int = 3, log=print) -> list:
    """One row a batch size (module docstring)."""
    from vmrframe_tpu_torch.ops.chunked import chunked_batch_apply
    from vmrframe_tpu_torch.tools.bench_zoo import time_steps
    from vmrframe_tpu_torch.tools.profile_serve import _device_profile
    from vmrframe_tpu_torch.tools.roofline import count_traffic, seqpan_eval

    one, full, cfg, ev = seqpan_eval(max(batches), device, config)
    rows = []
    for B in batches:
        batch = {k: v[:B] if isinstance(v, torch.Tensor) and v.dim() and
                 v.shape[0] == max(batches) else v for k, v in full.items()}
        state = {"shift": 0}

        def rolled():
            state["shift"] += 1
            return {**batch, "vfeats": torch.roll(batch["vfeats"], state["shift"], dims=1)}

        def roll_only():
            return rolled()["vfeats"]

        def fwd_only():
            return ev.forward(rolled())["slogits"]

        def fwd_infer():
            b = rolled()
            return chunked_batch_apply(one, b, B, chunk)["props"] if chunk else one(b)["props"]

        row = {"batch": B, "chunk": chunk}
        for name, fn in (("roll_only", roll_only), ("fwd_only", fwd_only),
                         ("fwd_infer", fwd_infer)):
            row[f"{name}_ms"] = time_steps(fn, device, steps, reps)["median"]
        row["qps_fwd_infer"] = B / (row["fwd_infer_ms"] / 1e3)
        row["ms_per_query"] = row["fwd_infer_ms"] / B
        traffic = count_traffic(fwd_infer)
        row["gflop"], row["traffic_mb"] = traffic["flops"] / 1e9, traffic["bytes"] / 1e6
        row["device_ops"] = _device_profile(fwd_infer, 2, device=device)["device_ops_per_step"]
        rows.append(row)
        log(json.dumps(row))
    del ev
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="128,256,512,1024")
    ap.add_argument("--chunk", type=int, default=0, help="chunked_batch_apply's chunk (0: off)")
    ap.add_argument("--config", default=None, help="a config's widths (default: Charades)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/profile_batch.json")
    args = ap.parse_args(argv)

    from vmrframe_tpu_torch.device import resolve_device, strict_f32
    from vmrframe_tpu_torch.tools.bench_kernels import card_name

    device = str(resolve_device(args.device))
    strict_f32()
    batches = [int(b) for b in args.batches.split(",") if b.strip()]
    report = {"card": card_name(device), "device": device, "chunk": args.chunk,
              "rows": batch_rows(batches, device, args.chunk, args.config, args.steps,
                                 args.reps, log=lambda s: print(s, flush=True))}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
