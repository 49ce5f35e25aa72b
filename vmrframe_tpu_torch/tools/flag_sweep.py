"""Paired runs of the port's route switches, each in a fresh process
(counterpart of ``vmrframe_tpu/tools/flag_sweep.py``, whose candidates are
XLA flags; here they are the switches the port honours).

A sweep holds one config and one step (eval or train) and flips one switch
between two candidates, A and B; the runs alternate A, B, A, B ... for
``--pairs`` pairs (at least 3 for a reading), each a new Python process that
builds the model on synthetic data, times ``--steps`` steps queued between
two synchronizes (median of ``--reps``, ``tools/bench_zoo.py::time_steps``)
and reports its kernels' launches a step.  The sweep prints each
candidate's median and spread over its runs and the ratio of the medians,
B over A.  It changes no default.

Sweeps (``SWEEPS``):

- ``fused_dual_stack``: SeqPAN's Charades eval step
  (``configs/charades_seqpan_fused.yaml``, bf16), ``model.fused_dual_stack``
  off (A: 4 launches of #2 a forward) and on (B: 1 of #4);
- ``pallas_min_len``: ActionFormer's long train step
  (``configs/tacos_actionformer_long.yaml``), ``actionformer.pallas_min_len``
  at the config's value (A: the banded kernels) and -1 (B: the band-mask
  route);
- ``compute_dtype``: SeqPAN's Charades train step, ``train.compute_dtype``
  float32 (A) and the config's bfloat16 (B).

Writes ``--out`` (JSON) and one JSON line a run to stdout; never the JAX
package's ``docs/*.json``.

    python -m vmrframe_tpu_torch.tools.flag_sweep --sweeps fused_dual_stack --pairs 3
    python -m vmrframe_tpu_torch.tools.flag_sweep --device cpu --pairs 1 --steps 1 --reps 1 \\
        --batch-size 2 --sweeps fused_dual_stack
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from typing import Optional

SWEEPS = {
    "fused_dual_stack": ("configs/charades_seqpan_fused.yaml", "eval",
                         {"model.fused_dual_stack": False}, {"model.fused_dual_stack": True}),
    "pallas_min_len": ("configs/tacos_actionformer_long.yaml", "train",
                       {}, {"actionformer.pallas_min_len": -1}),
    "compute_dtype": ("configs/charades_seqpan_fused.yaml", "train",
                      {"train.compute_dtype": "float32"}, {"train.compute_dtype": "bfloat16"}),
}
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
CHILD_TIMEOUT_S = 900


def run_child(config: str, overrides: dict, mode: str, device: str, steps: int, reps: int,
              batch_size: Optional[int]) -> dict:
    """One candidate's run in this process: ms a step and launches a step."""
    import torch

    from vmrframe_tpu_torch.device import strict_f32
    from vmrframe_tpu_torch.tools.bench_zoo import build_from, kernels, time_steps

    strict_f32()
    cfg, trainer, train_batch, test_batch = build_from(config, overrides, device, batch_size)
    fn = (lambda: trainer.train_step(train_batch)) if mode == "train" else \
        (lambda: trainer.eval_step(test_batch))
    fns = kernels()
    for k in fns:
        k.launches = 0
    ms = time_steps(fn, device, steps, reps)
    calls = 1 + steps * reps
    out = {"ms": ms["median"], "ms_spread": ms, "batch_size": int(cfg.train.batch_size),
           "launches_per_step": {k.__name__: k.launches / calls for k in fns}}
    if torch.device(device).type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    return out


def run_one(config: str, overrides: dict, mode: str, device: str, steps: int, reps: int,
            batch_size: Optional[int]) -> dict:
    """One candidate's run in a fresh Python process."""
    cmd = [sys.executable, "-m", "vmrframe_tpu_torch.tools.flag_sweep", "--child",
           "--config", config, "--set", json.dumps(overrides), "--mode", mode,
           "--device", device, "--steps", str(steps), "--reps", str(reps)]
    if batch_size:
        cmd += ["--batch-size", str(batch_size)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
                          cwd=REPO, env=env)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-5:]
        raise RuntimeError(f"candidate {overrides} failed: " + " | ".join(tail))
    return json.loads(lines[-1])


def spread(xs) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "runs": list(xs)}


def sweep(name: str, device: str, pairs: int, steps: int, reps: int,
          batch_size: Optional[int] = None, log=print) -> dict:
    """A, B, A, B ... for ``pairs`` pairs; each candidate's ms and launches."""
    config, mode, a, b = SWEEPS[name]
    runs = {"A": [], "B": []}
    for i in range(pairs):
        for label, overrides in (("A", a), ("B", b)):
            res = run_one(config, overrides, mode, device, steps, reps, batch_size)
            runs[label].append(res)
            log(json.dumps({"sweep": name, "pair": i, "candidate": label,
                            "overrides": overrides, **res}))
    out = {"sweep": name, "config": config, "mode": mode, "pairs": pairs, "device": device}
    for label, overrides in (("A", a), ("B", b)):
        out[label] = {"overrides": overrides, "ms": spread([r["ms"] for r in runs[label]]),
                      "launches_per_step": runs[label][0]["launches_per_step"]}
    out["ratio_b_over_a"] = out["B"]["ms"]["median"] / out["A"]["ms"]["median"]
    out["pair_ratios"] = [rb["ms"] / ra["ms"] for ra, rb in zip(runs["A"], runs["B"])]
    if "card" in runs["A"][0]:
        out["card"] = runs["A"][0]["card"]
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweeps", default=",".join(SWEEPS))
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20, help="steps queued per repetition")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=None, help="override train.batch_size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/flag_sweep.json")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--config", help=argparse.SUPPRESS)
    ap.add_argument("--set", default="{}", help=argparse.SUPPRESS)
    ap.add_argument("--mode", default="eval", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(run_child(args.config, json.loads(args.set), args.mode, args.device,
                                   args.steps, args.reps, args.batch_size)), flush=True)
        return []
    results = []
    for name in (n.strip() for n in args.sweeps.split(",") if n.strip()):
        res = sweep(name, args.device, args.pairs, args.steps, args.reps, args.batch_size)
        print(json.dumps({k: res[k] for k in ("sweep", "ratio_b_over_a")} |
                         {"A_ms": res["A"]["ms"], "B_ms": res["B"]["ms"]}), flush=True)
        results.append(res)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": results}, f, indent=1)
    return results


if __name__ == "__main__":
    main()
