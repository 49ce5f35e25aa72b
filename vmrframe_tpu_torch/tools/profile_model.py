"""A zoo model's train step, piece by piece (counterpart of
``vmrframe_tpu/tools/profile_model.py``).

For any row of ``tools/bench_zoo.py``'s ``MODELS`` (built by
``bench_zoo.build``: synthetic batches seeded 0, the row's configuration):

- ``fwd_loss``: the forward and loss in train mode (a fresh generator for
  dropout each call), no gradient;
- ``loss_and_grad``: ``Trainer.loss_and_grads``;
- ``grad_optimizer``: that and the AdamW update (``optimizer.step``);
- ``full_train``: ``Trainer.train_step`` (adds span inference and IoU);
- ``eval_step``: ``Trainer.eval_step``.

Each piece: ms (``bench_zoo.time_steps``: calls queued between two
synchronizes, median of reps), GFLOP (``bench_zoo.count_flops``: the
forward and loss alone for ``fwd_loss``, with the gradients for the train
pieces, the eval step for ``eval_step``), MFU against the card's dense peak
for the row's compute type (``tools/h100.py``) and device operations per
call (``profile_serve._device_profile``): which piece holds the time, and
whether it is FLOPs, bytes or the count of operations.

    python -m vmrframe_tpu_torch.tools.profile_model --model CPL --out chiprun_out/profile_cpl.json
    python -m vmrframe_tpu_torch.tools.profile_model --model BAN --device cpu --steps 1 --reps 1

Writes ``--out`` (JSON) and one JSON line a piece; never the JAX package's
``docs/*.json``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

PIECES = ("fwd_loss", "loss_and_grad", "grad_optimizer", "full_train", "eval_step")


def pieces(trainer, train_batch, test_batch) -> dict:
    """name -> (call, FLOP-count mode) of each piece."""
    from vmrframe_tpu_torch.ops.input_pipeline import apply_device_pipeline
    from vmrframe_tpu_torch.train.trainer import step_seed

    batch = apply_device_pipeline(train_batch, trainer.cfg, augment=True)
    count = {"n": 0}

    def generator():
        count["n"] += 1
        return torch.Generator(device=trainer.device).manual_seed(step_seed(trainer.seed,
                                                                            count["n"]))

    def fwd_loss():
        trainer.model.train()
        with torch.no_grad():
            return trainer._loss(trainer.forward(batch, generator()), batch)[0]

    def loss_and_grad():
        trainer.model.train()
        return trainer.loss_and_grads(batch, generator())[0]

    def grad_optimizer():
        trainer.model.train()
        loss, grads, _, _ = trainer.loss_and_grads(batch, generator())
        trainer.optimizer.step(grads)
        return loss

    return {"fwd_loss": (fwd_loss, "forward"), "loss_and_grad": (loss_and_grad, "train"),
            "grad_optimizer": (grad_optimizer, "train"),
            "full_train": (lambda: trainer.train_step(train_batch), "train"),
            "eval_step": (lambda: trainer.eval_step(test_batch), "eval")}


def profile(model: str, device: str = "cuda", steps: int = 10, reps: int = 3,
            batch_size: Optional[int] = None, log=print) -> dict:
    from vmrframe_tpu_torch.tools import bench_zoo
    from vmrframe_tpu_torch.tools.h100 import PEAK_FLOPS
    from vmrframe_tpu_torch.tools.profile_serve import _device_profile

    cfg, trainer, train_batch, test_batch = bench_zoo.build(model, device, batch_size)
    dtype = str(cfg.train.get("compute_dtype", "float32"))
    flops = {"forward": bench_zoo.count_flops(trainer, train_batch, True, backward=False),
             "train": bench_zoo.count_flops(trainer, train_batch, True),
             "eval": bench_zoo.count_flops(trainer, test_batch, False)}
    out = {"model": model, "config": bench_zoo.MODELS[model][0],
           "overrides": bench_zoo.MODELS[model][1], "batch_size": int(cfg.train.batch_size),
           "dtype": dtype, "device": device, "peak_tflops": PEAK_FLOPS[dtype] / 1e12,
           "pieces": {}}
    for name, (fn, mode) in pieces(trainer, train_batch, test_batch).items():
        ms = bench_zoo.time_steps(fn, device, steps, reps)
        sec = ms["median"] / 1e3
        row = {"ms": ms["median"], "ms_spread": ms, "gflop": flops[mode] / 1e9,
               "mfu_pct": 100.0 * flops[mode] / sec / PEAK_FLOPS[dtype],
               "device_ops": _device_profile(fn, 2, device=device)["device_ops_per_step"]}
        out["pieces"][name] = row
        log(json.dumps({name: row}))
    del trainer
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, help="a bench_zoo.MODELS row")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/profile_model.json")
    args = ap.parse_args(argv)

    from vmrframe_tpu_torch.device import resolve_device, strict_f32
    from vmrframe_tpu_torch.tools.bench_kernels import card_name

    device = str(resolve_device(args.device))
    strict_f32()
    report = {"card": card_name(device), **profile(args.model, device, args.steps, args.reps,
                                                   args.batch_size,
                                                   log=lambda s: print(s, flush=True))}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
