"""Train and eval step timings of the model zoo, with FLOP accounting
(counterpart of ``vmrframe_tpu/tools/bench_zoo.py``).

For each row: the full train step (forward, loss, gradients, clipping,
AdamW, span inference, IoU: ``Trainer.train_step``) and the eval step
(forward, loss, inference, IoU: ``Trainer.eval_step``) on one synthetic
batch at the row's configuration.  Timing: ``--steps`` steps queued back to
back, a synchronize at each end, host clock; the median (and spread) of
``--reps`` repetitions after one warm-up step.

FLOPs: one train step's forward, loss and gradients and one eval forward
with loss and inference, counted by ``torch.utils.flop_counter`` on
``kernels.counting_route`` (a launch counts its kernel's plain version, the
route switches held at one setting, cuDNN off), so the count is the same
whichever route runs, on the card and on the CPU.  The counter counts
matrix products and convolutions only, where XLA's ``cost_analysis`` (the
JAX tool's count) also counted elementwise work: the two are not
comparable.  MFU is against the H100's dense peak for the step's compute
type (``train.compute_dtype``): 989 TFLOP/s in bf16, 67 in f32.

On the card a ``torch.profiler`` pass adds the card's busy time a step
(``*_device_busy_ms``) and a bound: ``compute`` at 25% of the peak or more,
``host`` where the card is busy less than half the step, else
``schedule``.  Bytes are not reported: the counter gives no byte count, and
summing every torch operation's inputs and outputs would count the
intermediates that a fused kernel never writes.

Rows (``MODELS``) take each family's configuration from the repository:
SeqPAN at the Charades width the reference ships
(``configs/charades_seqpan_fused.yaml`` in f32 with the stack's flag off,
the JAX defaults), BAN and ActionFormer at their test configurations (the
repository holds no full-width Charades one), CCA, CPL and the two long
configurations as they are; each with a ``_bf16`` twin, the route twin
``ActionFormerLongXLA`` (``actionformer.pallas_min_len: -1``: the band-mask
route, no banded kernel) and the batch twin ``BANLong_B32``.  Left out, as
twins that would time the same program twice: ``CPL_remat``, ``CPL_rep``, ``CPL_sp`` (``others.cpl_remat``
and ``cpl_shared_prefix``, accepted and ignored: one shared-prefix route),
``CCA_contract``, ``CCA_legacyscores``, ``CCA_scattermap``,
``CCA_r4default`` (XLA formulations of the map and scores; the port has
one), ``CCA_flatopt``, ``ActionFormer_treeopt``, ``ActionFormer_flatfix``
(flat against tree AdamW; the port has one AdamW), ``SeqPAN_shiftconv``,
``SeqPAN_convdw``, ``SeqPAN_bf16_convdw`` (the depthwise lowering; the port
has one convolution), ``ActionFormerLongPallasEval`` (the port's eval
already launches the banded kernel at these lengths), and the
``_u32drop`` twins (the mask's bits: a TPU stream's cost; the port honours
``train.dropout_bits``, so a later row may time it).

Writes ``--out`` (JSON, rows merged by model name) and one JSON line a row
to stdout; never the JAX package's ``docs/*.json``.

    python -m vmrframe_tpu_torch.tools.bench_zoo --models SeqPAN,CCA --out chiprun_out/zoo.json
    python -m vmrframe_tpu_torch.tools.bench_zoo --models BAN --device cpu --steps 1 --reps 1
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from vmrframe_tpu_torch.tools.h100 import PEAK_FLOPS

COMPUTE_BOUND_SHARE = 0.25  # of the peak, as the JAX tool classifies
HOST_BOUND_BUSY = 0.5  # the card busy less than this share of the step

_SEQPAN = ("configs/charades_seqpan_fused.yaml",
           {"model.fused_dual_stack": False, "train.compute_dtype": "float32"})
_BASE = {
    "SeqPAN": _SEQPAN,
    "BAN": ("tests/configs/charades_ban.json", {}),
    "CCA": ("configs/anet_cca.yaml", {}),
    "ActionFormer": ("tests/configs/charades_actionformer.yaml", {}),
    "CPL": ("configs/charades_cpl.yaml", {}),
}
MODELS: Dict[str, tuple] = {}
for _name, (_path, _over) in _BASE.items():
    MODELS[_name] = (_path, _over)
    MODELS[f"{_name}_bf16"] = (_path, {**_over, "train.compute_dtype": "bfloat16"})
MODELS.update({
    "ActionFormerLong": ("configs/tacos_actionformer_long.yaml", {}),
    "ActionFormerLongXLA": ("configs/tacos_actionformer_long.yaml",
                            {"actionformer.pallas_min_len": -1}),
    "BANLong": ("configs/tacos_ban_long.yaml", {}),
    "BANLong_B32": ("configs/tacos_ban_long.yaml", {"train.batch_size": 32}),
})

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def kernels():
    """The seven hand-written kernels' wrappers, whose ``launches`` count."""
    from vmrframe_tpu_torch.kernels import attention, dual_stack, window_attention

    return attention.KERNELS + dual_stack.KERNELS + window_attention.KERNELS


def build(name: str, device: str, batch_size: Optional[int] = None):
    """(cfg, trainer, a train batch on the device, a test batch on the device)
    of one row, on synthetic data seeded 0."""
    return build_from(*MODELS[name], device, batch_size)


def build_from(path: str, overrides: dict, device: str, batch_size: Optional[int] = None):
    """``build`` for a config file (relative to the repository) and its
    overrides."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.train.trainer import Trainer

    cfg = load_config(os.path.join(REPO, path)).updated(overrides)
    if batch_size:
        cfg = cfg.updated({"train.batch_size": int(batch_size)})
    B = int(cfg.train.batch_size)
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=2 * B, n_test=B)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"],
                      num_train_steps=1000, steps_per_epoch=10)
    batcher_cls = get_model_entry(str(cfg.model.name)).batcher_cls or Batcher
    train = next(batcher_cls(dataset["train_set"], store, cfg, derived, "train").epoch(seed=0))
    test = next(batcher_cls(dataset["test_set"], store, cfg, derived, "test").epoch(seed=0))
    trainer = Trainer(cfg, derived, dataset["word_vector"], device=device)
    return cfg, trainer, trainer.to_device(train), trainer.to_device(test)


def count_flops(trainer, batch, train: bool, backward: bool = True) -> int:
    """FLOPs of one step on ``kernels.counting_route``: in train mode the
    forward, loss and gradients (AdamW and the inference after it multiply
    no matrices; ``backward=False``: the forward and loss alone); in eval
    mode ``Trainer.eval_step``.  Nothing the step would update moves: the
    buffers (BatchNorm's statistics) are put back."""
    from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

    from vmrframe_tpu_torch.kernels import counting_route
    from vmrframe_tpu_torch.ops.input_pipeline import apply_device_pipeline
    from vmrframe_tpu_torch.train.trainer import step_seed

    buffers = {k: v.clone() for k, v in trainer.model.named_buffers()}
    counter = FlopCounterMode(display=False)
    # the dispatch mode alone: FlopCounterMode's module tracker hooks every
    # module's outputs, which fails on the parameters functional_call binds
    with counting_route(), _FlopCounterMode(counter):
        if train:
            trainer.model.train()
            generator = torch.Generator(device=trainer.device).manual_seed(
                step_seed(trainer.seed, 0))
            batch = apply_device_pipeline(batch, trainer.cfg, augment=True)
            if backward:
                trainer.loss_and_grads(batch, generator)
            else:
                with torch.no_grad():
                    trainer._loss(trainer.forward(batch, generator), batch)
        else:
            trainer.eval_step(batch)
    with torch.no_grad():
        for k, v in trainer.model.named_buffers():
            v.copy_(buffers[k])
    return counter.get_total_flops()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_steps(fn, device, steps: int, reps: int) -> dict:
    """ms a call of ``fn``: ``steps`` calls queued back to back between two
    synchronizes, host clock; median, min and max over ``reps``, after one
    warm-up call."""
    fn()
    _sync(device)
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def _bound(mfu: float, busy_ms: Optional[float], step_ms: float) -> str:
    if mfu >= COMPUTE_BOUND_SHARE:
        return f"compute ({100 * mfu:.0f}% of the peak)"
    if busy_ms is not None and busy_ms < HOST_BOUND_BUSY * step_ms:
        return f"host (card busy {100 * busy_ms / step_ms:.0f}% of the step)"
    busy = "not measured" if busy_ms is None else f"{100 * busy_ms / step_ms:.0f}%"
    return f"schedule (MFU {100 * mfu:.1f}%, card busy {busy})"


def bench_model(name: str, device: str = "cuda", steps: int = 10, reps: int = 3,
                profile: bool = True, batch_size: Optional[int] = None) -> dict:
    """One row: timings, launches a step, FLOPs and MFU."""
    cfg, trainer, train_batch, test_batch = build(name, device, batch_size)
    B = int(cfg.train.batch_size)
    dtype = str(cfg.train.get("compute_dtype", "float32"))
    path, overrides = MODELS[name]
    res = {"model": name, "family": str(cfg.model.name), "config": path,
           "overrides": overrides, "batch_size": B, "dtype": dtype, "device": str(device),
           "params": sum(p.numel() for p in trainer.model.parameters())}
    if torch.device(device).type == "cuda":
        res["card"] = torch.cuda.get_device_name(0)
    fns = kernels()
    for mode, fn, batch in (("train", trainer.train_step, train_batch),
                            ("eval", trainer.eval_step, test_batch)):
        for k in fns:
            k.launches = 0
        ms = time_steps(lambda: fn(batch), device, steps, reps)
        calls = 1 + steps * reps
        res[f"{mode}_launches_per_step"] = {k.__name__: k.launches / calls for k in fns}
        flops = count_flops(trainer, batch, train=(mode == "train"))
        sec = ms["median"] / 1e3
        mfu = flops / sec / PEAK_FLOPS[dtype]
        res.update({f"{mode}_ms_per_step": ms["median"], f"{mode}_ms_spread": ms,
                    f"{mode}_flops": flops, f"{mode}_gflops_per_step": flops / 1e9,
                    f"{mode}_achieved_tflops": flops / sec / 1e12,
                    f"{mode}_mfu_pct": 100.0 * mfu})
        busy = None
        if profile and torch.device(device).type == "cuda":
            from vmrframe_tpu_torch.tools.profile_serve import _device_profile

            busy = _device_profile(lambda: fn(batch), 3).get("device_busy_ms_per_step")
            res[f"{mode}_device_busy_ms"] = busy
        res[f"{mode}_bound"] = _bound(mfu, busy, ms["median"])
    res["train_samples_per_sec"] = B / (res["train_ms_per_step"] / 1e3)
    res["eval_qps"] = B / (res["eval_ms_per_step"] / 1e3)
    res["peak_tflops"] = PEAK_FLOPS[dtype] / 1e12
    del trainer
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


def write(out: str, rows: list, device: str) -> None:
    """Merges ``rows`` into the JSON at ``out`` by model name."""
    old = []
    if os.path.exists(out):
        try:
            with open(out) as f:
                old = json.load(f).get("results", [])
        except (OSError, json.JSONDecodeError):
            old = []
    names = {r["model"] for r in rows}
    merged = [r for r in old if r.get("model") not in names] + rows
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"device": device, "protocol": "steps queued between two synchronizes, "
                   "host clock, median of reps; FLOPs by torch.utils.flop_counter on the "
                   "counting route", "results": merged}, f, indent=1)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--steps", type=int, default=10, help="steps queued per repetition")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=None, help="override train.batch_size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-profile", action="store_true", help="skip the torch.profiler pass")
    ap.add_argument("--out", default="chiprun_out/bench_zoo.json")
    args = ap.parse_args(argv)

    from vmrframe_tpu_torch.device import resolve_device, strict_f32

    device = str(resolve_device(args.device))
    strict_f32()
    np.random.seed(0)
    rows = []
    for name in (n.strip() for n in args.models.split(",") if n.strip()):
        try:
            res = bench_model(name, device, args.steps, args.reps, not args.no_profile,
                              args.batch_size)
        except Exception as e:  # one row's failure is recorded; the others still run
            res = {"model": name, "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-1500:]}
        print(json.dumps({k: v for k, v in res.items() if k != "trace"}), flush=True)
        rows.append(res)
        write(args.out, rows, device)
    return rows


if __name__ == "__main__":
    raise SystemExit(1 if any("error" in r for r in main()) else 0)
