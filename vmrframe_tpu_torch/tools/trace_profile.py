"""Where the device time of one step goes, operation by operation
(counterpart of ``vmrframe_tpu/tools/trace_profile.py``).

Profiles SeqPAN's eval step (forward and span inference at Charades width,
bf16, batch 128: ``tools/roofline.py::seqpan_eval``), or with ``--model
NAME --mode eval|train`` the eval or train step of any row of
``tools/bench_zoo.py``'s ``MODELS`` (``Trainer.eval_step`` or
``train_step``), under ``torch.profiler`` with shapes and FLOPs recorded
(``profile_serve._device_profile``).  For each device operation: its device
time and launches per step, the ATen operations that launched it with their
input shapes (innermost first, through the profiler's correlation ids), and
a category: ``gemm``, ``kernel #n`` (a hand-written kernel, by its
``vmr::`` launch range), ``elementwise``, ``reduction``, ``copy/layout``,
``memset`` or ``other``.  Beside them: the step's time
(``bench_zoo.time_steps``), the busy time, and the step's counted traffic
(``tools/roofline.py::count_traffic``), which ``tools/roofline_trace.py``
joins to the rows.  Prints the top sinks.

    python -m vmrframe_tpu_torch.tools.trace_profile --out chiprun_out/trace_eval_b128.json
    python -m vmrframe_tpu_torch.tools.trace_profile --model CCA --mode train \\
        --out chiprun_out/trace_cca_train.json
    python -m vmrframe_tpu_torch.tools.trace_profile --device cpu \\
        --config tests/configs/charades_seqpan.yaml --batch 8 --steps 1 --reps 1

Writes ``--out`` (JSON); never the JAX package's ``docs/*.json``.  On the
CPU the operations are the host's (each ATen operation's own time).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Optional

import torch

KERNEL_NUMBER = {"fused_masked_attention": 1, "fused_dual_attention": 2,
                 "fused_cq_attention": 3, "dual_attention_stack": 4, "banded_attention": 5,
                 "banded_attention_dq": 6, "banded_attention_dkv": 7}
GEMM = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::addbmm",
        "aten::convolution", "aten::_convolution", "aten::cudnn_convolution",
        "aten::convolution_backward", "aten::cudnn_convolution_backward_input",
        "aten::cudnn_convolution_backward_weight", "aten::_cudnn_rnn",
        "aten::_cudnn_rnn_backward", "aten::_scaled_dot_product_efficient_attention",
        "aten::_scaled_dot_product_flash_attention", "aten::_addmm_activation",
        "aten::addmv", "aten::addmv_", "aten::mv", "aten::dot", "aten::matmul", "aten::linear",
        "aten::einsum"}
REDUCTION = {"aten::sum", "aten::mean", "aten::amax", "aten::amin", "aten::max", "aten::min",
             "aten::_softmax", "aten::_log_softmax", "aten::_softmax_backward_data",
             "aten::_log_softmax_backward_data", "aten::native_layer_norm",
             "aten::native_layer_norm_backward", "aten::var", "aten::var_mean", "aten::std",
             "aten::norm", "aten::linalg_vector_norm", "aten::cumsum", "aten::argmax",
             "aten::argmin", "aten::topk", "aten::sort", "aten::logsumexp", "aten::any",
             "aten::all", "aten::prod", "aten::nonzero", "aten::max_pool1d",
             "aten::max_pool2d_with_indices", "aten::native_batch_norm",
             "aten::native_batch_norm_backward", "aten::_foreach_norm"}
COPY = {"aten::copy_", "aten::clone", "aten::_to_copy", "aten::cat", "aten::stack",
        "aten::index", "aten::index_select", "aten::gather", "aten::embedding",
        "aten::embedding_dense_backward", "aten::repeat", "aten::flip", "aten::roll",
        "aten::constant_pad_nd", "aten::index_put_", "aten::_index_put_impl_",
        "aten::scatter", "aten::scatter_", "aten::scatter_add_", "aten::index_add_",
        "aten::masked_select", "aten::narrow_copy", "aten::take_along_dim",
        "aten::slice_backward", "aten::select_backward", "aten::index_select_backward",
        "aten::_pack_padded_sequence", "aten::_pad_packed_sequence", "aten::tril", "aten::triu"}
MEMSET = {"aten::zero_", "aten::fill_", "aten::zeros", "aten::zeros_like", "aten::ones",
          "aten::full", "aten::full_like", "aten::ones_like"}
ELEMENTWISE_KERNEL = ("elementwise", "vectorized", "unrolled")


def category(row: dict) -> str:
    """The row's category, from its device name and launching operations."""
    name = row["name"]
    if name.startswith("Memset"):
        return "memset"
    if name.startswith("Memcpy"):
        return "copy/layout"
    for op, _ in row["chain"]:
        if op.startswith("vmr::"):
            return f"kernel #{KERNEL_NUMBER.get(op[5:], 0)}"
    for op, _ in row["chain"]:
        for cat, ops in (("gemm", GEMM), ("reduction", REDUCTION), ("copy/layout", COPY),
                         ("memset", MEMSET)):
            if op in ops:
                return cat
    if row["chain"] and (any(k in name for k in ELEMENTWISE_KERNEL)
                         or name == row["chain"][0][0]):  # the CPU: an ATen operation
        return "elementwise"
    return "other"


def zoo_step(model: str, mode: str, device: str, batch_size: Optional[int] = None):
    """(step, label) for a ``bench_zoo.MODELS`` row's eval or train step."""
    from vmrframe_tpu_torch.tools import bench_zoo

    cfg, trainer, train, test = bench_zoo.build(model, device, batch_size)
    if mode == "train":
        return (lambda: trainer.train_step(train)), cfg
    return (lambda: trainer.eval_step(test)), cfg


def trace(step, device: str, steps: int = 10, reps: int = 3) -> dict:
    """The step's time, its device operations by category and its counted
    traffic."""
    from vmrframe_tpu_torch.tools.bench_zoo import time_steps
    from vmrframe_tpu_torch.tools.profile_serve import _device_profile
    from vmrframe_tpu_torch.tools.roofline import count_traffic

    ms = time_steps(step, device, steps, reps)
    prof = _device_profile(step, steps, ops=True, device=device)
    rows = prof.pop("ops")
    by_cat = defaultdict(lambda: {"ms_per_step": 0.0, "launches": 0.0})
    for row in rows:
        row["category"] = category(row)
        by_cat[row["category"]]["ms_per_step"] += row["ms_per_step"]
        by_cat[row["category"]]["launches"] += row["launches_per_step"] * steps
    by_cat = {k: {"ms_per_step": v["ms_per_step"],
                  "launches_per_step": round(v["launches"]) / steps} for k, v in by_cat.items()}
    traffic = count_traffic(step)
    return {"step_ms": ms["median"], "step_ms_spread": ms, **prof,
            "ops_ms_per_step": sum(r["ms_per_step"] for r in rows),
            "by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1]["ms_per_step"])),
            "kernel_launches_per_step": {
                f"#{n}": by_cat.get(f"kernel #{n}", {}).get("launches_per_step", 0.0)
                for n in range(1, 8)},  # whole launches over the steps: exact
            "rows": rows, "counted": traffic}


def top_sinks(report: dict, n: int = 12) -> list:
    """The ``n`` rows with the most device time a step."""
    return [{"name": r["name"][:80], "op": r["chain"][0][0] if r["chain"] else None,
             "category": r["category"], "ms_per_step": r["ms_per_step"],
             "launches_per_step": r["launches_per_step"]} for r in report["rows"][:n]]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="a bench_zoo.MODELS row (default: SeqPAN's "
                    "eval step at Charades width, bf16)")
    ap.add_argument("--mode", default="eval", choices=("eval", "train"))
    ap.add_argument("--batch", type=int, default=None, help="batch (SeqPAN's default: 128)")
    ap.add_argument("--config", default=None, help="SeqPAN: a config's widths")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/trace.json")
    args = ap.parse_args(argv)

    from vmrframe_tpu_torch.device import resolve_device, strict_f32
    from vmrframe_tpu_torch.tools.bench_kernels import card_name
    from vmrframe_tpu_torch.tools.roofline import seqpan_eval

    device = str(resolve_device(args.device))
    strict_f32()
    if args.model:
        step, cfg = zoo_step(args.model, args.mode, device, args.batch)
        label = args.model
    else:
        if args.mode != "eval":
            ap.error("the default step is SeqPAN's eval step; --mode train needs --model")
        fwd_infer, batch, cfg, _ = seqpan_eval(args.batch or 128, device, args.config)
        step, label = (lambda: fwd_infer(batch)), "SeqPAN_fwd_infer"
    B = int(cfg.train.batch_size)
    report = {"card": card_name(device), "device": device, "model": label, "mode": args.mode,
              "batch": B, "dtype": str(cfg.train.get("compute_dtype", "float32")),
              **trace(step, device, args.steps, args.reps)}
    report["top_sinks"] = top_sinks(report)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in ("card", "model", "mode", "batch", "step_ms",
                                             "device_busy_ms_per_step", "device_ops_per_step",
                                             "by_category", "kernel_launches_per_step")}))
    for row in report["top_sinks"]:
        print(json.dumps(row))
    return report


if __name__ == "__main__":
    main()
