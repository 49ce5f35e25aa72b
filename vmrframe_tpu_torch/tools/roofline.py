"""How close a step comes to the card's floor (counterpart of
``vmrframe_tpu/tools/roofline.py``).

Three probes of what the card sustains, then the traffic of the step:

1. **Streaming bandwidth** (``measure_hbm_bw``): a copy, an add, a sum, a
   fill and an f32-to-bf16 cast over buffers of 64 KiB to 1 GiB (sizes a
   factor 2 apart); each kernel's own device time from the profiler
   (``profile_serve._device_profile``), so launch gaps do not count, or
   from CUDA events where the profiler saw no device time.  A rate at each
   size, and the best.
2. **Launch overhead** (``measure_launch_overhead``): a chain of 1000
   data-dependent one-element kernels queued behind a sleep kernel, so the
   host's queueing does not show: the card's time per kernel.
3. **Chain bandwidth** (``measure_chain_bw``): 16 data-dependent bf16
   elementwise kernels back to back at the model's activation sizes (1-4
   MiB), the gaps included.
4. **Step traffic** (``count_traffic``): every ATen operation of one step,
   run under a dispatch mode on ``kernels.counting_route``: its FLOPs (the
   formulas of ``torch.utils.flop_counter``) and the bytes of its tensor
   inputs and outputs.  In eager torch each operation reads its inputs
   from device memory and writes its outputs back, so that sum is its
   traffic; views launch nothing and move nothing.  A hand-written kernel
   counts once, by the tensors it reads and writes where it is launched
   (its plain version runs beneath it for the FLOPs only: its
   intermediates never leave the chip).

The step's floor is ``max(bytes / best measured rate, device operations x
launch overhead, FLOPs / peak)``; the tool reports measured time over floor
for SeqPAN's eval step (forward and span inference) at Charades width in
bf16 (``tools/serve.py::make_cfg``), batches 128 and 512 by default, with
``--chunk N`` through ``ops/chunked.py::chunked_batch_apply``.  Times are
``bench_zoo.time_steps``' (steps queued between two synchronizes, median
of reps).  The peaks are ``tools/h100.py``'s.

    python -m vmrframe_tpu_torch.tools.roofline --out chiprun_out/roofline.json
    python -m vmrframe_tpu_torch.tools.roofline --batches 128,512 --chunk 256
    python -m vmrframe_tpu_torch.tools.roofline --device cpu \\
        --config tests/configs/charades_seqpan.yaml --batches 8 --steps 1 --reps 1 --small

Writes ``--out`` (JSON) and one JSON line a batch to stdout; never the JAX
package's ``docs/*.json``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from vmrframe_tpu_torch.tools.h100 import peak_ops

KIB = 1024
PROBE_SIZES = tuple(64 * KIB * 2 ** i for i in range(15))  # 64 KiB .. 1 GiB a buffer
SMALL_PROBE_SIZES = (64 * KIB, 256 * KIB)  # --small: a CPU rehearsal
CHAIN_SIZES = tuple(m * KIB * KIB for m in (1, 2, 3, 4))
CHAIN_OPS, LAUNCH_CHAIN = 16, 1000

# operations that launch nothing: allocations and views whose schema has no alias
NO_KERNEL = {"aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
             "aten::new_empty_strided", "aten::_unsafe_view", "aten::lift_fresh",
             "aten::resize_", "aten::set_", "aten::_reshape_alias", "aten::detach_"}
# the mutated argument is written, never read
WRITE_ONLY = {"aten::copy_", "aten::fill_", "aten::zero_", "aten::normal_", "aten::uniform_",
              "aten::bernoulli_", "aten::random_", "aten::exponential_", "aten::geometric_",
              "aten::cauchy_", "aten::log_normal_"}
# read only their input's type, device and shape, never its values
LIKE = {"aten::new_zeros", "aten::new_ones", "aten::new_full", "aten::zeros_like",
        "aten::ones_like", "aten::full_like", "aten::rand_like", "aten::randn_like",
        "aten::randint_like"}
# read only the rows their indices name: the table counts at the output's size
GATHER = {"aten::embedding", "aten::index_select", "aten::index", "aten::gather"}
# in place, touching only the cells their indices name: self at the values' size
SCATTER_ = {"aten::index_put_", "aten::_index_put_impl_", "aten::scatter_",
            "aten::scatter_add_", "aten::index_add_", "aten::index_copy_",
            "aten::masked_scatter_", "aten::put_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def input_shapes(func, args, kwargs) -> list:
    """The shapes of the operation's tensor arguments in schema order, as the
    profiler records them (``record_shapes``), the empty ones (scalars,
    lists, absent arguments) left out."""
    out = []
    for i, arg in enumerate(func._schema.arguments):
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        if isinstance(value, torch.Tensor) and value.dim() > 0:
            out.append(list(value.shape))
    return out


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes the operation's kernels read and write: each tensor input once
    (a gather's table at its output's size; an argument that is only
    written, or whose type and shape alone are read, not at all), each
    output once."""
    name = func._schema.name
    if name in NO_KERNEL:
        return 0
    schema = func._schema
    if any(r.alias_info is not None and not r.alias_info.is_write for r in schema.returns):
        return 0  # a view
    outs = _tensors(out)
    out_bytes = sum(_nbytes(t) for t in {id(t): t for t in outs}.values())
    values = [args[i] if i < len(args) else kwargs.get(a.name)
              for i, a in enumerate(schema.arguments)]
    table = _tensors(values)[0] if name in GATHER else None
    read = 0
    for arg, value in zip(schema.arguments, values if name not in LIKE else ()):
        written = arg.alias_info is not None and arg.alias_info.is_write
        for t in _tensors(value):
            if written and (name in WRITE_ONLY or name in SCATTER_ or arg.name == "out"):
                continue
            read += min(_nbytes(t), out_bytes) if t is table else _nbytes(t)
    if name in SCATTER_:  # only the touched cells are written: the values' size
        by_name = dict(zip((a.name for a in schema.arguments), values))
        source = [by_name.get(k) for k in ("values", "src", "source")]
        source = [t for t in source if isinstance(t, torch.Tensor)]
        out_bytes = _nbytes(source[0]) if source else out_bytes
    return read + out_bytes


class _Traffic(TorchDispatchMode):
    """FLOPs and bytes of each ATen operation, by (name, input shapes)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.rows = {}
        self.inside = 0  # > 0 while a kernel's plain version runs
        self.kernel_flops = 0

    def _flops(self, func, args, kwargs, out) -> int:
        fn = self.registry.get(func._overloadpacket)
        return int(fn(*args, **kwargs, out_val=out)) if fn else 0

    def add(self, name: str, shapes, dtype, flops: int, nbytes: int) -> None:
        key = json.dumps([name, shapes])
        row = self.rows.setdefault(key, {"op": name, "shapes": shapes, "dtype": dtype,
                                         "calls": 0, "flops": 0, "bytes": 0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops = self._flops(func, args, kwargs, out)
        if self.inside:
            self.kernel_flops += flops
            return out
        nbytes = op_bytes(func, args, kwargs, out)
        if nbytes or flops:
            floats = [t for t in _tensors((args, kwargs)) if t.is_floating_point()]
            dtype = str(floats[0].dtype).split(".")[-1] if floats else None
            self.add(func._schema.name, input_shapes(func, args, kwargs), dtype, flops, nbytes)
        return out

    def kernel(self, name: str, plain, args):
        """One launch of kernel ``name``: the tensors it reads and writes,
        the FLOPs of its plain version."""
        self.inside += 1
        self.kernel_flops = 0
        try:
            out = plain(*args)
        finally:
            self.inside -= 1
        reads = _tensors(args)
        nbytes = sum(_nbytes(t) for t in reads) + sum(_nbytes(t) for t in _tensors(out))
        self.add(f"vmr::{name}", [], str(reads[0].dtype).split(".")[-1], self.kernel_flops,
                 nbytes)
        return out


def count_traffic(fn, *args) -> dict:
    """FLOPs and bytes of ``fn(*args)``, by operation (``ops``: name, input
    shapes, compute type, calls, FLOPs, bytes) and in all, on
    ``kernels.counting_route`` with the routes the step really takes (no
    route switch held, cuDNN as configured).  Nothing the step would update
    moves: a module's buffers are the caller's to restore."""
    from vmrframe_tpu_torch.kernels import counting_route, kernel_traffic

    mode = _Traffic()
    with counting_route(hold_routes=False), kernel_traffic(mode.kernel), mode:
        fn(*args)
    ops = sorted(mode.rows.values(), key=lambda r: -r["bytes"])
    return {"ops": ops, "calls": sum(r["calls"] for r in ops),
            "flops": sum(r["flops"] for r in ops), "bytes": sum(r["bytes"] for r in ops),
            "flop_time_ms": sum(r["flops"] / peak_ops(r["dtype"] or "float32", r["op"])
                                for r in ops) * 1e3}


# ------------------------------------------------------------------ probes


def _kernel_ms(fn, device: str, reps: int) -> tuple:
    """(device ms of one call of ``fn``, the timer): its kernels' own time
    (the profiler's), the mean over ``reps`` calls; where the profiler saw
    no device time in any of its passes, CUDA events around ``reps`` calls
    queued behind a sleep kernel (``bench_kernels.device_ms``: the gaps
    between the calls included)."""
    from vmrframe_tpu_torch.tools.bench_kernels import device_ms
    from vmrframe_tpu_torch.tools.profile_serve import _device_profile

    fn()
    ms = _device_profile(fn, reps, device=device)["device_busy_ms_per_step"]
    if ms:
        return ms, "profiler"
    return device_ms(fn, n=reps, device=device)["median"], "cuda_events"


def measure_hbm_bw(device: str = "cuda", sizes=PROBE_SIZES, reps: int = 5) -> dict:
    """Bytes a second of a copy (reads and writes a buffer), an add of a
    scalar (the same), a sum (reads it), a zero fill (writes it) and a cast
    to bf16 (reads it, writes half of it) at each buffer size, each from
    its kernels' own time (``_kernel_ms``: ``timer`` says whose);
    ``points``: (bytes moved, rate) of each."""
    points, detail = [], {}
    for size in sizes:
        n = size // 4
        x = torch.ones(n, device=device)
        y, half = torch.empty_like(x), torch.empty(n, device=device, dtype=torch.bfloat16)
        kinds = {"copy": (lambda: y.copy_(x), 2 * size),
                 "add": (lambda: torch.add(x, 1.0, out=y), 2 * size),
                 "sum": (lambda: x.sum(), size), "zero": (lambda: y.zero_(), size),
                 "cast": (lambda: half.copy_(x), size + size // 2)}
        rates = {}
        for kind, (fn, moved) in kinds.items():
            ms, timer = _kernel_ms(fn, device, reps)
            rates[kind] = {"bytes": moved, "ms": ms, "bytes_per_s": moved / (ms / 1e3),
                           "timer": timer}
            points.append([moved, rates[kind]["bytes_per_s"]])
        detail[str(size)] = rates
        del x, y, half
    return {"points": sorted(points), "best_bytes_per_s": max(r for _, r in points),
            "largest_buffer_bytes_per_s": max(v["bytes_per_s"]
                                              for v in detail[str(sizes[-1])].values()),
            "by_buffer_size": detail}


def rate_at(probe: dict, nbytes: float) -> float:
    """The byte rate an operation moving ``nbytes`` is held to: the best
    rate the probes reached at half that traffic or more, else the largest
    probe's.  A rate rises with the size until the L2 cache is outgrown;
    an operation that reads what the one before it wrote finds it there,
    at sizes whose probe (reading a buffer it wrote long before) already
    spills, so the window reaches down to half the traffic."""
    points = probe["points"]
    rates = [r for b, r in points if b >= nbytes / 2]
    return max(rates) if rates else points[-1][1]


def measure_launch_overhead(device: str = "cuda", n: int = LAUNCH_CHAIN) -> dict:
    """ms a kernel on the card in a chain of ``n`` data-dependent
    one-element adds queued behind a sleep kernel (the host's queueing
    hidden); on the CPU the host clock."""
    from vmrframe_tpu_torch.tools.bench_kernels import device_ms

    x = torch.zeros(1, device=device)

    def chain():
        v = x
        for _ in range(n):
            v = v + 1.0
        return v

    ms = device_ms(chain, n=1, reps=5, device=device)
    return {"kernels": n, "ms_per_kernel": ms["median"] / n, "spread": ms}


def measure_chain_bw(device: str = "cuda", sizes=CHAIN_SIZES) -> dict:
    """Bytes a second of ``CHAIN_OPS`` data-dependent bf16 multiplies back to
    back (each reads and writes the buffer), gaps included, at each size."""
    from vmrframe_tpu_torch.tools.bench_kernels import device_ms

    out = {}
    for size in sizes:
        x = torch.ones(size // 2, device=device, dtype=torch.bfloat16)

        def chain():
            v = x
            for _ in range(CHAIN_OPS):
                v = v * 1.0001
            return v

        ms = device_ms(chain, n=1, reps=5, device=device)["median"] / CHAIN_OPS
        out[str(size)] = {"ms_per_kernel": ms, "bytes_per_s": 2 * size / (ms / 1e3)}
    best = max(out.values(), key=lambda r: r["bytes_per_s"])
    return {"best_bytes_per_s": best["bytes_per_s"], "by_size": out}


def probes(device: str = "cuda", small: bool = False) -> dict:
    """The three probes (``--small``: two buffer sizes and short chains, a
    rehearsal on the CPU)."""
    return {"hbm": measure_hbm_bw(device, SMALL_PROBE_SIZES if small else PROBE_SIZES,
                                  reps=1 if small else 5),
            "launch": measure_launch_overhead(device, 20 if small else LAUNCH_CHAIN),
            "chain": measure_chain_bw(device, CHAIN_SIZES[:1] if small else CHAIN_SIZES)}


# ------------------------------------------------------------ SeqPAN's step


def seqpan_eval(batch_size: int, device: str = "cuda", config: Optional[str] = None,
                dtype: str = "bfloat16", chunk: int = 0):
    """(fwd_infer, batch, cfg, evaluator) of SeqPAN's eval step: the
    deterministic forward and span inference (``{"slogits", "elogits",
    "props"}``) on one synthetic test batch of ``batch_size`` at Charades
    width (``tools/serve.py::make_cfg``) or ``config``'s widths; seeded
    weights; with ``chunk`` through ``chunked_batch_apply``."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.ops.chunked import chunked_batch_apply
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.tools.serve import make_cfg
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    updates = {"train.batch_size": batch_size, "train.compute_dtype": dtype}
    cfg = load_config(config).updated(updates) if config else \
        make_cfg(batch_size=batch_size, compute_dtype=dtype)
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=4, n_test=batch_size)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    host = Batcher(dataset["test_set"], store, cfg, derived, batch_size=batch_size).make_batch(
        list(range(batch_size)))
    ev = Evaluator(cfg, derived, dataset["word_vector"], device=device, seed=0)
    batch = ev.to_device({k: v for k, v in host.items() if k != "num_valid"})

    def one(b):
        out = ev.forward(b)
        return {"slogits": out["slogits"], "elogits": out["elogits"],
                "props": ev.entry.infer_fn(out, b, cfg)}

    def fwd_infer(b):
        return chunked_batch_apply(one, b, batch_size, chunk) if chunk else one(b)

    return fwd_infer, batch, cfg, ev


def step_floor(traffic: dict, probe: dict, device_ops: float) -> dict:
    """The step's floor: the largest of its bytes at the best measured
    rate, its device operations at the measured launch overhead, and its
    FLOPs at the peak of their type."""
    parts = {"bytes_ms": traffic["bytes"] / probe["hbm"]["best_bytes_per_s"] * 1e3,
             "launch_ms": device_ops * probe["launch"]["ms_per_kernel"],
             "flops_ms": traffic["flop_time_ms"]}
    bound = max(parts, key=parts.get)
    return {**parts, "floor_ms": parts[bound], "bound_by": bound.replace("_ms", "")}


def roofline_row(batch_size: int, probe: dict, device: str, chunk: int = 0,
                 config: Optional[str] = None, steps: int = 10, reps: int = 3) -> dict:
    """Measured ms of SeqPAN's eval step at ``batch_size`` over its floor."""
    from vmrframe_tpu_torch.tools.bench_zoo import time_steps
    from vmrframe_tpu_torch.tools.profile_serve import _device_profile

    fwd_infer, batch, cfg, ev = seqpan_eval(batch_size, device, config, chunk=chunk)
    step = lambda: fwd_infer(batch)  # noqa: E731
    ms = time_steps(step, device, steps, reps)
    traffic = count_traffic(step)
    prof = _device_profile(step, max(1, steps // 2), device=device)
    floor = step_floor(traffic, probe, prof["device_ops_per_step"])
    row = {"batch": batch_size, "chunk": chunk, "dtype": str(cfg.train.compute_dtype),
           "measured_ms": ms["median"], "measured_spread": ms,
           "device_busy_ms": prof["device_busy_ms_per_step"],
           "device_ops": prof["device_ops_per_step"],
           "gflop": traffic["flops"] / 1e9, "traffic_mb": traffic["bytes"] / 1e6,
           "counted_ops": traffic["calls"], **floor,
           "measured_over_floor": ms["median"] / floor["floor_ms"],
           "qps": batch_size / (ms["median"] / 1e3)}
    del ev
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="128,512")
    ap.add_argument("--chunk", type=int, default=0, help="chunked_batch_apply's chunk (0: off)")
    ap.add_argument("--config", default=None, help="a config's widths (default: Charades)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10, help="steps queued per repetition")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--small", action="store_true", help="short probes (a CPU rehearsal)")
    ap.add_argument("--out", default="chiprun_out/roofline.json")
    args = ap.parse_args(argv)

    from vmrframe_tpu_torch.device import resolve_device, strict_f32
    from vmrframe_tpu_torch.tools.bench_kernels import card_name

    device = str(resolve_device(args.device))
    strict_f32()
    report = {"card": card_name(device), "device": device, "probes": probes(device, args.small)}
    print(json.dumps({"probes": {"best_bytes_per_s": report["probes"]["hbm"]["best_bytes_per_s"],
                                 "launch_ms": report["probes"]["launch"]["ms_per_kernel"],
                                 "chain_bytes_per_s":
                                     report["probes"]["chain"]["best_bytes_per_s"]}}), flush=True)
    rows = []
    for b in (int(x) for x in args.batches.split(",") if x.strip()):
        rows.append(roofline_row(b, report["probes"], device, args.chunk, args.config,
                                 args.steps, args.reps))
        print(json.dumps(rows[-1]), flush=True)
    report["rows"] = rows
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
