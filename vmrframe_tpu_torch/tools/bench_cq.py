"""Times the CQ attention kernel (#3) on the card, beside its plain version
and its bound.

    python -m vmrframe_tpu_torch.tools.bench_cq [--label NAME] [--out record.json] [--phases]

Shapes: SeqPAN's two CQAttention calls (video to text and back) at
Charades (64 by 30), ANet (100 by 30) and TACoS (256 by 30) widths, both
ways round, batch 128, D 128; random lengths with sample 0 wholly masked,
w4C, w4Q, w4mlu uniform in +-sqrt(6 / (D + 1)); in bf16 and f32.  Beside
each kernel time: the plain version's on the same inputs (it repeats the
kernel's arithmetic; no yardstick of speed), the kernel's largest
difference from it, and the bound, max(bytes / 3.35 TB/s, FLOPs / peak:
989 TFLOP/s bf16, 67 f32) (``cq_work``, which ``chip_smoke.py`` reads too).

Per-call device time from CUDA events around 20 calls queued behind a
sleep kernel, median of 5 runs.  Run from a checkout's root, it times that
checkout's kernel, so two trees compare on one card one after the other;
for a tree without this file, run it by its path from that tree's root
with ``PYTHONPATH=.``.  Prints the card's name and power limit, then one
JSON object.

``--phases`` also runs the kernel's clocked twin (``cq_phase_clocks``) on
each row's inputs: every block adds the SM clocks of each phase (staging,
the rank-1 terms, the scores, the softmax statistics, S_ and S_t, staging
again, S_t^T c, the outputs) up to the barrier that ends it; the row gets
each phase's mean over blocks and 5 launches, in cycles, and the SM clock
``nvidia-smi`` reads right after.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from vmrframe_tpu_torch.tools.bench_banded import device_ms
from vmrframe_tpu_torch.tools.h100 import HBM_BYTES_PER_S, PEAK_OPS

B, D = 128, 128
SHAPES = {"charades": ((64, 30), (30, 64)), "anet": ((100, 30), (30, 100)),
          "tacos": ((256, 30), (30, 256))}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def cq_work(B: int, Lc: int, Lq: int, D: int, size: int) -> tuple:
    """(bytes, operations) of CQ attention with ``size``-byte elements.
    Bytes: c and q read, the three weight vectors and both masks read, c2q
    and q2c written, once each.  Operations: the four products (the scores,
    S_ q, S_t^T c, S_ (S_t^T c)), Lc Lq D multiply-adds each, the rank-1
    terms c . w4C and q . w4Q, and c * w4mlu."""
    elems = B * Lc * D + B * Lq * D + 3 * D + B * (Lc + Lq) + 2 * B * Lc * D
    ops = B * (8 * Lc * Lq * D + 2 * (Lc + Lq) * D + Lc * D)
    return elems * size, ops


def bound_ms(B: int, Lc: int, Lq: int, D: int, dtype: torch.dtype) -> tuple:
    """The least time the card could take, and what bounds it."""
    nbytes, ops = cq_work(B, Lc, Lq, D, torch.finfo(dtype).bits // 8)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def inputs(g: torch.Generator, Lc: int, Lq: int):
    """c, q, w4C, w4Q, w4mlu, c_mask, q_mask in f32 on the card."""
    masks = []
    for L in (Lc, Lq):
        lens = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
        lens[0] = 0
        masks.append((torch.arange(L, device="cuda")[None] < lens[:, None]).float())
    bound = math.sqrt(6.0 / (D + 1))
    vec = lambda *s: (torch.rand(*s, generator=g, device="cuda") * 2 - 1) * bound  # noqa: E731
    return (torch.randn(B, Lc, D, generator=g, device="cuda"),
            torch.randn(B, Lq, D, generator=g, device="cuda"),
            vec(D, 1), vec(D, 1), vec(1, 1, D), *masks)


def phase_cycles(K, x, launches: int = 5) -> dict:
    """Mean SM clocks per block in each of #3's phases, and the SM clock."""
    K.cq_phase_clocks(*x)
    clocks = sum(K.cq_phase_clocks(*x) for _ in range(launches)).double() / launches
    torch.cuda.synchronize()
    out = {name: clocks[:, i].mean().item() for i, name in enumerate(K.CQ_PHASES)}
    out["total"], out["slowest_block"] = sum(out.values()), clocks.sum(1).max().item()
    out["sm_clock"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name for this tree in the record")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    ap.add_argument("--phases", action="store_true",
                    help="also time each phase inside the kernel with the SM clock")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_cq: no CUDA device; this tool times the card")
    from vmrframe_tpu_torch.kernels import attention as K

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    record = {"label": args.label, "card": card}
    for shape, grids in SHAPES.items():
        for Lc, Lq in grids:
            case = inputs(g, Lc, Lq)
            for key, dtype in DTYPES.items():
                x = tuple(t.to(dtype) for t in case)
                bound, by = bound_ms(B, Lc, Lq, D, dtype)
                got = K.fused_cq_attention(*x)
                want = K.cq_attention_plain(*x)
                err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
                row = {"shape": [B, Lc, Lq, D], "ms": device_ms(lambda: K.fused_cq_attention(*x)),
                       "plain_ms": device_ms(lambda: K.cq_attention_plain(*x)),
                       "bound_ms": bound, "bound_by": by, "max_abs_err": err}
                if args.phases:
                    row["phase_cycles"] = phase_cycles(K, x)
                record[f"{shape}_{Lc}x{Lq}_{key}"] = row
                print(f"{shape} {Lc}x{Lq} {key} {json.dumps(row)}", flush=True)
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
