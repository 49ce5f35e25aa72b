"""Times the whole-stack dual-attention kernel (#4) on the card, beside the
module path that computes the same stack.

    python -m vmrframe_tpu_torch.tools.bench_stack [--label NAME] [--out record.json]

Shapes: SeqPAN at Charades width (batch 128, Lv 64, Lt 30) and at TACoS
width (batch 128, Lv 256, Lt 30); D 128, 4 heads of 32; random lengths with
sample 0 wholly masked; two ``DualAttentionBlock``s with every leaf random,
in bf16 (the serving policy: activations and W cast, b, ln, xb f32) and f32.
Beside each kernel time: the module path for the same stack (4
``DualAttentionBlock`` calls, each through kernel #2, the projections in
cuBLAS; the other route to the same result, not a library call) and the
kernel's bound, max(bytes / 3.35 TB/s, multiply-adds x 2 / peak: 989
TFLOP/s bf16, 67 f32) (``stack_work``, which ``chip_smoke.py`` reads too).

Per-call device time from CUDA events around 20 calls (1 for the module
path, which is hundreds of small launches) queued behind a sleep kernel,
median of 5 runs.  Run from a checkout's root, it times that checkout's
kernels, so two trees compare on one card one after the other; for a tree
without this file, run it by its path from that tree's root with
``PYTHONPATH=.``.  A shape the tree's kernel does not take is recorded with
the wrapper's message.  Prints the card's name and power limit, then one
JSON object.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess

import torch

from vmrframe_tpu_torch.tools.bench_banded import device_ms
from vmrframe_tpu_torch.tools.h100 import HBM_BYTES_PER_S, PEAK_OPS

SHAPES = {"charades": (128, 64, 30), "tacos": (128, 256, 30)}
D, HEADS = 128, 4
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def blocks(seed: int = 0):
    """Two seeded ``DualAttentionBlock``s on the card in f32 with every leaf
    random (the initialisers leave LN at 1/0 and the BiLinear's extra bias
    at 0)."""
    from vmrframe_tpu_torch.layers.attention import DualAttentionBlock
    from vmrframe_tpu_torch.weights import init_weights

    g = torch.Generator().manual_seed(seed)
    out = []
    for i in range(2):
        block = init_weights(DualAttentionBlock(D, HEADS), seed + i).eval()
        with torch.no_grad():
            for name, p in block.named_parameters():
                if "layer_norm" in name or name.endswith("bias_value"):
                    p.add_(0.1 * torch.randn(p.shape, generator=g))
        out.append(block.cuda())
    return out


def features(g: torch.Generator, B: int, Lv: int, Lt: int):
    """v, t (f32) and their {0,1} masks; random lengths, sample 0 wholly masked."""
    masks = []
    for L in (Lv, Lt):
        lens = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
        lens[0] = 0
        masks.append((torch.arange(L, device="cuda")[None] < lens[:, None]).float())
    return (torch.randn(B, Lv, D, generator=g, device="cuda"),
            torch.randn(B, Lt, D, generator=g, device="cuda"), *masks)


def stack_work(B: int, Lv: int, Lt: int, size: int, D: int) -> tuple:
    """(bytes, operations) of the stack at width ``D`` with ``size``-byte
    features and W.
    Bytes: v, t in and out, the masks (f32), one pass over both layers'
    stacks (W in the compute type, b, ln, xb in f32).  Operations: per call
    with F from-rows and T to-rows, 12 F D^2 + 2 T D^2 multiply-adds of
    projections (the BiLinear counted folded: one product over fn + gc) and
    2 F (F + T) D of attention (scores and p v of both branches, each head
    its own hd lanes), over the four calls."""
    nbytes = 2 * B * (Lv + Lt) * D * size + 4 * B * (Lv + Lt) \
        + 2 * (14 * D * D * size + 4 * (14 + 6 + 2) * D)
    call = lambda F, T: 12 * F * D * D + 2 * T * D * D + 2 * F * (F + T) * D  # noqa: E731
    return nbytes, 2 * 2 * B * (call(Lv, Lt) + call(Lt, Lv))


def bound_ms(B: int, Lv: int, Lt: int, dtype: torch.dtype) -> float:
    nbytes, ops = stack_work(B, Lv, Lt, torch.finfo(dtype).bits // 8, D)
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]) * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name for this tree in the record")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_stack: no CUDA device; this tool times the card")
    from vmrframe_tpu_torch.kernels import dual_stack as S
    from vmrframe_tpu_torch.ops.precision import cast_module_

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    f32_blocks = blocks()
    record = {"label": args.label, "card": card}
    for shape, (B, Lv, Lt) in SHAPES.items():
        v, t, vm, tm = features(g, B, Lv, Lt)
        for key, dtype in DTYPES.items():
            mods = [cast_module_(copy.deepcopy(b), dtype) for b in f32_blocks]
            with torch.no_grad():
                p1, p2 = (m.stacks() for m in mods)
            x, y = v.to(dtype), t.to(dtype)

            @torch.no_grad()
            def module_path():
                a, b = x, y
                for m in mods:
                    a, b = m(a, b, vm, tm), m(b, a, tm, vm)
                return a, b

            row = {"shape": [B, Lv, Lt], "bound_ms": bound_ms(B, Lv, Lt, dtype),
                   "module_path_ms": device_ms(module_path, n=1)}
            try:
                row["ms"] = device_ms(lambda: S.dual_attention_stack(x, y, vm, tm, p1, p2, HEADS))
            except ValueError as e:  # a tree whose kernel does not take this shape
                row["ms"], row["raises"] = None, str(e)
            record[f"{shape}_{key}"] = row
            print(f"{shape} {key} {json.dumps(row)}", flush=True)
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
