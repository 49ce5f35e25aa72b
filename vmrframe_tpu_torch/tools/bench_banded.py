"""Times kernel #5, the banded attention forward, on the card.

    python -m vmrframe_tpu_torch.tools.bench_banded [--label NAME] [--out record.json]

At the shapes ActionFormer's long config (``configs/tacos_actionformer_long.yaml``)
gives it: 4 heads of 128, window 19, T = 2304 (2 launches per forward), 1152
and 576 (1 each), q, k and v as head-split views of one (B, T, 3C)
projection, random lengths with sample 0 wholly masked (rows without a valid
key take the kernel's padding-row path).  bf16 at the serving batch (8) and
f32 at the training batch (2); ``bf16_unmasked``: bf16 with every key valid,
as in a served batch of videos resampled to the config's length.  Beside
each: SDPA with the band-and-key boolean mask in the same type (one PyTorch
call computing the same function on every row with a valid key; timed
only).

Per-call device time from CUDA events around 20 calls queued behind a sleep
kernel, median of 5 runs; each type's time is the launch-weighted mean over
the three lengths.  Run from a checkout's root, it times that checkout's
kernel, so two trees can be compared on one card, one after the other.  Prints
the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

HEADS, HEAD_DIM, WINDOW = 4, 128, 19
LAUNCHES = {2304: 2, 1152: 1, 576: 1}  # per forward of the long config
BATCH = {torch.bfloat16: 8, torch.float32: 2}  # serving, training
SLEEP_CYCLES = 100_000_000  # the host queues a timed run meanwhile


def device_ms(fn, n: int = 20, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def case(g: torch.Generator, B: int, T: int, dtype: torch.dtype, masked: bool):
    """q, k, v (B, H, T, hd) views of one projection, and a (B, T) mask."""
    lens = torch.randint(T // 2, T + 1, (B,), generator=g, device="cuda")
    lens[0] = 0
    if not masked:
        lens[:] = T
    mask = (torch.arange(T, device="cuda")[None] < lens[:, None]).to(dtype)
    qkv = torch.randn(B, T, 3 * HEADS * HEAD_DIM, generator=g, device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (HEADS, HEAD_DIM)).transpose(1, 2)
               for t in qkv.split(HEADS * HEAD_DIM, dim=-1))
    return q, k, v, mask


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name for this tree in the record")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_banded: no CUDA device; this tool times the card")
    from vmrframe_tpu_torch.kernels import window_attention as W

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    record = {"label": args.label, "card": card}
    for dtype, key, masked in ((torch.bfloat16, "bf16", True), (torch.float32, "f32", True),
                               (torch.bfloat16, "bf16_unmasked", False)):
        rows, total = [], sum(LAUNCHES.values())
        for T, launches in LAUNCHES.items():
            q, k, v, mask = case(g, BATCH[dtype], T, dtype, masked)
            i = torch.arange(T, device="cuda")
            allowed = (((i[:, None] - i[None, :]).abs() <= WINDOW // 2)[None]
                       & (mask[:, None, :] > 0))[:, None]
            rows.append({
                "T": T, "batch": BATCH[dtype], "launches_per_forward": launches,
                "ms": device_ms(lambda: W.banded_attention(q, k, v, mask, WINDOW)),
                "sdpa_ms": device_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)),
            })
        record[key] = {
            "ms": sum(r["ms"] * r["launches_per_forward"] for r in rows) / total,
            "sdpa_ms": sum(r["sdpa_ms"] * r["launches_per_forward"] for r in rows) / total,
            "shapes": rows,
        }
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
