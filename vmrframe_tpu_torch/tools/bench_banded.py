"""Times the banded attention kernels on the card: #5 (the forward), or with
``--backward`` #6 (dq) and #7 (dk/dv).

    python -m vmrframe_tpu_torch.tools.bench_banded [--backward] [--label NAME] [--out record.json]

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

``--backward``: #6 and #7 at the training shapes (batch 2, the same three
lengths, 4 launches each per train step), f32 and bf16, with the cotangent
random on every row, in (B, T, H, hd) memory as autograd hands it back;
``bwd``: sample 0 wholly masked and sample 1 of a random length with a hole
wider than the band (the cases ``chip_smoke.py`` times), ``bwd_unmasked``:
every key valid.  Beside them: SDPA's backward with the same boolean band
mask (dq, dk and dv together; forward plus backward less forward).

Per-call device time from CUDA events around 20 calls queued behind a sleep
kernel, median of 5 runs; each type's time is the launch-weighted mean over
the three lengths.  Run from a checkout's root, it times that checkout's
kernels, so two trees can be compared on one card, one after the other; for
a tree whose copy of this tool lacks a mode, run this file by its path from
that tree's root with ``PYTHONPATH=.``.  Prints
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


def band_mask(mask: torch.Tensor) -> torch.Tensor:
    """The band-and-key boolean mask, (B, 1, T, T)."""
    i = torch.arange(mask.shape[1], device=mask.device)
    return ((((i[:, None] - i[None, :]).abs() <= WINDOW // 2)[None]
             & (mask[:, None, :] > 0))[:, None])


def bwd_case(g: torch.Generator, T: int, dtype: torch.dtype, masked: bool):
    """q, k, v (B, H, T, hd) views of one projection at the training batch,
    a (B, T) mask and a cotangent (B, H, T, hd) over (B, T, H, hd) memory."""
    B = BATCH[torch.float32]
    mask = torch.ones(B, T, device="cuda")
    if masked:
        mask[0] = 0.0
        mask[1, int(torch.randint(T // 2, T + 1, (1,), generator=g, device="cuda")):] = 0.0
        mask[1, T // 4:T // 4 + 3 * WINDOW] = 0.0
    qkv = torch.randn(B, T, 3 * HEADS * HEAD_DIM, generator=g, device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (HEADS, HEAD_DIM)).transpose(1, 2)
               for t in qkv.split(HEADS * HEAD_DIM, dim=-1))
    cot = torch.randn(B, T, HEADS, HEAD_DIM, generator=g, device="cuda").to(dtype)
    return q, k, v, mask.to(dtype), cot.transpose(1, 2)


def backward_rows(W, g: torch.Generator, dtype: torch.dtype, masked: bool) -> list:
    rows = []
    for T, launches in LAUNCHES.items():
        q, k, v, mask, cot = bwd_case(g, T, dtype, masked)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        allowed = band_mask(mask)
        fwd = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=allowed)  # noqa: E731
        rows.append({
            "T": T, "batch": q.shape[0], "launches_per_step": launches,
            "dq_ms": device_ms(lambda: W.banded_attention_dq(q, k, v, mask, cot, WINDOW)),
            "dkv_ms": device_ms(lambda: W.banded_attention_dkv(q, k, v, mask, cot, WINDOW)),
            "sdpa_bwd_ms": device_ms(lambda: torch.autograd.grad(fwd(), leaves, cot))
            - device_ms(fwd),
        })
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backward", action="store_true", help="time #6 and #7 instead of #5")
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
    total = sum(LAUNCHES.values())
    mean = lambda rows, col, n: sum(r[col] * r[n] for r in rows) / total  # noqa: E731
    if args.backward:
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for masked, key in ((True, "bwd"), (False, "bwd_unmasked")):
                rows = backward_rows(W, g, dtype, masked)
                record[f"{key}_{name}"] = {
                    col: mean(rows, col, "launches_per_step")
                    for col in ("dq_ms", "dkv_ms", "sdpa_bwd_ms")} | {"shapes": rows}
    for dtype, key, masked in (() if args.backward else (
            (torch.bfloat16, "bf16", True), (torch.float32, "f32", True),
            (torch.bfloat16, "bf16_unmasked", False))):
        rows = []
        for T, launches in LAUNCHES.items():
            q, k, v, mask = case(g, BATCH[dtype], T, dtype, masked)
            allowed = band_mask(mask)
            rows.append({
                "T": T, "batch": BATCH[dtype], "launches_per_forward": launches,
                "ms": device_ms(lambda: W.banded_attention(q, k, v, mask, WINDOW)),
                "sdpa_ms": device_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)),
            })
        record[key] = {col: mean(rows, col, "launches_per_forward") for col in ("ms", "sdpa_ms")}
        record[key]["shapes"] = rows
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
