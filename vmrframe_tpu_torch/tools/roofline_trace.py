"""Per-operation floors from a device trace (counterpart of
``vmrframe_tpu/tools/roofline_trace.py``).

Reads one ``tools/trace_profile.py`` JSON (each device operation's time per
step, the ATen operations that launched it with their input shapes, its
category, and the step's counted traffic) and one ``tools/roofline.py``
JSON (the probes).  Each trace row is joined to the counted operation it
belongs to: the launching operation whose name and input shapes a counted
operation has (a hand-written kernel by its ``vmr::`` range).
(The outermost such operation: a counted operation is one called from
Python, and the operations it calls within are not counted on their own.)
The rows of one counted operation form a group, and each group gets a
floor by category:

- ``gemm`` and the hand-written kernels: the larger of their FLOPs at the
  peak of their type (``tools/h100.py``) and their bytes at the probe's
  rate;
- every other category (``elementwise``, ``reduction``, ``copy/layout``,
  ``memset``, ``other``): their bytes at the probe's rate.

The byte rate is ``roofline.rate_at`` each call's bytes: the best rate the
streaming probe reached at half that traffic or more.  A group that reads below
its floor means the count or the probe is wrong (``below_floor``).  Out
come ``floor_ms`` (every counted operation at its floor; the rows no count
names at zero, their time beside it as ``unjoined_ms``) and
``floor_no_copies_ms`` (the ``copy/layout`` groups removed), beside the
operations' measured sum and the step's measured time.

    python -m vmrframe_tpu_torch.tools.roofline_trace --trace chiprun_out/trace.json \\
        --probe chiprun_out/roofline.json --out chiprun_out/roofline_trace.json

Writes ``--out`` (JSON); never the JAX package's ``docs/*.json``.
"""

from __future__ import annotations

import argparse
import json
import os

from vmrframe_tpu_torch.tools.h100 import peak_ops
from vmrframe_tpu_torch.tools.roofline import rate_at

FLOOR_SHARE = 0.95  # a group measured below this share of its floor is a fault
COMPUTE = ("gemm", "kernel #")


def _key(name: str, shapes) -> str:
    return json.dumps([name, [list(s) for s in shapes if s]])


def join(rows: list, counted: list):
    """(groups by counted key, rows no counted operation names)."""
    by_key = {_key(c["op"], c["shapes"]): c for c in counted}
    groups, unjoined = {}, []
    for row in rows:
        key = next((k for k in (_key(op, shapes) for op, shapes in reversed(row["chain"]))
                    if k in by_key), None)
        if key is None:
            unjoined.append(row)
            continue
        g = groups.setdefault(key, {"counted": by_key[key], "rows": [], "ms_per_step": 0.0,
                                    "launches_per_step": 0.0})
        g["rows"].append(row)
        g["ms_per_step"] += row["ms_per_step"]
        g["launches_per_step"] += row["launches_per_step"]
    return groups, unjoined


def floor_ms(counted: dict, cat: str, probe: dict) -> float:
    """ms a step of one counted operation at its floor."""
    calls = counted["calls"]
    per_call_bytes = counted["bytes"] / counted["calls"]
    t_bytes = per_call_bytes / rate_at(probe, per_call_bytes)
    t = t_bytes
    if cat.startswith(COMPUTE):
        t = max(t, counted["flops"] / counted["calls"]
                / peak_ops(counted["dtype"] or "float32", counted["op"]))
    return calls * t * 1e3


def decompose(trace: dict, probe: dict) -> dict:
    """The trace's groups with their floors, and the step's floors."""
    groups, unjoined = join(trace["rows"], trace["counted"]["ops"])
    out, floor, copies = [], 0.0, 0.0
    for g in groups.values():
        cats = {}
        for r in g["rows"]:
            cats[r["category"]] = cats.get(r["category"], 0.0) + r["ms_per_step"]
        cat = max(cats, key=cats.get)
        f = floor_ms(g["counted"], cat, probe)
        floor += f
        copies += f if cat == "copy/layout" else 0.0
        c = g["counted"]
        out.append({"op": c["op"], "shapes": c["shapes"], "dtype": c["dtype"],
                    "category": cat, "ms_per_step": g["ms_per_step"],
                    "launches_per_step": g["launches_per_step"], "calls_per_step": c["calls"],
                    "bytes_per_step": c["bytes"], "flops_per_step": c["flops"],
                    "floor_ms": f, "measured_over_floor": g["ms_per_step"] / f if f else None,
                    "headroom_ms": g["ms_per_step"] - f,
                    "kernels": sorted({r["name"][:80] for r in g["rows"]})})
    out.sort(key=lambda r: -r["headroom_ms"])
    ops_ms = sum(r["ms_per_step"] for r in trace["rows"])
    unjoined_ms = sum(r["ms_per_step"] for r in unjoined)
    below = [r for r in out if r["measured_over_floor"] is not None
             and r["measured_over_floor"] < FLOOR_SHARE]
    ratios = [r["measured_over_floor"] for r in out if r["measured_over_floor"]]
    return {
        "model": trace.get("model"), "mode": trace.get("mode"), "batch": trace.get("batch"),
        "card": trace.get("card"), "step_ms": trace.get("step_ms"),
        "ops_ms_per_step": ops_ms, "floor_ms": floor, "floor_no_copies_ms": floor - copies,
        "floor_share_of_ops": floor / ops_ms if ops_ms else None,
        "floor_share_of_step": floor / trace["step_ms"] if trace.get("step_ms") else None,
        "unjoined_ms": unjoined_ms, "unjoined_ops": len(unjoined),
        "min_measured_over_floor": min(ratios) if ratios else None,
        "below_floor": below, "groups": out,
        "unjoined": [{"name": r["name"][:80], "op": r["chain"][0][0] if r["chain"] else None,
                      "ms_per_step": r["ms_per_step"]} for r in unjoined[:20]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="chiprun_out/trace.json")
    ap.add_argument("--probe", default="chiprun_out/roofline.json")
    ap.add_argument("--top", type=int, default=12, help="sinks printed")
    ap.add_argument("--out", default="chiprun_out/roofline_trace.json")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    with open(args.probe) as f:
        probe = json.load(f)["probes"]["hbm"]
    res = decompose(trace, probe)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k not in ("groups", "unjoined",
                                                                "below_floor")}))
    for row in res["groups"][:args.top]:
        print(json.dumps({k: row[k] for k in ("op", "category", "ms_per_step", "floor_ms",
                                               "headroom_ms", "launches_per_step")}))
    return res


if __name__ == "__main__":
    main()
