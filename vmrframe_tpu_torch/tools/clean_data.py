"""Dataset cleaning (counterpart of ``vmrframe_tpu/tools/clean_data.py``;
the reference's ``scripts/clean_charades.py`` and ``scripts/round_anet.py``).

- ``--mode clean``: keep [vid, duration, span, sentence] and append a
  running sample id; a span must end within its duration.
- ``--mode round``: durations and spans to 2 decimals, span ends clamped to
  the duration.
- ``--mode prepare-ban``: both splits of a Charades annotation directory
  cleaned into the ``charades_clean/{train,test}.json`` layout that the
  reference's BAN config names and never ships.

    python -m vmrframe_tpu_torch.tools.clean_data --mode clean --in A.json --out B.json
    python -m vmrframe_tpu_torch.tools.clean_data --mode round --in A.json --out B.json
    python -m vmrframe_tpu_torch.tools.clean_data --mode prepare-ban --in data/charades_gt \\
        --out data/charades_clean
"""

from __future__ import annotations

import argparse
import json
import os


def clean_annotations(records):
    out = []
    for sample_id, record in enumerate(records):
        duration, span = record[1], record[2]
        assert duration >= span[1], f"{duration} {span[1]}"
        out.append(record[:4] + [sample_id])
    return out


def round_durations(records):
    out = []
    for record in records:
        vid, duration, (s, e), sentence = record[:4]
        duration = round(duration, 2)
        e = min(round(e, 2), duration)
        s = min(round(s, 2), e)
        out.append([vid, duration, [s, e], sentence] + list(record[4:]))
    return out


def prepare_ban(src_dir: str, out_dir: str):
    """``train.json`` and ``test.json`` of ``src_dir`` cleaned into
    ``out_dir``; [(path written, records)]."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for split in ("train", "test"):
        src, dst = os.path.join(src_dir, f"{split}.json"), os.path.join(out_dir, f"{split}.json")
        with open(src, encoding="utf8") as f:
            records = json.load(f)
        cleaned = clean_annotations(records)
        with open(dst, "w", encoding="utf8") as f:
            json.dump(cleaned, f)
        written.append((dst, len(cleaned)))
        print(f"{split}: {len(records)} -> {len(cleaned)} records ({dst})")
    return written


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=["clean", "round", "prepare-ban"], required=True)
    parser.add_argument("--in", dest="inp", required=True,
                        help="input json (clean/round) or annotation dir (prepare-ban)")
    parser.add_argument("--out", required=True,
                        help="output json (clean/round) or output dir (prepare-ban)")
    args = parser.parse_args(argv)
    if args.mode == "prepare-ban":
        prepare_ban(args.inp, args.out)
        return
    with open(args.inp, encoding="utf8") as f:
        records = json.load(f)
    out = clean_annotations(records) if args.mode == "clean" else round_durations(records)
    with open(args.out, "w", encoding="utf8") as f:
        json.dump(out, f)
    print(f"{len(records)} -> {len(out)} records ({args.out})")


if __name__ == "__main__":
    main()
