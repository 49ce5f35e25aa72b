"""Teacher-curve export, the distillation flywheel (counterpart of
``vmrframe_tpu/tools/export_labels.py``): run a trained checkpoint over a
split (the train split by default) in order, in test mode, and write an
index-aligned pickle of ``[vid, (2, valid_len) float32]`` start/end curves,
which ``MultiTeacherBatcher`` and ``CCAPreTrainBatcher`` read
(``loss.t{0,1,2}_path``).

A 1D model's curves (SeqPAN, BaseFast, the students, ...) are the sigmoid of
its start and end logits over the valid frames.  A 2D model's are the row
and column maxima of its sigmoid scores times its map's mask over the valid
clips, each curve L2-normalized (the JAX tool's default ``normalize_2d``; a
zero curve stays zero): BAN's ``tmap`` with its ``map2d_mask``, CCA's
``scores2d`` with ``mask2d(NUM_CLIPS)``.  The forward is the
trainer's eval forward, in the config's ``train.compute_dtype`` (the JAX
tool applies the f32 masters directly: the same in f32).

``import_external_labels`` converts a third-party teacher's result pickle
(EMAT-style ``(vid, se_logits, vlen)`` tuples, GMD-style dicts) into the
same format.

Usage:
    python -m vmrframe_tpu_torch.tools.export_labels --config C --checkpoint P \\
        --out teacher_curves.pkl [--split train_set] [--synthetic] [--device cpu]
    python -m vmrframe_tpu_torch.tools.export_labels --import-external RESULT.pkl \\
        --out teacher_curves.pkl [--sigmoid auto|yes|no]
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from vmrframe_tpu_torch.data.labels import mask2d


def curves_from_outputs(model_name: str, outputs) -> np.ndarray:
    """(B, 2, L) teacher curves from one eval forward's outputs."""
    if "slogits" in outputs:
        return torch.stack([torch.sigmoid(outputs["slogits"]),
                            torch.sigmoid(outputs["elogits"])], dim=1).float().cpu().numpy()
    if "tmap" in outputs:
        scores, mask = outputs["tmap"], outputs["map2d_mask"]
    elif "scores2d" in outputs:
        scores = outputs["scores2d"]
        mask = torch.as_tensor(mask2d(scores.shape[-1]), device=scores.device)
    else:
        raise ValueError(f"don't know how to export teacher curves for {model_name}")
    smap = torch.sigmoid(scores) * mask[None].float()
    return torch.stack([smap.amax(dim=2), smap.amax(dim=1)], dim=1).float().cpu().numpy()


def _norm(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x)
    return x / n if n > 0 else x


@torch.no_grad()
def export_labels(cfg, derived, dataset, features, trainer, out_path: str,
                  split: str = "train_set") -> list:
    """Writes ``out_path`` and returns its list: one ``[vid, curves]`` per
    record of ``dataset[split]``, in order, each cut to its clip's length
    (a 2D model's curves L2-normalized each)."""
    from vmrframe_tpu_torch.data.batcher import Batcher

    records = dataset[split]
    batcher_cls = trainer.entry.batcher_cls or Batcher
    batcher = batcher_cls(records, features, cfg, derived, "test")
    trainer.model.eval()
    save_list = []
    for batch in batcher.epoch(seed=0, shuffle=False):
        outputs = trainer.forward(trainer.to_device(batch))
        curves = curves_from_outputs(cfg.model.name, outputs)
        is_2d = "slogits" not in outputs  # curves from a 2D map, as curves_from_outputs read them
        vlens = (batch["vmasks"].sum(axis=1) if "vmasks" in batch else batch["vlens"]).astype(int)
        for i in range(int(batch["num_valid"])):
            c = curves[i, :, : vlens[i]]
            if is_2d:
                c = np.stack([_norm(c[0]), _norm(c[1])])
            save_list.append([records[len(save_list)]["vid"], c.astype(np.float32)])
    with open(out_path, "wb") as f:
        pickle.dump(save_list, f, protocol=pickle.HIGHEST_PROTOCOL)
    return save_list


def import_external_labels(result_path: str, out_path: str, apply_sigmoid=None) -> list:
    """Converts a third-party teacher's result pickle into the teacher-curve
    format (``[vid, (2, L) float32]``):

    - EMAT style: ``(vid, se_logits, vlen)`` tuples; the logits get a sigmoid;
    - GMD style: dicts with ``vid``, ``vlen`` and ``prop_logits``; raw.

    A time-major (L, 2) array is transposed.  ``apply_sigmoid`` overrides
    the format's default."""
    with open(result_path, "rb") as f:
        entries = pickle.load(f)
    out = []
    for sample in entries:
        if isinstance(sample, dict):
            vid, arr = sample["vid"], sample["prop_logits"]
            arr = np.stack(arr) if isinstance(arr, list) else np.asarray(arr)
            do_sig = bool(apply_sigmoid) if apply_sigmoid is not None else False
        else:
            vid, arr = sample[0], sample[1]
            do_sig = bool(apply_sigmoid) if apply_sigmoid is not None else True
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim != 2:
            raise ValueError(f"teacher logits for {vid} must be 2D, got {arr.shape}")
        if arr.shape[0] != 2 and arr.shape[1] == 2:
            arr = arr.T
        if do_sig:
            arr = 1.0 / (1.0 + np.exp(-arr))
        out.append([str(vid), arr.astype(np.float32)])
    with open(out_path, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    return out


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(prog="python -m vmrframe_tpu_torch.tools.export_labels")
    parser.add_argument("--import-external", metavar="RESULT_PKL",
                        help="convert a third-party (EMAT/GMD-style) result pickle instead of "
                             "running a checkpoint")
    parser.add_argument("--sigmoid", choices=["auto", "yes", "no"], default="auto",
                        help="sigmoid the imported logits (auto: EMAT yes, GMD no)")
    parser.add_argument("--config")
    parser.add_argument("--checkpoint")
    parser.add_argument("--out", required=True)
    parser.add_argument("--split", default="train_set")
    parser.add_argument("--synthetic", action="store_true",
                        help="synthetic features and captions instead of the config's files")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args(argv)

    if args.import_external:
        sig = {"auto": None, "yes": True, "no": False}[args.sigmoid]
        out = import_external_labels(args.import_external, args.out, apply_sigmoid=sig)
        print(f"imported {len(out)} external teacher curves to {args.out}")
        return out
    if not args.config or not args.checkpoint:
        parser.error("--config and --checkpoint are required unless --import-external")

    from vmrframe_tpu_torch.cli import load_data
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.device import strict_f32
    from vmrframe_tpu_torch.train.trainer import Trainer
    from vmrframe_tpu_torch.weights import load_checkpoint

    strict_f32()
    cfg = load_config(args.config)
    derived = Derived(seed=args.seed, num_train_steps=1)
    dataset, features, _ = load_data(cfg, derived, args.synthetic, args.seed)
    trainer = Trainer(cfg, derived, dataset["word_vector"], device=args.device)
    load_checkpoint(trainer.model, args.checkpoint)
    out = export_labels(cfg, derived, dataset, features, trainer, args.out, args.split)
    print(f"wrote {len(out)} teacher curves to {args.out}")
    return out


if __name__ == "__main__":
    main()
