"""Command line (counterpart of ``vmrframe_tpu/cli.py``): train and evaluate.

    python -m vmrframe_tpu_torch --config config/charades/SeqPAN.yaml
    python -m vmrframe_tpu_torch --config ... --eval --checkpoint ckpt/.../best_SeqPAN.pt
    python -m vmrframe_tpu_torch --config ... --debug          # lazy feature reads
    python -m vmrframe_tpu_torch --config configs/tacos_actionformer_long.yaml --synthetic
    python -m vmrframe_tpu_torch --config ... --synthetic --epochs 1 --device cpu

The flags are the JAX package's (``--config --checkpoint --eval --debug
--suffix --seed --synthetic --epochs --bf16 --save-results``) plus
``--device`` (default ``cuda``).  Data parallel over N cards (or N CPU
processes with ``--device cpu``), with ``train.batch_size`` the global
batch, as the JAX trainer splits it over its mesh (``parallel/mesh.py``):

    torchrun --nproc_per_node N -m vmrframe_tpu_torch --config ... --synthetic

Only rank 0 logs, writes checkpoints and ``--save-results``.  float32
means float32 on the card: no TF32 (``device.strict_f32``).  The data come
from the config's ``paths``: the features (``paths.feature_path``, a
directory of ``*.npy`` or one ``.h5`` file, read lazily under ``--debug``)
and the dataset built from the annotation and GloVe files, cached as
``<paths.cache_dir>/<task>_<suffix>.pkl`` (``data/datasets.py``).
``--synthetic`` runs on deterministic random features and captions instead.  Checkpoints and a log file go to
``<paths.ckpt_dir>/<task>_<suffix>/``, relative to the working directory.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vmrframe_tpu_torch")
    parser.add_argument("--config", type=str, required=True, help="config file path")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="checkpoint to evaluate (--eval) or to resume from")
    parser.add_argument("--eval", action="store_true", help="only evaluate")
    parser.add_argument("--debug", action="store_true", help="lazy feature loading")
    parser.add_argument("--suffix", type=str, default="", help="task suffix")
    parser.add_argument("--seed", default=1234, type=int, help="random seed")
    parser.add_argument("--synthetic", action="store_true", help="synthetic features/annotations")
    parser.add_argument("--epochs", type=int, default=None, help="override train.epochs")
    parser.add_argument("--save-results", type=str, default=None,
                        help="--eval: per-sample predictions JSON; training: the metric history")
    parser.add_argument("--bf16", action="store_true",
                        help="mixed precision (train.compute_dtype: bfloat16; f32 masters)")
    parser.add_argument("--device", type=str, default=None, help="torch device (default cuda)")
    return parser.parse_args(argv)


def setup_logger(ckpt_dir: str, title: str) -> logging.Logger:
    """The ``vmrframe_tpu_torch`` logger: INFO to stderr and to a log file in
    ``ckpt_dir``.  It propagates, so handlers above it see its records."""
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = logging.getLogger("vmrframe_tpu_torch")
    logger.setLevel(logging.INFO)
    for handler in list(logger.handlers):  # a second run in one process: no double lines
        logger.removeHandler(handler)
        handler.close()
    fmt = logging.Formatter("%(levelname)s:%(message)s")
    log_file = os.path.join(ckpt_dir, time.strftime("%Y%m%d_%H%M%S") + f"_{title}.log")
    for handler in (logging.StreamHandler(), logging.FileHandler(log_file)):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


def load_data(cfg, derived, synthetic: bool, seed: int, lazy: bool = False):
    """(dataset, feature store, timings) for ``cfg``: deterministic random
    data from ``seed`` when ``synthetic``, else the files of ``cfg.paths``
    (the dataset through its ``.pkl`` cache).  Sets ``derived``'s vocabulary
    sizes."""
    if synthetic:
        from vmrframe_tpu_torch.testing import make_synthetic_data

        t0 = time.perf_counter()
        dataset, features = make_synthetic_data(cfg, seed=seed)
        cache, features_s = "synthetic", 0.0
    else:
        from vmrframe_tpu_torch.data.datasets import cache_path, load_dataset
        from vmrframe_tpu_torch.data.features import open_feature_store

        t0 = time.perf_counter()
        feature_path = cfg.get("paths", {}).get("feature_path", "")
        if not os.path.exists(feature_path):
            raise FileNotFoundError(f"paths.feature_path {feature_path!r} does not exist: name "
                                    f"the dataset's files in the config, or pass --synthetic")
        features = open_feature_store(feature_path, cfg.model.vlen, lazy=lazy)
        features_s = time.perf_counter() - t0
        cache = "loaded" if os.path.exists(cache_path(cfg, derived)) else "built"
        t0 = time.perf_counter()
        dataset = load_dataset(cfg, derived, vfeat_lens=features.lengths())
    data_s = time.perf_counter() - t0  # the dataset: its cache built or read
    derived.num_words = dataset["n_words"]
    derived.num_chars = dataset["n_chars"]
    return dataset, features, {"cache": cache, "data_s": data_s, "features_s": features_s,
                               "lazy": bool(getattr(features, "lazy", False))}


def main(argv=None):
    args = parse_args(argv)
    from torch import device as torch_device

    from vmrframe_tpu_torch.parallel import mesh

    on_cpu = args.device is not None and torch_device(args.device).type == "cpu"
    joined = mesh.initialize_distributed("gloo" if on_cpu else None)
    try:
        return _main(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args):
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.device import strict_f32
    from vmrframe_tpu_torch.metrics import get_i345_mi
    from vmrframe_tpu_torch.parallel import mesh
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.train.trainer import Trainer, fit

    strict_f32()
    cfg = load_config(args.config)
    if args.epochs is not None:
        cfg = cfg.updated({"train.epochs": args.epochs})
    if args.bf16:
        cfg = cfg.updated({"train.compute_dtype": "bfloat16"})
    derived = Derived(suffix=args.suffix, seed=args.seed)

    dataset, features, data = load_data(cfg, derived, args.synthetic, args.seed, lazy=args.debug)

    entry = get_model_entry(cfg.model.name)
    batcher_cls = entry.batcher_cls or Batcher
    train_batcher = batcher_cls(dataset["train_set"], features, cfg, derived, "train")
    test_batcher = batcher_cls(dataset["test_set"], features, cfg, derived, "test")
    derived.steps_per_epoch = len(train_batcher)
    derived.num_train_steps = len(train_batcher) * cfg.train.epochs

    ckpt_dir = os.path.join(cfg.paths.ckpt_dir, f"{cfg.task}_{derived.suffix}")
    if mesh.rank() == 0:
        logger = setup_logger(ckpt_dir, cfg.model.name)
    else:  # the other processes of a data-parallel run say nothing
        logger = logging.getLogger("vmrframe_tpu_torch.quiet")
        logger.propagate, logger.disabled = False, True
    logger.info(str(args))
    logger.info(f"data: {dataset['n_train']} train, {dataset['n_test']} test records, "
                f"{dataset['n_words']} words; cache {data['cache']} in {data['data_s']:.2f} s, "
                f"features read in {data['features_s']:.2f} s")

    device = args.device
    if mesh.is_distributed() and device in (None, "cuda"):  # the card of this process
        import torch

        device = f"cuda:{torch.cuda.current_device()}"
    trainer = Trainer(cfg, derived, dataset["word_vector"], device=device)

    if args.eval:
        trainer.init_state(args.seed)
        if args.checkpoint:
            from vmrframe_tpu_torch.train.checkpoints import restore_into

            restore_into(trainer, args.checkpoint)
        ious, lossmeter, secs, props = trainer.run_eval_epoch(
            test_batcher.epoch(seed=0), collect_props=True)
        r1i3, r1i5, _, r1i7, mi = get_i345_mi(ious)
        logger.info(f"TEST |\tR1I3: {r1i3:.2f}\tR1I5: {r1i5:.2f}\tR1I7: {r1i7:.2f}\t"
                    f"mIoU: {mi:.2f}\tloss:{lossmeter.avg:.4f}\tcompute_s:{secs:.2f}")
        if args.save_results and mesh.rank() == 0:
            out = []
            for rec, p, iou in zip(dataset["test_set"], props, ious):
                dur = rec["duration"]
                out.append({"vid": rec["vid"], "sentence": rec["sentence"],
                            "pred_time": [float(p[0]) * dur, float(p[1]) * dur],
                            "gt_time": [float(rec["se_time"][0]), float(rec["se_time"][1])],
                            "iou": float(iou)})
            with open(args.save_results, "w", encoding="utf8") as f:
                json.dump(out, f)
            logger.info(f"wrote {len(out)} predictions to {args.save_results}")
        return {"r1i3": r1i3, "r1i5": r1i5, "r1i7": r1i7, "miou": mi, "loss": lossmeter.avg,
                "eval_batches": len(test_batcher), **data}

    result = fit(trainer, train_batcher, test_batcher, rng_seed=args.seed, ckpt_dir=ckpt_dir,
                 log=logger.info, resume_from=args.checkpoint)
    logger.info(f"best mIoU: {result['best_miou']:.2f}")
    if args.save_results and mesh.rank() == 0:
        with open(args.save_results, "w", encoding="utf8") as f:
            json.dump({k: result[k] for k in ("best_miou", "best_path", "history")}, f)
        logger.info(f"wrote training history to {args.save_results}")
    return {**result, "eval_batches": len(test_batcher), **data}
