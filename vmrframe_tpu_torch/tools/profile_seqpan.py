"""SeqPAN's eval step block by block (counterpart of
``vmrframe_tpu/tools/profile_seqpan.py``).

Times each block of SeqPAN standalone at Charades width in bf16 (the
served model of ``tools/roofline.py::seqpan_eval``: seeded weights, one
synthetic batch, random activations of each block's input shapes):
``embedding_text`` (``Embedding``), ``visual_projection``,
``feature_encoder_video`` and ``_text``, ``dual_attention_block_v`` (one
``DualAttentionBlock`` call, video from text), ``cq_attention``,
``cq_concat``, ``predictor`` (``SeqPANPredictor``), ``infer_span``
(``infer_span_1d``) and the ``full_forward``; each row names the
hand-written kernels one call launches.  Blocks timed alone lose nothing
to their neighbours, so read the ranking, not the sum
(``sum_weighted_blocks`` counts the dual block 4 times and the CQ
attention twice, as the forward runs them).

``--grad``: each block's forward and backward (the gradients of its
output's sum by its parameters; the attention cores through
``kernels/attention.py``'s autograd Functions, whose backward recomputes
the plain formula).  ``--train``: the train step at the bench
configuration (``bench_zoo``'s ``SeqPAN`` row, f32), split as
``tools/profile_model.py`` splits it: the loss in train mode, with the
gradients, with the optimizer, the full step.

Timing: ``bench_zoo.time_steps`` (calls queued between two synchronizes,
median of reps).

    python -m vmrframe_tpu_torch.tools.profile_seqpan --out chiprun_out/profile_seqpan.json
    python -m vmrframe_tpu_torch.tools.profile_seqpan --grad \\
        --out chiprun_out/profile_seqpan_grad.json
    python -m vmrframe_tpu_torch.tools.profile_seqpan --train \\
        --out chiprun_out/profile_seqpan_train.json
    python -m vmrframe_tpu_torch.tools.profile_seqpan --device cpu \\
        --config tests/configs/charades_seqpan.yaml --batch 8 --steps 1 --reps 1

Writes ``--out`` (JSON) and one JSON line a block; never the JAX package's
``docs/*.json``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

BLOCKS = ("embedding_text", "visual_projection", "feature_encoder_video",
          "feature_encoder_text", "dual_attention_block_v", "cq_attention", "cq_concat",
          "predictor")


def block_calls(model, batch) -> dict:
    """name -> (call, the module whose parameters it reads) of each block
    on inputs of the shapes the forward gives it."""
    from vmrframe_tpu_torch.ops.span import infer_span_1d

    B, L = batch["vmasks"].shape
    T, D = batch["tmasks"].shape[1], int(model.model_cfg.dim)
    g = torch.Generator(device=batch["vfeats"].device).manual_seed(0)
    dtype = batch["vfeats"].dtype
    rand = lambda *s: torch.randn(*s, generator=g, device=g.device).to(dtype)  # noqa: E731
    vfeat, tfeat, fuse = rand(B, L, D), rand(B, T, D), rand(B, L, D)
    slog, elog = torch.randn(B, L, generator=g, device=g.device), \
        torch.randn(B, L, generator=g, device=g.device)
    vmask, tmask = batch["vmasks"], batch["tmasks"]
    t_enc = getattr(model, "tfeat_encoder", model.vfeat_encoder)
    return {
        "embedding_text": (lambda: model.text_encoder(batch["words_ids"], batch["char_ids"]),
                           model.text_encoder),
        "visual_projection": (lambda: model.video_affine(batch["vfeats"]), model.video_affine),
        "feature_encoder_video": (lambda: model.vfeat_encoder(vfeat), model.vfeat_encoder),
        "feature_encoder_text": (lambda: t_enc(tfeat), t_enc),
        "dual_attention_block_v": (
            lambda: model.dual_attention_block_1(vfeat, tfeat, vmask, tmask),
            model.dual_attention_block_1),
        "cq_attention": (lambda: model.q2v_attn(vfeat, tfeat, vmask, tmask), model.q2v_attn),
        "cq_concat": (lambda: model.cq_cat(fuse, tfeat, tmask), model.cq_cat),
        "predictor": (lambda: model.predictor(fuse, vmask), model.predictor),
        "infer_span": (lambda: infer_span_1d(slog, elog, vmask.float()), None),
        "full_forward": (lambda: model(batch)["slogits"], model),
    }


def _first(out) -> torch.Tensor:
    return out[0] if isinstance(out, (tuple, list)) else out


def with_grad(call, module):
    """The call's forward and the gradients of its output's sum by the
    module's parameters."""
    params = [p for p in module.parameters() if p.is_floating_point()]

    def run():
        with torch.enable_grad():
            out = _first(call()).float().sum()
            return torch.autograd.grad(out, params, allow_unused=True)
    return run


def profile_blocks(device: str, batch_size: int = 128, config: Optional[str] = None,
                   grad: bool = False, steps: int = 10, reps: int = 3, log=print) -> dict:
    from vmrframe_tpu_torch.ops.precision import cast_batch
    from vmrframe_tpu_torch.tools.bench_zoo import kernels, time_steps
    from vmrframe_tpu_torch.tools.roofline import seqpan_eval

    _, batch, cfg, ev = seqpan_eval(batch_size, device, config)
    batch = cast_batch(batch, ev.compute_dtype)
    fns = kernels()
    ms = {}
    launched = {}
    for name, (call, module) in block_calls(ev.model, batch).items():
        if grad:
            if module is None:
                continue
            call = with_grad(call, module)
        before = [k.launches for k in fns]
        with torch.no_grad() if not grad else torch.enable_grad():
            call()
        launched[name] = {k.__name__: k.launches - b for k, b in zip(fns, before)
                          if k.launches > b}
        with torch.no_grad() if not grad else torch.enable_grad():
            ms[name] = time_steps(call, device, steps, reps)["median"]
        log(json.dumps({name: ms[name], "kernels": launched[name]}))
    weighted = sum(ms[b] for b in BLOCKS if b in ms) + 3 * ms["dual_attention_block_v"] \
        + ms["cq_attention"]
    del ev
    return {"batch": batch_size, "dtype": str(cfg.train.compute_dtype), "grad": grad,
            "ms": ms, "kernels": launched, "sum_weighted_blocks": weighted}


def profile_train(device: str, steps: int = 10, reps: int = 3, log=print) -> dict:
    from vmrframe_tpu_torch.tools import bench_zoo
    from vmrframe_tpu_torch.tools.profile_model import pieces

    cfg, trainer, train, test = bench_zoo.build("SeqPAN", device)
    names = {"fwd_loss": "loss_value_train_mode", "loss_and_grad": "loss_and_grad",
             "grad_optimizer": "grad_plus_optimizer", "full_train": "full_train_step"}
    ms = {}
    for name, (fn, _) in pieces(trainer, train, test).items():
        if name in names:
            ms[names[name]] = bench_zoo.time_steps(fn, device, steps, reps)["median"]
            log(json.dumps({names[name]: ms[names[name]]}))
    del trainer
    return {"batch": int(cfg.train.batch_size),
            "dtype": str(cfg.train.get("compute_dtype", "float32")), "ms": ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grad", action="store_true", help="each block's forward and backward")
    ap.add_argument("--train", action="store_true", help="the train step, piece by piece")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--config", default=None, help="a config's widths (default: Charades)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/profile_seqpan.json")
    args = ap.parse_args(argv)

    from vmrframe_tpu_torch.device import resolve_device, strict_f32
    from vmrframe_tpu_torch.tools.bench_kernels import card_name

    device = str(resolve_device(args.device))
    strict_f32()
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.train:
        body = profile_train(device, args.steps, args.reps, log)
    else:
        body = profile_blocks(device, args.batch, args.config, args.grad, args.steps,
                              args.reps, log)
    report = {"card": card_name(device), "device": device, **body}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
