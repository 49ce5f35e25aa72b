"""Checkpoints (counterpart of ``vmrframe_tpu/train/checkpoints.py``, which
writes orbax trees that the port cannot read).

A checkpoint is one ``torch.save`` file, ``<ckpt_dir>/<name>.pt``, holding
``{"params": state_dict, "step": int, "extras": {...}}`` and, in a full one,
``"opt_state"``: the optimizer's ``{"count", "mu": {name: ...}, "nu": {...}}``.
All tensors are saved on the CPU.  Unlike the JAX package's, the
``extras`` (ActionFormer's EMA loss normaliser) are saved too, so a resumed
run goes on exactly as an uninterrupted one.  ``weights.load_checkpoint``
loads the ``params`` of one into a serving model.

``restore_into`` loads the weights strictly and matches the optimizer state
by key: a saved key that the live optimizer lacks is dropped with a warning;
a live key the checkpoint lacks leaves the whole optimizer state fresh, with
a loud warning (the Adam moments and the schedule's count restart).
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import torch

logger = logging.getLogger(__name__)


def _flat_opt(state: dict) -> Dict[str, object]:
    out = {"count": state["count"]}
    for moment in ("mu", "nu"):
        out.update({f"{moment}/{name}": t for name, t in state[moment].items()})
    return out


def save_checkpoint(ckpt_dir: str, trainer, name: str = "best", full: bool = False) -> str:
    """Writes ``<ckpt_dir>/<name>.pt`` (atomically) and returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"{name}.pt"))
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    payload = {"params": cpu(trainer.model.state_dict()), "step": int(trainer.step),
               "extras": cpu(trainer.extras)}
    if full:
        opt = trainer.optimizer.state
        payload["opt_state"] = {"count": int(opt["count"]), "mu": cpu(opt["mu"]),
                                "nu": cpu(opt["nu"])}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_into(trainer, path: str) -> None:
    """Weights (strict), step and extras, and the optimizer state when the
    checkpoint holds one, into a ``Trainer`` built by ``init_state``."""
    restored = load_checkpoint(path)
    trainer.model.load_state_dict(restored["params"], strict=True)
    trainer.step = int(restored.get("step", trainer.step))
    for k, v in restored.get("extras", {}).items():
        if k in trainer.extras:
            trainer.extras[k] = v.to(trainer.extras[k].device, trainer.extras[k].dtype)
    if restored.get("opt_state") is None:
        return
    live, got = _flat_opt(trainer.optimizer.state), _flat_opt(restored["opt_state"])
    extra = sorted(set(got) - set(live))
    missing = sorted(set(live) - set(got))
    if extra:
        logger.warning("checkpoint %s: optimizer state carries %d keys the live optimizer "
                       "lacks (%s ...): dropped on restore", path, len(extra), extra[:3])
    if missing:
        logger.warning("checkpoint %s: optimizer state is MISSING %d keys (%s ...): optimizer "
                       "state NOT restored; Adam moments and the schedule's count restart "
                       "fresh (warmup restarts mid-run)", path, len(missing), missing[:3])
        return
    state = trainer.optimizer.state
    state["count"] = int(got["count"])
    with torch.no_grad():
        for moment in ("mu", "nu"):
            for name, t in state[moment].items():
                t.copy_(got[f"{moment}/{name}"])
