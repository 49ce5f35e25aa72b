"""The port's ActionFormer training slice, its checkpoints and CLI, on the
CPU (split from ``test_torch_af_train.py`` so that pytest-xdist can run the
two halves on different workers; the config and data helpers are that
file's):

- a resumed run equals an uninterrupted one (droppath live); missing
  optimizer keys warn and keep a fresh state;
- the CLI on the tiny config trains, ``--eval`` reproduces the saved mIoU,
  and a config that names no files is refused;
- ``proj_pdrop`` keeps its share of the inputs in a train step.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import logging
import os

import numpy as np
import pytest
import torch
import yaml

from test_torch_af_train import LONG, TINY, _worlds
from vmrframe_tpu_torch.config import load_config
from vmrframe_tpu_torch.kernels import window_attention as W
from vmrframe_tpu_torch.train.checkpoints import restore_into, save_checkpoint
from vmrframe_tpu_torch.train.trainer import Trainer


def test_resumed_run_equals_uninterrupted_one(tmp_path):
    """droppath live: the stream of each step comes from (seed, step)."""
    w = _worlds(TINY, n_train=32, n_test=8)
    batches = list(w["train"].epoch(seed=2))
    assert len(batches) == 4
    make = lambda: Trainer(w["cfg"], w["der"], None, device="cpu")  # noqa: E731
    whole = make()
    for b in batches:
        whole.train_step(whole.to_device(b))
    first = make()
    for b in batches[:2]:
        first.train_step(first.to_device(b))
    path = save_checkpoint(str(tmp_path), first, name="last_ActionFormer", full=True)
    resumed = make()
    restore_into(resumed, path)
    assert resumed.step == 2 and resumed.optimizer.state["count"] == 2
    for b in batches[2:]:
        resumed.train_step(resumed.to_device(b))
    for (name, p), q in zip(whole.model.named_parameters(), resumed.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)
    torch.testing.assert_close(resumed.extras["loss_normalizer"],
                               whole.extras["loss_normalizer"], rtol=0, atol=0)


def test_missing_optimizer_keys_warn_and_keep_a_fresh_state(tmp_path, caplog):
    w = _worlds(TINY, n_train=8, n_test=8)
    trainer = Trainer(w["cfg"], w["der"], None, device="cpu")
    trainer.train_step(trainer.to_device(next(w["train"].epoch(seed=0))))
    path = save_checkpoint(str(tmp_path), trainer, name="last", full=True)
    payload = torch.load(path, weights_only=True)
    dropped = sorted(payload["opt_state"]["mu"])[0]
    del payload["opt_state"]["mu"][dropped]
    payload["opt_state"]["nu"]["stray.weight"] = torch.zeros(1)
    torch.save(payload, path)
    fresh = Trainer(w["cfg"], w["der"], None, device="cpu")
    with caplog.at_level(logging.WARNING):
        restore_into(fresh, path)
    text = caplog.text
    assert "MISSING" in text and dropped in text and "stray.weight" in text
    assert fresh.optimizer.state["count"] == 0 and fresh.step == 1
    for name, p in trainer.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[name], p, rtol=0, atol=0)


def test_cli_trains_and_evaluates_the_tiny_config_on_cpu(tmp_path, monkeypatch):
    from vmrframe_tpu_torch.cli import main

    cfg = load_config(LONG).updated(TINY)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    monkeypatch.chdir(tmp_path)
    before = [fn.launches for fn in W.KERNELS]
    result = main(["--config", "tiny.yaml", "--synthetic", "--epochs", "1", "--device", "cpu",
                   "--save-results", "history.json"])
    assert result["steps"] == 8 and os.path.exists(result["best_path"])
    assert result["best_path"].startswith(str(tmp_path / "ckpt"))
    assert np.isfinite(result["history"][0]["train_loss"])
    assert float(result["extras"]["loss_normalizer"]) != 100.0
    assert os.path.exists(tmp_path / "ckpt" / "tacos_" / "last_ActionFormer.pt")
    evaluated = main(["--config", "tiny.yaml", "--synthetic", "--eval", "--device", "cpu",
                      "--checkpoint", result["best_path"]])
    assert evaluated["miou"] == result["best_miou"]
    assert [fn.launches for fn in W.KERNELS] == before  # CPU: the plain versions
    with pytest.raises(FileNotFoundError, match="synthetic"):  # the config names no files
        main(["--config", "tiny.yaml", "--device", "cpu"])


def test_train_mode_raises_on_dropout():
    """``proj_pdrop`` (the config's ``train_cfg.dropout``) in a train step:
    the step runs, and the attention projection's dropout keeps a share of
    its inputs within 4 standard deviations of 230/256 (0.1 at 8 bits)."""
    cfg = load_config(LONG).updated({**TINY, "actionformer.train_cfg.dropout": 0.1})
    w = _worlds(TINY, n_train=8, n_test=8)
    trainer = Trainer(cfg, w["der"], None, device="cpu")
    seen = []
    drop = trainer.model.backbone.stem_0.attn.proj_drop
    assert drop.rate == 0.1 and drop.bits == 8
    drop.register_forward_hook(lambda mod, args, out: seen.append((args[0] != 0, out != 0)))
    metrics = trainer.train_step(trainer.to_device(next(w["train"].epoch(seed=0))))
    assert np.isfinite(float(metrics["loss"])) and trainer.step == 1
    (nonzero, kept), = seen
    n = int(nonzero.sum())
    keep = 230 / 256
    share = int((kept & nonzero).sum()) / n
    assert abs(share - keep) <= 4 * np.sqrt(keep * (1 - keep) / n)
