"""The port's SeqPAN-family training: a resumed run and the CLI, on the CPU
(split from ``test_torch_seqpan_train.py`` so that pytest-xdist can run the
two halves on different workers; the config and data helpers are that
file's):

- a resumed run at droprate 0.2, the gumbel head live, equals an
  uninterrupted one, and the dropout draws from the step's stream;
- the CLI trains SeqPAN, BackBone and BaseFast on synthetic data with
  dilation and erosion, and ``--eval`` reproduces the saved mIoU.

All at the tiny test config (vlen 32, dim 32).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os

import numpy as np
import pytest
import torch
import yaml

from test_torch_seqpan_train import AUG, CFG, MODELS, _worlds
from vmrframe_tpu_torch.config import load_config
from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.train.checkpoints import restore_into, save_checkpoint
from vmrframe_tpu_torch.train.trainer import Trainer


def test_resumed_run_at_droprate_equals_uninterrupted_one(tmp_path):
    """droprate 0.2 and the gumbel head live: each step's stream comes from
    (seed, step), so a run resumed after step 2 draws what a whole run draws."""
    w = _worlds("SeqPAN", {"model.droprate": 0.2, "train.batch_size": 8}, n_train=32)
    batches = list(w["train"].epoch(seed=2))
    assert len(batches) == 4
    make = lambda: Trainer(w["cfg"], w["der"], w["ds"]["word_vector"], device="cpu")  # noqa: E731
    whole = make()
    for b in batches:
        whole.train_step(whole.to_device(b))
    first = make()
    for b in batches[:2]:
        first.train_step(first.to_device(b))
    path = save_checkpoint(str(tmp_path), first, name="last_SeqPAN", full=True)
    resumed = make()
    restore_into(resumed, path)
    for b in batches[2:]:
        resumed.train_step(resumed.to_device(b))
    for (name, p), q in zip(whole.model.named_parameters(), resumed.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)
    # and the dropout is live: the same weights with another step stream end elsewhere
    other = make()
    other.seed = 7
    for b in batches:
        other.train_step(other.to_device(b))
    assert not torch.equal(other.model.cq_cat.conv1d.weight, whole.model.cq_cat.conv1d.weight)


@pytest.mark.parametrize("name", MODELS)
def test_cli_trains_and_evaluates_the_family_on_cpu(name, tmp_path, monkeypatch):
    from vmrframe_tpu_torch.cli import main

    cfg = load_config(CFG).updated({"model.name": name, "paths.ckpt_dir": "ckpt/",
                                    "dataprocess.video_augmentation": AUG})
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    monkeypatch.chdir(tmp_path)
    before = [fn.launches for fn in K.KERNELS]
    result = main(["--config", "tiny.yaml", "--synthetic", "--epochs", "1", "--device", "cpu"])
    assert result["steps"] == 4 and os.path.exists(result["best_path"])
    assert np.isfinite(result["history"][0]["train_loss"])
    evaluated = main(["--config", "tiny.yaml", "--synthetic", "--eval", "--device", "cpu",
                      "--checkpoint", result["best_path"]])
    assert evaluated["miou"] == result["best_miou"]
    assert [fn.launches for fn in K.KERNELS] == before  # CPU: the plain versions
