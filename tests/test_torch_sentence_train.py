"""Training the sentence variants and BackBoneActionFormer through the port,
on the CPU, at the tiny test config (vlen 32, dim 32, ``sentence_dim`` 32):

- 3 train steps of the port's ``Trainer`` from the JAX trainer's initial
  weights at droprate 0 against ``vmrframe_tpu.train.trainer.Trainer`` at
  1e-4: BackBoneBertSentence (one fixed gumbel noise in the match head of
  both packages) and BackBoneAlignFeature (loc + alignment loss);
- the CLI (``--synthetic``) trains one epoch of each of the three new
  families and ``--eval`` of the best checkpoint gives the logged mIoU.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import vmrframe_tpu.models.seqpan as JS
from test_torch_seqpan_train import _jax_variables
from test_torch_sentence import CFG, MODELS, sentence_dim
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.train.trainer import Trainer as JTrainer
from vmrframe_tpu.train.trainer import TrainState
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.models import seqpan as S
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.train.trainer import Trainer
from vmrframe_tpu_torch.weights import init_weights, load_jax_params

N_STEPS, BATCH = 3, 8
TRAJ = {"model.droprate": 0.0, "train.warmup_proportion": 0.0, "train.lr": 1e-3,
        "train.batch_size": BATCH}


@pytest.fixture(scope="module", params=MODELS)
def trajectory(request):
    """The JAX trainer's first N_STEPS steps from the port's seeded weights,
    every ``gumbel_softmax`` drawing one fixed noise."""
    name = request.param
    updates = {"model.name": name, **TRAJ}
    jcfg, cfg = jload_config(CFG).updated(updates), load_config(CFG).updated(updates)
    n = N_STEPS * BATCH
    noise = np.random.default_rng(11).gumbel(size=(BATCH, cfg.model.vlen, 4)).astype(np.float32)
    with sentence_dim(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "gumbel_softmax", lambda rng, logits, tau=1.0: jax.nn.softmax(
            (logits + jnp.asarray(noise, logits.dtype)) / tau, axis=-1))
        jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=n, n_test=8)
        ds, store = make_synthetic_data(cfg, seed=0, n_train=n, n_test=8)
        jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"],
                        num_train_steps=N_STEPS, steps_per_epoch=N_STEPS)
        der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=N_STEPS,
                      steps_per_epoch=N_STEPS)
        jbatches = list(jget_model_entry(name).batcher_cls(jds["train_set"], jstore, jcfg, jder,
                                                           "train").epoch(seed=7))
        batches = list(get_model_entry(name).batcher_cls(ds["train_set"], store, cfg, der,
                                                         "train").epoch(seed=7))
        jtrainer = JTrainer(jcfg, jder, jds["word_vector"])
        jb0 = {k: jnp.asarray(v) for k, v in jbatches[0].items() if k != "num_valid"}
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda b: jtrainer.model.init(
            {"params": key, "dropout": key, "gumbel": key}, b, True), jb0)
        seeded = get_model_entry(name).model_cls(cfg, der, ds["word_vector"])
        variables = _jax_variables(init_weights(seeded, 0), shapes)
        params = variables["params"]
        constants = {k: v for k, v in variables.items() if k != "params"}
        start = jax.device_get(params)
        state = jax.device_put(TrainState(params, constants, jtrainer.tx.init(params),
                                          jnp.zeros((), jnp.int32), {}), jtrainer._repl)
        step = jtrainer.compiled_train_step()
        jlosses = []
        for b in jbatches:
            state, metrics = step(state, jtrainer._shard_batch(b), jax.random.PRNGKey(1))
            jlosses.append(float(metrics["loss"]))
    return dict(name=name, cfg=cfg, der=der, ds=ds, batches=batches, jlosses=jlosses,
                params=start, constants=jax.device_get(state.constants).get("constants", {}),
                noise=torch.from_numpy(noise))


def test_train_trajectory_matches_jax(trajectory, monkeypatch):
    w = trajectory
    monkeypatch.setattr(S, "gumbel_noise", lambda logits, generator: w["noise"].to(logits.dtype))
    with sentence_dim():
        trainer = Trainer(w["cfg"], w["der"], w["ds"]["word_vector"], device="cpu")
    load_jax_params(trainer.model, w["params"], w["constants"])
    assert len(w["batches"]) == N_STEPS
    losses = [float(trainer.train_step(trainer.to_device(b))["loss"]) for b in w["batches"]]
    np.testing.assert_allclose(losses, w["jlosses"], rtol=1e-4)
    assert losses[0] != losses[-1]


@pytest.mark.parametrize("name", MODELS + ("BackBoneActionFormer",))
def test_cli_trains_and_evaluates(name, tmp_path, monkeypatch):
    from vmrframe_tpu_torch.cli import main

    cfg = load_config(CFG).updated({"model.name": name, "paths.ckpt_dir": "ckpt/",
                                    "train.batch_size": 16})
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    monkeypatch.chdir(tmp_path)
    with sentence_dim():
        fit = main(["--config", "tiny.yaml", "--synthetic", "--epochs", "1", "--device", "cpu"])
        assert os.path.exists(fit["best_path"]) and np.isfinite(fit["history"][0]["train_loss"])
        ev = main(["--config", "tiny.yaml", "--synthetic", "--eval", "--device", "cpu",
                   "--checkpoint", fit["best_path"]])
    assert ev["miou"] == fit["best_miou"]
