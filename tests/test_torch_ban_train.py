"""BAN's training, its frozen-teacher student and its curve export in the
port against the JAX package, on the CPU, at the tiny BAN test config
(vlen 16, pooling [4, 2, 2], dims 16-32):

- three train steps of the port's ``Trainer`` against
  ``vmrframe_tpu.train.trainer.Trainer`` from the same weights, the losses
  at 1e-4, the proposals selected at each step's start equal.  BAN drops at
  seven sites at a fixed 0.1 whatever ``model.droprate`` says; inside this
  test only, every dropout of both packages' BAN runs at rate 0
  (``model.droprate`` 0, the JAX module's ``Dropout`` name patched, the
  port's ``Dropout`` modules set), so a train step is deterministic.  The
  selection is data-dependent and stop-gradient: a near-tie flipped by a
  step's rounding would part the trajectories, so the proposals are
  compared at every step.  The weights are the port's seeded init (seed 0),
  whose map scores at this size separate the selected cells from the rest;
  a mismatch would show as unequal proposals or losses, never be skipped;
- ``BaseFast_BAN_PreTrain``: the deterministic forward (the student's
  logits, the BAN teacher's row and column curves) and loss at 1e-4, and a
  port train step leaving the teacher bit-equal with zero Adam moments;
- the BAN export (``tools/export_labels.py``: row and column maxima of
  sigmoid(tmap) * mask2d over each clip, L2-normalized) against the JAX
  tool at 1e-5;
- the CLI trains BAN one epoch and ``--eval`` of its best checkpoint gives
  the logged best mIoU and test loss.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

import vmrframe_tpu.models.ban as JB
from test_torch_ban import TINY, jax_variables
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.layers.dropout import Dropout as JDropout
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.tools import export_labels as JE
from vmrframe_tpu.train.trainer import Trainer as JTrainer
from vmrframe_tpu.train.trainer import TrainState
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.layers.dropout import Dropout
from vmrframe_tpu_torch.models import ban as B
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.tools import export_labels as E
from vmrframe_tpu_torch.train.trainer import Trainer
from vmrframe_tpu_torch.weights import init_weights, load_jax_params

HERE = os.path.dirname(__file__)
STUDENT = os.path.join(HERE, "configs", "charades_seqpan.yaml")
N_STEPS, BATCH = 3, 8
TRAJ = {"model.droprate": 0.0, "train.warmup_proportion": 0.0, "train.lr": 1e-3,
        "train.batch_size": BATCH}


def _no_dropout(model):
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    return model


def _worlds(jcfg, cfg, n_train, n_test=4):
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=n_train, n_test=n_test)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=n_train, n_test=n_test)
    steps = -(-n_train // BATCH)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=steps,
                    steps_per_epoch=steps)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=steps,
                  steps_per_epoch=steps)
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, jstore=jstore, ds=ds, store=store, jder=jder,
                der=der)


def _jax_state(jtrainer, model, jb):
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: jtrainer.model.init(
        {"params": key, "dropout": key, "gumbel": key}, b, True), jb)
    variables = jax_variables(model, shapes)
    constants = {k: v for k, v in variables.items() if k != "params"}
    return variables["params"], constants


# -------------------------------------------------------------- trajectory


def test_train_trajectory_matches_jax(monkeypatch):
    jcfg, cfg = jload_config(TINY).updated(TRAJ), load_config(TINY).updated(TRAJ)
    w = _worlds(jcfg, cfg, N_STEPS * BATCH)
    entry, jentry = get_model_entry("BAN"), jget_model_entry("BAN")
    jbatches = list(jentry.batcher_cls(w["jds"]["train_set"], w["jstore"], jcfg, w["jder"],
                                       "train").epoch(seed=7))
    batches = list(entry.batcher_cls(w["ds"]["train_set"], w["store"], cfg, w["der"],
                                     "train").epoch(seed=7))
    assert len(batches) == len(jbatches) == N_STEPS

    monkeypatch.setattr(JB, "Dropout", lambda rate: JDropout(0.0))
    jtrainer = JTrainer(jcfg, w["jder"], w["jds"]["word_vector"])
    jb0 = {k: jnp.asarray(v) for k, v in jbatches[0].items() if k != "num_valid"}
    seeded = init_weights(entry.model_cls(cfg, w["der"], w["ds"]["word_vector"]), 0)
    params, constants = _jax_state(jtrainer, seeded, jb0)
    start, constants = jax.device_get(params), jax.device_get(constants)  # the step donates
    state = jax.device_put(TrainState(params, constants, jtrainer.tx.init(params),
                                      jnp.zeros((), jnp.int32), {}), jtrainer._repl)
    step = jtrainer.compiled_train_step()
    jlosses, jprops = [], []
    for b in jbatches:
        jbd = {k: jnp.asarray(v) for k, v in b.items() if k != "num_valid"}
        out = jtrainer.model.apply({"params": jax.device_get(state.params), **constants}, jbd,
                                   True)
        jprops.append(np.asarray(out["coarse_pred"]))
        state, metrics = step(state, jtrainer._shard_batch(b), jax.random.PRNGKey(1))
        jlosses.append(float(metrics["loss"]))

    trainer = Trainer(cfg, w["der"], w["ds"]["word_vector"], device="cpu")
    load_jax_params(trainer.model, start, constants["constants"])
    _no_dropout(trainer.model)
    selected = []
    real = B.proposal_selection
    monkeypatch.setattr(B, "proposal_selection",
                        lambda *a, **k: selected.append(real(*a, **k)) or selected[-1])
    losses = []
    for b in batches:
        losses.append(float(trainer.train_step(trainer.to_device(b))["loss"]))
    props = [torch.stack([trainer.model.cells_i[s], trainer.model.cells_j[s] + 1], -1).numpy()
             for s in selected]
    for k in range(N_STEPS):
        np.testing.assert_array_equal(props[k], jprops[k], err_msg=f"step {k}")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[0] != losses[-1]


# --------------------------------------------------- BaseFast_BAN_PreTrain


def _pretrain_configs():
    """The student at the tiny SeqPAN config beside a BAN teacher of the BAN
    test config's widths at the student's vlen and vdim (the JAX package's
    ``tests/test_ban_pretrain.py``)."""
    out = []
    for load in (jload_config, load_config):
        ban, student = load(TINY), load(STUDENT)
        teacher = dict(ban.model.to_dict(), vlen=student.model.vlen, vdim=student.model.vdim,
                       name="BAN", droprate=0.0)
        out.append(student.updated({"model.name": "BaseFast_BAN_PreTrain",
                                    "loss.temperature": 3, "teacher0.model": teacher,
                                    "gcn": ban.gcn.to_dict(), "train.batch_size": BATCH,
                                    "model.droprate": 0.0}))
    return out


def test_ban_pretrain_forward_and_frozen_teacher():
    jcfg, cfg = _pretrain_configs()
    w = _worlds(jcfg, cfg, BATCH)
    name = "BaseFast_BAN_PreTrain"
    entry, jentry = get_model_entry(name), jget_model_entry(name)
    batch = next(Batcher(w["ds"]["train_set"], w["store"], cfg, w["der"], "test").epoch(seed=0))
    jbatch = next(JBatcher(w["jds"]["train_set"], w["jstore"], jcfg, w["jder"],
                           "test").epoch(seed=0))
    for key in jbatch:
        np.testing.assert_array_equal(batch[key], jbatch[key], err_msg=key)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items() if k != "num_valid"}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items() if k != "num_valid"}
    model = init_weights(entry.model_cls(cfg, w["der"], w["ds"]["word_vector"]), 0).eval()
    jmodel = jentry.model_cls(jcfg, w["jder"], w["jds"]["word_vector"])
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: jmodel.init({"params": key, "dropout": key,
                                                   "gumbel": key}, b, True), jb)
    variables = jax_variables(model, shapes)
    assert any(k.startswith("teach_model.boundary_aware") for k in model.state_dict())
    # jitted: the curves read the teacher's map before its proposal selection
    want = jax.jit(lambda v, b: jmodel.apply(v, b, True))(variables, jb)
    with torch.no_grad():
        got = model(tb)
    for key in ("slogits", "elogits", "slogits_t0", "elogits_t0"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)
    assert got["slogits_t0"].shape == (BATCH, cfg.model.vlen)
    np.testing.assert_allclose(float(entry.loss_fn(got, tb, cfg).detach()),
                               float(jentry.loss_fn(want, jb, jcfg)), atol=1e-4, rtol=1e-4)

    trainer = Trainer(cfg, w["der"], w["ds"]["word_vector"], device="cpu")
    teacher = {k: v.clone() for k, v in trainer.model.named_parameters()
               if k.startswith("teach_model.")}
    trainer.train_step(trainer.to_device(batch))
    after = dict(trainer.model.named_parameters())
    assert len(teacher) > 40
    assert all(torch.equal(v, after[k]) for k, v in teacher.items())
    mu = trainer.optimizer.state["mu"]
    assert all(not mu[k].any() for k in teacher)
    assert mu["predictor.start_dense.weight"].any()


# ------------------------------------------------------------------- export


def test_ban_export_matches_the_jax_tool(tmp_path):
    n_train = 12  # two batches of 8, the last partial
    jcfg, cfg = jload_config(TINY), load_config(TINY)
    w = _worlds(jcfg, cfg, n_train)
    trainer = Trainer(cfg, w["der"], w["ds"]["word_vector"], device="cpu")
    got = E.export_labels(cfg, w["der"], w["ds"], w["store"], trainer, str(tmp_path / "ours.pkl"))
    jtrainer = JTrainer(jcfg, w["jder"], w["jds"]["word_vector"])
    jbatch = next(jget_model_entry("BAN").batcher_cls(w["jds"]["train_set"], w["jstore"], jcfg,
                                                      w["jder"], "test").epoch(seed=0))
    jb = {k: jnp.asarray(v) for k, v in jbatch.items() if k != "num_valid"}
    params, constants = _jax_state(jtrainer, trainer.model, jb)
    state = TrainState(params, constants, None, 0, {})
    # the tool applies the model op by op; the curves read tmap, which comes
    # before the proposal selection, so the jitted forward gives them too
    jtrainer.model = types.SimpleNamespace(apply=jax.jit(jtrainer.model.apply, static_argnums=2))
    want = JE.export_labels(jcfg, w["jder"], w["jds"], w["jstore"], state, jtrainer,
                            str(tmp_path / "jax.pkl"))
    assert len(got) == len(want) == n_train
    with open(tmp_path / "ours.pkl", "rb") as f:
        assert pickle.load(f)[3][0] == got[3][0]
    for (vid, curve), (jvid, jcurve) in zip(got, want):
        assert vid == jvid and curve.dtype == np.float32 and curve.shape == jcurve.shape
        np.testing.assert_allclose(curve, jcurve, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(curve, axis=1), 1.0, atol=1e-5)


# --------------------------------------------------------------------- CLI


def test_cli_trains_and_evaluates_ban(tmp_path, monkeypatch, caplog):
    from vmrframe_tpu_torch import cli

    cfg = load_config(TINY).updated({"paths.ckpt_dir": str(tmp_path / "ckpt"),
                                     "train.batch_size": 4})
    path = tmp_path / "ban.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    monkeypatch.chdir(tmp_path)
    result = cli.main(["--config", str(path), "--synthetic", "--epochs", "1", "--device", "cpu"])
    assert result["steps"] > 0 and result["best_path"].endswith("best_BAN.pt")
    evaluated = cli.main(["--config", str(path), "--synthetic", "--eval", "--checkpoint",
                          result["best_path"], "--device", "cpu"])
    assert evaluated["miou"] == result["best_miou"]
    assert evaluated["loss"] == result["history"][0]["test_loss"]
