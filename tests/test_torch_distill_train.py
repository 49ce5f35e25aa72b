"""The port's distillation training against the JAX package, on the CPU, at
the tiny test config (vlen 32, dim 32):

- three train steps of the port's ``Trainer`` from the JAX trainer's initial
  weights at droprate 0 (student and teacher), with one fixed gumbel noise in
  every match head of both packages, against
  ``vmrframe_tpu.train.trainer.Trainer`` at 1e-4: ``OneTeacher`` (both towers
  trained), ``OneTeacher_SoftLabel`` (the teacher frozen: bit-equal to its
  start in both packages, its Adam moments exactly zero) and
  ``MultiTeacher`` (three pickled teachers);
- the port's ``AdamW`` with a frozen filter against the JAX route the
  trainer takes, ``flat_adamw`` (frozen gradients in the clip norm, no
  decay and no moments for frozen leaves);
- ``load_teacher_hook`` from a port checkpoint and from a JAX ``.npz``, in
  place; a missing path warns, a checkpoint of another tree raises;
- ``restore_into`` of a frozen-teacher run, and the CLI for all five models.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import vmrframe_tpu.models.seqpan as JS
from test_torch_distill import MODELS, _write_pickle, configs
from test_torch_seqpan_train import _jax_variables
from vmrframe_tpu.config import Config as JConfig
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.train.optim import flat_adamw
from vmrframe_tpu.train.trainer import Trainer as JTrainer
from vmrframe_tpu.train.trainer import TrainState
from vmrframe_tpu_torch.config import Derived
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.models import seqpan as S
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.train.checkpoints import restore_into, save_checkpoint
from vmrframe_tpu_torch.train.optim import AdamW, linear_warmup_decay
from vmrframe_tpu_torch.train.trainer import Trainer
from vmrframe_tpu_torch.weights import init_weights

N_STEPS, BATCH = 3, 8
# droprate 0 in both towers and no warmup: train mode is deterministic but
# for the gumbel noise, and step 1 moves the weights
TRAJ = {"model.droprate": 0.0, "teacher0.model.droprate": 0.0,
        "train.warmup_proportion": 0.0, "train.lr": 1e-3, "train.batch_size": BATCH}
TRAJ_MODELS = ("OneTeacher", "OneTeacher_SoftLabel", "MultiTeacher")


def _worlds(name, updates, tmp_path, n_train=N_STEPS * BATCH, n_test=8):
    """Configs, datasets and train batchers of both packages; MultiTeacher's
    three teachers read one pickle written for the train records."""
    _, probe = configs(name, **updates)
    ds, store = make_synthetic_data(probe, seed=0, n_train=n_train, n_test=n_test)
    if name == "MultiTeacher":
        path = _write_pickle(tmp_path / "teachers.pkl", ds["train_set"], seed=1)
        updates = {**updates, **{f"loss.t{i}_path": path for i in range(3)}}
    jcfg, cfg = configs(name, **updates)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=n_train, n_test=n_test)
    steps = -(-n_train // BATCH)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=steps,
                    steps_per_epoch=steps)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=steps,
                  steps_per_epoch=steps)
    jbatcher = jget_model_entry(name).batcher_cls or JBatcher
    batcher = get_model_entry(name).batcher_cls or Batcher
    return dict(name=name, jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, jder=jder, der=der, store=store,
                jtrain=jbatcher(jds["train_set"], jstore, jcfg, jder, "train"),
                train=batcher(ds["train_set"], store, cfg, der, "train"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.fixture(scope="module", params=TRAJ_MODELS)
def trajectory(request, tmp_path_factory):
    """The JAX trainer's first N_STEPS steps from the port's seeded weights,
    every ``gumbel_softmax`` drawing one fixed noise."""
    w = _worlds(request.param, TRAJ, tmp_path_factory.mktemp("traj"))
    noise = np.random.default_rng(11).gumbel(size=(BATCH, w["cfg"].model.vlen, 4))
    noise = noise.astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "gumbel_softmax", lambda rng, logits, tau=1.0: jax.nn.softmax(
            (logits + jnp.asarray(noise, logits.dtype)) / tau, axis=-1))
        jtrainer = JTrainer(w["jcfg"], w["jder"], w["jds"]["word_vector"])
        jbatches = list(w["jtrain"].epoch(seed=7))
        jb0 = {k: jnp.asarray(v) for k, v in jbatches[0].items() if k != "num_valid"}
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda b: jtrainer.model.init(
            {"params": key, "dropout": key, "gumbel": key}, b, True), jb0)
        seeded = get_model_entry(w["name"]).model_cls(w["cfg"], w["der"], w["ds"]["word_vector"])
        variables = _jax_variables(init_weights(seeded, 0), shapes)
        params = variables["params"]
        constants = {k: v for k, v in variables.items() if k != "params"}
        start = jax.device_get(params)  # the step donates its state
        state = jax.device_put(TrainState(params, constants, jtrainer.tx.init(params),
                                          jnp.zeros((), jnp.int32), {}), jtrainer._repl)
        step = jtrainer.compiled_train_step()
        jlosses = []
        for b in jbatches:
            state, metrics = step(state, jtrainer._shard_batch(b), jax.random.PRNGKey(1))
            jlosses.append(float(metrics["loss"]))
        end = jax.device_get(state.params)
    return dict(w, noise=torch.from_numpy(noise), jlosses=jlosses, jstart=_flat(start),
                jend=_flat(end), params=start, constants=jax.device_get(state.constants)["constants"])


def _port_trainer(w, monkeypatch):
    from vmrframe_tpu_torch.weights import load_jax_params

    monkeypatch.setattr(S, "gumbel_noise", lambda logits, generator: w["noise"].to(logits.dtype))
    trainer = Trainer(w["cfg"], w["der"], w["ds"]["word_vector"], device="cpu")
    load_jax_params(trainer.model, w["params"], w["constants"])
    return trainer


def test_train_trajectory_matches_jax(trajectory, monkeypatch):
    w = trajectory
    trainer = _port_trainer(w, monkeypatch)
    start = {k: v.clone() for k, v in trainer.model.named_parameters()}
    batches = list(w["train"].epoch(seed=7))
    assert len(batches) == N_STEPS
    if w["name"] == "MultiTeacher":
        assert {"label1d_t0s", "label1d_t1s", "label1d_t2s"} <= set(batches[0])
    losses = [float(trainer.train_step(trainer.to_device(b))["loss"]) for b in batches]
    np.testing.assert_allclose(losses, w["jlosses"], rtol=1e-4)
    end = dict(trainer.model.named_parameters())
    teacher = {"OneTeacher": "teacher_t0", "OneTeacher_SoftLabel": "teach_model"}.get(w["name"])
    if teacher is None:
        return
    jnames = [k for k in w["jstart"] if k.startswith(teacher + "/")]
    names = [k for k in end if k.startswith(teacher + ".")]
    assert len(names) == len(jnames) > 100
    jmoved = [k for k in jnames if not np.array_equal(w["jstart"][k], w["jend"][k])]
    moved = [k for k in names if not torch.equal(start[k], end[k])]
    mu, nu = trainer.optimizer.state["mu"], trainer.optimizer.state["nu"]
    if w["name"] == "OneTeacher":  # trained jointly
        assert len(moved) > 100 and len(jmoved) > 100
    else:  # frozen: bit-equal to its start in both packages, its moments exactly zero
        assert moved == [] and jmoved == []
        assert all(not mu[k].any() and not nu[k].any() for k in names)
        student = [k for k in end if not k.startswith(teacher + ".")]
        assert all(mu[k].any() for k in student if k.endswith(".weight"))


# ---------------------------------------------------------------- optimizer


def test_frozen_adamw_matches_flat_adamw():
    """Random grads on a two-part tree, frozen grads nonzero (they count in
    the clip norm): 4 steps of the port's AdamW against JAX ``flat_adamw``."""
    rng = np.random.default_rng(0)
    shapes = {"teach_model/dense/kernel": (6, 5), "teach_model/dense/bias": (5,),
              "teach_model/layer_norm/scale": (5,), "predictor/dense/kernel": (5, 3),
              "predictor/dense/bias": (3,), "predictor/layer_norm/scale": (3,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 2 for k, s in shapes.items()}
             for _ in range(4)]
    cfg = JConfig({"train": {"lr": 0.01, "warmup_proportion": 0.25, "clip_norm": 1.0}})

    def nest(flat):
        out = {}
        for k, v in flat.items():
            node = out
            *parents, leaf = k.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        return out

    tx = flat_adamw(cfg, 8, frozen_filter=lambda path: path.startswith("teach_model"))
    jparams = nest(init)
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update(nest(g), opt_state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
    want = _flat(jax.device_get(jparams))

    params = {k.replace("/", "."): torch.tensor(v) for k, v in init.items()}
    opt = AdamW(params, linear_warmup_decay(0.01, 8, 0.25), 1.0,
                frozen_filter=lambda name: name.startswith("teach_model."))
    for g in grads:
        opt.step({k.replace("/", "."): torch.tensor(v) for k, v in g.items()})
    for k, v in want.items():
        got = params[k.replace("/", ".")].numpy()
        if k.startswith("teach_model"):
            np.testing.assert_array_equal(got, init[k], err_msg=k)
            assert not opt.state["mu"][k.replace("/", ".")].any()
        else:
            np.testing.assert_allclose(got, v, rtol=1e-6, atol=1e-7, err_msg=k)
    assert not np.array_equal(want["predictor/dense/kernel"], init["predictor/dense/kernel"])


# ------------------------------------------------------------- teacher hook


def _trainer(name, der, ds, **updates):
    _, cfg = configs(name, **updates)
    return Trainer(cfg, der, ds["word_vector"], device="cpu")


@pytest.fixture(scope="module")
def hook_world():
    _, cfg = configs("SeqPAN")
    ds, store = make_synthetic_data(cfg, seed=0, n_train=16, n_test=8)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=4,
                  steps_per_epoch=2)
    return ds, store, der


@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_teacher_hook_loads_in_place(fmt, hook_world, tmp_path):
    ds, _, der = hook_world
    seqpan = _trainer("SeqPAN", der, ds)
    seqpan.init_state(99)  # weights unlike any seeded teacher's
    if fmt == "pt":
        path = save_checkpoint(str(tmp_path), seqpan, name="best_SeqPAN")
    else:  # the JAX package's variables, flattened as weights.load_npz reads them
        jcfg, _ = configs("SeqPAN")
        jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=16, n_test=8)
        jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"])
        b = next(JBatcher(jds["test_set"], jstore, jcfg, jder, "test").epoch(seed=0))
        b = {k: jnp.asarray(v) for k, v in b.items() if k != "num_valid"}
        key = jax.random.PRNGKey(0)
        model = jget_model_entry("SeqPAN").model_cls(jcfg, jder, jds["word_vector"])
        shapes = jax.eval_shape(lambda x: model.init(
            {"params": key, "dropout": key, "gumbel": key}, x, True), b)
        variables = _jax_variables(seqpan.model, shapes)
        path = str(tmp_path / "seqpan.npz")
        np.savez(path, **{f"params/{k}": v for k, v in _flat(variables["params"]).items()})
    trainer = _trainer("OneTeacher_SoftLabel", der, ds,
                       **{"teacher0.model.checkpoint": path})
    seeded = _trainer("OneTeacher_SoftLabel", der, ds)
    teacher = dict(trainer.model.teach_model.named_parameters())
    for name, p in seqpan.model.named_parameters():
        torch.testing.assert_close(teacher[name], p, rtol=0, atol=0, msg=name)
    for name, p in seeded.model.named_parameters():  # the student keeps its seeded init
        if not name.startswith("teach_model."):
            assert torch.equal(dict(trainer.model.named_parameters())[name], p), name
    # in place: the optimizer steps the very tensors the model holds
    for name, p in trainer.model.named_parameters():
        assert trainer.optimizer.params[name] is p


def test_teacher_hook_warns_on_a_missing_path_and_raises_on_another_tree(hook_world, tmp_path,
                                                                        caplog):
    ds, _, der = hook_world
    seeded = _trainer("OneTeacher_SoftLabel", der, ds)
    with caplog.at_level(logging.WARNING, logger="vmrframe_tpu_torch.models.distill"):
        missing = _trainer("OneTeacher_SoftLabel", der, ds,
                           **{"teacher0.model.checkpoint": str(tmp_path / "none.pt")})
    assert "does not exist" in caplog.text
    for (name, p), q in zip(seeded.model.named_parameters(), missing.model.parameters()):
        assert torch.equal(p, q), name
    basefast = _trainer("BaseFast", der, ds)
    path = save_checkpoint(str(tmp_path), basefast, name="best_BaseFast")
    with pytest.raises(ValueError, match="missing"):
        _trainer("OneTeacher_SoftLabel", der, ds, **{"teacher0.model.checkpoint": path})


def test_restore_into_a_frozen_teacher_run(hook_world, tmp_path):
    """A full checkpoint of a frozen-teacher run restores (the teacher's zero
    moments under the same keys), and the resumed run goes on as the whole
    one."""
    ds, store, der = hook_world
    _, cfg = configs("OneTeacher_SoftLabel", **{"train.batch_size": 4})
    batches = list(Batcher(ds["train_set"], store, cfg, der, "train").epoch(seed=1))[:3]
    make = lambda: Trainer(cfg, der, ds["word_vector"], device="cpu")  # noqa: E731
    whole = make()
    for b in batches:
        whole.train_step(whole.to_device(b))
    first = make()
    first.train_step(first.to_device(batches[0]))
    path = save_checkpoint(str(tmp_path), first, name="last", full=True)
    resumed = make()
    restore_into(resumed, path)
    assert resumed.optimizer.state["count"] == 1 and resumed.step == 1
    for moment in ("mu", "nu"):
        assert set(resumed.optimizer.state[moment]) == set(first.optimizer.state[moment])
        assert not any(v.any() for k, v in resumed.optimizer.state[moment].items()
                       if k.startswith("teach_model."))
    for b in batches[1:]:
        resumed.train_step(resumed.to_device(b))
    for (name, p), q in zip(whole.model.named_parameters(), resumed.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)


# --------------------------------------------------------------------- CLI


@pytest.mark.parametrize("name", MODELS)
def test_cli_trains_and_evaluates_each_model(name, tmp_path, monkeypatch):
    from vmrframe_tpu_torch.cli import main

    _, cfg = configs(name, **{"paths.ckpt_dir": "ckpt/", "train.batch_size": 8})
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    monkeypatch.chdir(tmp_path)
    fit = main(["--config", "tiny.yaml", "--synthetic", "--epochs", "1", "--device", "cpu"])
    assert fit["steps"] == 8 and os.path.exists(fit["best_path"])
    assert np.isfinite(fit["history"][0]["train_loss"])
    ev = main(["--config", "tiny.yaml", "--synthetic", "--eval", "--device", "cpu",
               "--checkpoint", fit["best_path"]])
    assert ev["miou"] == fit["best_miou"]
