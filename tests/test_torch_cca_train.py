"""CCA's model, training and export in the port against the JAX package, on
the CPU, at the tiny CCA test config (16 clips, 24 concepts, width 16):

- the deterministic forward (``scores2d``), the loss and the spans against
  the jitted JAX forward (1e-4, spans equal; at this size the top two cells
  of each sample lie far apart);
- the bf16 route: the JAX model on bf16 weights, constants and batch (the
  bf16 policy's rank rule) against the port's; ``scores2d`` is f32 in both
  (the f32 ``v_t_param`` promotes the blend) and lies within the bf16
  rounding of the map branch;
- three train steps of the port's ``Trainer`` against
  ``vmrframe_tpu.train.trainer.Trainer`` from the same weights, with the
  two fixed dropouts (0.5 and 0.1) at rate 0 in both packages inside the
  test: the losses at 1e-4, BatchNorm's running statistics after the
  third step, and the eval forward on them;
- the export (``tools/export_labels.py``: row and column maxima of
  sigmoid(scores2d) * mask2d(NUM_CLIPS) over each clip, L2-normalized)
  against the JAX tool at 1e-5, and those curves training
  ``BaseFast_CCA_PreTrain``;
- the CLI: one epoch, then ``--eval`` of the best checkpoint gives the
  logged mIoU and test loss.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml
from flax import traverse_util

import vmrframe_tpu.models.cca as JC
from test_torch_cca import TINY, _np, jax_variables
from test_torch_distill import configs as distill_configs
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.cca_batcher import CCABatcher as JCCABatcher
from vmrframe_tpu.layers.dropout import Dropout as JDropout
from vmrframe_tpu.ops.precision import cast_floating
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.tools import export_labels as JE
from vmrframe_tpu.train.trainer import Trainer as JTrainer
from vmrframe_tpu.train.trainer import TrainState
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.cca_batcher import CCABatcher
from vmrframe_tpu_torch.layers.dropout import Dropout
from vmrframe_tpu_torch.ops.precision import cast_batch, cast_module_
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.tools import export_labels as E
from vmrframe_tpu_torch.train.trainer import Trainer
from vmrframe_tpu_torch.models import cca as C
from vmrframe_tpu_torch.weights import from_jax_params, init_weights

N_STEPS, BATCH = 3, 8
TRAJ = {"train.warmup_proportion": 0.0, "train.lr": 1e-3, "train.batch_size": BATCH}
KEY = jax.random.PRNGKey(0)
LSTM_STEPS = 4  # bf16 steps at the query LSTM output's largest magnitude (3.0 measured)


def _world(n_train, updates=None):
    updates = {**TRAJ, **(updates or {})}
    jcfg, cfg = jload_config(TINY).updated(updates), load_config(TINY).updated(updates)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=n_train, n_test=BATCH)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=n_train, n_test=BATCH)
    steps = -(-n_train // BATCH)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=steps,
                    steps_per_epoch=steps)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=steps,
                  steps_per_epoch=steps)
    model = init_weights(get_model_entry("CCA").model_cls(cfg, der, ds["word_vector"]), 0)
    jmodel = jget_model_entry("CCA").model_cls(jcfg, jder, jds["word_vector"])
    jbatch = next(JCCABatcher(jds["test_set"], jstore, jcfg, jder, "test").epoch(seed=0))
    batch = next(CCABatcher(ds["test_set"], store, cfg, der, "test").epoch(seed=0))
    jb = {k: jnp.asarray(v) for k, v in jbatch.items() if k != "num_valid"}
    shapes = jax.eval_shape(lambda b: jmodel.init({"params": KEY, "dropout": KEY}, b, True), jb)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items() if k != "num_valid"}
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, jstore=jstore, ds=ds, store=store, jder=jder,
                der=der, model=model.eval(), jmodel=jmodel, jb=jb, tb=tb,
                variables=jax_variables(model, shapes))


def _apply(jmodel):
    return jax.jit(lambda v, b: jmodel.apply(v, b, True))


def test_forward_loss_and_spans_match_jax():
    w = _world(BATCH)
    jentry, entry = jget_model_entry("CCA"), get_model_entry("CCA")
    want = _apply(w["jmodel"])(w["variables"], w["jb"])
    with torch.no_grad():
        got = w["model"](w["tb"])
    assert set(got) == set(want)
    np.testing.assert_allclose(_np(got["scores2d"]), np.asarray(want["scores2d"]), atol=1e-4)
    np.testing.assert_allclose(float(entry.loss_fn(got, w["tb"], w["cfg"])),
                               float(jentry.loss_fn(want, w["jb"], w["jcfg"])), rtol=1e-4)
    # spans: the argmax cells, each sample's top two apart by far more than the distance
    top2 = np.sort((np.asarray(jax.nn.sigmoid(want["scores2d"]))
                    * JC.dense_mask2d(16)).reshape(BATCH, -1), axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
    np.testing.assert_array_equal(entry.infer_fn(got, w["tb"], w["cfg"]).numpy(),
                                  np.asarray(jentry.infer_fn(want, w["jb"], w["jcfg"])))


def test_bf16_route_follows_flax_promotion():
    """The bf16 policy's rank rule on both sides: the adjacency, concept
    embeddings, GloVe table, unk row and every rank-2+ weight bf16; the
    BatchNorm statistics and ``v_t_param`` f32.  The route's types are the
    JAX model's (its module outputs all bf16 but BatchNorm's f32), and
    ``scores2d`` comes out f32 in both: the f32 scalar promotes the blend
    of two bf16 score maps.  The values agree to the bf16 resolution of the
    scores, two bf16 steps (2 * 2**-7) of their largest magnitude: the port
    rounds each of the two blended maps to bf16, as the model's types say,
    where XLA's fusion of the jitted JAX forward keeps them f32 (0.0166 of
    1.7 here).  The query LSTM scans in bf16 on both sides
    (``test_bf16_query_lstm_follows_the_jax_scan``)."""
    w = _world(BATCH)
    bf = jnp.bfloat16
    v = cast_floating(w["variables"], bf)
    assert v["constants"]["C_GCN"]["adj_all"].dtype == bf and v["params"]["v_t_param"].dtype \
        == jnp.float32 and v["batch_stats"]["sim_map"]["bn"]["var"].dtype == jnp.float32
    want = _apply(w["jmodel"])(v, cast_floating(w["jb"], bf))["scores2d"]
    model = cast_module_(w["model"], torch.bfloat16)
    try:
        assert model.C_GCN.adj_all.dtype == torch.bfloat16
        assert model.sim_map.bn.running_var.dtype == torch.float32
        with torch.no_grad():
            got = model(cast_batch(w["tb"], torch.bfloat16))["scores2d"]
    finally:
        model.float()
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2 * 2 ** -7 * scale)


def test_bf16_query_lstm_follows_the_jax_scan():
    """The query LSTM (``sim_lstm``) under the bf16 policy, on the same
    weights and the same bf16 word features: the jitted JAX scan adds its
    f32 biases in f32, rounds the input projection to bf16 and keeps its
    state in bf16; the port's LSTM sums each gate's two biases in f32,
    rounds them once and runs in bf16 too.  The output is bf16 on both
    sides and within ``LSTM_STEPS`` bf16 steps of JAX's largest magnitude
    (the two scans round their gates at different places)."""
    w = _world(BATCH)
    bf = jnp.bfloat16
    _, inter = jax.jit(lambda v, b: w["jmodel"].apply(v, b, True, capture_intermediates=True))(
        cast_floating(w["variables"], bf), cast_floating(w["jb"], bf))
    want = inter["intermediates"]["sim_lstm"]["__call__"][0]
    model = cast_module_(w["model"], torch.bfloat16)
    got = []
    hook = model.sim_lstm.register_forward_hook(lambda mod, args, out: got.append(out))
    try:
        with torch.no_grad():
            model(cast_batch(w["tb"], torch.bfloat16))
    finally:
        hook.remove()
        model.float()
    assert want.dtype == bf and len(got) == 1 and got[0].dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(_np(got[0]) - want).max() <= LSTM_STEPS * step


def got_flat(tree):
    return traverse_util.flatten_dict(tree, sep="/")


def _no_dropout(model):
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    return model


def test_train_trajectory_and_running_statistics_match_jax(monkeypatch):
    w = _world(N_STEPS * BATCH)
    jentry = jget_model_entry("CCA")
    jbatches = list(JCCABatcher(w["jds"]["train_set"], w["jstore"], w["jcfg"], w["jder"],
                                "train").epoch(seed=7))
    batches = list(CCABatcher(w["ds"]["train_set"], w["store"], w["cfg"], w["der"],
                              "train").epoch(seed=7))
    assert len(batches) == len(jbatches) == N_STEPS

    monkeypatch.setattr(JC, "Dropout", lambda rate: JDropout(0.0))
    jtrainer = JTrainer(w["jcfg"], w["jder"], w["jds"]["word_vector"])
    params = w["variables"]["params"]
    constants = {k: v for k, v in w["variables"].items() if k != "params"}
    state = jax.device_put(TrainState(params, constants, jtrainer.tx.init(params),
                                      jnp.zeros((), jnp.int32), {}), jtrainer._repl)
    step = jtrainer.compiled_train_step()
    jlosses, jbias = [], []
    for b in jbatches:
        jbias.append(np.asarray(jax.device_get(state.params)["sim_map"]["conv"]["bias"]))
        state, metrics = step(state, jtrainer._shard_batch(b), jax.random.PRNGKey(1))
        jlosses.append(float(metrics["loss"]))
    jstate = jax.device_get(state)

    trainer = Trainer(w["cfg"], w["der"], w["ds"]["word_vector"], device="cpu")
    trainer.model.load_state_dict(w["model"].state_dict(), strict=True)
    _no_dropout(trainer.model)
    losses, bias = [], []
    for b in batches:
        bias.append(trainer.model.sim_map.conv.bias.detach().clone().numpy())
        losses.append(float(trainer.train_step(trainer.to_device(b))["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[0] != losses[-1]

    # The conv bias before BatchNorm has a zero gradient in train mode (the
    # batch mean takes it out), so AdamW steps it by its rounding noise,
    # differently in each package; every other parameter follows JAX.
    # Each running mean holds 0.1 * 0.9**(2 - k) of step k's bias: taken
    # out, the rest is the batch statistics of the trained convolution.
    got = jax_variables(trainer.model, {"params": state.params})["params"]
    for path, want in traverse_util.flatten_dict(jstate.params, sep="/").items():
        if path.replace("/", ".") not in C.TRAIN_SHIFT_INVARIANT:
            np.testing.assert_allclose(np.asarray(got_flat(got)[path]), want, atol=1e-5,
                                       err_msg=path)
    stats = jstate.constants["batch_stats"]["sim_map"]["bn"]
    bn = trainer.model.sim_map.bn
    def carried(biases):
        return sum(0.1 * 0.9 ** (N_STEPS - 1 - k) * b for k, b in enumerate(biases))

    np.testing.assert_allclose(_np(bn.running_mean) - carried(bias),
                               stats["mean"] - carried(jbias), atol=1e-5)
    np.testing.assert_allclose(_np(bn.running_var), stats["var"], rtol=1e-4)

    # the eval forward reads the running statistics, on JAX's trained state
    want = _apply(w["jmodel"])({"params": jstate.params, **jstate.constants}, w["jb"])
    trainer.model.load_state_dict(from_jax_params(jstate.params, jstate.constants["constants"],
                                                  jstate.constants["batch_stats"]), strict=True)
    metrics = trainer.eval_step(w["tb"])
    with torch.no_grad():
        scores = trainer.forward(w["tb"])["scores2d"]
    np.testing.assert_allclose(_np(scores), np.asarray(want["scores2d"]), atol=1e-4)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jentry.loss_fn(want, w["jb"], w["jcfg"])), rtol=1e-4)


def test_export_matches_the_jax_tool_and_trains_the_pretrain_student(tmp_path):
    n_train = 12  # two batches of 8, the last partial
    w = _world(n_train)
    trainer = Trainer(w["cfg"], w["der"], w["ds"]["word_vector"], device="cpu")
    trainer.model.load_state_dict(w["model"].state_dict(), strict=True)
    out = str(tmp_path / "cca_curves.pkl")
    got = E.export_labels(w["cfg"], w["der"], w["ds"], w["store"], trainer, out)
    jtrainer = JTrainer(w["jcfg"], w["jder"], w["jds"]["word_vector"])
    jtrainer.model = types.SimpleNamespace(
        apply=jax.jit(jtrainer.model.apply, static_argnums=2))  # the tool applies op by op
    params = w["variables"]["params"]
    state = TrainState(params, {k: v for k, v in w["variables"].items() if k != "params"},
                       None, 0, {})
    want = JE.export_labels(w["jcfg"], w["jder"], w["jds"], w["jstore"], state, jtrainer,
                            str(tmp_path / "jax.pkl"))
    assert len(got) == len(want) == n_train
    for (vid, curve), (jvid, jcurve) in zip(got, want):
        assert vid == jvid and curve.dtype == np.float32 and curve.shape == jcurve.shape
        np.testing.assert_allclose(curve, jcurve, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(curve, axis=1), 1.0, atol=1e-5)

    _, scfg = distill_configs("BaseFast_CCA_PreTrain", **{"loss.t0_path": out,
                                                          "train.batch_size": 4})
    sds, sstore = make_synthetic_data(scfg, seed=0, n_train=n_train, n_test=4)
    assert [r["vid"] for r in sds["train_set"]] == [v for v, _ in got]
    sder = Derived(num_words=sds["n_words"], num_chars=sds["n_chars"], num_train_steps=3,
                   steps_per_epoch=3)
    student = Trainer(scfg, sder, sds["word_vector"], device="cpu")
    batcher = student.entry.batcher_cls(sds["train_set"], sstore, scfg, sder, "train")
    batch = next(batcher.epoch(seed=0))
    with open(out, "rb") as f:
        curves = pickle.load(f)
    first = batcher.teacher.get(0, sds["train_set"][0], int(batch["vmasks"][0].sum()),
                                scfg.model.vlen)
    assert first.any() and curves[0][0] == sds["train_set"][0]["vid"]
    losses = [float(student.train_step(student.to_device(b))["loss"])
              for b in batcher.epoch(seed=0)]
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_cli_trains_and_evaluates_cca(tmp_path, monkeypatch):
    from vmrframe_tpu_torch import cli

    cfg = load_config(TINY).updated({"paths.ckpt_dir": str(tmp_path / "ckpt"),
                                     "train.batch_size": 8})
    path = tmp_path / "cca.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    monkeypatch.chdir(tmp_path)
    result = cli.main(["--config", str(path), "--synthetic", "--epochs", "1", "--device", "cpu"])
    assert result["steps"] > 0 and result["best_path"].endswith("best_CCA.pt")
    state = torch.load(result["best_path"], map_location="cpu", weights_only=True)
    state = state.get("params", state)
    assert float(state["sim_map.bn.running_var"].sub(1).abs().max()) > 0  # trained statistics
    evaluated = cli.main(["--config", str(path), "--synthetic", "--eval", "--checkpoint",
                          result["best_path"], "--device", "cpu"])
    assert evaluated["miou"] == result["best_miou"]
    assert evaluated["loss"] == result["history"][0]["test_loss"]
