"""CPL's training in the port against the JAX package, on the CPU, at the
tiny SeqPAN test config with ``model.name: CPL``:

- three train steps of the port's ``Trainer`` against
  ``vmrframe_tpu.train.trainer.Trainer`` from the same weights, the losses
  at 1e-4.  CPL's words ``Dropout(0.1)`` and its decoders' 0.1 are fixed
  rates; inside this test every dropout of both packages runs at rate 0
  (``model.droprate`` 0, the JAX modules' ``Dropout`` names patched, the
  port's ``Dropout`` modules set), as the JAX package's own reference
  trainer test does;
- the bf16 route: the JAX model on bf16 weights and batch against the
  port's, the outputs' types equal, the port's bf16 outputs no farther from
  the f32 forward than the JAX package's;
- the CLI: one epoch, then ``--eval`` of the best checkpoint gives the
  logged mIoU and test loss.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

import vmrframe_tpu.layers.cpl_decoder as JD
import vmrframe_tpu.models.cpl as JM
from test_torch_cca import _np, jax_variables
from test_torch_cpl import CFG, CPL, world
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.layers.dropout import Dropout as JDropout
from vmrframe_tpu.ops.precision import cast_floating
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.train.trainer import Trainer as JTrainer
from vmrframe_tpu.train.trainer import TrainState
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.layers.dropout import Dropout
from vmrframe_tpu_torch.ops.precision import cast_batch, cast_module_
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.train.trainer import Trainer

N_STEPS, BATCH = 3, 8
TRAJ = {**CPL, "model.droprate": 0.0, "train.warmup_proportion": 0.0, "train.lr": 1e-3,
        "train.batch_size": BATCH}
KEY = jax.random.PRNGKey(0)


def test_train_trajectory_matches_jax(monkeypatch):
    jcfg, cfg = jload_config(CFG).updated(TRAJ), load_config(CFG).updated(TRAJ)
    n = N_STEPS * BATCH
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=n, n_test=BATCH)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=n, n_test=BATCH)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=N_STEPS,
                    steps_per_epoch=N_STEPS)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=N_STEPS,
                  steps_per_epoch=N_STEPS)
    jbatches = list(JBatcher(jds["train_set"], jstore, jcfg, jder, "train").epoch(seed=7))
    batches = list(Batcher(ds["train_set"], store, cfg, der, "train").epoch(seed=7))
    assert len(batches) == len(jbatches) == N_STEPS

    for mod in (JM, JD):
        monkeypatch.setattr(mod, "Dropout", lambda rate: JDropout(0.0))
    trainer = Trainer(cfg, der, ds["word_vector"], device="cpu")
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    jtrainer = JTrainer(jcfg, jder, jds["word_vector"])
    jb0 = {k: jnp.asarray(v) for k, v in jbatches[0].items() if k != "num_valid"}
    shapes = jax.eval_shape(lambda b: jtrainer.model.init({"params": KEY, "dropout": KEY}, b,
                                                          True), jb0)
    variables = jax_variables(trainer.model, shapes)
    params, constants = variables["params"], {"constants": variables["constants"]}
    state = jax.device_put(TrainState(params, constants, jtrainer.tx.init(params),
                                      jnp.zeros((), jnp.int32), {}), jtrainer._repl)
    step = jtrainer.compiled_train_step()
    jlosses = []
    for b in jbatches:
        state, metrics = step(state, jtrainer._shard_batch(b), jax.random.PRNGKey(1))
        jlosses.append(float(metrics["loss"]))
    losses = [float(trainer.train_step(trainer.to_device(b))["loss"]) for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[0] != losses[-1]


def test_bf16_route_follows_flax_promotion():
    """bf16 weights (rank >= 2) and batch on both sides: ``words_logit``,
    ``center`` and ``width`` bf16, ``gauss_weight`` f32 (computed in f32)
    in both, the causal mask promoting the self-attention logits to f32
    before the softmax returns to bf16.  Through four bf16 decoder layers
    the two packages round apart by several bf16 steps (XLA's fusions of
    the jitted JAX forward keep some bf16 intermediates in f32; its op-by-op
    forward lies 0.023 from its jitted one on logits of 1.8), so each output
    is held to the f32 forward instead: the port's bf16 output lies no
    farther from it than the JAX bf16 output does, with 25% to spare (here
    0.036 against 0.048 for the logits, 2.4e-3 against 2.9e-3 for the
    centers)."""
    w = world()
    bf = jnp.bfloat16
    apply = jax.jit(lambda v, b: w["jmodel"].apply(v, b, True))
    want = apply(cast_floating(w["variables"], bf), cast_floating(w["jb"], bf))
    f32 = apply(w["variables"], w["jb"])
    model = get_model_entry("CPL").model_cls(w["cfg"], w["der"], w["ds"]["word_vector"])
    model.load_state_dict(w["model"].state_dict(), strict=True)
    cast_module_(model.eval(), torch.bfloat16)
    with torch.no_grad():
        got = model(cast_batch(w["tb"], torch.bfloat16))
    for key in ("words_logit", "center", "width", "gauss_weight"):
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        ref = np.asarray(f32[key])
        port_err = np.abs(_np(got[key]) - ref).max()
        jax_err = np.abs(np.asarray(want[key], np.float32) - ref).max()
        assert 0 < port_err <= 1.25 * jax_err, (key, port_err, jax_err)


def test_cli_trains_and_evaluates_cpl(tmp_path, monkeypatch):
    from vmrframe_tpu_torch import cli

    cfg = load_config(CFG).updated({**CPL, "paths.ckpt_dir": str(tmp_path / "ckpt"),
                                    "train.batch_size": 16})
    path = tmp_path / "cpl.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    monkeypatch.chdir(tmp_path)
    result = cli.main(["--config", str(path), "--synthetic", "--epochs", "1", "--device", "cpu"])
    assert result["steps"] > 0 and result["best_path"].endswith("best_CPL.pt")
    evaluated = cli.main(["--config", str(path), "--synthetic", "--eval", "--checkpoint",
                          result["best_path"], "--device", "cpu"])
    assert evaluated["miou"] == result["best_miou"]
    assert evaluated["loss"] == result["history"][0]["test_loss"]
