"""BackBoneActionFormer and the conv-backbone ActionFormer in the port
against the JAX package, on the CPU:

- BackBoneActionFormer at the tiny test config (vlen 32, dim 32): the JAX
  tree carried strictly (``backbone.*`` of ActionFormer's layers beside
  BackBone's), the deterministic forward, loss and spans at 1e-4 with the
  AffineDropPath scales lifted off their 1e-4 init; at dim 128 with
  ``model.fused_dual_stack`` on (the JAX side's Pallas stack in interpret
  mode) one call of the stack, 2/2 of #3/#1 and no banded attention (T 64
  is below ``pallas_min_len`` 512);
- 3-step loss trajectories from identical weights against the JAX
  ``Trainer`` at 1e-4: BackBoneActionFormer (droprate 0, stochastic depth
  off in both packages: their ``drop_path`` is the identity, the
  counterpart of ``path_pdrop`` 0 that keeps the AffineDropPath scales),
  and ActionFormer with the conv backbone (the long config cut to
  ``TINY``, droppath 0).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_actionformer import LONG, TINY, _lift_drop_path
from test_torch_seqpan_train import _jax_variables
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.af_batcher import ActionFormerBatcher as JAFBatcher
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.layers import actionformer as JL
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.train.trainer import Trainer as JTrainer
from vmrframe_tpu.train.trainer import TrainState
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.kernels import dual_stack as S
from vmrframe_tpu_torch.layers import actionformer as L
from vmrframe_tpu_torch.models import common
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.train.trainer import Trainer
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.weights import from_jax_params, init_weights, load_jax_params

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")
NAME = "BackBoneActionFormer"
ATOL = 1e-4
N_STEPS, BATCH = 3, 8


@functools.lru_cache(maxsize=None)
def _world(wide: bool):
    updates = {"model.name": NAME, "train.batch_size": 4}
    if wide:
        updates.update({"model.dim": 128, "model.vlen": 64})
    jcfg, cfg = jload_config(CFG).updated(updates), load_config(CFG).updated(updates)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=4, n_test=4)
    ds, _ = make_synthetic_data(cfg, seed=0, n_train=4, n_test=4)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=2,
                    steps_per_epoch=1)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    batch = next(JBatcher(jds["test_set"], jstore, jcfg, jder, "test").epoch(seed=0))
    batch = {k: v for k, v in batch.items() if k != "num_valid"}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jget_model_entry(NAME).model_cls(jcfg, jder, jds["word_vector"])
    rng = jax.random.PRNGKey(0)
    init = jax.jit(lambda r, b: jmodel.init({"params": r, "dropout": r, "gumbel": r}, b, True))
    variables = jax.device_get(init(rng, jb))
    variables = {**variables, "params": _lift_drop_path(variables["params"],
                                                        np.random.default_rng(3))}
    return dict(jcfg=jcfg, cfg=cfg, jder=jder, der=der, ds=ds, batch=batch, jb=jb,
                variables=variables)


def _compare(w, jflag, flag):
    jcfg = w["jcfg"].updated({"model.fused_dual_stack": jflag})
    jentry = jget_model_entry(NAME)
    want = jentry.model_cls(jcfg, w["jder"], w["ds"]["word_vector"]).apply(
        w["variables"], w["jb"], True)
    cfg = w["cfg"].updated({"model.fused_dual_stack": flag})
    entry = get_model_entry(NAME)
    model = entry.model_cls(cfg, w["der"], w["ds"]["word_vector"]).eval()
    load_jax_params(model, w["variables"]["params"], w["variables"]["constants"])
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in w["batch"].items()}
    with torch.no_grad():
        got = model(tb)
        loss = entry.loss_fn(got, tb, cfg)
        props = entry.infer_fn(got, tb, cfg)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss), float(jentry.loss_fn(want, w["jb"], jcfg)),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(props.numpy(), np.asarray(jentry.infer_fn(want, w["jb"], jcfg)))


def test_carry_over_is_strict():
    w = _world(False)
    state = from_jax_params(w["variables"]["params"], w["variables"]["constants"])
    model = get_model_entry(NAME).model_cls(w["cfg"], w["der"], w["ds"]["word_vector"])
    assert set(state) == set(model.state_dict())
    assert {"tfeat_encoder.conv_block.pointwise_3.weight", "backbone.embd_1.conv.weight",
            "backbone.stem_1.attn.query_conv.conv.weight", "backbone.branch_2.drop_path_mlp.weight",
            "dual_attention_block_2.dense_1.weight"} <= set(state)
    assert "match_conv1d.weight" not in state and "backbone.branch_3.ln1.weight" not in state
    model.load_state_dict(state, strict=True)


def test_forward_loss_and_spans_match_jax(monkeypatch):
    calls = []
    real = L.banded_attention
    monkeypatch.setattr(L, "banded_attention", lambda *a: calls.append(1) or real(*a))
    _compare(_world(False), False, False)
    assert calls == []  # T 32 < pallas_min_len 512: the band-mask route, as in JAX


def test_fused_stack_route_matches_jax(monkeypatch):
    counts = {"stack": 0, "banded": 0, "dual": 0, "cq": 0, "masked": 0}

    def counting(module, name, key):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a: counts.__setitem__(key, counts[key] + 1)
                            or real(*a))

    counting(common, "dual_attention_stack", "stack")
    counting(L, "banded_attention", "banded")
    counting(K, "fused_dual_attention", "dual")
    counting(K, "fused_cq_attention", "cq")
    counting(K, "fused_masked_attention", "masked")
    before = [fn.launches for fn in K.KERNELS + S.KERNELS]
    _compare(_world(True), "interpret", True)
    assert counts == {"stack": 1, "banded": 0, "dual": 0, "cq": 2, "masked": 2}
    assert [fn.launches for fn in K.KERNELS + S.KERNELS] == before  # plain versions on the CPU


def test_bf16_route_follows_flax_promotion(monkeypatch):
    """BackBoneActionFormer's bf16 eval forward (weights and batch cast by
    the bf16 policy) in both packages on the same weights, from the fusion
    on: both packages' ``encode_and_fuse`` give one seeded bf16 tensor, and
    the backbone's two embedding convs are left out in both (``arch[0]``
    0), so that the ulps XLA's and torch's bf16 convolutions round apart do
    not hide the route.  JAX adds the f32 position table to the bf16
    activations, so its blocks and its predictor run in f32 on their bf16
    weights promoted; the port does the same
    (``ops/precision.py::promoted_call``).  Largest logit distance to the
    JAX bf16 forward: 4.8e-3 before the promotion was ported (the port
    stayed in bf16 after the table and returned bf16 logits), 3.6e-7 with
    it, so 1e-4 fails the one and passes the other."""
    from vmrframe_tpu.models import backbone_actionformer as JBBAF
    from vmrframe_tpu.ops.precision import cast_floating
    from vmrframe_tpu_torch.models import backbone_actionformer as BBAF
    from vmrframe_tpu_torch.ops.precision import cast_batch, cast_module_

    w = _world(False)
    shape = (w["batch"]["vfeats"].shape[0], w["cfg"].model.vlen, w["cfg"].model.dim)
    fuse = jnp.asarray(np.random.default_rng(5).standard_normal(shape), jnp.bfloat16)
    no_embd = lambda cls: lambda **kw: cls(**{**kw, "arch": (0,) + tuple(kw["arch"][1:])})  # noqa: E731
    monkeypatch.setattr(JBBAF, "encode_and_fuse", lambda *a, **k: (None, None, fuse))
    monkeypatch.setattr(JBBAF, "ConvTransformerBackbone", no_embd(JL.ConvTransformerBackbone))
    monkeypatch.setattr(BBAF, "encode_and_fuse", lambda *a: (
        None, None, torch.from_numpy(np.asarray(fuse, np.float32)).to(torch.bfloat16)))
    monkeypatch.setattr(BBAF, "ConvTransformerBackbone", no_embd(L.ConvTransformerBackbone))
    jentry = jget_model_entry(NAME)
    want = jentry.model_cls(w["jcfg"], w["jder"], w["ds"]["word_vector"]).apply(
        cast_floating(w["variables"], jnp.bfloat16), cast_floating(w["jb"], jnp.bfloat16), True)
    model = get_model_entry(NAME).model_cls(w["cfg"], w["der"], w["ds"]["word_vector"]).eval()
    state = from_jax_params(w["variables"]["params"], w["variables"]["constants"])
    model.load_state_dict({k: v for k, v in state.items() if "embd" not in k}, strict=True)
    cast_module_(model, torch.bfloat16)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in w["batch"].items()}
    with torch.no_grad():
        got = model(cast_batch(tb, torch.bfloat16))
    for key in ("slogits", "elogits"):
        assert want[key].dtype == jnp.float32, key
        np.testing.assert_allclose(got[key].float().numpy(), np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)
        assert got[key].dtype == torch.float32, key


# ------------------------------------------------------------ trajectories


def _identity_drop_path(mp):
    """Stochastic depth off in both packages, the AffineDropPath scales kept."""
    mp.setattr(JL, "drop_path", lambda rng, x, drop_prob, deterministic: x)
    mp.setattr(L, "drop_path", lambda x, drop_prob, u: x)


def _trajectory_world(kind):
    if kind == NAME:
        updates = {"model.name": NAME, "model.droprate": 0.0, "train.warmup_proportion": 0.0,
                   "train.lr": 1e-3, "train.batch_size": BATCH}
        jcfg, cfg = jload_config(CFG).updated(updates), load_config(CFG).updated(updates)
        jbatcher, batcher = JBatcher, Batcher
    else:  # ActionFormer with the conv backbone
        updates = {**TINY, "actionformer.backbone_type": "conv",
                   "actionformer.train_cfg.droppath": 0.0, "train.warmup_proportion": 0.0,
                   "train.lr": 1e-3}
        jcfg, cfg = jload_config(LONG).updated(updates), load_config(LONG).updated(updates)
        jbatcher, batcher = JAFBatcher, ActionFormerBatcher
    n = N_STEPS * BATCH
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=n, n_test=8)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=n, n_test=8)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=N_STEPS,
                    steps_per_epoch=N_STEPS)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=N_STEPS,
                  steps_per_epoch=N_STEPS)
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, jder=jder, der=der,
                jtrain=jbatcher(jds["train_set"], jstore, jcfg, jder, "train"),
                train=batcher(ds["train_set"], store, cfg, der, "train"))


@pytest.fixture(scope="module", params=[NAME, "ActionFormer_conv"])
def trajectory(request):
    """The JAX trainer's first N_STEPS steps from the port's seeded weights."""
    w = _trajectory_world(request.param)
    with pytest.MonkeyPatch.context() as mp:
        _identity_drop_path(mp)
        jtrainer = JTrainer(w["jcfg"], w["jder"], w["jds"]["word_vector"])
        jbatches = list(w["jtrain"].epoch(seed=7))
        jb0 = {k: jnp.asarray(v) for k, v in jbatches[0].items() if k != "num_valid"}
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda b: jtrainer.model.init(
            {"params": key, "dropout": key, "gumbel": key}, b, True), jb0)
        seeded = get_model_entry(str(w["cfg"].model.name)).model_cls(w["cfg"], w["der"],
                                                                     w["ds"]["word_vector"])
        variables = _jax_variables(init_weights(seeded, 0), shapes)
        params = variables["params"]
        constants = {k: v for k, v in variables.items() if k != "params"}
        state = jax.device_put(TrainState(params, constants, jtrainer.tx.init(params),
                                          jnp.zeros((), jnp.int32),
                                          jtrainer.entry.init_extras(jtrainer.cfg)
                                          if jtrainer.entry.stateful else {}), jtrainer._repl)
        start = jax.device_get(params)
        step = jtrainer.compiled_train_step()
        jlosses = []
        for b in jbatches:
            state, metrics = step(state, jtrainer._shard_batch(b), jax.random.PRNGKey(1))
            jlosses.append(float(metrics["loss"]))
    return dict(w, jlosses=jlosses, params=start,
                constants=jax.device_get(state.constants).get("constants", {}))


def test_train_trajectory_matches_jax(trajectory, monkeypatch):
    w = trajectory
    _identity_drop_path(monkeypatch)
    trainer = Trainer(w["cfg"], w["der"], w["ds"]["word_vector"], device="cpu")
    load_jax_params(trainer.model, w["params"], w["constants"])
    batches = list(w["train"].epoch(seed=7))
    assert len(batches) == N_STEPS
    losses = [float(trainer.train_step(trainer.to_device(b))["loss"]) for b in batches]
    np.testing.assert_allclose(losses, w["jlosses"], rtol=1e-4)
    assert losses[0] != losses[-1]
