"""The SeqPAN family in the port (SeqPAN, BackBone, BaseFast) against the
JAX models, from carried-over weights, and the gate of the whole-stack
dual-attention route.

- SeqPAN and BackBone at dim 128 (the gate needs D % 128 == 0), a few
  samples, f32: forward, loss and spans with ``model.fused_dual_stack`` off
  (module path) and on (the JAX side with ``"interpret"``: its Pallas kernel
  in interpret mode; the port's wrapper runs the plain version on CPU
  tensors), each against the JAX model at 1e-4, spans equal;
- BaseFast on the tiny test config against the JAX BaseFast;
- ``from_jax_params`` is strict for both new trees;
- the gate's conditions, and that nothing is launched on the CPU.

The JAX models are applied op by op (no ``jit``): compiling the dim-128
forward would take minutes here.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.kernels import dual_stack as S
from vmrframe_tpu_torch.models import common
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.weights import from_jax_params, load_jax_params

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")
ATOL = 1e-4
WIDE = {"model.dim": 128, "model.num_heads": 4, "train.batch_size": 4}


def _world(name, updates):
    """JAX config, model, variables and one test batch for model ``name``
    (built once per distinct request)."""
    return _build_world(name, tuple(sorted(updates.items())))


@functools.lru_cache(maxsize=None)
def _build_world(name, updates):
    updates = {"model.name": name, **dict(updates)}
    jcfg = jload_config(CFG).updated(updates)
    ds, store = jmake_synthetic_data(jcfg, seed=0, n_train=4, n_test=4)
    jder = JDerived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=2,
                    steps_per_epoch=1)
    batch = next(JBatcher(ds["test_set"], store, jcfg, jder, "test").epoch(seed=0, shuffle=False))
    batch = {k: v for k, v in batch.items() if k != "num_valid"}
    entry = jget_model_entry(name)
    rng = jax.random.PRNGKey(0)
    variables = entry.model_cls(jcfg, jder, ds["word_vector"]).init(
        {"params": rng, "dropout": rng, "gumbel": rng}, batch, True)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    return dict(jcfg=jcfg, jder=jder, ds=ds, batch=batch, entry=entry, variables=variables,
                cfg=load_config(CFG).updated(updates), der=der)


def _compare(w, jflag, flag):
    """The JAX model with ``fused_dual_stack: jflag`` against the port's with
    ``flag``, on the same variables and batch."""
    jcfg = w["jcfg"].updated({"model.fused_dual_stack": jflag})
    jmodel = w["entry"].model_cls(jcfg, w["jder"], w["ds"]["word_vector"])
    want = jmodel.apply(w["variables"], w["batch"], True)
    want_loss = w["entry"].loss_fn(want, w["batch"], jcfg)
    want_props = w["entry"].infer_fn(want, w["batch"], jcfg)

    cfg = w["cfg"].updated({"model.fused_dual_stack": flag})
    entry = get_model_entry(str(cfg.model.name))
    model = entry.model_cls(cfg, w["der"], w["ds"]["word_vector"]).eval()
    load_jax_params(model, w["variables"]["params"], w["variables"]["constants"])
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in w["batch"].items()}
    with torch.no_grad():
        got = model(tb)
        got_loss = entry.loss_fn(got, tb, cfg)
        got_props = entry.infer_fn(got, tb, cfg)
    assert set(got) == set(want)
    for key in want:
        if key != "vmask":
            np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), atol=ATOL,
                                       err_msg=key)
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=ATOL)
    np.testing.assert_array_equal(got_props.numpy(), np.asarray(want_props))
    return got


@pytest.fixture(scope="module", params=["SeqPAN", "BackBone"])
def wide(request):
    return _world(request.param, WIDE)


@pytest.mark.parametrize("jflag,flag", [(False, False), ("interpret", True)],
                         ids=["module_path", "fused_stack"])
def test_dual_attention_models_match_jax_on_both_routes(wide, jflag, flag, monkeypatch):
    calls = []
    real = common.dual_attention_stack
    monkeypatch.setattr(common, "dual_attention_stack",
                        lambda *a: calls.append(1) or real(*a))
    before = [fn.launches for fn in K.KERNELS + S.KERNELS]
    _compare(wide, jflag, flag)
    assert len(calls) == (1 if flag else 0)  # one call of the stack per forward, or none
    assert [fn.launches for fn in K.KERNELS + S.KERNELS] == before  # nothing launches on the CPU


def test_basefast_matches_jax():
    got = _compare(_world("BaseFast", {}), False, False)
    assert set(got) >= {"match_score", "label_embs"}


@pytest.mark.parametrize("name,has,lacks", [
    ("BackBone", "tfeat_encoder.conv_block.pointwise_3.weight", "match_conv1d.weight"),
    ("BaseFast", "vfeat_encoder.conv_block.pointwise_1.weight",
     "dual_attention_block_1.dense_1.weight")], ids=["BackBone", "BaseFast"])
def test_carry_over_is_strict_for_the_new_trees(name, has, lacks):
    w = _world(name, {})
    params, constants = w["variables"]["params"], w["variables"]["constants"]
    state = from_jax_params(params, constants)
    model = get_model_entry(name).model_cls(w["cfg"], w["der"], w["ds"]["word_vector"])
    assert set(state) == set(model.state_dict())
    assert has in state and lacks not in state
    if name == "BaseFast":
        assert "vfeat_encoder.conv_block.pointwise_2.weight" not in state  # 2 layers, not 4
    model.load_state_dict(state, strict=True)
    with pytest.raises(RuntimeError, match="Missing"):
        model.load_state_dict({k: v for k, v in state.items() if k != has}, strict=True)
    # train mode: dropout (the config's 0.1) and, with a match head, gumbel noise
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in w["batch"].items()}
    out = model.train()(tb, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v).all() for v in out.values())
    with torch.no_grad():
        assert not torch.equal(out["slogits"], model.eval()(tb)["slogits"])


def test_gate_conditions(monkeypatch):
    from vmrframe_tpu_torch.tools.serve import make_cfg

    m = make_cfg(dim=128, fused_dual_stack=True).model
    assert common.use_fused_stack(m, deterministic=True)
    assert not common.use_fused_stack(m, deterministic=False)  # train mode
    assert not common.use_fused_stack(make_cfg(dim=128).model, True)  # off by default
    assert common.use_fused_stack(make_cfg(dim=128).model.__class__(
        {**make_cfg(dim=128).model.to_dict(), "fused_dual_stack": "interpret"}), True)
    assert not common.use_fused_stack(make_cfg(dim=64, fused_dual_stack=True).model, True)
    odd = make_cfg(dim=128, fused_dual_stack=True).updated({"model.num_heads": 3}).model
    assert not common.use_fused_stack(odd, True)

    # D = 32 with the flag set: the module path runs, the stack is never called
    def never(*a):
        raise AssertionError("the fused route was taken")

    monkeypatch.setattr(common, "dual_attention_stack", never)
    cfg = load_config(CFG).updated({"model.fused_dual_stack": True})
    w = _world("SeqPAN", {})
    model = get_model_entry("SeqPAN").model_cls(cfg, w["der"], w["ds"]["word_vector"]).eval()
    load_jax_params(model, w["variables"]["params"], w["variables"]["constants"])
    with torch.no_grad():
        out = model({k: torch.from_numpy(np.asarray(v)) for k, v in w["batch"].items()})
    assert torch.isfinite(out["slogits"]).all()


def test_bf16_module_path_follows_jax():
    """SeqPAN's bf16 eval forward with ``model.fused_dual_stack`` off, the
    route of the JAX trainer's and evaluator's jitted steps (weights and
    batch cast by the bf16 policy, the batch on the device): the dual
    attention and every layer after it stay bf16 in JAX, and in the port.
    Where JAX is applied op by op to a batch of host numpy bf16 arrays, its
    masks promote instead: numpy's bf16 minus the Python float 1.0 is f32,
    so ``(1.0 - s_attn_mask) * -1e30`` (``layers/attention.py``) turns the
    attention and every layer after it f32.  That promotion belongs to the
    host arrays, not to the JAX model's route, so the port does not follow
    it.

    Every port module but the dropouts has a JAX module of the same path,
    and each call of each gives the dtype the jitted JAX forward gives.  An
    all-bf16 route rounds apart from XLA's fused one by bf16 steps (JAX's
    own op-by-op and jitted bf16 forwards lie 7.8e-3, one step, apart on
    logits of 1.08), so the values are held in steps of bf16 at each
    output's largest magnitude: every module's output within 6 of the
    jitted JAX output (here at most 5, at ``q2v_attn``), the logits within
    3 (here 1.5 and 2.4: 1.17e-2 and 9.3e-3), and the port's bf16 logits no
    farther from the f32 forward than JAX's, with 25% to spare."""
    from flax import traverse_util

    from test_torch_cca import jax_variables
    from vmrframe_tpu.layers.attention import DualMultiAttention as JDual
    from vmrframe_tpu.ops.precision import cast_floating
    from vmrframe_tpu_torch.layers.dropout import Dropout
    from vmrframe_tpu_torch.ops.precision import cast_batch, cast_module_
    from vmrframe_tpu_torch.weights import init_weights

    def bf16_steps(got, want):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        return np.abs(got - want).max() / step

    jcfg, cfg = jload_config(CFG), load_config(CFG)
    ds, store = jmake_synthetic_data(jcfg, seed=0, n_train=4, n_test=4)
    jder = JDerived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    batch = next(JBatcher(ds["test_set"], store, jcfg, jder, "test").epoch(seed=0, shuffle=False))
    batch = {k: v for k, v in batch.items() if k != "num_valid"}
    model = get_model_entry("SeqPAN").model_cls(cfg, Derived(num_words=ds["n_words"],
                                                             num_chars=ds["n_chars"]),
                                                ds["word_vector"])
    init_weights(model.eval(), 3)
    jmodel = jget_model_entry("SeqPAN").model_cls(jcfg, jder, ds["word_vector"])
    key = jax.random.PRNGKey(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax_variables(model, jax.eval_shape(
        lambda b: jmodel.init({"params": key, "dropout": key, "gumbel": key}, b, True), jb))
    bf = jnp.bfloat16
    want, inter = jax.jit(lambda v, b: jmodel.apply(v, b, True, capture_intermediates=True))(
        cast_floating(variables, bf), cast_floating(jb, bf))
    jcalls = {path.replace("/__call__", "").replace("/", "."): calls for path, calls in
              traverse_util.flatten_dict(inter["intermediates"], sep="/").items()}
    f32 = jax.jit(lambda v, b: jmodel.apply(v, b, True))(variables, jb)
    cast_module_(model, torch.bfloat16)
    calls = {}
    for name, mod in model.named_modules():
        if name and not isinstance(mod, Dropout):
            assert name in jcalls, name
            mod.register_forward_hook(
                lambda mod, args, out, name=name: calls.setdefault(name, []).append(out))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        got = model(cast_batch(tb, torch.bfloat16))
    assert len(calls["dual_attention_block_1.dual_multihead_attention"]) == 2
    for name, outs in calls.items():
        assert len(outs) == len(jcalls[name]), name
        for out, jout in zip(outs, jcalls[name]):
            outs_t = list(out) if isinstance(out, (tuple, list)) else [out]
            jouts = jax.tree_util.tree_leaves(jout)
            assert [str(o.dtype).split(".")[-1] for o in outs_t] == \
                [str(o.dtype) for o in jouts], name
            for o, jo in zip(outs_t, jouts):
                assert bf16_steps(o.detach().float(), jo) <= 6, name
    for key in ("slogits", "elogits"):
        assert want[key].dtype == bf and got[key].dtype == torch.bfloat16, key
        assert bf16_steps(got[key].float(), want[key]) <= 3, key
        ref = np.asarray(f32[key])
        port_err = np.abs(got[key].float().numpy() - ref).max()
        jax_err = np.abs(np.asarray(want[key], np.float32) - ref).max()
        assert 0 < port_err <= 1.25 * jax_err, (key, port_err, jax_err)

    # the host-array promotion, on the JAX module alone
    jdual = JDual(16, 4)
    x, m = np.ones((2, 5, 16), np.float32), np.ones((2, 5), np.float32)
    v = cast_floating(jdual.init(jax.random.PRNGKey(0), x, x, m, m), bf)
    host = [a.astype(bf) for a in (x, x, m, m)]
    assert jdual.apply(v, *host).dtype == jnp.float32
    assert jdual.apply(v, *map(jnp.asarray, host)).dtype == bf
