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
