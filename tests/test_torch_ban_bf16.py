"""BAN's bf16 route in the port against the jitted JAX bf16 route, on the
CPU, at the tiny BAN test config (vlen 16, pooling [4, 2, 2]), on both
routes of the map (compact cells and the dense map):

- every port module's output type, call by call, equals the type the jitted
  JAX forward gives the module of the same path (weights and batch cast by
  the bf16 policy, the batch on the device, as the JAX evaluator's step
  takes it).  In JAX the LSTMs add their f32 biases in f32, round the input
  projection back to the input's type and scan in it, so every layer of
  BAN stays bf16; so does the port's;
- every module's output within a few bf16 steps of JAX's at its largest
  magnitude.  The proposal selection reads bf16 scores, which tie far more
  often than f32 ones, so XLA's fusions and torch's kernels select apart;
  the port's layers after the selection are held on JAX's selection (the
  cells JAX's ``coarse_pred`` names, put in place of the port's own), the
  port's own selection is held to ``proposal_selection`` of its own scores;
- a bf16 train step through the port's ``Trainer`` (the f32 masters, the
  forward on their bf16 casts): finite loss, every LSTM weight and bias
  with a finite gradient, the two biases of a gate with the same one.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_ban import world
from vmrframe_tpu.ops.precision import cast_floating
from vmrframe_tpu_torch.layers.dropout import Dropout
from vmrframe_tpu_torch.layers.recurrent import LSTM
from vmrframe_tpu_torch.models import ban as B
from vmrframe_tpu_torch.ops.precision import cast_batch, cast_module_

MODULE_STEPS = 6  # bf16 steps at each output's largest magnitude (4.5 measured, td)
JAX_ONLY = ("boundary_aware",)  # returns the content stream too: (hb, hc, td)


def bf16_steps(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / step)


@pytest.mark.parametrize("compact", [True, False])
def test_bf16_module_types_follow_jax(compact, monkeypatch):
    w = world("tiny", compact)
    bf = jnp.bfloat16
    want, inter = jax.jit(lambda v, b: w["jmodel"].apply(v, b, True, capture_intermediates=True))(
        cast_floating(w["variables"], bf), cast_floating(w["jb"], bf))
    jcalls = {path.replace("/__call__", "").replace("/", "."): calls for path, calls in
              traverse_util.flatten_dict(inter["intermediates"], sep="/").items()}
    model = cast_module_(copy.deepcopy(w["model"]), torch.bfloat16)
    calls = {}
    for name, mod in model.named_modules():
        if name and not isinstance(mod, Dropout):
            assert name in jcalls, name
            mod.register_forward_hook(
                lambda mod, args, out, name=name: calls.setdefault(name, []).append(out))

    # JAX's selection, as indices into the K valid cells
    _, _, ii, jj = B._mask_meta(model.pooling, w["cfg"].model.vlen)
    cell = {(int(i), int(j)): k for k, (i, j) in enumerate(zip(ii, jj))}
    jpred = np.asarray(want["coarse_pred"])
    jsel = torch.tensor([[cell[(int(s), int(e) - 1)] for s, e in row] for row in jpred])
    own, select = {}, B.proposal_selection

    def jax_selection(scores, *args, **kwargs):
        own["sel"], own["scores"] = select(scores, *args, **kwargs), scores
        return jsel

    monkeypatch.setattr(B, "proposal_selection", jax_selection)
    with torch.no_grad():
        got = model(cast_batch(w["tb"], torch.bfloat16))
    # the port's own selection is the selection of its own scores
    assert own["scores"].dtype == torch.bfloat16
    again = select(own["scores"], model.moments, model.topk, model.neighbor, model.negative,
                   thresh=0.7)
    assert torch.equal(own["sel"], again)

    assert len(calls["visual_encoder.biLSTM"]) == 1
    for name, outs in calls.items():
        assert len(outs) == len(jcalls[name]), name
        for out, jout in zip(outs, jcalls[name]):
            outs_t = list(out) if isinstance(out, (tuple, list)) else [out]
            jouts = jax.tree_util.tree_leaves(jout)
            if name in JAX_ONLY:
                jouts = [jouts[0], jouts[-1]]
            assert [str(o.dtype).split(".")[-1] for o in outs_t] == \
                [str(o.dtype) for o in jouts], name
            for o, jo in zip(outs_t, jouts):
                assert bf16_steps(o.float(), jo) <= MODULE_STEPS, name
    assert set(got) == set(want)
    for key, jv in want.items():
        g = got[key]
        if jv.dtype == bf:
            assert g.dtype == torch.bfloat16, key
            assert bf16_steps(g.float(), jv) <= MODULE_STEPS, key
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(jv), err_msg=key)


def test_bf16_train_step():
    from vmrframe_tpu_torch.data.ban_batcher import BANBatcher
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.train.trainer import Trainer

    w = world("tiny")
    cfg = w["cfg"].updated({"train.compute_dtype": "bfloat16"})
    trainer = Trainer(cfg, w["der"], w["ds"]["word_vector"], device="cpu")
    trainer.model.load_state_dict(w["model"].state_dict())
    _, store = make_synthetic_data(cfg, seed=0, n_train=4, n_test=4)
    batch = trainer.to_device(next(BANBatcher(w["ds"]["train_set"], store, cfg, w["der"],
                                              "train").epoch(seed=0)))
    trainer.model.train()
    loss, grads, outputs, _ = trainer.loss_and_grads(batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    assert outputs["tmap"].dtype == torch.float32  # upcast from the bf16 forward
    lstms = [n for n, m in trainer.model.named_modules() if isinstance(m, LSTM)
             and not n.endswith("feature_transform_c")]  # the content stream BAN never reads
    assert len(lstms) == 4
    for prefix in lstms:
        for name, g in grads.items():
            if name.startswith(prefix + ".bias_ih"):
                assert torch.isfinite(g).all() and g.abs().sum() > 0, name
                torch.testing.assert_close(g, grads[name.replace("bias_ih", "bias_hh")],
                                           rtol=0, atol=0)
            elif name.startswith(prefix + ".weight"):
                assert torch.isfinite(g).all() and g.abs().sum() > 0, name
    for _ in range(2):
        assert torch.isfinite(trainer.train_step(batch)["loss"])
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
