"""CPL's pieces in the port against the JAX package, on the CPU, at the tiny
SeqPAN test config with ``model.name: CPL`` (32 clips, 16 words, dim 32,
4 heads, 8 proposals):

- ``cal_nll_loss`` (label smoothing 0.1, masked or weighted),
  ``rec_loss_cpl`` (the min over proposals) and ``div_loss_cpl`` (1e-5);
- ``generate_gauss_weight`` in f32 (1e-5);
- ``GaussMultiheadAttention`` on every path: self and cross attention, the
  causal -inf mask, padded keys at -1e30, the post-softmax Gaussian, and
  the shared-prefix path (P > 1) with and without a Gaussian (1e-4);
- ``TransformerDecoderLayer`` and ``TransformerDecoder`` with and without
  the cross attention and the shared prefix (1e-4);
- the JAX tree carried across with a strict load;
- the deterministic forward, the loss, the spans and the gradient of every
  parameter against the jitted JAX model (1e-4), and the same forward
  under every setting of the JAX package's ``others.cpl_shared_prefix``
  and ``others.cpl_remat``;
- the shipped config's width: 841,949 JAX parameters with the 52-word
  synthetic vocabulary.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmrframe_tpu.layers.cpl_decoder as JD
from test_torch_cca import _np, assert_grads_close, grads_as_state, jax_variables
from vmrframe_tpu import losses as JLoss
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.models.cpl import generate_gauss_weight as jgenerate_gauss_weight
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu_torch import losses as Loss
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.layers import cpl_decoder as D
from vmrframe_tpu_torch.models import cpl as M
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.weights import from_jax_params, init_weights

HERE = os.path.dirname(__file__)
CFG = os.path.join(HERE, "configs", "charades_seqpan.yaml")
FULL = os.path.join(HERE, "..", "configs", "charades_cpl.yaml")
OP_TOL, ATOL = 1e-5, 1e-4
KEY = jax.random.PRNGKey(0)
CPL = {"model.name": "CPL", "train.batch_size": 4}


def _t(x):
    return torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def world(updates=()):
    updates = {**CPL, **dict(updates)}
    jcfg, cfg = jload_config(CFG).updated(updates), load_config(CFG).updated(updates)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=4, n_test=4)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=4, n_test=4)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=2,
                    steps_per_epoch=1)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=2,
                  steps_per_epoch=1)
    jbatch = next(JBatcher(jds["test_set"], jstore, jcfg, jder, "test").epoch(seed=0))
    batch = next(Batcher(ds["test_set"], store, cfg, der, "test").epoch(seed=0))
    model = init_weights(get_model_entry("CPL").model_cls(cfg, der, ds["word_vector"]), 3)
    jmodel = jget_model_entry("CPL").model_cls(jcfg, jder, jds["word_vector"])
    jb = {k: jnp.asarray(v) for k, v in jbatch.items() if k != "num_valid"}
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": KEY, "dropout": KEY, "gumbel": KEY}, b, True), jb)
    tb = {k: _t(v) for k, v in batch.items() if k != "num_valid"}
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, jder=jder, der=der, jbatch=jbatch,
                batch=batch, jb=jb, tb=tb, model=model.eval(), jmodel=jmodel,
                variables=jax_variables(model, shapes))


# ----------------------------------------------------------------- losses


@pytest.mark.parametrize("weighted", [False, True])
def test_nll_and_cpl_losses_match_jax(weighted):
    rng = np.random.default_rng(int(weighted))
    B, P, T, V = 3, 4, 7, 11
    logit = rng.standard_normal((B * P, T, V)).astype(np.float32) * 2
    ids = rng.integers(0, V, (B, T))
    mask = (np.arange(T)[None] < rng.integers(1, T + 1, B)[:, None]).astype(np.float32)
    mask[0] = 0.0  # an empty sequence: the loss is 0, not a division by 0
    ids_p, mask_p = np.repeat(ids, P, axis=0), np.repeat(mask, P, axis=0)
    weights = rng.random((B * P, T)).astype(np.float32) if weighted else None
    want, want_acc = JLoss.cal_nll_loss(logit, ids_p, mask_p, weights)
    got, acc = Loss.cal_nll_loss(_t(logit), _t(ids_p), _t(mask_p),
                                 None if weights is None else _t(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_TOL, rtol=OP_TOL)
    assert float(acc) == float(want_acc)
    np.testing.assert_allclose(float(Loss.rec_loss_cpl(_t(logit), _t(ids), _t(mask), P)),
                               float(JLoss.rec_loss_cpl(logit, ids, mask, P)), rtol=OP_TOL)
    gw = rng.random((B * P, 9)).astype(np.float32)
    np.testing.assert_allclose(float(Loss.div_loss_cpl(_t(gw), P, 0.15, 2.0)),
                               float(JLoss.div_loss_cpl(gw, P, 0.15, 2.0)), rtol=OP_TOL)


def test_gauss_weight_matches_jax():
    rng = np.random.default_rng(2)
    BP, L = 16, 32
    center, width = rng.random(BP).astype(np.float32), rng.random(BP).astype(np.float32)
    width[:3] = 0.0  # the 1e-2 floor
    vmask = (np.arange(L)[None] < rng.integers(4, L + 1, BP)[:, None]).astype(np.float32)
    want = jgenerate_gauss_weight(L, center, width, vmask)
    got = M.generate_gauss_weight(L, _t(center), _t(width), _t(vmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_TOL)
    np.testing.assert_allclose(got.numpy().max(axis=1), 1.0, atol=1e-6)


# ---------------------------------------------------------------- modules


def _pair(port, jmod, *args, **static):
    init_weights(port, 7)
    shapes = jax.eval_shape(
        lambda *a: jmod.init({"params": KEY, "dropout": KEY}, *a, **static), *args)
    return port.eval(), jax_variables(port, shapes)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pad(B, T, seed):
    lens = np.random.default_rng(seed).integers(1, T + 1, B)
    return (np.arange(T)[None] >= lens[:, None]).astype(np.float32)  # 1 = pad


@pytest.mark.parametrize("case", ["self_causal", "cross_gauss", "shared_gauss",
                                  "shared_plain"])
def test_gauss_attention_matches_jax(case):
    B, P, Tq, Tk, E = 3, 4, 6, 9, 16
    shared = case.startswith("shared")
    q = _rand(B, Tq, E)
    kv = q if case in ("self_causal", "shared_plain") else _rand(B, Tk, E, seed=1)
    T = kv.shape[1]
    kpm = _pad(B, T, 2)
    mask = np.triu(np.full((Tq, T), -np.inf, np.float32), 1) if kv is q else None
    gw = None
    if case in ("cross_gauss", "shared_gauss"):
        gw = np.random.default_rng(3).random((B * P if shared else B, T)).astype(np.float32)
    n_props = P if shared else 1
    jmod = JD.GaussMultiheadAttention(E, 4, 0.1)
    port, v = _pair(D.GaussMultiheadAttention(E, 4, 0.1), jmod, q, kv, kv, kpm,
                    **({"attn_mask": mask} if mask is not None else {}),
                    **({"gauss_weight": gw} if gw is not None else {}),
                    deterministic=True, n_props=n_props)
    want, _ = jmod.apply(v, q, kv, kv, kpm, mask, gw, True, n_props=n_props)
    got = port(_t(q), _t(kv), _t(kv), _t(kpm), None if mask is None else _t(mask),
               None if gw is None else _t(gw), n_props=n_props)
    assert got.shape == (B * n_props, Tq, E)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cross,n_props", [(False, 1), (True, 1), (False, 4), (True, 4)])
def test_decoder_matches_jax(cross, n_props):
    B, L, T, E = 3, 10, 6, 16
    tgt, src = _rand(B, T, E), _rand(B * n_props, L, E, seed=1) if cross else None
    tmask = 1.0 - _pad(B, T, 4)
    smask = 1.0 - _pad(B * n_props, L, 5) if cross else None
    gw = np.random.default_rng(6).random((B * n_props, L if cross else T)).astype(np.float32)
    kw = {"src_gauss_weight": gw} if cross else {"tgt_gauss_weight": gw}
    jmod = JD.TransformerDecoder(2, E, 4, 0.1)
    jkw = dict(kw, deterministic=True, n_props=n_props)
    port, v = _pair(D.TransformerDecoder(2, E, 4, 0.1, cross=cross), jmod, src, smask, tgt,
                    tmask, **jkw)
    want, _ = jmod.apply(v, src, smask, tgt, tmask, **jkw)
    got = port(None if src is None else _t(src), None if smask is None else _t(smask), _t(tgt),
               _t(tmask), n_props=n_props, **{k: _t(x) for k, x in kw.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    assert ("encoder_attn" in v["params"]["layer_0"]) == cross


# ------------------------------------------------------------- the model


def test_carry_over_is_strict():
    w = world()
    v = w["variables"]
    state = from_jax_params(v["params"], v["constants"])
    model = get_model_entry("CPL").model_cls(w["cfg"], w["der"], w["ds"]["word_vector"])
    assert set(state) == set(model.state_dict())
    assert {"decoder1.layer_0.self_attn.in_proj_weight", "decoder2.layer_1.encoder_attn."
            "out_proj_kernel", "decoder2.layer_0.enc_ln_scale", "word_emb.glove_vec",
            "word_emb.unk_vec", "start_vec", "conv1d_cw_kernel", "fc_comp_kernel",
            "video_affine.video_conv1d.weight"} <= set(state)
    assert "decoder1.layer_0.encoder_attn.in_proj_weight" not in state
    model.load_state_dict(state, strict=True)
    for key, value in w["model"].state_dict().items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0, atol=0)


def test_forward_loss_spans_and_grads_match_jax():
    w = world()
    jentry, entry = jget_model_entry("CPL"), get_model_entry("CPL")
    v = w["variables"]
    consts = {k: t for k, t in v.items() if k != "params"}

    def loss_fn(params, b):
        out = w["jmodel"].apply({"params": params, **consts}, b, True)
        return jentry.loss_fn(out, b, w["jcfg"]), out

    (jloss, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"],
                                                                              w["jb"])
    model = w["model"]
    got = model(w["tb"])
    loss = entry.loss_fn(got, w["tb"], w["cfg"])
    assert set(got) == set(want) and got["words_logit"].shape == (4 * 8, 16, w["der"].num_words)
    for key in want:
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key], np.float32), atol=ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=ATOL)
    np.testing.assert_allclose(entry.infer_fn(got, w["tb"], w["cfg"]).detach().numpy(),
                               np.asarray(jentry.infer_fn(want, w["jb"], w["jcfg"])),
                               atol=1e-6)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    assert_grads_close(jax_variables(grads_as_state(model, grads), {"params": jgrads})["params"],
                       jgrads)


SETTINGS = [{"others.cpl_shared_prefix": s} for s in (True, "always", "eval", False)] + \
    [{"others.cpl_remat": True, "others.cpl_shared_prefix": s} for s in (True, False)]


@pytest.mark.parametrize("setting", SETTINGS, ids=lambda s: "-".join(map(str, s.values())))
def test_every_shared_prefix_and_remat_setting_gives_the_port_forward(setting):
    """Each setting is a formulation of one deterministic forward in the
    JAX package; the port computes one (the shared prefix, activations
    stored) and accepts each key."""
    w = world()
    jcfg, cfg = w["jcfg"].updated(setting), w["cfg"].updated(setting)
    jmodel = jget_model_entry("CPL").model_cls(jcfg, w["jder"], w["jds"]["word_vector"])
    want = jax.jit(lambda v, b: jmodel.apply(v, b, True))(w["variables"], w["jb"])
    model = get_model_entry("CPL").model_cls(cfg, w["der"], w["ds"]["word_vector"]).eval()
    model.load_state_dict(w["model"].state_dict(), strict=True)
    with torch.no_grad():
        got = model(w["tb"])
    for key in ("words_logit", "gauss_weight", "center", "width"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=ATOL, err_msg=key)


def test_unknown_shared_prefix_value_raises():
    w = world()
    with pytest.raises(ValueError, match="cpl_shared_prefix"):
        M.CPL(w["cfg"].updated({"others.cpl_shared_prefix": "train"}), w["der"],
              w["ds"]["word_vector"])


def test_shipped_config_has_the_published_parameter_count():
    """``configs/charades_cpl.yaml`` with the 52-word synthetic vocabulary
    (``docs/BENCH_ZOO.json``'s) builds the JAX CPL of 841,949 parameters,
    and the port's model holds the same count."""
    jcfg, cfg = jload_config(FULL), load_config(FULL)
    ds = jmake_synthetic_data(jcfg, seed=0, n_train=1, n_test=1, n_videos=1)[0]
    assert ds["n_words"] == 52
    der = JDerived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    m = jcfg.model
    batch = {"vfeats": jnp.zeros((1, m.vlen, m.vdim)), "vmasks": jnp.ones((1, m.vlen)),
             "words_ids": jnp.ones((1, m.tlen), jnp.int32), "tmasks": jnp.ones((1, m.tlen))}
    jmodel = jget_model_entry("CPL").model_cls(jcfg, der, ds["word_vector"])
    shapes = jax.eval_shape(lambda b: jmodel.init({"params": KEY, "dropout": KEY}, b, True),
                            batch)
    count = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert count == 841_949
    model = get_model_entry("CPL").model_cls(cfg, Derived(num_words=ds["n_words"]),
                                             ds["word_vector"])
    assert sum(p.numel() for p in model.parameters()) == count
