"""The rest of ActionFormer in the port against the JAX package, on the CPU:

- ``MaskedMHCA`` with rel-PE (band-mask route; the gate never takes the
  banded kernel for it), ``ConvBlock`` (stride 1 and 2), ``ConvBackbone``
  and ``FPN1D``, each at 1e-4 on weights carried by ``from_jax_params``
  with a strict load;
- the whole model with the conv backbone, with the FPN neck and with rel-PE
  (the long config cut to width 32 and 512 frames, ``TINY``): the JAX tree
  carried strictly, forward at 1e-4, loss at 1e-5 relative;
- ``nms_1d`` (methods 0, 1 and 2) and its batched form against the JAX
  scan, and ``actionformer_infer_full`` (soft, linear and hard NMS with and
  without voting, and the ``"none"`` top-k with ties) against the JAX
  protocol;
- the C++ twin (``vmrframe_tpu_torch/native``), built from the port's own
  copy, against the torch ``nms_1d``, and its refusal to run unbuilt.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmrframe_tpu_torch.native as N
from test_torch_actionformer import LONG, TINY, _lengths_mask, _lift_drop_path, _t
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.af_batcher import ActionFormerBatcher as JAFBatcher
from vmrframe_tpu.layers import actionformer as JL
from vmrframe_tpu.models import actionformer as JA
from vmrframe_tpu.ops.nms import batched_nms_1d as jbatched_nms_1d
from vmrframe_tpu.ops.nms import nms_1d as jnms_1d
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.train.trainer import Trainer as JTrainer
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher
from vmrframe_tpu_torch.layers import actionformer as L
from vmrframe_tpu_torch.models import actionformer as A
from vmrframe_tpu_torch.ops import nms
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.weights import from_jax_params, init_weights, load_jax_params

ATOL = 1e-4
VARIANTS = {"conv": {"actionformer.backbone_type": "conv"},
            "fpn": {"actionformer.fpn_type": "fpn"},
            "rel_pe": {"actionformer.use_rel_pe": True}}


def _carry(module, params):
    load_jax_params(module, jax.device_get(params), {})
    return module.eval()


def _init(jmodule, seed, *args):
    return jax.device_get(jmodule.init(jax.random.PRNGKey(seed),
                                       *(jnp.asarray(a) for a in args))["params"])


# ------------------------------------------------------------- the layers


@pytest.mark.parametrize("stride", [1, 2])
def test_masked_mhca_rel_pe_matches_jax(stride, monkeypatch):
    rng = np.random.default_rng(10 + stride)
    B, C, H, window = 2, 32, 2, 9
    T = 512 * stride
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = _lengths_mask([T, T - 141], T)
    jm = JL.MaskedMHCA(C, H, stride, stride, window_size=window, use_rel_pe=True,
                       pallas_min_len=256)
    params = _init(jm, stride, x, mask)
    assert params["rel_pe"].shape == (H, window) and np.abs(params["rel_pe"]).max() > 0
    want, want_mask = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    m = _carry(L.MaskedMHCA(C, H, stride, stride, window, use_rel_pe=True, pallas_min_len=256),
               params)
    assert not m.use_banded_kernel(512, 512)  # above the threshold, but rel-PE
    monkeypatch.setattr(L, "banded_attention", lambda *a: pytest.fail("banded kernel called"))
    with torch.no_grad():
        got, got_mask = m(_t(x), _t(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # without its term the output moves: rel-PE is not a no-op here
    with torch.no_grad():
        m.rel_pe.zero_()
        assert (m(_t(x), _t(mask))[0] - got).abs().max() > 10 * ATOL


def test_rel_pe_init_is_flax_truncated_normal():
    m = init_weights(L.MaskedMHCA(512, 16, window_size=64, use_rel_pe=True), seed=0)
    p = m.rel_pe.detach()
    std = (2.0 / 512) ** 0.5
    assert tuple(p.shape) == (16, 64)
    assert p.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7  # truncated at 2 sigma
    assert abs(float(p.std()) - std) < 0.1 * std  # the std after truncation, as flax's
    assert not hasattr(L.MaskedMHCA(32, 2, window_size=-1, use_rel_pe=True), "rel_pe")


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_block_matches_jax(stride):
    rng = np.random.default_rng(20 + stride)
    B, T, C = 2, 37, 16
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = _lengths_mask([T, 20], T)
    jblock = JL.ConvBlock(C, 3, stride)
    params = _init(jblock, stride, x, mask)
    assert ("downsample" in params) == (stride > 1)
    want, want_mask = jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    block = _carry(L.ConvBlock(C, 3, stride), params)
    with torch.no_grad():
        got, got_mask = block(_t(x), _t(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_conv_backbone_and_fpn_match_jax():
    rng = np.random.default_rng(30)
    B, T, n_in, C, out = 2, 256, 24, 32, 16
    x = rng.standard_normal((B, T, n_in)).astype(np.float32)
    mask = _lengths_mask([T, 170], T)
    jbb = JL.ConvBackbone(n_in, C, 3, arch=(2, 2, 3))
    params = _init(jbb, 30, x, mask)
    want_feats, want_masks = jbb.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    bb = _carry(L.ConvBackbone(n_in, C, 3, arch=(2, 2, 3)), params)
    with torch.no_grad():
        feats, masks = bb(_t(x), _t(mask))
    assert [f.shape[1] for f in feats] == [256, 128, 64, 32]
    for got, want, gm, wm in zip(feats, want_feats, masks, want_masks):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the neck on the backbone's pyramid, with and without its LN
    for with_ln in (True, False):
        jfpn = JL.FPN1D(4, out, 2, with_ln=with_ln)
        fparams = jax.device_get(jfpn.init(jax.random.PRNGKey(31), want_feats,
                                           want_masks)["params"])
        want_f, want_m = jfpn.apply({"params": fparams}, want_feats, want_masks)
        fpn = _carry(L.FPN1D(4, C, out, 2, with_ln=with_ln), fparams)
        with torch.no_grad():
            got_f, got_m = fpn(feats, masks)
        for got, want, gm, wm in zip(got_f, want_f, got_m, want_m):
            assert got.shape[-1] == out
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ------------------------------------------------------------- the models


@functools.lru_cache(maxsize=None)
def _model_world(variant):
    updates = {**TINY, **VARIANTS[variant]}
    jcfg, cfg = jload_config(LONG).updated(updates), load_config(LONG).updated(updates)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=4, n_test=6)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=4, n_test=6)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=2,
                    steps_per_epoch=2)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    jbatch = next(JAFBatcher(jds["test_set"], jstore, jcfg, jder, "test").epoch(seed=0))
    batch = next(ActionFormerBatcher(ds["test_set"], store, cfg, der).epoch())
    trainer = JTrainer(jcfg, jder, jds["word_vector"])
    jb = {k: jnp.asarray(v) for k, v in jbatch.items() if k != "num_valid"}
    rng = jax.random.PRNGKey(0)
    init = jax.jit(lambda r, b: trainer.model.init({"params": r, "dropout": r}, b, True))
    params = _lift_drop_path(jax.device_get(init(rng, jb)["params"]), np.random.default_rng(9))
    jout = trainer.model.apply({"params": params}, jb, True)
    jextras = trainer.entry.init_extras(jcfg)
    want_loss, _ = trainer.entry.loss_fn(jout, jb, jcfg, jextras)
    return dict(cfg=cfg, der=der, ds=ds, batch=batch, params=params, jout=jout,
                want_loss=float(want_loss))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_actionformer_variant_forward_and_loss_match_jax(variant, monkeypatch):
    w = _model_world(variant)
    model = A.ActionFormer(w["cfg"], w["der"], w["ds"]["word_vector"])
    state = from_jax_params(w["params"], {})
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)
    names = set(state)
    if variant == "conv":
        assert {"backbone.embd_0.conv.weight", "backbone.stem_0.conv1.conv.weight",
                "backbone.branch_0.downsample.conv.weight"} <= names
        assert not any(".attn." in k for k in names)
    elif variant == "fpn":
        assert {"neck.lateral_0.conv.weight", "neck.fpn_conv_3.conv.weight",
                "neck.fpn_norm_3.weight"} <= names
    else:
        assert "backbone.stem_0.attn.rel_pe" in names and "backbone.branch_2.attn.rel_pe" in names
    calls = []
    real = L.banded_attention
    monkeypatch.setattr(L, "banded_attention", lambda *a: calls.append(1) or real(*a))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in w["batch"].items() if k != "num_valid"}
    with torch.no_grad():
        out = model.eval()(tb)
        loss, _ = A.actionformer_loss(out, tb, w["cfg"], A.actionformer_init_extras(w["cfg"]))
    for key in ("cls_logits", "offsets", "fpn_mask"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(w["jout"][key]), atol=ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss), w["want_loss"], rtol=1e-5)
    # the kernel route in the two stem blocks (T 512 >= pallas_min_len 256) but
    # for rel-PE and the conv backbone, which has no attention
    assert len(calls) == {"conv": 0, "fpn": 2, "rel_pe": 0}[variant]


# ------------------------------------------------------------------- NMS


def _problem(seed, n=64, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    starts = rng.random(shape).astype(np.float32) * 50
    lengths = rng.random(shape).astype(np.float32) * 20 + 1
    return np.stack([starts, starts + lengths], axis=-1), rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("method,threshold,sigma", [(0, 0.5, 0.5), (1, 0.3, 0.5),
                                                    (2, 0.1, 0.75)])
def test_nms_1d_matches_jax(method, threshold, sigma):
    segs, scores = _problem(method)
    want = jnms_1d(jnp.asarray(segs), jnp.asarray(scores), threshold, 30, 0.01, method, sigma)
    got = nms.nms_1d(_t(segs), _t(scores), threshold, 30, 0.01, method, sigma)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(got[2].sum()) < 30 or method != 0  # hard NMS runs out of segments
    valid = np.asarray(want[2])
    np.testing.assert_allclose(got[0].numpy()[valid], np.asarray(want[0])[valid], atol=1e-6)
    np.testing.assert_allclose(got[1].numpy()[valid], np.asarray(want[1])[valid], atol=1e-6)
    # the batched form is the per-row one, row by row
    bsegs, bscores = _problem(method + 10, batch=4)
    batched = nms.batched_nms_1d(_t(bsegs), _t(bscores), threshold, 30, 0.01, method, sigma)
    jbatched = jbatched_nms_1d(jnp.asarray(bsegs), jnp.asarray(bscores), threshold, 30, 0.01,
                               method, sigma)
    for b in range(4):
        row = nms.nms_1d(_t(bsegs[b]), _t(bscores[b]), threshold, 30, 0.01, method, sigma)
        for x, y in zip(row, batched):
            torch.testing.assert_close(x, y[b], rtol=0, atol=0)
    np.testing.assert_array_equal(batched[2].numpy(), np.asarray(jbatched[2]))
    np.testing.assert_allclose(batched[1].numpy(), np.asarray(jbatched[1]), atol=1e-6)


def _random_outputs(cfg, seed, B=6, sparse=False):
    P = len(A._points(cfg))
    rng = np.random.default_rng(seed)
    batch = {"feat_stride": np.full((B,), 4.0, np.float32),
             "feat_num_frames": np.full((B,), 16.0, np.float32),
             "fps": np.full((B,), 30.0, np.float32),
             "duration": rng.uniform(10, 40, size=(B,)).astype(np.float32)}
    logits = rng.normal(size=(B, P, 1)).astype(np.float32)
    if sparse:  # a handful of candidates: the top-k reaches the zeroed scores
        logits[:] = -20.0
        logits[:, rng.integers(0, P, 5)] = 2.0
    logits[1] = -20.0  # every score below pre_nms_thresh
    outputs = {"cls_logits": logits,
               "offsets": np.abs(rng.normal(size=(B, P, 2)) * 3).astype(np.float32),
               "fpn_mask": (rng.random((B, P)) > 0.2).astype(np.float32)}
    return outputs, batch


@pytest.mark.parametrize("method,voting", [("soft", 0.9), ("soft", 0.0), ("linear", 0.9),
                                           ("hard", 0.0), ("none", 0.9)])
def test_infer_full_matches_jax(method, voting):
    updates = {**TINY, "actionformer.test_cfg.nms_method": method,
               "actionformer.test_cfg.voting_thresh": voting}
    jcfg, cfg = jload_config(LONG).updated(updates), load_config(LONG).updated(updates)
    for sparse in (False, True):
        outputs, batch = _random_outputs(cfg, seed=len(method) + int(10 * voting), sparse=sparse)
        want = JA.actionformer_infer_full({k: jnp.asarray(v) for k, v in outputs.items()},
                                          {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        got = A.actionformer_infer_full({k: _t(v) for k, v in outputs.items()},
                                        {k: _t(v) for k, v in batch.items()}, cfg)
        K = int(cfg.actionformer.test_cfg.max_seg_num)
        assert got["segments"].shape == (6, K, 2) and got["valid"].dtype == torch.bool
        np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
        assert not got["valid"][1].any() and got["valid"][0].any()
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                                   atol=1e-6)
        valid = np.asarray(want["valid"])
        np.testing.assert_allclose(got["segments"].numpy()[valid],
                                   np.asarray(want["segments"])[valid], atol=1e-4)
        if method == "none":  # the invalid tail too: ties go to the lower index
            np.testing.assert_allclose(got["segments"].numpy(), np.asarray(want["segments"]),
                                       atol=1e-4)


# ------------------------------------------------------------ the C++ twin


@pytest.mark.parametrize("method,threshold,sigma", [(0, 0.5, 0.5), (1, 0.3, 0.5),
                                                    (2, 0.1, 0.75)])
def test_cpp_twin_matches_torch_nms(method, threshold, sigma):
    lib = N.load()
    assert N.library_path().parent.name == "_build" and N.library_path().exists()
    assert N.load() is lib  # built once
    for seed in range(3):
        segs, scores = _problem(100 + seed)
        c_segs, c_scores, c_idx = N.nms_1d_cpu(segs, scores, threshold, 0.05, method, sigma, 40)
        t_segs, t_scores, t_valid = nms.nms_1d(_t(segs), _t(scores), threshold, 40, 0.05,
                                               method, sigma)
        n = int(t_valid.sum())
        assert len(c_idx) == n and t_valid[:n].all()  # the torch picks' valid prefix
        np.testing.assert_allclose(c_segs, t_segs[:n].numpy(), atol=0)
        np.testing.assert_allclose(c_scores, t_scores[:n].numpy(), rtol=1e-5)


def test_cpp_twin_raises_when_it_cannot_be_built(monkeypatch, tmp_path):
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "library_path", lambda: tmp_path / "libnms_1d-test.so")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        N.load()
    monkeypatch.undo()
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "SOURCE", bad)
    monkeypatch.setattr(N, "library_path", lambda: tmp_path / "libnms_1d-broken.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.load()
