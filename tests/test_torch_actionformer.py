"""The port's ActionFormer slice against the JAX package, on the CPU.

- ``banded_attention_plain`` against the Pallas ``banded_attention`` in
  interpret mode (f32, atol 1e-5) on every row, padding rows included;
- ``MaskedMHCA`` on both of its routes, ``TransformerBlock`` with stride 2,
  the backbone and the whole model, all at 1e-4, on weights carried from the
  JAX tree by ``from_jax_params`` with a strict load.  The tiny model config
  is the long YAML cut to width 32 and 512 frames with ``pallas_min_len``
  256, so the port takes the kernel route (the plain version here) at level
  0 while the JAX model takes its band-mask route (no Pallas on the CPU);
- the loss with the EMA extras at 1e-5 relative, the predicted spans, the
  test-mode batches and ``linear_resize``;
- the band gate, the bf16 policy on the new tree, and serving ActionFormer
  on the CPU.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.af_batcher import ActionFormerBatcher as JAFBatcher
from vmrframe_tpu.data.af_batcher import linear_resize as jlinear_resize
from vmrframe_tpu.kernels.window_attention import banded_attention as jbanded_attention
from vmrframe_tpu.layers import actionformer as JL
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.train.trainer import Trainer
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher, linear_resize
from vmrframe_tpu_torch.kernels import window_attention as W
from vmrframe_tpu_torch.layers import actionformer as L
from vmrframe_tpu_torch.models.actionformer import (ActionFormer, actionformer_infer,
                                                    actionformer_init_extras, actionformer_loss)
from vmrframe_tpu_torch.ops.precision import cast_batch
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.weights import from_jax_params, load_jax_params

LONG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                    "tacos_actionformer_long.yaml")
TINY = {
    "train.batch_size": 8, "train.compute_dtype": "float32",
    "model.vlen": 512, "model.vdim": 24, "model.word_dim": 16, "model.char_dim": 8,
    "actionformer.backbone_arch": [1, 2, 3], "actionformer.input_dim": 24,
    "actionformer.embd_dim": 32, "actionformer.fpn_dim": 32, "actionformer.head_dim": 32,
    "actionformer.n_head": 2, "actionformer.max_seq_len": 512,
    "actionformer.pallas_min_len": 256,
}
ATOL = 1e-4
BF16_STEPS = 12  # test_bf16_module_path_follows_jax's bar (9.5 measured)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lengths_mask(lens, T):
    return (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(np.float32)


def _lift_drop_path(params, rng):
    """AffineDropPath scales start at 1e-4, which would hide the branch they
    scale from the comparison: draw them in [0.5, 1.5] instead."""
    if not isinstance(params, dict):
        return params
    out = {}
    for k, v in params.items():
        if k.startswith("drop_path") and isinstance(v, dict):
            v = {"scale": rng.uniform(0.5, 1.5, np.shape(v["scale"])).astype(np.float32)}
        out[k] = _lift_drop_path(v, rng)
    return out


def _carry(module, params):
    """The JAX params loaded strictly into the port's module."""
    load_jax_params(module, jax.device_get(params), {})
    return module.eval()


# ------------------------------------------------------------- the kernel


@pytest.mark.parametrize("T,window,hd", [(384, 19, 16), (512, 9, 32), (700, 19, 32),
                                         (700, 9, 16)])
def test_banded_plain_matches_pallas_interpret(T, window, hd):
    rng = np.random.default_rng(T + window)
    B, H = 3, 2
    q, k, v = (rng.standard_normal((B, H, T, hd)).astype(np.float32) for _ in range(3))
    mask = _lengths_mask([T, T - 137, 0], T)  # ragged, and a wholly masked sample
    mask[0, 200:260] = 0.0  # a hole wider than the band: rows with no valid key
    want = jbanded_attention(*(jnp.asarray(a) for a in (q, k, v, mask)), window,
                             interpret=True)
    got = W.banded_attention_plain(*(_t(a) for a in (q, k, v, mask)), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the wholly masked sample: each tile's uniform average over its slice
    uniform = v[2, :, :W.key_window(window)].mean(1, keepdims=True)
    np.testing.assert_allclose(got[2, :, :128].numpy(), np.broadcast_to(uniform, (H, 128, hd)),
                               atol=1e-5)


def test_banded_wrapper_takes_the_plain_path_on_cpu_and_counts_no_launch():
    x = torch.randn(2, 2, 384, 16)
    mask = torch.ones(2, 384)
    before = W.banded_attention.launches
    torch.testing.assert_close(W.banded_attention(x, x, x, mask, 19),
                               W.banded_attention_plain(x, x, x, mask, 19), rtol=0, atol=0)
    assert W.banded_attention.launches == before
    with pytest.raises(ValueError, match="too small"):
        W.banded_attention_plain(x[:, :, :200], x[:, :, :200], x[:, :, :200], mask[:, :200], 19)


# ------------------------------------------------------------- the layers


@pytest.mark.parametrize("stride", [1, 2])
def test_masked_mhca_both_routes_match_jax(stride):
    rng = np.random.default_rng(stride)
    B, C, H, window = 2, 32, 2, 19
    T = 512 * stride
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = _lengths_mask([T, T - 141], T)
    j_band = JL.MaskedMHCA(C, H, stride, stride, window_size=window, pallas_min_len=-1)
    j_kern = JL.MaskedMHCA(C, H, stride, stride, window_size=window, pallas_min_len=256,
                           pallas_interpret=True)
    params = j_band.init(jax.random.PRNGKey(stride), jnp.asarray(x), jnp.asarray(mask))["params"]
    want, want_mask = j_band.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    want_k, _ = j_kern.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    for min_len in (-1, 256):  # band-mask route, then the kernel route
        m = _carry(L.MaskedMHCA(C, H, stride, stride, window, pallas_min_len=min_len), params)
        assert m.use_banded_kernel(512, 512) == (min_len == 256)
        with torch.no_grad():
            got, got_mask = m(_t(x), _t(mask))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        for ref in (want, want_k):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_band_gate_conditions():
    """The port's counterpart of the JAX gate: a window, T at or above the
    eval threshold, Tq == Tk, one key window within the padded length.  An
    unset eval threshold is ``pallas_min_len``; a rel-PE layer never takes
    the kernel, which does not add the term."""
    m = L.MaskedMHCA(64, 4, window_size=19, pallas_min_len=256)
    assert m.use_banded_kernel(512, 512)
    assert m.use_banded_kernel(300, 300)  # padded to 384 = K_WIN
    assert not m.use_banded_kernel(192, 192)  # below the threshold
    assert not m.use_banded_kernel(512, 256)  # Tq != Tk
    assert not L.MaskedMHCA(64, 4, window_size=19, pallas_min_len=200).use_banded_kernel(
        250, 250)  # padded 256 < K_WIN 384
    assert not L.MaskedMHCA(64, 4, window_size=300, pallas_min_len=256).use_banded_kernel(
        500, 500)  # padded 512 < K_WIN 640
    assert not L.MaskedMHCA(64, 4, window_size=19, pallas_min_len=-1).use_banded_kernel(512, 512)
    assert not L.MaskedMHCA(64, 4, window_size=-1, pallas_min_len=256).use_banded_kernel(512, 512)
    # the gate is mode-aware: in eval mode the eval threshold (-1 disables,
    # a number replaces pallas_min_len), in train mode pallas_min_len
    m2 = L.MaskedMHCA(64, 4, window_size=19, pallas_min_len=256, pallas_min_len_eval=-1)
    assert not m2.eval().use_banded_kernel(512, 512)
    assert m2.train().use_banded_kernel(512, 512)
    m3 = L.MaskedMHCA(64, 4, window_size=19, pallas_min_len=256, pallas_min_len_eval=1024)
    assert not m3.eval().use_banded_kernel(512, 512) and m3.use_banded_kernel(1024, 1024)
    assert m3.train().use_banded_kernel(512, 512)
    assert not L.MaskedMHCA(64, 4, window_size=19, pallas_min_len=-1,
                            pallas_min_len_eval=256).train().use_banded_kernel(512, 512)
    rel = L.MaskedMHCA(64, 4, window_size=19, use_rel_pe=True, pallas_min_len=256)
    assert not rel.use_banded_kernel(512, 512) and not rel.train().use_banded_kernel(512, 512)
    assert tuple(rel.rel_pe.shape) == (4, 19)
    # the long config sets no eval threshold: every level with T >= 512 takes the kernel
    cfg = load_config(LONG)
    assert cfg.actionformer.get("pallas_min_len_eval") is None
    tiny = {k: v for k, v in TINY.items() if k != "actionformer.pallas_min_len"}
    model = ActionFormer(cfg.updated(tiny), Derived(), None)
    assert model.backbone.stem_0.attn.min_len == 512


def test_transformer_block_stride2_matches_jax():
    rng = np.random.default_rng(5)
    B, T, C, H = 2, 1024, 32, 2
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = _lengths_mask([T - 3, 700], T)
    jblock = JL.TransformerBlock(C, H, n_ds_stride=2, path_pdrop=0.1, mha_win_size=19,
                                 pallas_min_len=256)
    params = jblock.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(mask))["params"]
    params = _lift_drop_path(params, rng)
    want, want_mask = jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    block = _carry(L.TransformerBlock(C, H, n_ds_stride=2, path_pdrop=0.1, mha_win_size=19,
                                      pallas_min_len=256), params)
    assert block.attn.use_banded_kernel(512, 512)
    with torch.no_grad():
        got, got_mask = block(_t(x), _t(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_backbone_matches_jax():
    rng = np.random.default_rng(6)
    B, T, n_in = 2, 512, 24
    x = rng.standard_normal((B, T, n_in)).astype(np.float32)
    mask = _lengths_mask([T, 333], T)
    kw = dict(n_in=n_in, n_embd=32, n_head=2, n_embd_ks=3, max_len=T, arch=(1, 2, 3),
              mha_win_size=(19,) * 4, path_pdrop=0.1, use_abs_pe=True, pallas_min_len=256)
    jbb = JL.ConvTransformerBackbone(**kw)
    params = jbb.init(jax.random.PRNGKey(6), jnp.asarray(x), jnp.asarray(mask))["params"]
    params = _lift_drop_path(params, rng)
    want_feats, want_masks = jbb.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    bb = _carry(L.ConvTransformerBackbone(**kw), params)
    with torch.no_grad():
        feats, masks = bb(_t(x), _t(mask))
    assert [f.shape[1] for f in feats] == [512, 256, 128, 64]
    for got, want, gm, wm in zip(feats, want_feats, masks, want_masks):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_grouped_conv_carries_from_the_jax_layout():
    """A (k, in/groups, out) flax kernel with groups=512 becomes the torch
    (out, in/groups, k) weight and gives the same convolution."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 512)).astype(np.float32)
    mask = _lengths_mask([9, 5], 9)
    jconv = JL.MaskedConv1D(512, 3, 2, groups=512, use_bias=False)
    params = jconv.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(mask))["params"]
    assert params["conv"]["kernel"].shape == (3, 1, 512)
    want, want_mask = jconv.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    conv = _carry(L.MaskedConv1D(512, 512, 3, 2, groups=512, use_bias=False), params)
    assert conv.conv.weight.shape == (512, 1, 3)
    with torch.no_grad():
        got, got_mask = conv(_t(x), _t(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_linear_resize_matches_jax():
    rng = np.random.default_rng(8)
    for t0, size in ((17, 64), (64, 64), (3000, 2304), (100, 37)):
        x = rng.standard_normal((t0, 8)).astype(np.float32)
        np.testing.assert_array_equal(linear_resize(x, size), jlinear_resize(x, size))


# ------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = jload_config(LONG).updated(TINY), load_config(LONG).updated(TINY)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=4, n_test=10)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=4, n_test=10)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"],
                    num_train_steps=2, steps_per_epoch=2)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    jbatches = list(JAFBatcher(jds["test_set"], jstore, jcfg, jder, "test").epoch(seed=0))
    batches = list(ActionFormerBatcher(ds["test_set"], store, cfg, der).epoch())
    trainer = Trainer(jcfg, jder, jds["word_vector"])
    jb = {k: jnp.asarray(v) for k, v in jbatches[0].items() if k != "num_valid"}
    rng = jax.random.PRNGKey(0)
    params = jax.device_get(trainer.model.init({"params": rng, "dropout": rng}, jb, True)["params"])
    params = _lift_drop_path(params, np.random.default_rng(9))
    jouts = [trainer.model.apply({"params": params},
                                 {k: jnp.asarray(v) for k, v in b.items() if k != "num_valid"},
                                 True) for b in jbatches]
    model = ActionFormer(cfg, der, ds["word_vector"]).eval()
    load_jax_params(model, params, {})
    return dict(jcfg=jcfg, cfg=cfg, ds=ds, der=der, jbatches=jbatches, batches=batches,
                trainer=trainer, params=params, jouts=jouts, model=model)


def test_batches_match(world):
    assert len(world["batches"]) == len(world["jbatches"]) == 2  # the second is partial
    for got, want in zip(world["batches"], world["jbatches"]):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_strict_carry_of_the_jax_tree(world):
    model, params = world["model"], world["params"]
    state = from_jax_params(params, {})
    assert set(state) == set(model.state_dict())
    assert state["scale_0.weight"].shape == ()
    assert state["backbone.stem_0.drop_path_attn.weight"].shape == (1, 1, 32)
    torch.testing.assert_close(model.backbone.stem_0.drop_path_mlp.weight,
                               torch.tensor(params["backbone"]["stem_0"]["drop_path_mlp"]["scale"]))
    with pytest.raises(RuntimeError, match="scale_5"):  # a stray leaf fails the strict load
        load_jax_params(model, {**params, "scale_5": {"scale": np.ones((), np.float32)}}, {})


def test_init_weights_gives_the_initial_constants(world):
    """The JAX initialisers' constants: Scale 1.0, AffineDropPath 1e-4,
    ChannelLayerNorm ones and zeros, zero conv and dense biases."""
    from vmrframe_tpu_torch.weights import init_weights

    model = ActionFormer(world["cfg"], world["der"], world["ds"]["word_vector"])
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(7.0)
    init_weights(model, seed=0)
    state = model.state_dict()
    assert state["scale_0.weight"].item() == 1.0
    drop = state["backbone.stem_0.drop_path_attn.weight"]
    assert torch.equal(drop, torch.full_like(drop, 1e-4))
    norm = model.backbone.stem_0.ln1
    assert torch.equal(norm.weight, torch.ones_like(norm.weight))
    assert torch.equal(norm.bias, torch.zeros_like(norm.bias))
    assert not model.backbone.stem_0.attn.query.bias.any()
    assert (model.backbone.stem_0.attn.query.weight != 7.0).all()


def test_forward_loss_and_spans_match(world):
    cfg, jcfg, model = world["cfg"], world["jcfg"], world["model"]
    jentry = world["trainer"].entry
    jextras = jentry.init_extras(jcfg)
    extras = actionformer_init_extras(cfg)
    n_decided = 0
    for batch, jbatch, jout in zip(world["batches"], world["jbatches"], world["jouts"]):
        jb = {k: jnp.asarray(v) for k, v in jbatch.items() if k != "num_valid"}
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items() if k != "num_valid"}
        with torch.no_grad():
            out = model(tb)
            loss, new_extras = actionformer_loss(out, tb, cfg, extras)
            props = actionformer_infer(out, tb, cfg)
        for key in ("cls_logits", "offsets", "fpn_mask"):
            np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), atol=ATOL,
                                       err_msg=key)
        want_loss, want_extras = jentry.loss_fn(jout, jb, jcfg, jextras)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        np.testing.assert_allclose(float(new_extras["loss_normalizer"]),
                                   float(want_extras["loss_normalizer"]), rtol=1e-5)
        want_props = np.asarray(jentry.infer_fn(jout, jb, jcfg))
        # Near-ties: a top-1 score within the forward's tolerance of the
        # runner-up may pick another point in the other framework.  A logit
        # moves sigmoid by at most a quarter of its error, so samples whose
        # margin exceeds ATOL are decided; only those are compared.
        scores = np.sort(np.asarray(jax.nn.sigmoid(jout["cls_logits"][..., 0]) * jout["fpn_mask"]),
                         axis=1)
        decided = (scores[:, -1] - scores[:, -2] > ATOL) & (batch["sample_mask"] > 0)
        n_decided += int(decided.sum())
        np.testing.assert_allclose(props.numpy()[decided], want_props[decided], atol=1e-5)
    assert n_decided >= 7  # of the 10 samples


def test_infer_matches_jax_on_random_and_degenerate_outputs(world):
    """Decoding, the argmax, voting and the every-score-zero case, on
    outputs drawn directly (no near-ties to avoid: both sides read the same
    scores)."""
    from vmrframe_tpu.models.actionformer import _points as jpoints
    from vmrframe_tpu.models.actionformer import actionformer_infer as jinfer

    jcfg, cfg = world["jcfg"], world["cfg"]
    P = len(jpoints(jcfg))
    rng = np.random.default_rng(10)
    B = 6
    batch = {"feat_stride": np.full((B,), 4.0, np.float32),
             "feat_num_frames": np.full((B,), 16.0, np.float32),
             "fps": np.full((B,), 30.0, np.float32),
             "duration": rng.uniform(10, 40, size=(B,)).astype(np.float32)}
    logits = rng.normal(size=(B, P, 1)).astype(np.float32)
    logits[1] = -20.0  # every score below pre_nms_thresh: the zero segment
    outputs = {"cls_logits": logits,
               "offsets": np.abs(rng.normal(size=(B, P, 2))).astype(np.float32),
               "fpn_mask": (rng.random((B, P)) > 0.2).astype(np.float32)}
    want = np.asarray(jinfer({k: jnp.asarray(v) for k, v in outputs.items()},
                             {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    got = actionformer_infer({k: _t(v) for k, v in outputs.items()},
                             {k: _t(v) for k, v in batch.items()}, cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[1, 0], got[1, 1])


def test_evaluator_holds_the_extras_and_matches_the_trainer(world):
    from vmrframe_tpu.train.trainer import TrainState
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    cfg = world["cfg"]
    ev = Evaluator(cfg, world["der"], world["ds"]["word_vector"], device="cpu")
    ev.load_state_dict(from_jax_params(world["params"], {}))
    assert float(ev.extras["loss_normalizer"]) == 100.0
    jextras = world["trainer"].entry.init_extras(world["jcfg"])
    state = TrainState(world["params"], {}, None, np.zeros((), np.int32), jextras)
    _, want_meter, _ = world["trainer"].run_eval_epoch(state, iter(world["jbatches"]))
    _, got_meter, _ = ev.run_eval_epoch(iter(world["batches"]))
    np.testing.assert_allclose(got_meter.avg, want_meter.avg, rtol=1e-5)
    assert float(ev.extras["loss_normalizer"]) == 100.0  # eval does not move the EMA


def test_bf16_policy_on_the_actionformer_tree(world):
    """Rank >= 2 weights go to bf16 (conv and dense kernels, AffineDropPath's
    (1, 1, D) scale); rank <= 1 stays f32 (ChannelLayerNorm, biases, Scale),
    and ``Scale`` lifts its bf16 input to f32 as JAX's promotion does."""
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    cfg16 = world["cfg"].updated({"train.compute_dtype": "bfloat16"})
    ev = Evaluator(cfg16, world["der"], world["ds"]["word_vector"], device="cpu")
    ev.load_state_dict(from_jax_params(world["params"], {}))
    m = ev.model
    assert m.backbone.embd_0.conv.weight.dtype == torch.bfloat16
    assert m.backbone.stem_0.attn.query.weight.dtype == torch.bfloat16
    assert m.backbone.stem_0.drop_path_attn.weight.dtype == torch.bfloat16
    assert m.backbone.stem_0.attn.query.bias.dtype == torch.float32
    assert m.backbone.embd_norm_0.weight.dtype == torch.float32
    assert m.scale_0.weight.dtype == torch.float32
    batch = ev.to_device(world["batches"][0])
    with torch.no_grad():
        raw = m(cast_batch(batch, torch.bfloat16))
        out32 = world["model"](batch)
    assert raw["cls_logits"].dtype == torch.bfloat16
    assert raw["offsets"].dtype == torch.float32
    out16 = ev.forward(batch)
    assert torch.isfinite(out16["cls_logits"]).all()
    err = (out16["cls_logits"] - out32["cls_logits"]).abs().max()
    assert err < 0.1 * out32["cls_logits"].abs().max()


def test_bf16_module_path_follows_jax(world):
    """ActionFormer's bf16 eval forward, call by call, against the jitted JAX
    forward under the same policy (rank >= 2 weights and batch leaves cast to
    bf16, ``cast_floating``), as ``test_torch_family.py`` holds SeqPAN's:
    every port module but the dropouts has a JAX module of the same path,
    each of its calls
    gives the dtypes the JAX call gives, and each output lies within
    ``BF16_STEPS`` steps of bf16 at the JAX output's largest magnitude.  An
    all-bf16 route rounds apart from XLA's fused one, and the banded
    attention's softmax, the layer norms and the heads' convolutions each
    add steps; the largest is at ``cls_head.norm_1`` (9.5 measured; 12
    allowed), wider than SeqPAN's bar of 6, which stays."""
    from flax import traverse_util

    from vmrframe_tpu.ops.precision import cast_floating
    from vmrframe_tpu_torch.layers.dropout import Dropout
    from vmrframe_tpu_torch.ops.precision import cast_batch, cast_module_

    bf = jnp.bfloat16
    jb = {k: jnp.asarray(v) for k, v in world["jbatches"][0].items() if k != "num_valid"}
    _, inter = jax.jit(lambda p, b: world["trainer"].model.apply(
        {"params": p}, b, True, capture_intermediates=True))(cast_floating(world["params"], bf),
                                                             cast_floating(jb, bf))
    jcalls = {path.replace("/__call__", "").replace("/", "."): calls for path, calls in
              traverse_util.flatten_dict(inter["intermediates"], sep="/").items()}
    model = ActionFormer(world["cfg"], world["der"], world["ds"]["word_vector"]).eval()
    load_jax_params(model, world["params"], {})
    cast_module_(model, torch.bfloat16)
    calls, hooked = {}, set()
    for name, mod in model.named_modules():
        if name and not isinstance(mod, Dropout):
            assert name in jcalls, name
            hooked.add(name)
            mod.register_forward_hook(
                lambda mod, args, out, name=name: calls.setdefault(name, []).append(out))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in world["batches"][0].items()
          if k != "num_valid"}
    with torch.no_grad():
        model(cast_batch(tb, torch.bfloat16))
    # a masked convolution's inner conv holds the weights its parent applies
    assert all(name.endswith(".conv") for name in hooked - set(calls))
    worst = {}
    for name, outs in calls.items():
        assert len(outs) == len(jcalls[name]), name
        for out, jout in zip(outs, jcalls[name]):
            outs_t, jouts = jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(jout)
            assert [str(o.dtype).split(".")[-1] for o in outs_t] == \
                [str(o.dtype) for o in jouts], name
            for o, jo in zip(outs_t, jouts):
                got, want = o.detach().float().numpy(), np.asarray(jo, np.float32)
                step = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - 7)
                worst[name] = max(worst.get(name, 0.0), np.abs(got - want).max() / step)
    name = max(worst, key=worst.get)
    assert worst[name] <= BF16_STEPS, (name, worst[name])


def test_serving_actionformer_on_the_cpu(world):
    from concurrent.futures import ThreadPoolExecutor

    from vmrframe_tpu_torch.tools.serve import build_service

    service, dataset = build_service(world["cfg"], n_synthetic=6, device="cpu")
    try:
        assert service._batcher_cls is ActionFormerBatcher
        records = dataset["test_set"]
        before = W.banded_attention.launches

        def one(i):
            rec = records[i % len(records)]
            return service.predict(rec["vid"], rec["sentence"], rec["duration"], timeout=120)

        with ThreadPoolExecutor(max_workers=6) as ex:
            results = list(ex.map(one, range(12)))
        metrics = service.metrics()
        assert metrics["requests_ok"] == 12 and metrics["requests_error"] == 0
        for out in results:
            s, e = out["pred_frac"]
            assert 0.0 <= s <= e <= 1.0
        # the text is carried and unused: another sentence, the same span
        rec = records[0]
        a = service.predict(rec["vid"], "a person opens the door", rec["duration"])
        b = service.predict(rec["vid"], "someone closes a window", rec["duration"])
        assert a["pred_frac"] == b["pred_frac"]
        assert W.banded_attention.launches == before  # CPU: the plain version
    finally:
        service.close()
