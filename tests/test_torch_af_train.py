"""The port's ActionFormer training slice against the JAX package, on the CPU.

- the plain backwards of the banded attention (``_dq_kernel``,
  ``_dkv_kernel``) against ``jax.vjp`` of the Pallas ``banded_attention`` in
  interpret mode, with a random cotangent on every row (padding rows too),
  f32 at atol 1e-5; the ``autograd.Function`` on the CPU against them;
- ``MaskedMHCA``'s grads on both of its routes against ``jax.grad`` of the
  JAX module at 1e-4;
- ``drop_path`` against a numpy transcription of the JAX function;
- the schedule, the decay mask over the carried tree, and AdamW + clipping
  against the JAX package's optax chain (``tree_adamw``) at 1e-6;
- train-mode batches; the trainer's first five steps against
  ``vmrframe_tpu.train.trainer.Trainer`` from the same weights (droppath 0,
  no warmup: loss at 1e-4 relative, step-1 grads at 1e-4 of each grad's
  max); loss and grads with droppath live in deterministic mode;
- checkpoints, the CLI and proj_pdrop are in ``test_torch_af_train_resume.py``.

The model config is the long YAML cut to width 32 and 512 frames
(``TINY``), with ``pallas_min_len`` 256 so the port takes the kernel route
(the plain versions here) at level 0 while the JAX model takes its
band-mask route (no Pallas on the CPU).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.af_batcher import ActionFormerBatcher as JAFBatcher
from vmrframe_tpu.kernels.window_attention import banded_attention as jbanded_attention
from vmrframe_tpu.layers import actionformer as JL
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.train.optim import _decay_mask, linear_warmup_decay as jschedule, tree_adamw
from vmrframe_tpu.train.trainer import Trainer as JTrainer
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher
from vmrframe_tpu_torch.data.batcher import BatchPrefetcher
from vmrframe_tpu_torch.kernels import window_attention as W
from vmrframe_tpu_torch.layers import actionformer as L
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.train import optim
from vmrframe_tpu_torch.train.trainer import Trainer
from vmrframe_tpu_torch.weights import _flatten, _leaf, from_jax_params, load_jax_params

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
# the trajectory: no AffineDropPath on either side, no warmup (step 1 moves)
TRAJ = {**TINY, "actionformer.train_cfg.droppath": 0.0, "train.warmup_proportion": 0.0,
        "train.lr": 1e-3}
N_STEPS = 5


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


def _assert_grads_close(got: dict, want: dict, rel: float):
    """Each gradient's max abs diff within ``rel`` of its max magnitude.

    The key projection's bias and the key norm's bias shift every key's
    score in a row by the same amount, which the softmax ignores: their
    gradients are zero up to rounding, so for them both sides must be below
    ``rel`` of the largest gradient instead."""
    assert set(got) == set(want)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        if name.endswith(L.SHIFT_INVARIANT):
            small = max(float(got[name].abs().max()), float(w.abs().max()))
            assert small <= rel * largest, f"{name}: {small:.3e} not ~0"
            continue
        scale = max(float(w.abs().max()), 1e-12)
        err = float((got[name] - w).abs().max())
        assert err <= rel * scale, f"{name}: {err:.3e} > {rel} * {scale:.3e}"


# ------------------------------------------------------ the backward kernels


@pytest.mark.parametrize("T,window", [(384, 19), (576, 19), (700, 9), (1024, 19), (576, 9)])
def test_plain_backwards_match_pallas_interpret(T, window):
    """T_pad == K_WIN (384), K2 clamped to T_pad (576 -> 640), K2 below
    T_pad (700, 1024); ragged lengths, a hole wider than the band, a wholly
    masked sample; a random cotangent on every row."""
    rng = np.random.default_rng(T + window)
    B, H, hd = 3, 2, 16
    q, k, v, g = (rng.standard_normal((B, H, T, hd)).astype(np.float32) for _ in range(4))
    mask = _lengths_mask([T, T - 137, 0], T)
    mask[0, 200:260] = 0.0
    fn = lambda q_, k_, v_: jbanded_attention(q_, k_, v_, jnp.asarray(mask), window,  # noqa: E731
                                              interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    args = [_t(a) for a in (q, k, v, mask, g)]
    got = (W.banded_attention_dq_plain(*args, window),) + W.banded_attention_dkv_plain(*args,
                                                                                       window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)


def test_autograd_function_on_cpu():
    """On CPU tensors the Function runs the plain forward and the two plain
    backwards; with the cotangent zero on rows without a valid key its grads
    are torch.autograd's through the plain forward.  No launch is counted."""
    g = torch.Generator().manual_seed(0)
    B, H, T, hd, window = 2, 2, 700, 16, 19
    q, k, v, cot = (torch.randn(B, H, T, hd, generator=g) for _ in range(4))
    mask = _t(_lengths_mask([T, 500], T))
    mask[0, 100:150] = 0.0
    before = [fn.launches for fn in W.KERNELS]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    W.banded_attention(*leaves, mask, window).backward(cot)
    want = (W.banded_attention_dq_plain(q, k, v, mask, cot, window),) + \
        W.banded_attention_dkv_plain(q, k, v, mask, cot, window)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    i = torch.arange(T)
    band = (i[:, None] - i[None, :]).abs() <= window // 2
    has_key = (band[None] & (mask[:, None, :] > 0)).any(-1).float()
    cot = cot * has_key[:, None, :, None]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    W.banded_attention(*leaves, mask, window).backward(cot)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    W.banded_attention_plain(*ref, mask, window).backward(cot)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r.grad, rtol=0, atol=1e-5)
    assert [fn.launches for fn in W.KERNELS] == before


@pytest.mark.parametrize("stride", [1, 2])
def test_masked_mhca_grads_both_routes_match_jax(stride):
    rng = np.random.default_rng(10 + stride)
    B, C, H, window = 2, 32, 2, 19
    T = 512 * stride
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = _lengths_mask([T, T - 141], T)
    cot = rng.standard_normal((B, T // stride, C)).astype(np.float32)
    j_band = JL.MaskedMHCA(C, H, stride, stride, window_size=window, pallas_min_len=-1)
    j_kern = JL.MaskedMHCA(C, H, stride, stride, window_size=window, pallas_min_len=256,
                           pallas_interpret=True)
    params = j_band.init(jax.random.PRNGKey(stride), jnp.asarray(x), jnp.asarray(mask))["params"]

    def jgrads(module):
        def loss(p, xx):
            out, _ = module.apply({"params": p}, xx, jnp.asarray(mask), False,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.sum(out * cot)
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
        return from_jax_params(jax.device_get(gp), {}), torch.from_numpy(np.array(gx))

    wants = [jgrads(j_band), jgrads(j_kern)]
    for min_len in (-1, 256):  # band-mask route, then the kernel route
        m = L.MaskedMHCA(C, H, stride, stride, window, pallas_min_len=min_len)
        load_jax_params(m, jax.device_get(params), {})
        m.train()
        assert m.use_banded_kernel(512, 512) == (min_len == 256)
        xt = _t(x).requires_grad_()
        out, _ = m(xt, _t(mask))
        (out * _t(cot)).sum().backward()
        got = {n: p.grad for n, p in m.named_parameters()}
        for want_p, want_x in wants:
            _assert_grads_close(got, want_p, 1e-4)
            _assert_grads_close({"x": xt.grad}, {"x": want_x}, 1e-4)


# ------------------------------------------------------------- drop path


def test_drop_path_matches_numpy_and_keeps_its_rate():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5, 4)).astype(np.float32)
    u = rng.random((6, 1, 1)).astype(np.float32)
    drop = 0.3
    keep_prob = 1.0 - drop  # vmrframe_tpu/layers/actionformer.py::drop_path
    want = x / keep_prob * np.floor(keep_prob + u)
    np.testing.assert_allclose(L.drop_path(_t(x), drop, _t(u)).numpy(), want, rtol=1e-6)

    mod = L.AffineDropPath(4, drop_prob=0.1)
    with torch.no_grad():
        mod.weight.fill_(1.0)
    ones = torch.ones(20000, 1, 4)
    gen = torch.Generator().manual_seed(0)
    kept = (mod.train()(ones, gen)[:, 0, 0] > 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01
    scaled = mod(ones, torch.Generator().manual_seed(1))
    assert set(torch.unique(scaled).tolist()) <= {0.0, (torch.tensor(1.0) / 0.9).item()}
    torch.testing.assert_close(mod.eval()(_t(x[..., :4])), _t(x[..., :4]), rtol=0, atol=0)


# ------------------------------------------------------------- the optimizer


def test_schedule_matches_jax():
    for num, warm in ((10, 0.15), (37, 0.05), (8, 0.0)):
        ours, theirs = optim.linear_warmup_decay(1e-3, num, warm), jschedule(1e-3, num, warm)
        for step in range(num + 2):
            np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, atol=0)
    assert optim.linear_warmup_decay(1e-3, 10, 0.15)(0) == 0.0  # step 0 at lr 0


def _jax_state(jtrainer, batch, seed: int):
    """``jtrainer.init_state``'s TrainState, with the init jitted (eager flax
    init of the model takes most of a minute on the CPU)."""
    from vmrframe_tpu.train.trainer import TrainState

    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "num_valid"}
    rng = jax.random.PRNGKey(seed)
    init = jax.jit(lambda r, b: jtrainer.model.init({"params": r, "dropout": r, "gumbel": r}, b,
                                                    True))
    params = init(rng, jb)["params"]
    return TrainState(params, {}, jtrainer.tx.init(params), jnp.zeros((), jnp.int32),
                      jtrainer.entry.init_extras(jtrainer.cfg))


def test_decay_mask_over_the_carried_tree_matches_jax(droppath_world):
    params = droppath_world["params"]
    jmask = _flatten(_decay_mask(params))
    flat = _flatten(params)
    want = {_leaf(path, flat[path])[0]: bool(v) for path, v in jmask.items()}
    got = {name: optim.decays(name) for name in want}
    assert got == want
    assert want["backbone.stem_0.ln1.weight"] and not want["backbone.stem_0.ln1.bias"]
    assert want["backbone.stem_0.drop_path_attn.weight"]


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["below_clip", "above_clip"])
def test_adamw_and_clip_match_tree_adamw(grad_scale):
    rng = np.random.default_rng(int(grad_scale * 100))
    shapes = {"a/kernel": (4, 3), "a/bias": (3,), "ln/weight": (5,), "layer_norm/scale": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = types.SimpleNamespace(train=types.SimpleNamespace(lr=1e-2, warmup_proportion=0.15,
                                                            clip_norm=1.0))
    tx = tree_adamw(cfg, 10)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k.replace("/", "."): _t(v) for k, v in params.items()}
    opt = optim.build_optimizer(cfg, 10, tp)
    for _ in range(4):  # lr 0 at step 0 (fractional warmup), then warmup, then decay
        grads = {k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
                 for k, s in shapes.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step({k.replace("/", "."): _t(v) for k, v in grads.items()})
        assert (float(norm) >= 1.0) == (grad_scale > 1.0)
        for k in shapes:
            np.testing.assert_allclose(tp[k.replace("/", ".")].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    assert opt.state["count"] == 4


# --------------------------------------------------- batches and the trainer


def _worlds(updates, n_train=24, n_test=8):
    jcfg, cfg = jload_config(LONG).updated(updates), load_config(LONG).updated(updates)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=n_train, n_test=n_test)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=n_train, n_test=n_test)
    steps = (n_train + cfg.train.batch_size - 1) // cfg.train.batch_size
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=steps,
                    steps_per_epoch=steps)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=steps,
                  steps_per_epoch=steps)
    jtrain = JAFBatcher(jds["train_set"], jstore, jcfg, jder, "train")
    train = ActionFormerBatcher(ds["train_set"], store, cfg, der, "train")
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, jder=jder, der=der, jtrain=jtrain,
                train=train, store=store)


def test_train_batches_match_jax():
    w = _worlds(TINY, n_train=20)
    for seed in (3, 4):
        jb, tb = list(w["jtrain"].epoch(seed=seed)), list(w["train"].epoch(seed=seed))
        assert len(tb) == len(jb) == len(w["train"]) == 3  # the last is partial
        for got, want in zip(tb, jb):
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # shuffled: another seed, another order
    a, b = next(w["train"].epoch(seed=3)), next(w["train"].epoch(seed=4))
    assert not np.array_equal(a["se_fracs"], b["se_fracs"])
    # the prefetcher yields the same batches, and raises the producer's error
    direct = list(w["train"].epoch(seed=3))
    for got, want in zip(BatchPrefetcher(w["train"].epoch(seed=3)), direct):
        np.testing.assert_array_equal(got["feats"], want["feats"])

    def broken():
        yield direct[0]
        raise KeyError("vid")

    with pytest.raises(KeyError):
        list(BatchPrefetcher(broken()))
    # erosion: the train batches are the JAX batcher's, drawn from the same stream
    eroded = {"dataprocess.video_augmentation": {"unchanged": None, "erosion": 0.05}}
    got = list(ActionFormerBatcher(w["ds"]["train_set"], w["store"], w["cfg"].updated(eroded),
                                   w["der"], "train").epoch(seed=3))
    jds, jstore = jmake_synthetic_data(w["jcfg"], seed=0, n_train=20, n_test=8)
    want = list(JAFBatcher(jds["train_set"], jstore, w["jcfg"].updated(eroded), w["jder"],
                           "train").epoch(seed=3))
    assert len(got) == len(want) == 3
    for g, j in zip(got, want):
        for key in j:
            np.testing.assert_array_equal(g[key], j[key], err_msg=key)


@pytest.fixture(scope="module")
def trajectory():
    """The JAX trainer's first N_STEPS steps and its step-1 grads, and the
    port's trainer on the same weights."""
    w = _worlds(TRAJ, n_train=N_STEPS * 8)
    jbatches = list(w["jtrain"].epoch(seed=7))
    jtrainer = JTrainer(w["jcfg"], w["jder"], w["jds"]["word_vector"])
    state = _jax_state(jtrainer, jbatches[0], 0)
    params = jax.device_get(state.params)
    entry = jtrainer.entry
    jb0 = {k: jnp.asarray(v) for k, v in jbatches[0].items() if k != "num_valid"}

    def loss_fn(p):
        out = jtrainer.model.apply({"params": p}, jb0, False,
                                   rngs={"dropout": jax.random.PRNGKey(1)})
        return entry.loss_fn(out, jb0, w["jcfg"], state.extras)[0]

    jgrads = from_jax_params(jax.device_get(jax.jit(jax.grad(loss_fn))(params)), {})
    step = jtrainer.compiled_train_step()
    jlosses = []
    for b in jbatches:
        state, metrics = step(state, jtrainer._shard_batch(b), jax.random.PRNGKey(0))
        jlosses.append(float(metrics["loss"]))
    return dict(w, jbatches=jbatches, params=params, jgrads=jgrads, jlosses=jlosses,
                jextras=float(state.extras["loss_normalizer"]))


def _port_trainer(w):
    """The port's trainer on the JAX trajectory's initial weights."""
    trainer = Trainer(w["cfg"], w["der"], w["ds"]["word_vector"], device="cpu")
    load_jax_params(trainer.model, w["params"], {})
    return trainer


def test_trainer_step1_grads_match_jax(trajectory):
    w = trajectory
    trainer = _port_trainer(w)
    trainer.model.train()  # droppath 0: train mode is deterministic here
    _, grads, _, _ = trainer.loss_and_grads(trainer.to_device(next(w["train"].epoch(seed=7))))
    _assert_grads_close(grads, w["jgrads"], 1e-4)


def test_trainer_trajectory_matches_jax(trajectory):
    w = trajectory
    trainer = _port_trainer(w)
    batches = list(w["train"].epoch(seed=7))
    assert len(batches) == N_STEPS
    losses = [float(trainer.train_step(trainer.to_device(b))["loss"]) for b in batches]
    np.testing.assert_allclose(losses, w["jlosses"], rtol=1e-4)
    assert trainer.step == N_STEPS and trainer.optimizer.state["count"] == N_STEPS
    np.testing.assert_allclose(float(trainer.extras["loss_normalizer"]), w["jextras"], rtol=1e-5)
    assert not trainer.extras["loss_normalizer"].requires_grad


@pytest.fixture(scope="module")
def droppath_world():
    """TINY with droppath 0.1: JAX params (AffineDropPath scales lifted to
    [0.5, 1.5]) and the deterministic loss and grads of one batch."""
    w = _worlds(TINY, n_train=8, n_test=8)
    jb = next(w["jtrain"].epoch(seed=1))
    jtrainer = JTrainer(w["jcfg"], w["jder"], w["jds"]["word_vector"])
    state = _jax_state(jtrainer, jb, 2)
    params = _lift_drop_path(jax.device_get(state.params), np.random.default_rng(5))
    jbt = {k: jnp.asarray(v) for k, v in jb.items() if k != "num_valid"}

    def loss_fn(p):
        out = jtrainer.model.apply({"params": p}, jbt, True)
        return jtrainer.entry.loss_fn(out, jbt, w["jcfg"], state.extras)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(w, params=params, loss=float(loss),
                grads=from_jax_params(jax.device_get(grads), {}))


def test_loss_and_grads_with_droppath_live_in_deterministic_mode(droppath_world):
    """droppath 0.1 on both sides, deterministic: the AffineDropPath scales
    get grads, and every grad matches JAX's."""
    w = droppath_world
    trainer = Trainer(w["cfg"], w["der"], w["ds"]["word_vector"], device="cpu")
    load_jax_params(trainer.model, w["params"], {})
    trainer.model.eval()  # drop path off; the kernel route still on (pallas_min_len 256)
    loss, grads, _, _ = trainer.loss_and_grads(trainer.to_device(next(w["train"].epoch(seed=1))))
    np.testing.assert_allclose(float(loss.detach()), w["loss"], rtol=1e-5)
    assert grads["backbone.stem_0.drop_path_attn.weight"].abs().max() > 0
    _assert_grads_close(grads, w["grads"], 1e-4)
