"""The port's SeqPAN-family training against the JAX package, on the CPU.

- SeqPAN, BackBone and BaseFast: three train steps of the port's ``Trainer``
  from the JAX trainer's initial weights, at droprate 0, with one fixed
  gumbel noise on both sides (each package's draw patched here), against
  ``vmrframe_tpu.train.trainer.Trainer`` (loss at 1e-4 relative), and the
  step-1 gradients at 1e-4 of each gradient's max;
- the train route's autograd Functions of kernels #1-#3 (the plain forward
  on the CPU, the recomputed backward) against ``jax.vjp`` of the JAX
  package's reference formulas, f32, at 1e-5; the guard that keeps a raw
  launch from detaching its outputs;
- dropout (keep rate and scale, bits 8 and 32), the gumbel noise's moments;
- ``dilation``/``erosion`` identical to the JAX functions, and train batches
  with them identical to the JAX ``Batcher``'s;
- CQAttention at droprate 0.5 against the JAX module with the same masks;
- the resumed run and the CLI are in ``test_torch_seqpan_train_resume.py``.

All at the tiny test config (vlen 32, dim 32).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import math
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import vmrframe_tpu.layers.attention as JA
import vmrframe_tpu.models.seqpan as JS
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data import augment as JAug
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.kernels.attention import _cq_reference, _dual_reference
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.train.trainer import Trainer as JTrainer
from vmrframe_tpu.train.trainer import TrainState
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data import augment as Aug
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.layers.attention import CQAttention
from vmrframe_tpu_torch.layers.dropout import Dropout
from vmrframe_tpu_torch.models import seqpan as S
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.train.trainer import Trainer
from vmrframe_tpu_torch.weights import _leaf, from_jax_params, init_weights, load_jax_params

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")
MODELS = ("SeqPAN", "BackBone", "BaseFast")
N_STEPS, BATCH = 3, 16
# droprate 0 and no warmup: train mode is deterministic but for the gumbel
# noise, and step 1 moves the weights
TRAJ = {"model.droprate": 0.0, "train.warmup_proportion": 0.0, "train.lr": 1e-3,
        "train.batch_size": BATCH}
AUG = {"unchanged": None, "dilation": 0.05, "erosion": 0.05}
# gradients that are zero up to rounding (models/seqpan.py); BaseFast takes
# the sigmoid of its start and end logits, not their softmax over the
# positions, so only its attention key biases are
SHIFT_INVARIANT = {"SeqPAN": S.SHIFT_INVARIANT, "BackBone": S.SHIFT_INVARIANT,
                   "BaseFast": ("key.bias",)}


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _worlds(name, updates, n_train=N_STEPS * BATCH, n_test=8):
    updates = {"model.name": name, **updates}
    jcfg, cfg = jload_config(CFG).updated(updates), load_config(CFG).updated(updates)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=n_train, n_test=n_test)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=n_train, n_test=n_test)
    steps = -(-n_train // cfg.train.batch_size)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=steps,
                    steps_per_epoch=steps)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=steps,
                  steps_per_epoch=steps)
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, jder=jder, der=der,
                jtrain=JBatcher(jds["train_set"], jstore, jcfg, jder, "train"),
                train=Batcher(ds["train_set"], store, cfg, der, "train"))


def _assert_grads_close(got: dict, want: dict, rel: float, shift_invariant):
    """Each gradient's max abs diff within ``rel`` of its max magnitude;
    the shift-invariant biases, zero up to rounding, below ``rel`` of the
    largest gradient on both sides."""
    assert set(got) == set(want)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = got[name]
        assert g is not None and torch.isfinite(g).all(), name
        if name.endswith(shift_invariant):
            small = max(float(g.abs().max()), float(w.abs().max()))
            assert small <= rel * largest, f"{name}: {small:.3e} not ~0"
            continue
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max())
        assert err <= rel * scale, f"{name}: {err:.3e} > {rel} * {scale:.3e}"


# ------------------------------------------------- trajectories against JAX


def _jax_variables(model, shapes):
    """The JAX variables of tree ``shapes`` (``jax.eval_shape`` of the init)
    holding ``model``'s weights: ``weights.from_jax_params``'s rule run
    backwards, which spares compiling the JAX init."""
    state = model.state_dict()
    out = {}
    for collection, tree in shapes.items():
        flat = {}
        for path, leaf in traverse_util.flatten_dict(tree, sep="/").items():
            name, _ = _leaf(path, np.zeros(leaf.shape, np.float32))
            value = state[name].numpy()
            if path.endswith("kernel"):
                value = value.T if value.ndim == 2 else value.transpose(2, 1, 0)
            assert value.shape == leaf.shape, path
            flat[path] = jnp.asarray(value)
        out[collection] = traverse_util.unflatten_dict(flat, sep="/")
    return out



@pytest.fixture(scope="module", params=MODELS)
def trajectory(request):
    """The JAX trainer's first N_STEPS steps, and its step-1 gradients, with
    ``gumbel_softmax`` drawing a fixed noise."""
    name = request.param
    w = _worlds(name, TRAJ)
    noise = np.random.default_rng(11).gumbel(size=(BATCH, w["cfg"].model.vlen, 4))
    noise = noise.astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "gumbel_softmax", lambda rng, logits, tau=1.0: jax.nn.softmax(
            (logits + jnp.asarray(noise, logits.dtype)) / tau, axis=-1))
        jtrainer = JTrainer(w["jcfg"], w["jder"], w["jds"]["word_vector"])
        jbatches = list(w["jtrain"].epoch(seed=7))
        jb0 = {k: jnp.asarray(v) for k, v in jbatches[0].items() if k != "num_valid"}
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda b: jtrainer.model.init(
            {"params": key, "dropout": key, "gumbel": key}, b, True), jb0)
        seeded = get_model_entry(name).model_cls(w["cfg"], w["der"], w["ds"]["word_vector"])
        variables = _jax_variables(init_weights(seeded, 0), shapes)
        params = variables["params"]
        constants = {k: v for k, v in variables.items() if k != "params"}

        def loss_fn(p):
            out = jtrainer.model.apply({"params": p, **constants}, jb0, False,
                                       rngs={"dropout": key, "gumbel": key})
            return jtrainer.entry.loss_fn(out, jb0, w["jcfg"])

        jgrads = from_jax_params(jax.device_get(jax.jit(jax.grad(loss_fn))(params)), {})
        host_params, host_constants = jax.device_get((params, constants["constants"]))
        state = jax.device_put(TrainState(params, constants, jtrainer.tx.init(params),
                                          jnp.zeros((), jnp.int32), {}), jtrainer._repl)
        step = jtrainer.compiled_train_step()
        jlosses = []
        for b in jbatches:
            state, metrics = step(state, jtrainer._shard_batch(b), jax.random.PRNGKey(1))
            jlosses.append(float(metrics["loss"]))
    return dict(w, name=name, noise=torch.from_numpy(noise), jgrads=jgrads, jlosses=jlosses,
                params=host_params, constants=host_constants)


def _port_trainer(w, monkeypatch):
    monkeypatch.setattr(S, "gumbel_noise", lambda logits, generator: w["noise"].to(logits.dtype))
    trainer = Trainer(w["cfg"], w["der"], w["ds"]["word_vector"], device="cpu")
    load_jax_params(trainer.model, w["params"], w["constants"])
    return trainer


def test_train_step1_grads_match_jax(trajectory, monkeypatch):
    w = trajectory
    trainer = _port_trainer(w, monkeypatch)
    trainer.model.train()
    before = [fn.launches for fn in K.KERNELS]
    _, grads, _, _ = trainer.loss_and_grads(trainer.to_device(next(w["train"].epoch(seed=7))),
                                            torch.Generator().manual_seed(0))
    _assert_grads_close(grads, w["jgrads"], 1e-4, SHIFT_INVARIANT[w["name"]])
    assert [fn.launches for fn in K.KERNELS] == before  # the plain versions on the CPU


def test_train_trajectory_matches_jax(trajectory, monkeypatch):
    w = trajectory
    trainer = _port_trainer(w, monkeypatch)
    batches = list(w["train"].epoch(seed=7))
    assert len(batches) == N_STEPS
    losses = [float(trainer.train_step(trainer.to_device(b))["loss"]) for b in batches]
    np.testing.assert_allclose(losses, w["jlosses"], rtol=1e-4)
    assert trainer.step == N_STEPS


# ------------------------------------------------ the train route's Functions


def _ragged_mask(rng, B, L):
    lens = rng.integers(1, L + 1, B)
    lens[0] = L
    return (np.arange(L)[None] < lens[:, None]).astype(np.float32)


def _close_to_max(got, want, name, rel=1e-5):
    """Within ``rel`` of the gradient's max magnitude (of 1 when smaller):
    the weight vectors' gradients are sums over every score."""
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), f"{name}: {err:.3e}"


def _grads_of(fn, args, n_diff, cotangents):
    xs = [_t(a).requires_grad_(i < n_diff) for i, a in enumerate(args)]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, xs[:n_diff], [_t(c) for c in cotangents])


@pytest.mark.parametrize("B,H,L,M,hd", [(3, 2, 17, 9, 8), (2, 4, 64, 30, 32)])
def test_attention_functions_match_jax_vjp(B, H, L, M, hd):
    """#1 and #2 through their Functions (plain forward, recomputed backward)
    against ``jax.vjp`` of ``_dual_reference`` (#1: its self branch)."""
    rng = np.random.default_rng(L + M)
    q, f_k, f_v = (rng.standard_normal((B, H, L, hd)).astype(np.float32) for _ in range(3))
    t_k, t_v = (rng.standard_normal((B, H, M, hd)).astype(np.float32) for _ in range(2))
    vm, tm = _ragged_mask(rng, B, L), _ragged_mask(rng, B, M)
    s_mask, x_mask = vm[:, :, None] * vm[:, None], vm[:, :, None] * tm[:, None]
    g_s, g_x = (rng.standard_normal((B, H, L, hd)).astype(np.float32) for _ in range(2))
    args = (q, f_k, f_v, t_k, t_v, s_mask, x_mask)
    _, vjp = jax.vjp(lambda *a: _dual_reference(*a, jnp.asarray(s_mask), jnp.asarray(x_mask)),
                     *map(jnp.asarray, args[:5]))
    want = vjp((jnp.asarray(g_s), jnp.asarray(g_x)))
    got = _grads_of(K.dual_attention, args, 5, (g_s, g_x))
    for name, a, b in zip(("q", "f_k", "f_v", "t_k", "t_v"), got, want):
        _close_to_max(a, b, name)
    _, vjp = jax.vjp(lambda q_, k_, v_: _dual_reference(
        q_, k_, v_, k_, v_, jnp.asarray(s_mask), jnp.asarray(s_mask))[0],
        *map(jnp.asarray, (q, f_k, f_v)))
    want = vjp(jnp.asarray(g_s))
    got = _grads_of(K.masked_attention, (q, f_k, f_v, s_mask), 3, (g_s,))
    for name, a, b in zip(("q", "k", "v"), got, want):
        _close_to_max(a, b, name)


@pytest.mark.parametrize("B,Lc,Lq,D", [(3, 17, 9, 16), (2, 64, 30, 32), (2, 30, 64, 32)])
def test_cq_function_matches_jax_vjp(B, Lc, Lq, D):
    rng = np.random.default_rng(Lc * Lq)
    c, q = (rng.standard_normal((B, L, D)).astype(np.float32) for L in (Lc, Lq))
    w4C, w4Q = (rng.standard_normal((D, 1)).astype(np.float32) * 0.3 for _ in range(2))
    w4mlu = rng.standard_normal((1, 1, D)).astype(np.float32) * 0.3
    cm, qm = _ragged_mask(rng, B, Lc), _ragged_mask(rng, B, Lq)
    g1, g2 = (rng.standard_normal((B, Lc, D)).astype(np.float32) for _ in range(2))
    args = (c, q, w4C, w4Q, w4mlu, cm, qm)
    _, vjp = jax.vjp(lambda *a: _cq_reference(*a, jnp.asarray(cm), jnp.asarray(qm)),
                     *map(jnp.asarray, args[:5]))
    want = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    got = _grads_of(K.cq_attention, args, 5, (g1, g2))
    for name, a, b in zip(("context", "query", "w4C", "w4Q", "w4mlu"), got, want):
        _close_to_max(a, b, name)


class _OnCuda:
    """Stands in for a CUDA tensor as far as the wrappers read one before
    their guard: its device and whether it requires grad."""

    device = torch.device("cuda")
    requires_grad = True


@pytest.mark.parametrize("wrapper,n_args", [(K.fused_masked_attention, 4),
                                            (K.fused_dual_attention, 7),
                                            (K.fused_cq_attention, 7)],
                         ids=["masked", "dual", "cq"])
def test_wrappers_refuse_to_detach_outputs(wrapper, n_args):
    """A raw launch on CUDA inputs that require grad, with grad mode on,
    raises before anything else; the Functions' forward runs with grad mode
    off, so it passes there; on the CPU the plain version is differentiable."""
    with pytest.raises(RuntimeError, match="no backward"):
        wrapper(*[_OnCuda() for _ in range(n_args)])
    x = torch.ones(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="detached"):
        K.refuse_detached((x,), "k")
    with torch.no_grad():
        K.refuse_detached((x,), "k")
    K.refuse_detached((x.detach(),), "k")


# ---------------------------------------------------- dropout and gumbel


@pytest.mark.parametrize("bits,rate", [(8, 0.2), (8, 0.1), (8, 0.5), (32, 0.2), (32, 0.1)])
def test_dropout_keep_rate_and_scale(bits, rate):
    x = torch.rand(400, 500) + 0.5
    drop = Dropout(rate, bits).train()
    y = drop(x, torch.Generator().manual_seed(bits))
    t = round(rate * 256)
    keep = (256 - t) / 256 if bits == 8 else 1.0 - rate  # 0.2 -> 205/256 with 8 bits
    scale = 256.0 / (256 - t) if bits == 8 else 1.0 / (1.0 - rate)
    kept = y != 0
    n = x.numel()
    assert abs(kept.float().mean().item() - keep) <= 4 * math.sqrt(keep * (1 - keep) / n)
    want = x * torch.tensor(scale, dtype=x.dtype) if bits == 8 else x / (1.0 - rate)
    assert torch.equal(y[kept], want[kept])


def test_dropout_identity_and_edges():
    x = torch.randn(4, 5)
    assert Dropout(0.2).eval()(x) is x
    assert Dropout(0.0).train()(x) is x
    assert torch.equal(Dropout(1.0).train()(x), torch.zeros_like(x))
    with pytest.raises(ValueError, match="Generator"):
        Dropout(0.2).train()(x)
    # the same generator state gives the same mask; another seed another
    a, b, c = (Dropout(0.5).train()(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_model_dropout_width_comes_from_the_config():
    w = _worlds("SeqPAN", {"train.dropout_bits": 32}, n_train=4, n_test=4)
    for bits, cfg in ((32, w["cfg"]), (8, load_config(CFG))):
        model = get_model_entry("SeqPAN").model_cls(cfg, w["der"], w["ds"]["word_vector"])
        drops = [m for m in model.modules() if isinstance(m, Dropout)]
        assert drops and {m.bits for m in drops} == {bits}
        assert {m.rate for m in drops} == {float(cfg.model.droprate)}


def test_gumbel_noise_moments():
    """Gumbel(0, 1): mean the Euler-Mascheroni constant, variance pi^2/6,
    each within 5 standard errors over 10^6 draws."""
    n = 1_000_000
    g = S.gumbel_noise(torch.zeros(n), torch.Generator().manual_seed(3)).double()
    var = math.pi ** 2 / 6
    assert abs(g.mean().item() - 0.5772156649) <= 5 * math.sqrt(var / n)
    assert abs(g.var().item() - var) <= 5 * math.sqrt(4.4 * var ** 2 / n)  # kurtosis 5.4
    assert torch.isfinite(g).all()
    bf = S.gumbel_noise(torch.zeros(1000, dtype=torch.bfloat16), torch.Generator().manual_seed(3))
    assert bf.dtype == torch.bfloat16 and torch.isfinite(bf).all()


# ------------------------------------------------------------ augmentation


def test_dilation_and_erosion_equal_jax():
    for seed in range(50):
        data = np.random.default_rng(seed)
        T = int(data.integers(8, 80))
        vfeat = data.standard_normal((T, 6)).astype(np.float32)
        s = int(data.integers(0, T))
        e = int(data.integers(s, T))
        label = np.zeros(T, np.float32)
        label[s:e + 1] = 1.0
        if seed % 10 == 0:
            label[:] = 1.0  # no negative frame: random features stand in
        p = float(data.uniform(0.02, 0.6))
        for port, ref in ((Aug.feature_dilation, JAug.feature_dilation),
                          (Aug.feature_erosion, JAug.feature_erosion)):
            r1, r2 = random.Random(seed), random.Random(seed)
            for got, want in zip(port(vfeat, label, p, r1), ref(vfeat, label, p, r2)):
                np.testing.assert_array_equal(got, want)
            assert r1.random() == r2.random()  # the streams advanced alike
        r1, r2 = random.Random(seed), random.Random(seed)
        for got, want in zip(Aug.video_augmentation(s / T, (e + 1) / T, vfeat, AUG, r1),
                             JAug.video_augmentation(s / T, (e + 1) / T, vfeat, AUG, r2)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_augmented_train_batches_equal_jax(name):
    w = _worlds(name, {"dataprocess.video_augmentation": AUG, "train.batch_size": 8},
                n_train=20)
    for seed in (3, 4):
        jb, tb = list(w["jtrain"].epoch(seed=seed)), list(w["train"].epoch(seed=seed))
        assert len(tb) == len(jb) == 3
        for got, want in zip(tb, jb):
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the test batcher applies no augmentation
    test = Batcher(w["ds"]["test_set"], w["train"].features, w["cfg"], w["der"], "test")
    assert test.aug_is_identity


# ---------------------------------------------- CQAttention's two input pairs


class _JaxMasks:
    """Stands in for the JAX package's ``Dropout``: each call multiplies by
    the next of the given keep-and-scale masks."""

    queue = []

    def __init__(self, rate):
        self.rate = rate

    def __call__(self, x, deterministic=True):
        return x * jnp.asarray(_JaxMasks.queue.pop(0), x.dtype)


def test_cq_attention_at_droprate_half_matches_jax(monkeypatch):
    """Scores from the dropped context and query, c2q, q2c and the concat
    from the undropped ones: the same masks on both sides, outputs and
    gradients at 1e-4."""
    B, Lc, Lq, D, rate = 3, 20, 9, 16, 0.5
    rng = np.random.default_rng(5)
    c, q = (rng.standard_normal((B, L, D)).astype(np.float32) for L in (Lc, Lq))
    cm, qm = _ragged_mask(rng, B, Lc), _ragged_mask(rng, B, Lq)
    masks = [(rng.random(shape) >= rate).astype(np.float32) / (1 - rate)
             for shape in ((B, Lc, D), (B, Lq, D))]
    jmod = JA.CQAttention(D, rate)
    variables = jmod.init(jax.random.PRNGKey(0), c, q, cm, qm, True)
    monkeypatch.setattr(JA, "Dropout", _JaxMasks)

    def jloss(p, c_, q_):
        _JaxMasks.queue = list(masks)
        out = jmod.apply({"params": p}, c_, q_, cm, qm, False)
        return jnp.sum(out * jnp.sin(out)), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], jnp.asarray(c), jnp.asarray(q))

    mod = CQAttention(D, rate).train()
    load_jax_params(mod, variables["params"], {})
    fed = iter(masks)
    monkeypatch.setattr(mod.dropout, "forward", lambda x, generator=None: x * _t(next(fed)))
    ct, qt = _t(c).requires_grad_(), _t(q).requires_grad_()
    got = mod(ct, qt, _t(cm), _t(qm))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    (got * torch.sin(got)).sum().backward()
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(jgrads[1]), atol=1e-4)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(jgrads[2]), atol=1e-4)
    jp = from_jax_params(jax.device_get(jgrads[0]), {})
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jp[name].numpy(), atol=1e-4, err_msg=name)
