"""CCA's pieces in the port against the JAX package, on the CPU, at the tiny
CCA test config (``tests/configs/anet_cca.yaml``: 16 clips, 24 concepts,
width 16):

- ``data/concepts.py`` on both branches (the synthetic ``default_rng(7)``
  graph, and small pickles written to ``tmp_path``), exactly;
- ``infer_span_2d``, ``lossfun_loc2d`` (with ``sample_mask``) and
  ``CCABatcher``'s batch;
- the strided map meta and map, and their gradient (1e-5);
- ``cosine_sum_scores``' forward and both gradients against ``jax.vjp`` of
  the JAX op, with all-zero map cells (d2 <= eps^2) in the input (1e-5);
- ``ConceptGCN``, ``FuseAttention``, ``TransformerLayer``,
  ``RefBatchTransformerLayer`` and ``BatchNorm2dTanhConv`` against the JAX
  modules on carried weights (1e-4); BatchNorm's running statistics after
  three train-mode forwards (flax's momentum and biased variance) and the
  eval forward after them, which ``nn.BatchNorm2d``'s update would miss;
- the JAX tree carried across with a strict load (params, constants and
  ``batch_stats``);
- every setting of the JAX package's formulation switches
  (``others.cca_map_impl``, ``others.cca_contraction_scores``): the JAX
  model's train-mode forward, running statistics, loss and gradient
  against the port's (which computes one form), dropout off in both;
- the shipped config's width: 59,133,437 JAX parameters.

The JAX weights come from the port's seeded init through the carry-over
rule run backwards (``jax_variables``).  The gradients of the two
shift-invariant key biases, and in train mode of the conv bias before
BatchNorm (``cca.TRAIN_SHIFT_INVARIANT``), are zero up to rounding in both
packages; they are held to the largest gradient.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import vmrframe_tpu.models.cca as JC
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data import concepts as JCon
from vmrframe_tpu.data.cca_batcher import CCABatcher as JCCABatcher
from vmrframe_tpu.layers.dropout import Dropout as JDropout
from vmrframe_tpu.losses import lossfun_loc2d as jlossfun_loc2d
from vmrframe_tpu.ops.span import infer_span_2d as jinfer_span_2d
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data import concepts as Con
from vmrframe_tpu_torch.data.cca_batcher import CCABatcher
from vmrframe_tpu_torch.layers.dropout import Dropout
from vmrframe_tpu_torch.losses import lossfun_loc2d
from vmrframe_tpu_torch.models import cca as C
from vmrframe_tpu_torch.ops.span import infer_span_2d
from vmrframe_tpu_torch.ops.windowed import cell_segment_max_map
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.weights import _leaf, from_jax_params, init_weights

HERE = os.path.dirname(__file__)
TINY = os.path.join(HERE, "configs", "anet_cca.yaml")
FULL = os.path.join(HERE, "..", "configs", "anet_cca.yaml")
OP_TOL, ATOL = 1e-5, 1e-4
KEY = jax.random.PRNGKey(0)
_BACK = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}  # torch layout -> flax kernel


def jax_variables(model, shapes):
    """The JAX variables of tree ``shapes`` holding the port ``model``'s
    weights and buffers: ``weights.from_jax_params``'s rule run backwards
    (dense, conv1d and conv2d kernels, ``batch_stats``)."""
    state = model.state_dict()
    out = {}
    for collection, tree in shapes.items():
        flat = {}
        for path, leaf in traverse_util.flatten_dict(tree, sep="/").items():
            full = f"batch_stats/{path}" if collection == "batch_stats" else path
            name, _ = _leaf(full, np.zeros(leaf.shape, np.float32))
            value = state[name].detach().numpy()
            if path.rsplit("/", 1)[-1] == "kernel":
                value = value.transpose(_BACK[value.ndim])
            assert value.shape == leaf.shape, path
            flat[path] = jnp.asarray(value)
        out[collection] = traverse_util.unflatten_dict(flat, sep="/")
    return out


def grads_as_state(model, grads):
    """A state dict of the parameters' gradients (zeros where none) and the
    buffers, for ``jax_variables``."""
    state = {k: (g if g is not None else torch.zeros_like(p))
             for (k, p), g in zip(model.named_parameters(), grads)}
    state.update(dict(model.named_buffers()))
    return type("Grads", (), {"state_dict": lambda self: state})()


def assert_grads_close(got, want, shift_invariant=(), atol=ATOL):
    """Each gradient within ``atol`` of its largest entry; the shift-invariant
    ones (zero up to rounding) within ``atol`` of the largest gradient."""
    got = traverse_util.flatten_dict(got, sep="/")
    want = traverse_util.flatten_dict(want, sep="/")
    assert set(got) == set(want)
    top = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for path, w in want.items():
        w, g = np.asarray(w), np.asarray(got[path])
        scale = top if path.replace("/", ".") in shift_invariant else \
            max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g / scale, w / scale, atol=atol, err_msg=path)


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@functools.lru_cache(maxsize=None)
def world(updates=()):
    updates = dict(updates)
    jcfg, cfg = jload_config(TINY).updated(updates), load_config(TINY).updated(updates)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=8, n_test=8)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=8, n_test=8)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=2,
                    steps_per_epoch=1)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=2,
                  steps_per_epoch=1)
    jbatch = next(JCCABatcher(jds["test_set"], jstore, jcfg, jder, "test").epoch(seed=0))
    batch = next(CCABatcher(ds["test_set"], store, cfg, der, "test").epoch(seed=0))
    model = init_weights(get_model_entry("CCA").model_cls(cfg, der, ds["word_vector"]), 3)
    jmodel = jget_model_entry("CCA").model_cls(jcfg, jder, jds["word_vector"])
    jb = {k: jnp.asarray(v) for k, v in jbatch.items() if k != "num_valid"}
    shapes = jax.eval_shape(lambda b: jmodel.init({"params": KEY, "dropout": KEY}, b, True), jb)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items() if k != "num_valid"}
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, jstore=jstore, store=store, jder=jder,
                der=der, jbatch=jbatch, batch=batch, jb=jb, tb=tb, model=model.eval(),
                jmodel=jmodel, variables=jax_variables(model, shapes))


# ------------------------------------------------------------------- data


def test_concepts_synthetic_branch_equals_jax():
    for path in (TINY, FULL):
        jcfg, cfg = jload_config(path), load_config(path)
        wd = int(cfg.INPUT.PRE_QUERY_SIZE)
        je, ja = JCon.load_concepts(jcfg, word_dim=wd)
        e, a = Con.load_concepts(cfg, word_dim=wd)
        np.testing.assert_array_equal(e, je)
        np.testing.assert_array_equal(a, ja)
        assert e.shape == (int(cfg.num_attribute), wd) and a.dtype == np.float32


def test_concepts_file_branch_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    n_attr, n_com, wd = 6, 3, 5
    files = {
        "inp_name": rng.standard_normal((n_attr, wd)).astype(np.float32),
        "com_emb": {f"c{i}": rng.standard_normal(wd).astype(np.float32) for i in range(n_com)},
        "adj_file": rng.integers(0, 9, (n_attr, n_attr)).astype(np.float64),
        "num_path": {f"a{i}": int(rng.integers(1, 5)) for i in range(n_attr)},
        "com_concept": rng.random((n_com, n_attr + n_com)),
    }
    updates = {}
    for key, value in files.items():
        with open(tmp_path / f"{key}.pkl", "wb") as f:
            pickle.dump(value, f)
        updates[key] = str(tmp_path / f"{key}.pkl")
    jcfg, cfg = jload_config(TINY).updated(updates), load_config(TINY).updated(updates)
    (je, ja), (e, a) = JCon.load_concepts(jcfg, word_dim=wd), Con.load_concepts(cfg, word_dim=wd)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(a, ja)
    assert a.shape == (n_attr + n_com, n_attr + n_com)
    np.testing.assert_array_equal(Con.rescale_adj_matrix(files["adj_file"] / 4.0),
                                  JCon.rescale_adj_matrix(files["adj_file"] / 4.0))
    # one pickle missing: the synthetic graph of num_attribute nodes
    cfg2 = cfg.updated({"com_emb": str(tmp_path / "absent.pkl")})
    assert Con.load_concepts(cfg2, word_dim=wd)[1].shape == (24, 24)


def test_infer_span_2d_and_loc2d_loss_equal_jax():
    rng = np.random.default_rng(1)
    B, L = 5, 12
    scores = rng.standard_normal((B, L, L)).astype(np.float32)
    labels = rng.random((B, L, L)).astype(np.float32)
    mask = np.triu(rng.random((L, L)) > 0.3)
    vmask = (np.arange(L)[None] < rng.integers(3, L + 1, B)[:, None]).astype(np.float32)
    sample_mask = np.array([1, 1, 1, 0, 1], np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        infer_span_2d(t(scores), t(mask), t(vmask)).numpy(),
        np.asarray(jinfer_span_2d(scores, mask, vmask)))
    for sm in (None, sample_mask):
        got = lossfun_loc2d(t(scores), t(labels), t(mask), 0.5, 1.0,
                            None if sm is None else t(sm))
        want = jlossfun_loc2d(scores, labels, mask, 0.5, 1.0, sample_mask=sm)
        np.testing.assert_allclose(float(got), float(want), rtol=OP_TOL)


def test_batch_equals_jax():
    w = world()
    assert set(w["batch"]) == set(w["jbatch"])
    for key, value in w["jbatch"].items():
        np.testing.assert_array_equal(w["batch"][key], value, err_msg=key)
    assert w["batch"]["label2ds"].shape == (8, 16, 16)


# -------------------------------------------------------------------- ops


def test_strided_map_and_its_gradient_equal_jax():
    L, pooling = 16, (4, 2, 2)
    jmask, jcells = JC.cca_strided_mask_meta(list(pooling), L)
    mask, cells = C.cca_strided_mask_meta(pooling, L)
    np.testing.assert_array_equal(mask, jmask)
    assert list(cells) == list(jcells)
    x = np.random.default_rng(2).standard_normal((2, L, 3)).astype(np.float32)
    g = np.random.default_rng(3).standard_normal((2, L, L, 3)).astype(np.float32)
    for impl in ("gather", "scatter"):
        fn = functools.partial(JC.strided_segment_max_map, cells=jcells, impl=impl)
        want, jgx = jax.jit(lambda v, ct: (fn(v), jax.vjp(fn, v)[1](ct)[0]))(x, g)
        xt = torch.from_numpy(x).requires_grad_(True)
        got = cell_segment_max_map(xt, cells)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=OP_TOL)
        (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
        np.testing.assert_allclose(_np(gx), np.asarray(jgx), atol=OP_TOL)


def test_cosine_sum_scores_and_its_vjp_match_jax():
    rng = np.random.default_rng(1)
    B, L, H = 2, 6, 10
    q = rng.standard_normal((B, H)).astype(np.float32)
    m = rng.standard_normal((B, L, L, H)).astype(np.float32)
    m[0, 1, 4] = 0.0  # an all-zero cell: d2 = 0 <= eps^2, the clamped branch
    m[1, 2:, :2] = 0.0  # the cells off a strided map
    m[1, 0, 0] *= 1e-7  # near the clamp
    g = rng.standard_normal((B, L, L)).astype(np.float32)
    g[0, 1, 4] = 0.0  # the loss masks an off-map cell, so its cotangent is 0 there
    want, vjp = jax.vjp(JC.cosine_sum_scores, jnp.asarray(q), jnp.asarray(m))
    jdq, jdm = vjp(jnp.asarray(g))
    qt, mt = torch.from_numpy(q).requires_grad_(True), torch.from_numpy(m).requires_grad_(True)
    got = C.cosine_sum_scores(qt, mt)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=OP_TOL)
    dq, dm = torch.autograd.grad(got, (qt, mt), torch.from_numpy(g))
    np.testing.assert_allclose(_np(dq), np.asarray(jdq), atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_allclose(_np(dm), np.asarray(jdm), atol=OP_TOL, rtol=OP_TOL)
    # the zero cell's map gradient is the a-term alone: g q / eps, here 0 with g
    assert not dm[0, 1, 4].any() and dm[1, 3, 0].abs().sum() > 0
    np.testing.assert_allclose(_np(C.l2norm(torch.from_numpy(m))),
                               np.asarray(JC.l2norm(jnp.asarray(m))), atol=OP_TOL)


# ---------------------------------------------------------------- modules


def _module_pair(port, jmod, *args, **static):
    """The port module with seeded weights and the JAX module's variables
    holding them (built by eval_shape from the arrays ``args``)."""
    init_weights(port, 5)
    shapes = jax.eval_shape(
        lambda *a: jmod.init({"params": KEY, "dropout": KEY}, *a, **static), *args)
    return port.eval(), jax_variables(port, shapes)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_concept_gcn_matches_jax():
    embs, adj = Con.load_concepts(load_config(TINY), word_dim=50)
    port, v = _module_pair(C.ConceptGCN(16, adj, embs), JC.ConceptGCN(16, adj, embs))
    assert set(v["constants"]) == {"adj_all", "concept_embs"}
    np.testing.assert_allclose(_np(port()), np.asarray(JC.ConceptGCN(16, adj, embs).apply(v)),
                               atol=ATOL)


def test_fuse_attention_matches_jax():
    feat, concept = _rand(4, 16), _rand(24, 16, seed=1)
    jmod = JC.FuseAttention(16, 16)
    port, v = _module_pair(C.FuseAttention(16, 16), jmod, feat, concept,
                           deterministic=True)
    np.testing.assert_allclose(_np(port(torch.from_numpy(feat), torch.from_numpy(concept))),
                               np.asarray(jmod.apply(v, feat, concept, True)), atol=ATOL)


@pytest.mark.parametrize("quirk", [False, True], ids=["per_sample", "ref_batch"])
def test_transformer_layers_match_jax(quirk):
    x = _rand(3, 16, 40)  # (B, channel rows, L + A)
    jmod = (JC.RefBatchTransformerLayer if quirk else JC.TransformerLayer)(40)
    port, v = _module_pair((C.RefBatchTransformerLayer if quirk else C.TransformerLayer)(40),
                           jmod, x, deterministic=True)
    if quirk:
        assert v["params"]["in_proj_weight"].shape == (120, 40)
        assert v["params"]["ff1_kernel"].shape == (40, 2048)
    np.testing.assert_allclose(_np(port(torch.from_numpy(x))), np.asarray(jmod.apply(v, x, True)),
                               atol=ATOL)
    with pytest.raises(ValueError, match="multiple"):
        (C.RefBatchTransformerLayer if quirk else C.TransformerLayer)(41)


def test_batchnorm_map_branch_and_running_statistics_match_jax():
    """Three train-mode forwards (batch statistics, running ones updated
    with flax's momentum 0.9 and the biased variance), then an eval
    forward on the running statistics."""
    maps = [_rand(4, 8, 8, 16, seed=s) * (1 + s) + s for s in range(3)]
    jmod = JC.BatchNorm2dTanhConv(16)
    port, v = _module_pair(C.BatchNorm2dTanhConv(16, 16), jmod, maps[0],
                           deterministic=True)
    assert set(v["batch_stats"]["bn"]) == {"mean", "var"}
    assert v["params"]["conv"]["kernel"].shape == (5, 5, 16, 16)
    port.train()
    torch_mean, torch_var = torch.zeros(16), torch.ones(16)
    for x in maps:
        want, mutated = jmod.apply(v, x, False, mutable=["batch_stats"])
        v = {**v, **mutated}
        np.testing.assert_allclose(_np(port(torch.from_numpy(x), False)), np.asarray(want),
                                   atol=ATOL)
        with torch.no_grad():  # what nn.BatchNorm2d(momentum=0.1) would keep
            y = port.conv(torch.from_numpy(x)).permute(0, 3, 1, 2)
            torch.nn.functional.batch_norm(y, torch_mean, torch_var, training=True,
                                           momentum=0.1)
    stats = v["batch_stats"]["bn"]
    np.testing.assert_allclose(_np(port.bn.running_mean), np.asarray(stats["mean"]), atol=OP_TOL)
    np.testing.assert_allclose(_np(port.bn.running_var), np.asarray(stats["var"]), rtol=OP_TOL)
    np.testing.assert_allclose(_np(torch_mean), np.asarray(stats["mean"]), atol=OP_TOL)
    assert np.abs(_np(torch_var) - np.asarray(stats["var"])).max() > 1e-3  # its unbiased var
    x = _rand(4, 8, 8, 16, seed=9)
    np.testing.assert_allclose(_np(port.eval()(torch.from_numpy(x), True)),
                               np.asarray(jmod.apply(v, x, True)), atol=ATOL)


# ------------------------------------------------------------- the model


def test_carry_over_is_strict():
    w = world()
    v = w["variables"]
    state = from_jax_params(v["params"], v["constants"], v["batch_stats"])
    model = get_model_entry("CCA").model_cls(w["cfg"], w["der"], w["ds"]["word_vector"])
    assert set(state) == set(model.state_dict())
    assert {"C_GCN.adj_all", "C_GCN.gc1_weight", "glove_vec", "unk_vec", "v_t_param",
            "sim_map.bn.running_mean", "sim_map.bn.weight", "sim_map.conv.weight",
            "sim_lstm.weight_ih_l1_reverse", "V_TransformerLayer.ln1_scale"} <= set(state)
    model.load_state_dict(state, strict=True)
    for key, value in w["model"].state_dict().items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0, atol=0)


SWITCHES = [("gather", "vjp"), ("gather", "eval"), ("gather", "always"), ("gather", "never"),
            ("scatter", "vjp")]


@pytest.mark.parametrize("map_impl,scores", SWITCHES)
def test_every_formulation_switch_matches_the_port(map_impl, scores, monkeypatch):
    """The JAX model's train-mode step (batch statistics; "eval" and "never"
    take the product form there) under each setting, dropout off in both
    packages: scores2d, the running statistics, the loss and the gradient of
    every parameter against the port's one form."""
    w = world()
    others = {"others.cca_map_impl": map_impl, "others.cca_contraction_scores": scores}
    jcfg, cfg = w["jcfg"].updated(others), w["cfg"].updated(others)
    monkeypatch.setattr(JC, "Dropout", lambda rate: JDropout(0.0))
    jentry, entry = jget_model_entry("CCA"), get_model_entry("CCA")
    jmodel = jentry.model_cls(jcfg, w["jder"], w["jds"]["word_vector"])
    v = w["variables"]
    consts = {k: t for k, t in v.items() if k != "params"}

    def loss_fn(params, b):
        out, mutated = jmodel.apply({"params": params, **consts}, b, False,
                                    mutable=["batch_stats"])
        return jentry.loss_fn(out, b, jcfg), (out["scores2d"], mutated)

    (jloss, (jscores, mutated)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], w["jb"])

    model = entry.model_cls(cfg, w["der"], w["ds"]["word_vector"])
    model.load_state_dict(w["model"].state_dict(), strict=True)
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    model.train()
    out = model(w["tb"])
    loss = entry.loss_fn(out, w["tb"], cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(_np(out["scores2d"]), np.asarray(jscores), atol=ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=ATOL)
    stats = mutated["batch_stats"]["sim_map"]["bn"]
    np.testing.assert_allclose(_np(model.sim_map.bn.running_mean), np.asarray(stats["mean"]),
                               atol=OP_TOL)
    np.testing.assert_allclose(_np(model.sim_map.bn.running_var), np.asarray(stats["var"]),
                               atol=OP_TOL)
    got = jax_variables(grads_as_state(model, grads), {"params": jgrads})["params"]
    assert_grads_close(got, jgrads, C.TRAIN_SHIFT_INVARIANT)


def test_unknown_switch_values_raise():
    w = world()
    for key in ("cca_map_impl", "cca_contraction_scores"):
        with pytest.raises(ValueError, match=key):
            C.CCA(w["cfg"].updated({f"others.{key}": "fast"}), w["der"], w["ds"]["word_vector"])


def test_shipped_config_has_the_published_parameter_count():
    """``configs/anet_cca.yaml`` builds the JAX CCA of 59,133,437
    parameters (``docs/BENCH_ZOO.json``), with the synthetic concept graph
    of 3152 nodes, and the port's model holds the same count."""
    jcfg, cfg = jload_config(FULL), load_config(FULL)
    ds = jmake_synthetic_data(jcfg, seed=0, n_train=1, n_test=1, n_videos=1)[0]
    der = JDerived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    m = jcfg.model
    batch = {"vfeats": jnp.zeros((1, m.vlen, m.vdim)), "vmasks": jnp.ones((1, m.vlen)),
             "words_ids": jnp.ones((1, m.tlen), jnp.int32), "tmasks": jnp.ones((1, m.tlen))}
    jmodel = jget_model_entry("CCA").model_cls(jcfg, der, ds["word_vector"])
    shapes = jax.eval_shape(lambda b: jmodel.init({"params": KEY, "dropout": KEY}, b, True),
                            batch)
    count = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert count == 59_133_437
    assert shapes["constants"]["C_GCN"]["adj_all"].shape == (3152, 3152)
    with torch.device("meta"):
        model = get_model_entry("CCA").model_cls(cfg, Derived(num_words=ds["n_words"]),
                                                 ds["word_vector"])
    assert sum(p.numel() for p in model.parameters()) == count
