"""BAN in the port against the JAX package, on the CPU, at two small sizes:
the tiny BAN test config (vlen 16, pooling [4, 2, 2], dims 16-32) and the
shipped long config's structure (vlen 128, pooling [15, 8, 8, 8], topk 16)
cut to tiny widths, as the JAX package's own tests cut it:

- the JAX tree carried across under a strict ``load_state_dict`` (the LSTM
  leaves renamed, the rest by the usual rules);
- each 2D label function exactly, and ``BANBatcher``'s batch key for key;
- ``proposal_selection``'s indices equal to the JAX function's, on random
  and on tied scores;
- the deterministic forward on both routes (compact cells and the dense
  map) at 1e-4, the selected proposals equal, ``ban_infer``'s spans equal,
  and the port's two routes against each other;
- (``ban_loss`` and the gradients are in ``test_torch_ban_grads.py``, a
  file of their own so that xdist's ``--dist loadfile`` can run them on
  another worker);
- the service answering BAN requests.

The JAX weights come from the port's seeded init through the carry-over
rule run backwards (``jax_variables``), which spares compiling the JAX init.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import vmrframe_tpu.models.ban as JB
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data import labels as JLab
from vmrframe_tpu.data.ban_batcher import BANBatcher as JBANBatcher
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data import labels as Lab
from vmrframe_tpu_torch.data.ban_batcher import BANBatcher
from vmrframe_tpu_torch.models import ban as B
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.weights import _leaf, from_jax_params, init_weights

HERE = os.path.dirname(__file__)
TINY = os.path.join(HERE, "configs", "charades_ban.json")
LONG = os.path.join(HERE, "..", "configs", "tacos_ban_long.yaml")
# the long config's structure at tiny widths (the JAX package's own cut)
LONG_CUT = {"model.dim": 16, "model.vdim": 24, "model.fuse_dim": 32, "model.contrast_dim": 16,
            "model.query_embed_dim": 50, "model.word_dim": 50, "model.char_dim": 16,
            "model.tlen": 8, "train.batch_size": 2, "gcn.hidden_size": 32}
CONFIGS = {"tiny": (TINY, {}), "long": (LONG, LONG_CUT)}
ATOL = 1e-4


def jax_variables(model, shapes):
    """The JAX variables of tree ``shapes`` holding the port ``model``'s
    weights: ``weights.from_jax_params``'s rule run backwards."""
    state = model.state_dict()
    out = {}
    for collection, tree in shapes.items():
        flat = {}
        for path, leaf in traverse_util.flatten_dict(tree, sep="/").items():
            name, _ = _leaf(path, np.zeros(leaf.shape, np.float32))
            value = state[name].numpy()
            if path.rsplit("/", 1)[-1] == "kernel":
                value = value.T if value.ndim == 2 else value.transpose(2, 1, 0)
            assert value.shape == leaf.shape, path
            flat[path] = jnp.asarray(value)
        out[collection] = traverse_util.unflatten_dict(flat, sep="/")
    return out


@functools.lru_cache(maxsize=None)
def world(name: str, compact: bool = True, split: str = "test_set"):
    path, cut = CONFIGS[name]
    updates = {**cut, "model.compact_map": compact}
    jcfg, cfg = jload_config(path).updated(updates), load_config(path).updated(updates)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=4, n_test=4)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=4, n_test=4)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=2,
                    steps_per_epoch=1)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=2,
                  steps_per_epoch=1)
    jbatch = next(JBANBatcher(jds[split], jstore, jcfg, jder, "test").epoch(seed=0))
    batch = next(BANBatcher(ds[split], store, cfg, der, "test").epoch(seed=0))
    model = get_model_entry("BAN").model_cls(cfg, der, ds["word_vector"])
    init_weights(model, seed=3)
    jmodel = jget_model_entry("BAN").model_cls(jcfg, jder, jds["word_vector"])
    jb = {k: jnp.asarray(v) for k, v in jbatch.items() if k != "num_valid"}
    shapes = jax.eval_shape(lambda b: jmodel.init({"params": jax.random.PRNGKey(0),
                                                   "dropout": jax.random.PRNGKey(0)}, b, True), jb)
    variables = jax_variables(model, shapes)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items() if k != "num_valid"}
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, jbatch=jbatch, batch=batch, jb=jb, tb=tb,
                model=model.eval(), jmodel=jmodel, variables=variables, jder=jder, der=der)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


# ------------------------------------------------------------------ weights


@pytest.mark.parametrize("name", ["tiny", "long"])
def test_carry_over_is_strict(name):
    w = world(name)
    v = w["variables"]
    state = from_jax_params(v["params"], v.get("constants", {}))
    model = get_model_entry("BAN").model_cls(w["cfg"], w["der"], w["ds"]["word_vector"])
    assert set(state) == set(model.state_dict())
    assert {"visual_encoder.biLSTM.weight_ih_l0", "boundary_aware.feature_transform_b."
            "bias_hh_l1_reverse", "query_encoder.glove_vec", "query_encoder.unk_vec",
            "cqa_att.bias", "map2d_proj_kernel", "prop_interact_1.fc.weight"} <= set(state)
    model.load_state_dict(state, strict=True)
    for key, value in w["model"].state_dict().items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0, atol=0)


# ------------------------------------------------------------------- labels


@pytest.mark.parametrize("fn", ["iou_1d", "iou2d_label", "iou2d_label_no_plus_one", "mask2d",
                                "map2d_contrast", "se_offset_label"])
def test_label_functions_equal_jax(fn):
    rng = np.random.default_rng(len(fn))
    for _ in range(5):
        L = int(rng.integers(4, 40))
        duration = float(rng.uniform(5, 60))
        s = float(rng.uniform(0, duration * 0.7))
        e = float(rng.uniform(s + 0.1, duration))
        sidx, eidx = sorted(int(i) for i in rng.integers(0, L, 2))
        if fn == "iou_1d":
            cand = np.sort(rng.uniform(0, duration, (20, 2)), axis=1)
            args = (cand, [s, e])
        elif fn.startswith("iou2d_label"):
            args = (s, e, duration, L, fn == "iou2d_label")
        elif fn == "mask2d":
            args = (L, [int(c) for c in rng.integers(1, 6, 3)])
        elif fn == "map2d_contrast":
            args = (sidx, eidx, L)
        else:
            args = (s, e, duration, L)
        name = "iou2d_label" if fn.startswith("iou2d") else fn
        got, want = getattr(Lab, name)(*args), getattr(JLab, name)(*args)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert (Lab.mask2d(16) == JLab.mask2d(16)).all()  # the default recipe


@pytest.mark.parametrize("name", ["tiny", "long"])
def test_batch_equals_jax(name):
    w = world(name)
    assert set(w["batch"]) == set(w["jbatch"])
    for key, want in w["jbatch"].items():
        got = w["batch"][key]
        assert np.asarray(got).dtype == np.asarray(want).dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_train_batches_equal_jax():
    """A shuffled epoch with the train stream: the same batches."""
    w = world("tiny")
    jtrain = JBANBatcher(w["jds"]["train_set"], None, w["jcfg"], w["jder"], "train")
    train = BANBatcher(w["ds"]["train_set"], None, w["cfg"], w["der"], "train")
    _, jstore = jmake_synthetic_data(w["jcfg"], seed=0, n_train=4, n_test=4)
    _, store = make_synthetic_data(w["cfg"], seed=0, n_train=4, n_test=4)
    jtrain.features, train.features = jstore, store
    for got, want in zip(train.epoch(seed=5), jtrain.epoch(seed=5)):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --------------------------------------------------------- proposal selection


@pytest.mark.parametrize("case", ["random", "ties", "long"])
def test_proposal_selection_indices_equal_jax(case):
    rng = np.random.default_rng(len(case))
    L, pooling, topk, neighbor, negative = 16, (4, 2, 2), 4, 2, 0
    if case == "long":
        L, pooling, topk, neighbor, negative = 128, (15, 8, 8, 8), 16, 4, 3
    _, _, ii, jj = B._mask_meta(pooling, L)
    moments = np.stack([ii, jj + 1], axis=1).astype(np.float32)
    K = len(ii)
    scores = rng.random((6, K)).astype(np.float32)
    if case == "ties":  # many equal scores: the stable sorts decide
        scores = np.round(scores * 4) / 4
    want = np.stack([np.asarray(JB.proposal_selection(jnp.asarray(s), jnp.asarray(moments),
                                                      topk, neighbor, negative, 0.7))
                     for s in scores])
    got = B.proposal_selection(torch.from_numpy(scores), torch.from_numpy(moments), topk,
                               neighbor, negative, 0.7)
    assert got.shape == want.shape == (6, topk * (neighbor + 1) + negative)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ forward


def _jax_forward(w):
    """The JAX forward op by op.  At random init the map's scores spread
    over ~0.004 with exact f32 ties among the ~1500 cells of the long
    config, so that JAX's jitted forward, whose fusions round differently,
    selects other proposals than its own op-by-op forward; the port's scores
    match the op-by-op ones to 6e-8 and select what they select."""
    return w["jmodel"].apply(w["variables"], w["jb"], True)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("name", ["tiny", "long"])
def test_forward_matches_jax(name, compact):
    w = world(name, compact)
    want = _jax_forward(w)
    with torch.no_grad():
        got = w["model"](w["tb"])
    assert set(got) == set(want)
    for key in want:
        g, j = _np(got[key]), np.asarray(want[key])
        assert g.shape == j.shape, key
        if key in ("coarse_pred", "map2d_mask", "vlens"):
            np.testing.assert_array_equal(g, j, err_msg=key)
        else:
            np.testing.assert_allclose(g, j, atol=ATOL, err_msg=key)
    entry, jentry = get_model_entry("BAN"), jget_model_entry("BAN")
    np.testing.assert_array_equal(_np(entry.infer_fn(got, w["tb"], w["cfg"])),
                                  np.asarray(jentry.infer_fn(want, w["jb"], w["jcfg"])))


@pytest.mark.parametrize("name", ["tiny", "long"])
def test_compact_and_dense_routes_agree(name):
    """One set of weights through both routes of the port: every shared
    output at 2e-5, the sentinel's contrast row filling the dense map's
    invalid cells."""
    wc, wd = world(name, True), world(name, False)
    dense = get_model_entry("BAN").model_cls(wd["cfg"], wd["der"], wd["ds"]["word_vector"])
    dense.load_state_dict(wc["model"].state_dict(), strict=True)
    with torch.no_grad():
        oc, od = wc["model"](wc["tb"]), dense.eval()(wc["tb"])
    for key in ("tmap", "final_pred", "offset", "pred_score", "coarse_pred", "td", "sen_proj"):
        np.testing.assert_allclose(_np(oc[key]), _np(od[key]), atol=2e-5, err_msg=key)
    _, _, ii, jj = B._mask_meta(wc["model"].pooling, wc["cfg"].model.vlen)
    view = oc["map2d_proj_inv"][:, None, None, :].expand_as(od["map2d_proj"]).clone()
    view[:, ii, jj] = oc["map2d_proj_cells"]
    np.testing.assert_allclose(_np(view), _np(od["map2d_proj"]), atol=2e-5)


# ------------------------------------------------------------------ serving


def test_service_answers():
    from vmrframe_tpu_torch.tools.serve import MomentRetrievalService

    w = world("tiny")
    ds, cfg = w["ds"], w["cfg"].updated({"train.compute_dtype": "float32"})
    _, store = make_synthetic_data(cfg, seed=0, n_train=4, n_test=4)
    service = MomentRetrievalService(cfg, w["der"], ds["word_dict"], ds["char_dict"],
                                     ds["word_vector"], store, batch_size=4, device="cpu")
    try:
        vid = ds["test_set"][0]["vid"]
        out = service.predict(vid, "person opens the door", duration=30.0)
    finally:
        service.close()
    start, end = out["pred_time"]
    assert 0.0 <= start and 0.0 <= end <= 30.0 * 16 and np.isfinite([start, end]).all()
