"""The port's converter of reference checkpoints, its compatibility names,
its dataset scripts and the legacy VSL layers, against the JAX package:

- ``tools/convert_torch.py``: one synthetic reference-layout SeqPAN
  ``state_dict`` (the JAX tree under the reference's names, built as
  ``tests/test_convert_roundtrip.py`` builds it, plus dead tensors) through
  both converters: the same leaves, the dead ones dropped, and the JAX
  forward against the port's at 1e-4;
- ``compat.py``: every public name of the JAX module resolves, and
  ``iou_n1`` and ``score2d_to_moments_scores`` agree;
- ``tools/clean_data.py`` (all three modes) and ``tools/similar_sentence.py``
  write the same JSON;
- ``layers/legacy_vsl.py``: forwards and ``compute_loss`` at 1e-4.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_convert_roundtrip import _to_torch_names
from vmrframe_tpu import compat as jcompat
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.registry import get_model_entry as jentry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.tools import convert_torch as jconvert
from vmrframe_tpu_torch import compat
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.tools import convert_torch

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")
ATOL = 1e-4
DEAD = ("dual_attention_block_1.dual_multihead_attention.bilinear_1.dense_2.conv1d.weight",
        "dual_attention_block_1.dual_multihead_attention.layer_norm1.weight",
        "dual_attention_block_2.dual_multihead_attention.out_layer.conv1d.weight")


@pytest.fixture(scope="module")
def reference():
    """The JAX SeqPAN's variables, a test batch, and the reference-layout
    state_dict of those variables with three dead tensors."""
    cfg = jload_config(CFG)
    ds, store = jmake_synthetic_data(cfg, seed=0, n_train=8, n_test=8)
    derived = JDerived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    model = jentry("SeqPAN").model_cls(cfg=cfg, derived=derived, word_vectors=ds["word_vector"])
    batch = next(JBatcher(ds["test_set"], store, cfg, derived, "test").epoch(seed=0))
    batch = {k: v for k, v in batch.items() if k != "num_valid"}
    rng = jax.random.PRNGKey(0)
    variables = jax.device_get(jax.jit(lambda b: model.init(
        {"params": rng, "dropout": rng, "gumbel": rng}, b, True))(batch))
    flat_p = jconvert.flatten_tree(jax.tree_util.tree_map(np.asarray, variables["params"]))
    flat_c = jconvert.flatten_tree(jax.tree_util.tree_map(np.asarray, variables["constants"]))
    sd = _to_torch_names(flat_p, flat_c)
    r = np.random.default_rng(0)
    for key in DEAD:
        sd[key] = r.standard_normal((32, 32, 1) if key.endswith("conv1d.weight") else (32,),
                                    ).astype(np.float32)
    return dict(cfg=cfg, ds=ds, model=model, batch=batch, variables=variables, sd=sd)


def test_converters_agree_leaf_for_leaf(reference):
    sd = reference["sd"]
    want = jconvert.convert_seqpan_family(sd)
    got = convert_torch.convert_seqpan_family({k: torch.tensor(v) for k, v in sd.items()})
    for tree in ("params", "constants"):
        a, b = convert_torch.flatten_tree(got[tree]), jconvert.flatten_tree(want[tree])
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    flat = convert_torch.flatten_tree(got["params"])
    dead = ("bilinear_1/dense_2", "dual_multihead_attention/layer_norm1",
            "dual_multihead_attention/out_layer")
    assert not any(d in k for k in flat for d in dead)
    assert convert_torch.compare_trees(got["params"], reference["variables"]["params"]) \
        == ([], [], [])


def test_converted_forward_matches_jax(reference):
    cfg = load_config(CFG)
    ds = reference["ds"]
    model = get_model_entry("SeqPAN").model_cls(cfg, Derived(num_words=ds["n_words"],
                                                             num_chars=ds["n_chars"]),
                                                ds["word_vector"]).eval()
    convert_torch.load_reference(model, {k: torch.tensor(v) for k, v in reference["sd"].items()})
    batch = reference["batch"]
    want = jax.jit(lambda b: reference["model"].apply(reference["variables"], b, True))(batch)
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for key in ("slogits", "elogits", "match_score"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)


def test_reference_layout_round_trips(tmp_path):
    """The port's inverse of the conversion, and the CLI that writes a
    checkpoint the port reads, on every SeqPAN-family model."""
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.weights import init_weights, read_checkpoint

    for name in ("SeqPAN", "BackBone", "BaseFast"):
        cfg = load_config(CFG).updated({"model.name": name})
        ds, _ = make_synthetic_data(cfg, seed=0, n_train=8, n_test=4)
        model = init_weights(get_model_entry(name).model_cls(
            cfg, Derived(num_words=ds["n_words"], num_chars=ds["n_chars"]),
            ds["word_vector"]), 0)
        ref = convert_torch.reference_layout(model)
        assert any(".dense_2." in k for k in ref) == (name != "BaseFast")
        src, out = tmp_path / f"{name}.pkl", tmp_path / f"{name}.pt"
        config = tmp_path / f"{name}.yaml"
        config.write_text(open(CFG).read().replace('name: "SeqPAN"', f'name: "{name}"'))
        torch.save(ref, src)
        convert_torch.main(["--config", str(config), "--checkpoint", str(src), "--out", str(out)])
        state = read_checkpoint(str(out))
        for k, v in model.state_dict().items():
            assert torch.equal(state[k], v), k


def test_compat_names_and_helpers():
    public = [n for n in dir(jcompat) if not n.startswith("_") and n not in ("annotations", "np")]
    missing = [n for n in public if not hasattr(compat, n)]
    assert missing == []
    cands = np.array([[0.0, 2.0], [1.0, 3.5], [4.0, 5.0], [2.5, 2.5]])
    np.testing.assert_allclose(compat.iou_n1(cands, [1.0, 3.0]), jcompat.iou_n1(cands, [1.0, 3.0]))
    score = np.zeros((6, 6), np.float32)
    score[0, 2], score[1, 4], score[3, 3] = 0.5, 0.25, 0.75
    for a, b in zip(compat.score2d_to_moments_scores(score, 6, 12.5),
                    jcompat.score2d_to_moments_scores(score, 6, 12.5)):
        np.testing.assert_array_equal(a, b)
    assert compat.calculate_iou([1, 3], [2, 5]) == jcompat.calculate_iou([1, 3], [2, 5])
    assert compat.time_idx([3.3, 7.1], 10.0, 64) == jcompat.time_idx([3.3, 7.1], 10.0, 64)
    assert compat.idx_time([5, 40], 10.0, 64) == jcompat.idx_time([5, 40], 10.0, 64)
    for a, b in zip(compat.gene_soft_label(3, 9, 20, 32, 0.25),
                    jcompat.gene_soft_label(3, 9, 20, 32, 0.25)):
        np.testing.assert_allclose(a, b)
    lens = np.array([0, 3, 5])
    np.testing.assert_array_equal(compat.convert_length_to_mask(torch.tensor(lens), 5).numpy(),
                                  np.asarray(jcompat.convert_length_to_mask(jnp.asarray(lens), 5)))
    loss_fn, infer_fn = compat.build_train_engine("SeqPAN")
    assert loss_fn is get_model_entry("SeqPAN").loss_fn
    assert infer_fn is get_model_entry("SeqPAN").infer_fn


def _records(n=12):
    words = ["person opens the door", "a person opens the door", "someone sits on a chair",
             "person sits on the chair", "the man drinks water", "person opens the door"]
    r = np.random.default_rng(0)
    out = []
    for i in range(n):
        dur = float(r.uniform(10, 40))
        s = float(r.uniform(0, dur / 2))
        e = float(r.uniform(s, dur))
        out.append([f"vid{i % 4}", dur, [s, e], words[i % len(words)]])
    return out


def _run_both(tmp_path, tool, args):
    import importlib

    paths = {}
    for pkg in ("vmrframe_tpu", "vmrframe_tpu_torch"):
        out = tmp_path / pkg
        importlib.import_module(f"{pkg}.tools.{tool}").main(
            [a.replace("OUT", str(out)) for a in args])
        paths[pkg] = out
    return paths


@pytest.mark.parametrize("mode", ["clean", "round"])
def test_clean_data_writes_what_jax_writes(tmp_path, mode):
    src = tmp_path / "in.json"
    src.write_text(json.dumps(_records()))
    paths = _run_both(tmp_path, "clean_data", ["--mode", mode, "--in", str(src), "--out", "OUT"])
    assert paths["vmrframe_tpu"].read_text() == paths["vmrframe_tpu_torch"].read_text()


def test_prepare_ban_writes_what_jax_writes(tmp_path):
    src = tmp_path / "gt"
    src.mkdir()
    for split in ("train", "test"):
        (src / f"{split}.json").write_text(json.dumps(_records(8 if split == "test" else 12)))
    paths = _run_both(tmp_path, "clean_data", ["--mode", "prepare-ban", "--in", str(src),
                                               "--out", "OUT"])
    for split in ("train", "test"):
        assert (paths["vmrframe_tpu"] / f"{split}.json").read_text() \
            == (paths["vmrframe_tpu_torch"] / f"{split}.json").read_text()


def test_similar_sentence_writes_what_jax_writes(tmp_path, monkeypatch):
    """On the hashed encoder in both packages (the JAX one's SBERT never
    loads in the tests)."""
    import vmrframe_tpu.tools.similar_sentence as jsim
    from vmrframe_tpu.data.sentence_encoder import HashedBoWEncoder

    monkeypatch.setattr(jsim, "get_sentence_encoder", lambda dim=768: HashedBoWEncoder(dim))
    src = tmp_path / "train.json"
    src.write_text(json.dumps(_records()))
    paths = _run_both(tmp_path, "similar_sentence", ["--train", str(src), "--out", "OUT",
                                                     "--thresh", "0.9"])
    got = paths["vmrframe_tpu_torch"].read_text()
    assert got == paths["vmrframe_tpu"].read_text()
    assert len(json.loads(got)) > 12  # the repeated sentences found each other


# ------------------------------------------------------------ legacy VSL


def _legacy(jmod, tmod, *args, method=None):
    from vmrframe_tpu_torch.weights import load_jax_params

    variables = jmod.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
    load_jax_params(tmod, variables["params"], {})
    want = jmod.apply(variables, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = tmod.eval()(*(torch.from_numpy(np.asarray(a)) for a in args))
    return want, got


def _inputs(B=3, T=11, D=16):
    r = np.random.default_rng(0)
    x = r.standard_normal((B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([T, 7, 1])[:, None]).astype(np.float32)
    return x, mask


def test_highlight_layer_and_loss():
    from vmrframe_tpu.layers import legacy_vsl as J
    from vmrframe_tpu_torch.layers import legacy_vsl as P

    x, mask = _inputs()
    want, got = _legacy(J.HighLightLayer(), P.HighLightLayer(16), x, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    labels = (np.random.default_rng(1).random(mask.shape) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(P.HighLightLayer.compute_loss(got, torch.from_numpy(labels), torch.from_numpy(mask))),
        float(J.HighLightLayer.compute_loss(want, jnp.asarray(labels), jnp.asarray(mask))),
        atol=ATOL)


def test_dynamic_rnn():
    from vmrframe_tpu.layers import legacy_vsl as J
    from vmrframe_tpu_torch.layers import legacy_vsl as P

    x, mask = _inputs()
    want, got = _legacy(J.DynamicRNN(12), P.DynamicRNN(16, 12), x, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("predictor", ["rnn", "encoder"])
def test_conditioned_predictor(predictor):
    from vmrframe_tpu.layers import legacy_vsl as J
    from vmrframe_tpu_torch.layers import legacy_vsl as P

    x, mask = _inputs()
    want, got = _legacy(J.ConditionedPredictor(16, 11, predictor=predictor),
                        P.ConditionedPredictor(16, 11, predictor=predictor), x, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
