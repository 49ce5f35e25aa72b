"""The port's dataset preparation from files (``data/datasets.py``,
``data/glove.py``) against the JAX package's, on the same annotation JSON,
GloVe text and ``.npy`` features written by ``testing.write_dataset_files``:
records, ids, vocabularies and the embedding matrix equal, with and without
a GloVe file; the 50-d GloVe trap kept; the ``.pkl`` cache read back.
Numpy only: no JAX function is compiled here.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os

import numpy as np
import pytest

import vmrframe_tpu.data.datasets as JD
import vmrframe_tpu.data.glove as JG
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data import datasets as D
from vmrframe_tpu_torch.data import glove as G
from vmrframe_tpu_torch.testing import write_dataset_files

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")


def _files(tmp_path, **kw):
    cfg = load_config(CFG).updated({"model.word_dim": 300})
    return write_dataset_files(str(tmp_path / "data"), cfg, n_videos=10, n_train=40, n_test=16,
                               seed=3, n_words=80, min_len=20, max_len=90, **kw)


def _both(config, updates=None):
    """(port dataset, JAX dataset) from one config, each with its own cache."""
    updates = updates or {}
    cfg = load_config(config).updated(updates)
    jcfg = jload_config(config).updated(
        {**updates, "paths.cache_dir": cfg.paths.cache_dir.rstrip("/") + "_jax"})
    lens = D.scan_feature_lengths(cfg.paths.feature_path)
    return (D.load_dataset(cfg, Derived(suffix="t"), vfeat_lens=lens),
            JD.load_dataset(jcfg, JDerived(suffix="t"), vfeat_lens=lens))


def _assert_same(ours, theirs):
    assert set(ours) == set(theirs)
    for key in ours:
        if key == "word_vector":
            assert ours[key].dtype == theirs[key].dtype == np.float32
            np.testing.assert_array_equal(ours[key], theirs[key])
        else:
            assert ours[key] == theirs[key], key


def test_load_dataset_equals_jax(tmp_path):
    config = _files(tmp_path)
    ours, theirs = _both(config)
    _assert_same(ours, theirs)
    assert ours["n_train"] == 40 and ours["n_test"] == 16  # the missing videos dropped
    assert ours["word_vector"].shape == (ours["n_words"] - 2, 300)
    assert np.abs(ours["word_vector"]).sum(axis=1).min() > 0  # every GloVe word has its vector
    records = ours["train_set"] + ours["test_set"]
    # some caption words have no vector: they read as UNK
    assert any(w not in ours["word_dict"] for r in records for w in r["words"])
    assert any(ours["word_dict"][G.UNK] in r["wids"] for r in records)
    tlen = int(load_config(config).model.tlen)
    assert max(len(r["words"]) for r in records) > tlen >= max(len(r["wids"]) for r in records)
    assert any(r["se_time"][1] == r["duration"] for r in records)  # an etime clamped
    assert all(0.0 <= f <= 1.0 for r in records for f in r["se_frac"])


def test_without_a_glove_file_both_draw_the_same_fallback_vectors(tmp_path):
    config = _files(tmp_path)
    ours, theirs = _both(config, {"paths.glove_path": str(tmp_path / "absent.txt"),
                                  "model.word_dim": 24})
    _assert_same(ours, theirs)
    assert ours["word_vector"].shape == (ours["n_words"] - 2, 24)


def test_a_50d_glove_file_gives_both_an_empty_vocabulary(tmp_path):
    config = _files(tmp_path)
    words = [w for r in D.process_data(load_config(config).paths.train_path) for w in r["words"]]
    rng = np.random.default_rng(0)
    path = tmp_path / "glove50.txt"
    path.write_text("".join(w + " " + " ".join(f"{x:.4f}" for x in rng.standard_normal(50)) + "\n"
                            for w in sorted(set(words))))
    assert G.load_glove_vocab(str(path)) == JG.load_glove_vocab(str(path)) == set()
    ours, theirs = _both(config, {"paths.glove_path": str(path), "model.word_dim": 50})
    _assert_same(ours, theirs)
    assert ours["n_words"] == 2 and ours["word_vector"].shape == (0, 50)
    assert {w for r in ours["train_set"] for w in r["wids"]} == {1}  # every word is UNK


def test_glove_helpers_equal_jax(tmp_path):
    config = _files(tmp_path)
    glove = load_config(config).paths.glove_path
    vocab = G.load_glove_vocab(glove)
    assert vocab == JG.load_glove_vocab(glove) and len(vocab) == 74
    word_dict = {w: i for i, w in enumerate(sorted(vocab))}
    np.testing.assert_array_equal(G.filter_glove_embedding(word_dict, glove),
                                  JG.filter_glove_embedding(word_dict, glove))


def test_the_cache_round_trips_and_is_read_the_second_time(tmp_path, monkeypatch):
    cfg = load_config(_files(tmp_path))
    derived = Derived(suffix="v1")
    path = D.cache_path(cfg, derived)
    assert path == os.path.join(cfg.paths.cache_dir, "charades_v1.pkl")
    first = D.load_dataset(cfg, derived)  # no lengths given: the .npy headers are scanned
    assert os.path.exists(path)
    monkeypatch.setattr(D, "generate_dataset", lambda *a, **k: pytest.fail("rebuilt"))
    second = D.load_dataset(cfg, derived)
    _assert_same(second, first)
    # the JAX package reads the port's cache as its own
    jcfg = jload_config(os.path.join(str(tmp_path / "data"), "config.json"))
    _assert_same(JD.load_dataset(jcfg, JDerived(suffix="v1")), first)


def test_feature_lengths_come_from_the_headers(tmp_path):
    cfg = load_config(_files(tmp_path))
    lens = D.scan_feature_lengths(cfg.paths.feature_path)
    assert lens == JD.scan_feature_lengths(cfg.paths.feature_path)
    assert len(lens) == 10 and all(20 <= n <= 90 for n in lens.values())
    for vid, n in lens.items():
        assert np.load(os.path.join(cfg.paths.feature_path, f"{vid}.npy")).shape == (n, 64)


def test_a_record_outside_its_video_is_refused_as_in_jax():
    """stime past the duration: the JAX package asserts, the port raises
    (a check that ``python -O`` keeps)."""
    record = {"vid": "v0", "stime": 12.0, "etime": 13.0, "duration": 10.0, "sentence": "a b",
              "words": ["a", "b"]}
    dicts = ({"<PAD>": 0, "<UNK>": 1}, {"<PAD>": 0, "<UNK>": 1})
    with pytest.raises(AssertionError):
        JD.dataset_gen([record], {"v0": 20}, *dicts, 8, "train")
    with pytest.raises(ValueError, match="outside its video"):
        D.dataset_gen([record], {"v0": 20}, *dicts, 8, "train")
    assert D.dataset_gen([dict(record, stime=1.0)], {"v0": 20}, *dicts, 8, "train")[0][
        "se_time"] == [1.0, 10.0]  # etime clamped
