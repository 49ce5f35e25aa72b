"""The port's feature stores on files against the JAX package's: ``.npy``
directories (eager and lazy), one ``.h5`` file (eager, lazy, channel-first)
and ``open_feature_store``'s dispatch give the same arrays and lengths; the
lazy ``.npy`` store reads only the headers for ``lengths()``; the
ActionFormer batcher assembles the same batches from either store.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os

import numpy as np
import pytest

from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data import features as JF
from vmrframe_tpu.data.af_batcher import ActionFormerBatcher as JAFBatcher
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data import features as F
from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher

LONG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                    "tacos_actionformer_long.yaml")


@pytest.fixture()
def arrays():
    rng = np.random.default_rng(7)
    return {f"vid{i}": rng.standard_normal((int(rng.integers(8, 40)), 16)).astype(np.float32)
            for i in range(5)}


@pytest.fixture()
def npy_dir(tmp_path, arrays):
    root = tmp_path / "npy"
    root.mkdir()
    for vid, arr in arrays.items():
        np.save(root / f"{vid}.npy", arr)
    return str(root)


def _h5(tmp_path, arrays, transpose=False):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / ("cfirst.h5" if transpose else "feats.h5"))
    with h5py.File(path, "w") as f:
        for vid, arr in arrays.items():
            f.create_dataset(vid, data=arr.T if transpose else arr)
    return path


def _assert_same_store(ours, theirs, arrays):
    assert ours.lengths() == theirs.lengths() == {v: a.shape[0] for v, a in arrays.items()}
    for vid, arr in arrays.items():
        assert vid in ours and vid in theirs
        assert ours[vid].dtype == np.float32
        np.testing.assert_array_equal(ours[vid], theirs[vid])
        np.testing.assert_array_equal(ours[vid], arr)
    assert "missing" not in ours


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_npy_store_equals_jax(npy_dir, arrays, lazy):
    _assert_same_store(F.VideoFeatureStore(npy_dir, 64, lazy=lazy),
                       JF.VideoFeatureStore(npy_dir, 64, lazy=lazy), arrays)


def test_lazy_npy_lengths_read_only_the_headers(npy_dir, arrays, monkeypatch):
    store = F.VideoFeatureStore(npy_dir, 64, lazy=True)
    monkeypatch.setattr(np, "load", lambda *a, **k: pytest.fail("a whole file was read"))
    assert store.lengths() == {v: a.shape[0] for v, a in arrays.items()}


@pytest.mark.parametrize("lazy,transpose", [(False, False), (True, False), (False, True),
                                            (True, True)],
                         ids=["eager", "lazy", "eager_channel_first", "lazy_channel_first"])
def test_h5_store_equals_jax(tmp_path, arrays, lazy, transpose):
    path = _h5(tmp_path, arrays, transpose)
    _assert_same_store(F.H5FeatureStore(path, lazy=lazy, transpose=transpose),
                       JF.H5FeatureStore(path, lazy=lazy, transpose=transpose), arrays)


def test_open_feature_store_dispatches_as_jax(tmp_path, npy_dir, arrays):
    path = _h5(tmp_path, arrays)
    for target, kind, jkind in ((npy_dir, F.VideoFeatureStore, JF.VideoFeatureStore),
                                (path, F.H5FeatureStore, JF.H5FeatureStore)):
        for lazy in (False, True):
            ours, theirs = F.open_feature_store(target, 64, lazy), JF.open_feature_store(target, 64, lazy)
            assert isinstance(ours, kind) and isinstance(theirs, jkind) and ours.lazy == lazy
            _assert_same_store(ours, theirs, arrays)


@pytest.mark.parametrize("kind", ["npy", "h5"])
def test_actionformer_batches_from_file_stores_equal_jax(tmp_path, kind):
    tiny = {"train.batch_size": 4, "model.vdim": 24, "actionformer.input_dim": 24,
            "actionformer.max_seq_len": 128}
    rng = np.random.default_rng(1)
    arrays = {f"v{i}": rng.standard_normal((int(rng.integers(40, 300)), 24)).astype(np.float32)
              for i in range(6)}
    if kind == "npy":
        root = tmp_path / "feats"
        root.mkdir()
        for vid, arr in arrays.items():
            np.save(root / f"{vid}.npy", arr)
        target = str(root)
    else:
        target = _h5(tmp_path, arrays)
    records = []
    for i in range(6):
        vid = f"v{(i * 5) % 6}"
        dur = arrays[vid].shape[0] / 3.0
        records.append({"vid": vid, "se_time": [0.1 * dur, 0.6 * dur], "duration": dur,
                        "se_frac": [0.1, 0.6], "sentence": "a b", "words": ["a", "b"],
                        "wids": [2, 3], "cids": [[2], [3]]})
    cfg, jcfg = load_config(LONG).updated(tiny), jload_config(LONG).updated(tiny)
    ours = ActionFormerBatcher(records, F.open_feature_store(target, 128, lazy=True), cfg,
                               Derived(num_words=4, num_chars=4))
    theirs = JAFBatcher(records, JF.open_feature_store(target, 128, lazy=True), jcfg,
                        JDerived(num_words=4, num_chars=4), "test")
    got, want = list(ours.epoch(seed=0)), list(theirs.epoch(seed=0))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
