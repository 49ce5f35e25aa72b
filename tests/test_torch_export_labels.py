"""The port's teacher-curve export against the JAX tool, on the CPU, at the
tiny test config (vlen 32, dim 32):

- ``export_labels`` of a SeqPAN from one set of weights gives the JAX
  ``export_labels``' curves at 1e-5: the same vids in the same order, each
  curve cut to its clip's length, a partial last batch included;
- ``import_external_labels`` writes what the JAX function writes for
  EMAT-style tuples and GMD-style dicts (time-major arrays, lists of rows,
  the sigmoid overridden);
- the 2D branches of ``curves_from_outputs``: the row and column maxima of
  BAN's map and of CCA's (against the JAX tool's CCA branch);
- ``main`` with ``--device cpu`` exports from dataset files and a trainer
  checkpoint, and ``--import-external`` converts.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_distill import configs
from test_torch_seqpan_train import _jax_variables
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.tools import export_labels as JE
from vmrframe_tpu.train.trainer import Trainer as JTrainer
from vmrframe_tpu.train.trainer import TrainState
from vmrframe_tpu_torch.config import Derived
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.testing import make_synthetic_data, write_dataset_files
from vmrframe_tpu_torch.tools import export_labels as E
from vmrframe_tpu_torch.train.checkpoints import save_checkpoint
from vmrframe_tpu_torch.train.trainer import Trainer

N_TRAIN, BATCH = 20, 8  # three batches, the last with 4 records


def _read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_export_matches_the_jax_tool(tmp_path):
    jcfg, cfg = configs("SeqPAN", **{"train.batch_size": BATCH})
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=N_TRAIN, n_test=4)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=N_TRAIN, n_test=4)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=1)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=1)
    trainer = Trainer(cfg, der, ds["word_vector"], device="cpu")
    got = E.export_labels(cfg, der, ds, store, trainer, str(tmp_path / "ours.pkl"))

    jtrainer = JTrainer(jcfg, jder, jds["word_vector"])
    batch = next(Batcher(ds["train_set"], store, cfg, der, "test").epoch(seed=0))
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "num_valid"}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: jtrainer.model.init(
        {"params": key, "dropout": key, "gumbel": key}, b, True), jb)
    variables = _jax_variables(trainer.model, shapes)
    state = TrainState(variables["params"], {"constants": variables["constants"]}, None, 0, {})
    # the tool applies the model op by op: the same forward, jitted
    jtrainer.model = types.SimpleNamespace(apply=jax.jit(jtrainer.model.apply, static_argnums=2))
    want = JE.export_labels(jcfg, jder, jds, jstore, state, jtrainer, str(tmp_path / "jax.pkl"))

    assert len(got) == len(want) == N_TRAIN
    assert _read(tmp_path / "ours.pkl")[5][0] == got[5][0]
    for (vid, curve), (jvid, jcurve), record in zip(got, want, ds["train_set"]):
        assert vid == jvid == record["vid"]
        assert curve.dtype == np.float32 and curve.shape == jcurve.shape
        assert curve.shape[0] == 2 and 0 < curve.shape[1] <= cfg.model.vlen
        np.testing.assert_allclose(curve, jcurve, atol=1e-5)
    assert len({c.shape[1] for _, c in got}) > 1  # the clips' lengths differ


def _external_entries():
    rng = np.random.default_rng(0)
    emat = [(f"v{i}", rng.standard_normal((2, 12)).astype(np.float32), 12) for i in range(3)]
    emat.append(("v3", rng.standard_normal((9, 2)).astype(np.float32), 9))  # time-major
    gmd = [{"vid": f"g{i}", "vlen": 10, "prop_logits": rng.random((2, 10))} for i in range(2)]
    gmd.append({"vid": "g2", "vlen": 7, "prop_logits": [rng.random(7), rng.random(7)]})
    return {"emat": emat, "gmd": gmd}


@pytest.mark.parametrize("sigmoid", [None, True, False], ids=["auto", "yes", "no"])
@pytest.mark.parametrize("style", ["emat", "gmd"])
def test_import_external_labels_matches_jax(style, sigmoid, tmp_path):
    src = tmp_path / f"{style}.pkl"
    with open(src, "wb") as f:
        pickle.dump(_external_entries()[style], f)
    got = E.import_external_labels(str(src), str(tmp_path / "ours.pkl"), apply_sigmoid=sigmoid)
    want = JE.import_external_labels(str(src), str(tmp_path / "jax.pkl"), apply_sigmoid=sigmoid)
    assert len(got) == len(want) == 3 + (style == "emat")
    for (vid, arr), (jvid, jarr) in zip(got, want):
        assert vid == jvid and arr.dtype == jarr.dtype == np.float32
        np.testing.assert_array_equal(arr, jarr)
    assert _read(tmp_path / "ours.pkl")[0][0] == got[0][0]


@pytest.mark.parametrize("key,model", [("tmap", "models/ban.py"), ("scores2d", "models/cca.py")])
def test_2d_branches_name_the_missing_model(key, model):
    """Both 2D models are ported (``model`` names the module): BAN's branch
    gives the row and column maxima of sigmoid(tmap) * its map2d_mask,
    CCA's those of sigmoid(scores2d) * mask2d(NUM_CLIPS), equal to the JAX
    tool's CCA branch (their normalization and the whole exports against
    JAX are in ``test_torch_ban_train.py`` and ``test_torch_cca_train.py``)."""
    from types import SimpleNamespace

    tmap = torch.linspace(-2.0, 2.0, 2 * 8 * 8).reshape(2, 8, 8)
    if key == "tmap":
        mask = torch.ones(8, 8, dtype=torch.bool).triu()
        got = E.curves_from_outputs("BAN", {key: tmap, "map2d_mask": mask})
        smap = torch.sigmoid(tmap) * mask
        np.testing.assert_array_equal(got, torch.stack([smap.amax(2), smap.amax(1)], 1).numpy())
    else:
        got = E.curves_from_outputs("CCA", {key: tmap})
        cfg = SimpleNamespace(MODEL=SimpleNamespace(CCA=SimpleNamespace(NUM_CLIPS=8)))
        want = JE.curves_from_outputs("CCA", {key: jnp.asarray(tmap.numpy())}, None, cfg)
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert got.shape == (2, 2, 8) and got.dtype == np.float32
    with pytest.raises(ValueError):
        E.curves_from_outputs("X", {"logits": torch.zeros(2, 4)})


def test_main_exports_from_files_on_cpu(tmp_path, capsys):
    _, cfg = configs("SeqPAN", **{"model.word_dim": 300, "train.batch_size": BATCH,
                                  "paths.ckpt_dir": str(tmp_path / "ckpt")})
    config = write_dataset_files(str(tmp_path / "data"), cfg, n_videos=8, n_train=N_TRAIN,
                                 n_test=8, seed=0, n_words=40, min_len=20, max_len=60)
    from vmrframe_tpu_torch.cli import load_data
    from vmrframe_tpu_torch.config import load_config

    fcfg = load_config(config)
    der = Derived(seed=3)
    dataset, store, info = load_data(fcfg, der, synthetic=False, seed=3)
    assert info["cache"] == "built"
    trainer = Trainer(fcfg, der, dataset["word_vector"], device="cpu")
    trainer.init_state(5)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), trainer, name="best_SeqPAN")
    out = str(tmp_path / "curves.pkl")
    got = E.main(["--config", config, "--checkpoint", ckpt, "--out", out, "--device", "cpu"])
    assert f"wrote {N_TRAIN} teacher curves" in capsys.readouterr().out
    want = E.export_labels(fcfg, der, dataset, store, trainer, str(tmp_path / "direct.pkl"))
    assert [v for v, _ in _read(out)] == [r["vid"] for r in dataset["train_set"]]
    for (vid, curve), (wvid, wcurve) in zip(got, want):
        assert vid == wvid
        np.testing.assert_array_equal(curve, wcurve)
        assert ((curve > 0) & (curve < 1)).all()
    test = E.main(["--config", config, "--checkpoint", ckpt, "--out", out, "--device", "cpu",
                   "--split", "test_set"])
    assert [v for v, _ in test] == [r["vid"] for r in dataset["test_set"]]
    src = tmp_path / "emat.pkl"
    with open(src, "wb") as f:
        pickle.dump(_external_entries()["emat"], f)
    imported = E.main(["--import-external", str(src), "--out", out, "--sigmoid", "no"])
    np.testing.assert_array_equal(imported[0][1], _external_entries()["emat"][0][1])
