"""The port's CLI and service on dataset files, on the CPU, at the tiny test
width: ``python -m vmrframe_tpu_torch`` (``cli.main``) trains from the files
of ``testing.write_dataset_files`` without ``--synthetic`` and ``--eval``
reproduces the saved mIoU; ``--debug`` reads lazily; with
``dataprocess.device_pipeline`` it trains, and its evaluation equals the host
route's; the service built from the same files answers.  The files
themselves are held against the JAX package in ``test_torch_datasets.py``,
the trainer on synthetic data in ``test_torch_seqpan_train.py``.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import json
import os

import numpy as np
import pytest

from vmrframe_tpu_torch.cli import main
from vmrframe_tpu_torch.config import load_config
from vmrframe_tpu_torch.testing import write_dataset_files

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("files")
    cfg = load_config(CFG).updated({"model.word_dim": 300, "paths.ckpt_dir": str(root / "ckpt"),
                                    "train.epochs": 1})
    return write_dataset_files(str(root / "data"), cfg, n_videos=10, n_train=32, n_test=16,
                               seed=0, n_words=60, min_len=20, max_len=60)


def _variant(config, path, updates):
    with open(path, "w", encoding="utf8") as f:
        json.dump(load_config(config).updated(updates).to_dict(), f)
    return str(path)


def _cli(*args):
    return main(["--device", "cpu", *args])


def test_cli_trains_from_files_and_eval_reproduces_the_saved_miou(files):
    fit = _cli("--config", files, "--suffix", "host")
    assert fit["cache"] == "built" and not fit["lazy"]
    assert fit["steps"] == 2 and os.path.exists(fit["best_path"])
    assert np.isfinite(fit["history"][0]["train_loss"])
    ev = _cli("--config", files, "--suffix", "host", "--eval", "--checkpoint", fit["best_path"])
    assert ev["cache"] == "loaded"
    assert ev["miou"] == fit["best_miou"]


def test_debug_reads_the_features_lazily(files):
    ev = _cli("--config", files, "--suffix", "lazy", "--debug", "--eval")
    eager = _cli("--config", files, "--suffix", "lazy", "--eval")
    assert ev["lazy"] and not eager["lazy"]
    assert ev["miou"] == eager["miou"]


def test_device_pipeline_trains_and_evaluates_as_the_host_route(files, tmp_path):
    on = _variant(files, tmp_path / "pipeline.json",
                  {"dataprocess.device_pipeline": True,
                   "dataprocess.video_augmentation": {"erosion": 0.1}})
    fit = _cli("--config", on, "--suffix", "dp")
    assert fit["steps"] == 2 and np.isfinite(fit["history"][0]["train_loss"])
    host = _cli("--config", files, "--suffix", "dp", "--eval", "--checkpoint", fit["best_path"])
    dev = _cli("--config", on, "--suffix", "dp", "--eval", "--checkpoint", fit["best_path"])
    assert dev["miou"] == host["miou"] == fit["best_miou"]
    for key in ("r1i3", "r1i5", "r1i7"):
        assert dev[key] == host[key]


def test_the_service_built_from_the_files_answers(files):
    from vmrframe_tpu_torch.tools.serve import build_service

    cfg = load_config(files).updated({"train.compute_dtype": "float32"})
    service, dataset = build_service(cfg, batch_size=4, device="cpu", synthetic=False)
    try:
        assert service.store.lazy
        rec = dataset["test_set"][0]
        out = service.predict(rec["vid"], rec["sentence"], rec["duration"])
        assert len(out["pred_time"]) == 2
        assert 0.0 <= out["pred_frac"][0] <= out["pred_frac"][1] <= 1.0
        with pytest.raises(KeyError):
            service.predict("no-such-video", "a person", 3.0)
    finally:
        service.close()
