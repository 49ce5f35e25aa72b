"""The port's batcher routes against the JAX ``Batcher``, on the CPU:

- the ``num_workers`` thread pool: each sample's augmentation draws from
  ``random.Random(seed)`` for a seed drawn from the epoch's stream, so with
  4 workers and ``erosion`` or ``dilation`` a whole epoch's train batches
  equal the JAX package's for the same epoch seed, run after run;
- the device pipeline's raw batch (``dataprocess.device_pipeline``) equals
  the JAX ``_make_raw_batch``, and the JAX gate (one augmentation, no
  ``original``) decides the route in both.
Numpy only: no JAX function is compiled here.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os

import numpy as np
import pytest

from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.testing import make_synthetic_data

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")


def _pair(updates, loadertype="train", n_train=40):
    cfg, jcfg = load_config(CFG).updated(updates), jload_config(CFG).updated(updates)
    ds, store = make_synthetic_data(cfg, seed=1, n_train=n_train, n_test=8)
    jds, jstore = jmake_synthetic_data(jcfg, seed=1, n_train=n_train, n_test=8)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"])
    return (Batcher(ds["train_set"], store, cfg, der, loadertype),
            JBatcher(jds["train_set"], jstore, jcfg, jder, loadertype))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("aug", [{"erosion": 0.05}, {"dilation": 0.05},
                                 {"unchanged": None, "dilation": 0.1, "erosion": 0.1}],
                         ids=["erosion", "dilation", "mixed"])
def test_worker_pool_batches_equal_jax(aug):
    ours, theirs = _pair({"dataprocess.video_augmentation": aug, "train.num_workers": 4})
    assert ours.num_workers == theirs.num_workers == 4
    got = list(ours.epoch(seed=3))
    _assert_batches_equal(got, list(theirs.epoch(seed=3)))
    _assert_batches_equal(list(ours.epoch(seed=3)), got)  # the threads' timing does not show
    serial = list(Batcher(ours.dataset, ours.features, ours.cfg, Derived(), "train",
                          num_workers=0).epoch(seed=3))  # draws from the epoch's stream itself
    assert any(not np.array_equal(a["vfeats"], b["vfeats"]) for a, b in zip(got, serial))


def test_workers_default_to_none_and_one_runs_serially():
    ours, theirs = _pair({})
    assert ours.num_workers == theirs.num_workers == 0
    one, jone = _pair({"train.num_workers": 1, "dataprocess.video_augmentation": {"erosion": 0.1}})
    assert one.num_workers == jone.num_workers == 1
    serial, _ = _pair({"dataprocess.video_augmentation": {"erosion": 0.1}})
    # one worker draws from the epoch's stream itself, as no worker does
    _assert_batches_equal(list(one.epoch(seed=2)), list(serial.epoch(seed=2)))
    _assert_batches_equal(list(one.epoch(seed=2)), list(jone.epoch(seed=2)))


@pytest.mark.parametrize("loadertype", ["train", "test"])
def test_device_pipeline_raw_batch_equals_jax(loadertype):
    ours, theirs = _pair({"dataprocess.device_pipeline": True,
                          "dataprocess.video_augmentation": {"erosion": 0.05}}, loadertype,
                         n_train=20)
    assert ours.device_pipeline and theirs.device_pipeline
    assert ours._max_raw_len == theirs._max_raw_len == max(
        ours.features.lengths()[r["vid"]] for r in ours.dataset)
    got, want = list(ours.epoch(seed=5)), list(theirs.epoch(seed=5))
    assert "raw_vfeats" in got[0] and got[-1]["num_valid"] == 4  # the last batch is partial
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("updates", [
    {"dataprocess.video_augmentation": {"unchanged": None, "erosion": 0.05}},
    {"dataprocess.sample_type": "original"}], ids=["two_augmentations", "original"])
def test_the_jax_gate_keeps_such_configs_on_the_host(updates):
    ours, theirs = _pair({"dataprocess.device_pipeline": True, **updates})
    assert not ours.device_pipeline and not theirs.device_pipeline
    assert ours._max_raw_len == theirs._max_raw_len == 0
