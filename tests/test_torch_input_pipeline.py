"""The port's on-device input pipeline (``ops/input_pipeline.py``) against
the JAX package's, on the CPU.

- ``unchanged`` with ``truncation``, ``samelen`` and ``original`` sampling
  draw nothing: the port's ``device_augment_resample`` equals the JAX
  function at 1e-6 on raw batches whose lengths fall on both sides of
  ``vlen``, and equals the host batcher's batch;
- the pure helpers (segment weights, boundary heatmaps, O/B/I/E labels)
  equal their JAX counterparts on the same (head, cur_len, sidx, eidx);
- ``erosion`` and ``dilation`` are held to the JAX tests' semantics
  (``tests/test_input_pipeline.py``): the gt span survives in every sample,
  padded frames come from the negative pool, noise only where that pool is
  empty, static shapes, reproducible from the seed.  Their random bits are
  not compared: the JAX draws come from a PRNG torch does not reproduce.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmrframe_tpu.ops.input_pipeline as JP
from vmrframe_tpu_torch.config import Config, Derived
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.ops import input_pipeline as P
from vmrframe_tpu_torch.testing import make_synthetic_data

VLEN, VDIM = 32, 8


def _raw(seed, B=8, lo=6, hi=70):
    """A padded raw batch with lengths on both sides of VLEN, gt spans from
    a single frame to the whole clip."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=B).astype(np.int32)
    lens[:3] = [lo, VLEN, hi]
    raw = np.zeros((B, int(lens.max()), VDIM), np.float32)
    for b, n in enumerate(lens):
        raw[b, :n] = rng.standard_normal((n, VDIM))
    s = rng.uniform(0.0, 0.8, size=B)
    fracs = np.stack([s, np.minimum(1.0, s + rng.uniform(0.0, 0.5, size=B))], 1)
    fracs[3] = [0.0, 1.0]
    fracs[4] = [0.5, 0.5]
    return raw, lens, fracs.astype(np.float32)


def _ours(raw, lens, fracs, seed, **kw):
    out = P.device_augment_resample(torch.from_numpy(raw), torch.from_numpy(lens),
                                    torch.from_numpy(fracs), seed, vlen=VLEN, **kw)
    return {k: v.numpy() for k, v in out.items()}


def _theirs(raw, lens, fracs, seed, **kw):
    out = JP.device_augment_resample(jnp.asarray(raw), jnp.asarray(lens), jnp.asarray(fracs),
                                     seed, vlen=VLEN, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("sample_type", ["truncation", "samelen", "original"])
@pytest.mark.parametrize("seed", [0, 1])
def test_deterministic_pipeline_equals_jax(sample_type, seed):
    raw, lens, fracs = _raw(seed)
    ours = _ours(raw, lens, fracs, 5, sample_type=sample_type)
    theirs = _theirs(raw, lens, fracs, 5, sample_type=sample_type)
    assert set(ours) == set(theirs)
    np.testing.assert_allclose(ours["vfeats"], theirs["vfeats"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours["vmasks"], theirs["vmasks"])
    np.testing.assert_allclose(ours["label1ds"], theirs["label1ds"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours["NER_labels"], theirs["NER_labels"])
    assert ours["NER_labels"].dtype == np.int32 and ours["vfeats"].dtype == np.float32


def _cfg(sample_type):
    return Config({
        "task": "charades", "paths": {"ckpt_dir": "ckpt/"},
        "train": {"epochs": 1, "batch_size": 16},
        "dataprocess": {"video_augmentation": {"unchanged": None}, "sample_type": sample_type,
                        "label_threshold": 0.01, "device_pipeline": True},
        "model": {"name": "SeqPAN", "vlen": VLEN, "tlen": 12, "vdim": VDIM, "dim": 16,
                  "num_heads": 4, "word_dim": 50, "char_dim": 16, "droprate": 0.1},
    })


@pytest.mark.parametrize("sample_type", ["truncation", "samelen"])
def test_device_batch_equals_the_host_batch(sample_type):
    cfg = _cfg(sample_type)
    dataset, store = make_synthetic_data(cfg, seed=2, n_train=16, n_test=4)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    host = Batcher(dataset["train_set"], store, cfg.updated({"dataprocess.device_pipeline": False}),
                   derived, "train").make_batch(list(range(16)), random.Random(0))
    dev_batcher = Batcher(dataset["train_set"], store, cfg, derived, "train")
    assert dev_batcher.device_pipeline
    raw = dev_batcher.make_batch(list(range(16)), random.Random(0))
    out = P.apply_device_pipeline({k: torch.as_tensor(v) if k != "pipeline_seed" else int(v)
                                   for k, v in raw.items() if k != "num_valid"}, cfg, True)
    assert not set(P.RAW_KEYS) & set(out)
    for key in host:
        if key == "num_valid":
            continue
        got, want = out[key].numpy(), host[key]
        assert got.shape == want.shape and got.dtype == want.dtype, key
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-6, err_msg=key)


def test_segment_weights_equal_jax():
    cases = [(0, 6, True), (0, 32, False), (0, 70, True), (3, 40, True), (5, 20, False),
             (0, 1, True), (2, 33, True)]
    head, cur, res = (np.array(c) for c in zip(*cases))
    ours = P._segment_weights(torch.as_tensor(head), torch.as_tensor(cur), VLEN, 80,
                              torch.as_tensor(res)).numpy()
    theirs = np.asarray(jax.vmap(lambda h, c, r: JP._segment_weights(h, c, VLEN, 80, r))(
        jnp.asarray(head, jnp.int32), jnp.asarray(cur, jnp.int32), jnp.asarray(res)))
    np.testing.assert_array_equal(ours, theirs)


def test_dist_idx_and_ner_label_equal_jax():
    rng = np.random.default_rng(4)
    sidx = rng.integers(0, VLEN, size=40)
    eidx = np.minimum(VLEN - 1, sidx + rng.integers(0, 12, size=40))
    cur = np.maximum(eidx + 1, rng.integers(1, VLEN + 1, size=40))
    sidx[:3], eidx[:3], cur[:3] = [0, 5, 31], [0, 5, 31], [1, 6, 32]
    s, e, c = (torch.as_tensor(x) for x in (sidx, eidx, cur))
    js, je, jc = (jnp.asarray(x, jnp.int32) for x in (sidx, eidx, cur))
    np.testing.assert_allclose(P._dist_idx(s, e, VLEN).numpy(),
                               np.asarray(jax.vmap(lambda a, b: JP._dist_idx(a, b, VLEN))(js, je)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        P._ner_label(s, e, c, VLEN).numpy(),
        np.asarray(jax.vmap(lambda a, b, n: JP._ner_label(a, b, n, VLEN))(js, je, jc)))


def _gt_kept(out, B):
    assert out["vfeats"].shape == (B, VLEN, VDIM) and np.isfinite(out["vfeats"]).all()
    # both boundary heatmaps peak at 1: a non-empty gt span in every sample
    np.testing.assert_array_equal(out["label1ds"].max(axis=-1), np.ones((B, 2), np.float32))
    assert all((n == 1).any() or (n == 3).any() for n in out["NER_labels"])


@pytest.mark.parametrize("mode,p", [("erosion", 0.05), ("erosion", 0.4), ("dilation", 0.05),
                                    ("dilation", 0.3)])
def test_augmentations_keep_the_gt_span_and_static_shapes(mode, p):
    raw, lens, fracs = _raw(6, B=16)
    out = _ours(raw, lens, fracs, 7, aug_mode=mode, erosion_p=p)
    _gt_kept(out, 16)
    again = _ours(raw, lens, fracs, 7, aug_mode=mode, erosion_p=p)
    for key in out:
        np.testing.assert_array_equal(out[key], again[key])
    other = _ours(raw, lens, fracs, 8, aug_mode=mode, erosion_p=p)
    assert not np.array_equal(out["vfeats"], other["vfeats"])  # the seed draws


def test_erosion_crops_inside_the_clip_around_the_gt():
    """Without resampling the eroded clip is a contiguous slice of the raw
    clip that holds every gt frame."""
    raw, lens, fracs = _raw(9, B=16, lo=8, hi=VLEN)
    out = _ours(raw, lens, fracs, 11, aug_mode="erosion", erosion_p=0.4)
    cropped = 0
    for b in range(16):
        n = int(out["vmasks"][b].sum())
        T = int(lens[b])
        s, e = (int(round(f * (T - 1))) for f in fracs[b])
        starts = [h for h in range(T - n + 1) if np.array_equal(out["vfeats"][b, :n], raw[b, h:h + n])]
        assert len(starts) == 1, b
        assert starts[0] <= s and starts[0] + n - 1 >= e
        cropped += n < T
    assert cropped > 0


def test_dilation_pads_with_negative_frames():
    """Without resampling, every frame of the dilated clip is a raw frame;
    the gt frames appear once each, in order, and the pads are negative
    frames; p = 0 is the unchanged clip."""
    T, vdim = 20, VDIM
    rng = np.random.default_rng(0)
    raw = rng.standard_normal((4, T, vdim)).astype(np.float32)
    lens = np.full(4, T, np.int32)
    fracs = np.tile(np.float32([[0.25, 0.6]]), (4, 1))
    s, e = round(0.25 * (T - 1)), round(0.6 * (T - 1))
    out = _ours(raw, lens, fracs, 123, aug_mode="dilation", erosion_p=0.3)
    grew = 0
    for b in range(4):
        n = int(out["vmasks"][b].sum())
        rows = [np.flatnonzero((raw[b] == out["vfeats"][b, i]).all(1)) for i in range(n)]
        assert all(len(r) == 1 for r in rows), "a frame that is no raw frame"
        src = [int(r[0]) for r in rows]
        gt = [i for i in src if s <= i <= e]
        assert gt == list(range(s, e + 1))
        body = [i for i in range(n - T + 1) if src[i:i + T] == list(range(T))]
        assert len(body) == 1
        body = body[0]
        pads = src[:body] + src[body + T:]
        assert all(not s <= i <= e for i in pads)
        grew += len(pads) > 0
    assert grew > 0
    none = _ours(raw, lens, fracs, 123, aug_mode="dilation", erosion_p=0.0)
    base = _ours(raw, lens, fracs, 123, aug_mode="unchanged")
    for key in base:
        np.testing.assert_array_equal(none[key], base[key])


def test_dilation_draws_noise_only_where_the_pool_is_empty():
    """A clip whose gt covers every frame has no negative frame: its pads are
    uniform noise in [0, 1); a clip with negatives gets none."""
    T = 20
    rng = np.random.default_rng(1)
    raw = (rng.standard_normal((2, T, VDIM)) + 5.0).astype(np.float32)  # no raw value in [0, 1)
    lens = np.full(2, T, np.int32)
    fracs = np.float32([[0.0, 1.0], [0.3, 0.6]])
    out = _ours(raw, lens, fracs, 3, aug_mode="dilation", erosion_p=0.3, sample_type="original")
    for b in range(2):
        n = int(out["vmasks"][b].sum())
        noise = ((out["vfeats"][b, :n] >= 0) & (out["vfeats"][b, :n] < 1)).all(1)
        assert n > T
        assert noise.sum() == (n - T if b == 0 else 0)
