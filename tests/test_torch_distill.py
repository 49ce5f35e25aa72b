"""The port's distillation family against the JAX package, on the CPU, at the
tiny test config (vlen 32, dim 32):

- ``lossfun_softloc`` against the JAX loss at 1e-5 on ragged masks (a
  padded sample's KL is 0 in both: its -1e30 squares to inf in the norm);
- ``calculate_adapt_cof`` at 1e-6, with tied maxima and a zero union;
- ``linear_resample_ac`` equal to the JAX function and to
  ``F.interpolate(align_corners=True)``;
- ``MultiTeacherBatcher`` and ``CCAPreTrainBatcher`` batches equal to the JAX
  batchers', from the synthetic fallback curves and from a written pickle,
  and their refusal of ``dataprocess.device_pipeline``;
- each of the five models: the JAX tree carried across strictly, and the
  deterministic forward and loss at 1e-4 (the JAX models applied op by op);
- the service answers for a model with a teacher and for the two batchers;
- ``BaseFast_BAN_PreTrain`` is registered as in the JAX package.
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
import torch.nn.functional as F

import vmrframe_tpu.models.distill as JD
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data import distill_batcher as JDB
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.losses import lossfun_softloc as jlossfun_softloc
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data import distill_batcher as DB
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.losses import lossfun_softloc
from vmrframe_tpu_torch.models import distill as D
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.weights import from_jax_params

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")
MODELS = ("OneTeacher", "OneTeacher_SoftLabel", "BaseFast_BAN_CoTrain", "MultiTeacher",
          "BaseFast_CCA_PreTrain")
# the models that share one parameter tree share the JAX init
TREE_OF = {"OneTeacher": "teacher_t0", "OneTeacher_SoftLabel": "teach_model",
           "BaseFast_BAN_CoTrain": "teach_model", "MultiTeacher": "student",
           "BaseFast_CCA_PreTrain": "student"}
ATOL = 1e-4


def distill_updates(base_model: dict, name: str, **extra) -> dict:
    """The JAX package's distillation test settings (``tests/test_distill.py``):
    temperature 3, the teacher's model section the base config's, three
    teachers at coefficient 1.0 and temperature 3 with no pickle."""
    updates = {"model.name": name, "loss.temperature": 3, "teacher0.model": dict(base_model)}
    for i in range(3):
        updates.update({f"loss.t{i}_path": "", f"loss.t{i}_cof": 1.0,
                        f"loss.t{i}_temperature": 3})
    updates.update(extra)
    return updates


def configs(name: str, **extra):
    """(JAX config, port config) for model ``name`` at the tiny width."""
    jbase, base = jload_config(CFG), load_config(CFG)
    return (jbase.updated(distill_updates(jbase.model.to_dict(), name, **extra)),
            base.updated(distill_updates(base.model.to_dict(), name, **extra)))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------------ losses


def _ragged_mask(rng, B, L):
    lens = rng.integers(1, L + 1, B)
    lens[:3] = L  # three samples without padding: their KL is not 0
    return (np.arange(L)[None] < lens[:, None]).astype(np.float32)


@pytest.mark.parametrize("temperature", [1.0, 3.0])
def test_softloc_matches_jax_on_ragged_masks(temperature):
    rng = np.random.default_rng(int(temperature))
    B, L = 8, 32
    vmask = _ragged_mask(rng, B, L)
    s, e = (rng.standard_normal((B, L)).astype(np.float32) * 3 for _ in range(2))
    st, et = (rng.random((B, L)).astype(np.float32) for _ in range(2))
    want = np.asarray(jlossfun_softloc(*map(jnp.asarray, (s, e, st, et, vmask)), temperature))
    got = lossfun_softloc(*map(_t, (s, e, st, et, vmask)), temperature)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert (want[:3] > 0).all() and (want[vmask.sum(1) < L] == 0).all()


@pytest.mark.parametrize("case", ["random", "ties", "zero_union"])
def test_adapt_cof_matches_jax(case):
    rng = np.random.default_rng(3)
    B, L = 6, 16
    t_lab = rng.random((B, 2, L)).astype(np.float32)
    gt = rng.random((B, 2, L)).astype(np.float32)
    if case == "ties":  # equal maxima: both take the first
        t_lab[:, :, 3] = t_lab[:, :, 9] = 2.0
        gt[:, 0, 1] = gt[:, 0, 12] = 2.0
    elif case == "zero_union":  # every argmax at one position
        t_lab[:, :, 5] = gt[:, :, 5] = 2.0
    want = np.asarray(JD.calculate_adapt_cof(jnp.asarray(t_lab), jnp.asarray(gt)))
    got = D.calculate_adapt_cof(_t(t_lab), _t(gt))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if case == "zero_union":
        assert (got == 0).all()


@pytest.mark.parametrize("T,size", [(17, 9), (9, 17), (12, 12), (12, 1), (2, 64)])
def test_linear_resample_matches_jax_and_interpolate(T, size):
    x = np.random.default_rng(T * size).standard_normal((2, T)).astype(np.float32)
    got = DB.linear_resample_ac(x, size)
    np.testing.assert_array_equal(got, JDB.linear_resample_ac(x, size))
    if size > 1:
        want = F.interpolate(_t(x)[None], size=size, mode="linear",
                             align_corners=True)[0].numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------- batchers


def _batcher_pair(cls_name, loadertype, pickle_path=None, n_train=20):
    extra = {"train.batch_size": 8}
    if pickle_path:
        extra.update({f"loss.t{i}_path": pickle_path for i in range(3)})
    jcfg, cfg = configs("MultiTeacher", **extra)
    jds, jstore = jmake_synthetic_data(jcfg, seed=2, n_train=n_train, n_test=8)
    ds, store = make_synthetic_data(cfg, seed=2, n_train=n_train, n_test=8)
    split = "train_set" if loadertype == "train" else "test_set"
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"])
    return (getattr(DB, cls_name)(ds[split], store, cfg, der, loadertype),
            getattr(JDB, cls_name)(jds[split], jstore, jcfg, jder, loadertype), ds)


def _write_pickle(path, records, seed=0):
    """A teacher pickle for ``records``: curves of 5-50 frames each."""
    rng = np.random.default_rng(seed)
    data = [[r["vid"], rng.random((2, int(rng.integers(5, 50)))).astype(np.float32)]
            for r in records]
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return str(path)


@pytest.mark.parametrize("source", ["fallback", "pickle"])
@pytest.mark.parametrize("cls_name,loadertype", [
    ("MultiTeacherBatcher", "train"), ("MultiTeacherBatcher", "test"),
    ("CCAPreTrainBatcher", "train"), ("CCAPreTrainBatcher", "test")])
def test_distill_batches_equal_jax(cls_name, loadertype, source, tmp_path):
    path = None
    if source == "pickle":
        _, _, ds = _batcher_pair(cls_name, loadertype)
        split = "train_set" if loadertype == "train" else "test_set"
        path = _write_pickle(tmp_path / "t.pkl", ds[split])
    ours, theirs, _ = _batcher_pair(cls_name, loadertype, path)
    got, want = list(ours.epoch(seed=5)), list(theirs.epoch(seed=5))
    assert len(got) == len(want) == len(ours)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    keys = set(got[0])
    if cls_name == "MultiTeacherBatcher":
        assert ({"label1d_t0s", "label1d_t1s", "label1d_t2s"} <= keys) == (loadertype == "train")
    else:
        assert got[0]["label1ds_t0"].shape == (8, 32, 2)


def test_misaligned_pickle_raises(tmp_path):
    _, _, ds = _batcher_pair("MultiTeacherBatcher", "train")
    path = _write_pickle(tmp_path / "t.pkl", ds["test_set"] + ds["train_set"])
    ours, _, _ = _batcher_pair("MultiTeacherBatcher", "train", path)
    with pytest.raises(ValueError, match="misaligned"):
        next(ours.epoch(seed=0))


def test_batchers_refuse_the_device_pipeline():
    jcfg, cfg = configs("MultiTeacher", **{"dataprocess.device_pipeline": True})
    ds, store = make_synthetic_data(cfg, seed=0, n_train=8, n_test=8)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    assert Batcher(ds["train_set"], store, cfg, der, "train").device_pipeline
    with pytest.raises(ValueError, match="device_pipeline"):
        DB.MultiTeacherBatcher(ds["train_set"], store, cfg, der, "train")
    for loadertype in ("train", "test"):
        with pytest.raises(ValueError, match="device_pipeline"):
            DB.CCAPreTrainBatcher(ds["train_set"], store, cfg, der, loadertype)
    # a test batcher ships no teacher curves: the raw batch goes through, as in JAX
    raw = DB.MultiTeacherBatcher(ds["test_set"], store, cfg, der, "test").make_batch([0, 1])
    assert "raw_vfeats" in raw
    # the JAX batchers fail at the first batch instead
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=8, n_test=8)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"])
    with pytest.raises(KeyError):
        JDB.MultiTeacherBatcher(jds["train_set"], jstore, jcfg, jder, "train").make_batch(
            [0, 1], __import__("random").Random(0))


# ------------------------------------------------------------------ models


@functools.lru_cache(maxsize=None)
def _jax_world(tree: str):
    """JAX variables of one tree, initialised once, and a test batch of each
    batcher."""
    name = next(n for n, t in TREE_OF.items() if t == tree)
    jcfg, _ = configs(name)
    ds, store = jmake_synthetic_data(jcfg, seed=0, n_train=4, n_test=4)
    jder = JDerived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=2,
                    steps_per_epoch=1)
    batch = next(JBatcher(ds["test_set"], store, jcfg, jder, "test").epoch(seed=0))
    batch = {k: jnp.asarray(v) for k, v in batch.items() if k != "num_valid"}
    rng = jax.random.PRNGKey(0)
    variables = jget_model_entry(name).model_cls(jcfg, jder, ds["word_vector"]).init(
        {"params": rng, "dropout": rng, "gumbel": rng}, batch, True)
    return dict(ds=ds, store=store, jder=jder, variables=variables)


def _port_model(name, w):
    _, cfg = configs(name)
    der = Derived(num_words=w["ds"]["n_words"], num_chars=w["ds"]["n_chars"])
    return get_model_entry(name).model_cls(cfg, der, w["ds"]["word_vector"]), cfg, der


@pytest.mark.parametrize("name", MODELS)
def test_carry_over_is_strict(name):
    w = _jax_world(TREE_OF[name])
    model, _, _ = _port_model(name, w)
    state = from_jax_params(w["variables"]["params"], w["variables"]["constants"])
    assert set(state) == set(model.state_dict())
    prefix = {"teacher_t0": "teacher_t0.", "teach_model": "teach_model."}.get(TREE_OF[name])
    if prefix:  # the teacher is a whole SeqPAN under its prefix
        assert f"{prefix}dual_attention_block_1.dense_1.weight" in state
        assert f"{prefix}text_encoder.word_emb.glove_vec" in state
    assert "vfeat_encoder.conv_block.pointwise_3.weight" in state  # the student's 4 layers
    assert "dual_attention_block_1.dense_1.weight" not in state  # and no dual attention
    model.load_state_dict(state, strict=True)


@pytest.mark.parametrize("name", MODELS)
def test_deterministic_forward_and_loss_match_jax(name):
    w = _jax_world(TREE_OF[name])
    jcfg, _ = configs(name)
    jentry = jget_model_entry(name)
    jbatcher = (jentry.batcher_cls or JBatcher)(w["ds"]["test_set"], w["store"], jcfg,
                                                w["jder"], "test")
    jbatch = next(jbatcher.epoch(seed=0))
    jbatch = {k: v for k, v in jbatch.items() if k != "num_valid"}
    jmodel = jentry.model_cls(jcfg, w["jder"], w["ds"]["word_vector"])
    want = jmodel.apply(w["variables"], {k: jnp.asarray(v) for k, v in jbatch.items()}, True)
    want_loss = jentry.loss_fn(want, jbatch, jcfg)

    model, cfg, _ = _port_model(name, w)
    model.load_state_dict(from_jax_params(w["variables"]["params"],
                                          w["variables"]["constants"]), strict=True)
    entry = get_model_entry(name)
    tb = {k: _t(v) for k, v in jbatch.items()}
    before = [fn.launches for fn in K.KERNELS]
    with torch.no_grad():
        got = model.eval()(tb)
        got_loss = entry.loss_fn(got, tb, cfg)
        props = entry.infer_fn(got, tb, cfg)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(props.numpy(), np.asarray(jentry.infer_fn(want, jbatch, jcfg)))
    assert [fn.launches for fn in K.KERNELS] == before  # the plain versions on the CPU


def test_ban_pretrain_is_not_registered():
    """Once unregistered (its BAN teacher was not ported); now registered
    as the JAX package registers it: the frozen-teacher filter and hook,
    the softloc loss, the student's batcher.  Its forward against JAX is
    in ``test_torch_ban_train.py``."""
    entry = get_model_entry("BaseFast_BAN_PreTrain")
    assert entry.frozen_filter is D.teacher_frozen and entry.init_hook is D.load_teacher_hook
    assert entry.loss_fn is D.softlabel_loss and entry.batcher_cls is None


@pytest.mark.parametrize("name", ["OneTeacher_SoftLabel", "MultiTeacher",
                                  "BaseFast_CCA_PreTrain"])
def test_service_answers(name):
    from vmrframe_tpu_torch.tools.serve import build_service

    _, cfg = configs(name, **{"train.batch_size": 4})
    service, dataset = build_service(cfg, device="cpu", n_synthetic=8)
    try:
        rec = dataset["test_set"][0]
        out = service.predict(rec["vid"], rec["sentence"], rec["duration"])
    finally:
        service.close()
    assert 0.0 <= out["pred_time"][0] <= out["pred_time"][1] <= rec["duration"] + 1e-6
