"""The port's sentence variants against the JAX package, on the CPU, at the
tiny test config (vlen 32, dim 32) with ``sentence_dim`` 32 in both packages:

- ``HashedBoWEncoder`` bit-equal to the JAX one, and the JAX factory's
  fallback to it when SBERT cannot load (no download is tried);
- the plain versions of #1/#2 against the Pallas kernels in interpret mode
  at head dim 192 (BackBoneAlignFeature's at D = 768) and at one key
  (BackBoneBertSentence's text side), #3 at one query and at one context
  row, at 1e-5;
- ``SentenceBatcher`` and ``BertSentenceBatcher`` batches equal to the JAX
  batchers' in train and test mode, and their refusal of the device
  pipeline;
- BackBoneBertSentence and BackBoneAlignFeature: the JAX tree carried
  strictly, the deterministic forward, loss and spans at 1e-4 (the JAX
  models applied op by op), 2/4/2 calls of #1/#2/#3 a forward;
- the service answering for both on the CPU.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmrframe_tpu.data.sentence_encoder as JSE
import vmrframe_tpu.models.sentence_variants as JSV
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.kernels.attention import (fused_cq_attention, fused_dual_attention,
                                            fused_masked_attention)
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.sentence_encoder import HashedBoWEncoder, get_sentence_encoder
from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.models import sentence_variants as SV
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.weights import from_jax_params

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")
MODELS = ("BackBoneBertSentence", "BackBoneAlignFeature")
SENTENCE_DIM = 32  # the tiny config's dim: AlignFeature's L1 needs dim == sentence_dim
ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x))


@contextlib.contextmanager
def sentence_dim(n: int = SENTENCE_DIM):
    """Both packages' sentence batchers at width ``n``, and the JAX factory
    kept from SBERT: it would try a download first."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HF_HUB_OFFLINE", "1")
        mp.setattr(JSE, "SBertEncoder", _no_sbert)
        for cls in (JSV.SentenceBatcher, JSV.BertSentenceBatcher, SV.SentenceBatcher,
                    SV.BertSentenceBatcher):
            mp.setattr(cls, "sentence_dim", n)
        yield


def _no_sbert(*args, **kwargs):
    raise OSError("SBERT weights are not in this repository")


# ----------------------------------------------------------------- encoder


@pytest.mark.parametrize("dim", [32, 768])
def test_hashed_encoder_is_bit_equal_to_jax(dim):
    sentences = ["a person opens the door", "A person  OPENS the door ", "", "   ",
                 "the person closes the window then sits on a chair"]
    ours, theirs = HashedBoWEncoder(dim), JSE.HashedBoWEncoder(dim)
    for s in sentences + sentences:  # the second pass reads the cache
        got, want = ours.encode(s), theirs.encode(s)
        assert got.dtype == want.dtype == np.float32 and got.shape == (dim,)
        np.testing.assert_array_equal(got, want)
    assert ours.encode(sentences[0]) is ours.encode(sentences[0])
    np.testing.assert_array_equal(ours.encode(""), ours.encode("<empty>"))
    assert isinstance(get_sentence_encoder(dim), HashedBoWEncoder)
    assert get_sentence_encoder(dim).dim == dim


def test_jax_factory_falls_back_to_the_hashed_encoder_without_sbert(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(JSE, "SBertEncoder", _no_sbert)
    enc = JSE.get_sentence_encoder(24)
    assert isinstance(enc, JSE.HashedBoWEncoder) and enc.dim == 24
    np.testing.assert_array_equal(enc.encode("a cup"), get_sentence_encoder(24).encode("a cup"))


# ----------------------------------------------------------------- kernels


def _mask(rng, *shape):
    """Random {0,1} mask over the last axis, a few rows and the first sample
    wholly masked."""
    m = (rng.random(shape) > 0.3).astype(np.float32)
    m[rng.random(shape[:-1]) < 0.2] = 0.0
    m[0] = 0.0
    return m


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("Lq,Lk,hd", [(5, 7, 192), (7, 1, 192), (1, 7, 32), (6, 1, 32)],
                         ids=["hd192", "hd192_one_key", "one_query", "one_key"])
def test_masked_attention_plain_matches_pallas(Lq, Lk, hd):
    rng = np.random.default_rng(Lq * Lk + hd)
    B, H = 3, 2
    q, k, v = _normal(rng, B, H, Lq, hd), _normal(rng, B, H, Lk, hd), _normal(rng, B, H, Lk, hd)
    mask = _mask(rng, B, Lq, Lk)
    want = fused_masked_attention(*(jnp.asarray(a) for a in (q, k, v, mask)), interpret=True)
    got = K.masked_attention_plain(*(_t(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("L,M,hd", [(6, 4, 192), (6, 1, 32), (1, 6, 32), (5, 1, 192)],
                         ids=["hd192", "cross_one_key", "self_one_key", "hd192_one_key"])
def test_dual_attention_plain_matches_pallas(L, M, hd):
    rng = np.random.default_rng(L * M + hd)
    B, H = 3, 2
    q, fk, fv = (_normal(rng, B, H, L, hd) for _ in range(3))
    tk, tv = _normal(rng, B, H, M, hd), _normal(rng, B, H, M, hd)
    s_mask, x_mask = _mask(rng, B, L, L), _mask(rng, B, L, M)
    args = (q, fk, fv, tk, tv, s_mask, x_mask)
    want = fused_dual_attention(*(jnp.asarray(a) for a in args), interpret=True)
    got = K.dual_attention_plain(*(_t(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("Lc,Lq", [(6, 1), (1, 6)], ids=["one_query", "one_context_row"])
def test_cq_attention_plain_matches_pallas_at_one_position(Lc, Lq):
    rng = np.random.default_rng(Lc + 10 * Lq)
    B, D = 3, 768
    c, q = _normal(rng, B, Lc, D), _normal(rng, B, Lq, D)
    w4C, w4Q, w4mlu = (_normal(rng, *s) * 0.05 for s in ((D, 1), (D, 1), (1, 1, D)))
    c_mask = (rng.random((B, Lc)) > 0.3).astype(np.float32)
    q_mask = (rng.random((B, Lq)) > 0.3).astype(np.float32)
    c_mask[:, 0], q_mask[:, 0] = 1.0, 1.0
    c_mask[0], q_mask[1] = 0.0, 0.0  # wholly masked column and row softmaxes
    args = (c, q, w4C, w4Q, w4mlu, c_mask, q_mask)
    want = fused_cq_attention(*(jnp.asarray(a) for a in args), interpret=True)
    got = K.cq_attention_plain(*(_t(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


# ---------------------------------------------------------------- batchers


def _batchers(name, loadertype, **updates):
    jcfg = jload_config(CFG).updated({"model.name": name, "train.batch_size": 8, **updates})
    cfg = load_config(CFG).updated({"model.name": name, "train.batch_size": 8, **updates})
    jds, jstore = jmake_synthetic_data(jcfg, seed=3, n_train=20, n_test=12)
    ds, store = make_synthetic_data(cfg, seed=3, n_train=20, n_test=12)
    split = "train_set" if loadertype == "train" else "test_set"
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"])
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    ours = get_model_entry(name).batcher_cls(ds[split], store, cfg, der, loadertype)
    theirs = jget_model_entry(name).batcher_cls(jds[split], jstore, jcfg, jder, loadertype)
    return ours, theirs


@pytest.mark.parametrize("loadertype", ["train", "test"])
@pytest.mark.parametrize("name", MODELS)
def test_sentence_batches_equal_jax(name, loadertype):
    with sentence_dim():
        ours, theirs = _batchers(name, loadertype)
        assert isinstance(theirs.encoder, JSE.HashedBoWEncoder)
        got, want = list(ours.epoch(seed=5)), list(theirs.epoch(seed=5))
    assert len(got) == len(want) == len(ours)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    batch = got[-1]  # partial: its padded slots carry zero vectors
    assert batch["sentence_embeddings"].shape == (8, SENTENCE_DIM)
    assert ("tmasks_sentence" in batch) == (name == "BackBoneBertSentence")
    np.testing.assert_array_equal(batch["inner_masks"], batch["NER_labels"] == 2)
    assert not batch["sentence_embeddings"][int(batch["num_valid"]):].any()


def test_sentence_batchers_refuse_the_device_pipeline():
    with sentence_dim():
        for name in MODELS:
            with pytest.raises(ValueError, match="device_pipeline"):
                _batchers(name, "train", **{"dataprocess.device_pipeline": True})
        # the JAX batcher fails at its first batch instead: no NER labels
        _, theirs = _batchers("BackBoneBertSentence", "test", **{"train.batch_size": 8})
        theirs.device_pipeline = True
        theirs._max_raw_len = 64
        with pytest.raises(KeyError, match="NER_labels"):
            theirs.make_batch([0, 1], __import__("random").Random(0))


# ------------------------------------------------------------------ models


@functools.lru_cache(maxsize=None)
def _world(name):
    """JAX variables of ``name`` at the tiny width and a test batch of each
    package's batcher (equal, as the test above holds)."""
    with sentence_dim():
        jcfg = jload_config(CFG).updated({"model.name": name, "train.batch_size": 8})
        cfg = load_config(CFG).updated({"model.name": name, "train.batch_size": 8})
        jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=4, n_test=8)
        ds, store = make_synthetic_data(cfg, seed=0, n_train=4, n_test=8)
        jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"], num_train_steps=2,
                        steps_per_epoch=1)
        der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
        jentry = jget_model_entry(name)
        jbatch = jentry.batcher_cls(jds["test_set"], jstore, jcfg, jder, "test").make_batch(
            list(range(6)), __import__("random").Random(0))
        batch = get_model_entry(name).batcher_cls(ds["test_set"], store, cfg, der,
                                                  "test").make_batch(list(range(6)))
        jbatch = {k: jnp.asarray(v) for k, v in jbatch.items() if k != "num_valid"}
        rng = jax.random.PRNGKey(0)
        jmodel = jentry.model_cls(jcfg, jder, jds["word_vector"])
        variables = jax.device_get(jmodel.init({"params": rng, "dropout": rng, "gumbel": rng},
                                               jbatch, True))
        want = jmodel.apply(variables, jbatch, True)
        want_loss = jentry.loss_fn(want, jbatch, jcfg)
        want_props = jentry.infer_fn(want, jbatch, jcfg)
    return dict(cfg=cfg, der=der, ds=ds, batch=batch, variables=variables, want=want,
                want_loss=float(want_loss), want_props=np.asarray(want_props))


def _state(w):
    return from_jax_params(w["variables"]["params"], w["variables"].get("constants", {}))


def _port_model(name, w):
    with sentence_dim():
        model = get_model_entry(name).model_cls(w["cfg"], w["der"], w["ds"]["word_vector"])
    return model


@pytest.mark.parametrize("name,has,lacks", [
    ("BackBoneBertSentence", "text_affine.video_conv1d.weight", "text_encoder.word_emb.glove_vec"),
    ("BackBoneAlignFeature", "text_encoder.word_emb.glove_vec", "match_conv1d.weight")])
def test_carry_over_is_strict(name, has, lacks):
    w = _world(name)
    model = _port_model(name, w)
    state = _state(w)
    assert set(state) == set(model.state_dict())
    assert has in state and lacks not in state
    assert "tfeat_encoder.conv_block.pointwise_3.weight" in state  # 4 layers of its own
    if name == "BackBoneBertSentence":  # sentence_dim -> dim
        assert tuple(state["text_affine.video_conv1d.weight"].shape) == (32, SENTENCE_DIM)
    model.load_state_dict(state, strict=True)
    with pytest.raises(RuntimeError, match="Missing"):
        model.load_state_dict({k: v for k, v in state.items() if k != has}, strict=True)


@pytest.mark.parametrize("name", MODELS)
def test_deterministic_forward_loss_and_spans_match_jax(name, monkeypatch):
    w = _world(name)
    model = _port_model(name, w)
    model.load_state_dict(_state(w), strict=True)
    entry = get_model_entry(name)
    tb = {k: _t(v) for k, v in w["batch"].items() if k != "num_valid"}
    calls = {"masked": 0, "dual": 0, "cq": 0}
    for key, fn in (("masked", "fused_masked_attention"), ("dual", "fused_dual_attention"),
                    ("cq", "fused_cq_attention")):
        real = getattr(K, fn)
        monkeypatch.setattr(K, fn, lambda *a, _k=key, _f=real: calls.__setitem__(
            _k, calls[_k] + 1) or _f(*a))
    before = [fn.launches for fn in K.KERNELS]
    with torch.no_grad():
        got = model.eval()(tb)
        loss = entry.loss_fn(got, tb, w["cfg"])
        props = entry.infer_fn(got, tb, w["cfg"])
    assert set(got) == set(w["want"])
    for key, want in w["want"].items():
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss), w["want_loss"], atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(props.numpy(), w["want_props"])
    # #1 twice (the predictor), #2 four times, #3 twice; nothing launches on the CPU
    assert calls == {"masked": 2, "dual": 4, "cq": 2}
    assert [fn.launches for fn in K.KERNELS] == before
    if name == "BackBoneAlignFeature":  # the alignment term is in the loss
        assert w["want_loss"] > float(entry.loss_fn({**got, "vfeatalg": tb["sentence_embeddings"]},
                                                     tb, w["cfg"]))


@pytest.mark.parametrize("name", MODELS)
def test_service_answers(name):
    from vmrframe_tpu_torch.tools.serve import build_service

    cfg = load_config(CFG).updated({"model.name": name, "train.batch_size": 4})
    with sentence_dim():
        service, dataset = build_service(cfg, device="cpu", n_synthetic=8)
        try:
            rec = dataset["test_set"][0]
            out = service.predict(rec["vid"], rec["sentence"], rec["duration"])
        finally:
            service.close()
    assert 0.0 <= out["pred_time"][0] <= out["pred_time"][1] <= rec["duration"] + 1e-6
