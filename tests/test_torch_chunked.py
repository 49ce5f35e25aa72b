"""``vmrframe_tpu_torch/ops/chunked.py::chunked_batch_apply`` against the
direct call and against the JAX package's ``chunked_batch_apply``, on the
CPU (the port's counterparts of ``tests/test_chunked.py``'s three cases):

- a model-like function (per-sample work only, a leaf that is not batched)
  at chunks 4, 8, 16 and 32 of a batch of 16, equal to the direct call;
- the divisibility assertion;
- SeqPAN's deterministic forward and span inference at B 16 in chunks of 8
  (the tiny test config, seeded port weights carried to JAX): equal to the
  port's direct call, and within 1e-4 of the JAX ``chunked_batch_apply``
  over the jitted JAX forward on the same weights, spans equal.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cca import jax_variables
from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.ops.chunked import chunked_batch_apply as jchunked
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.ops.chunked import chunked_batch_apply
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.weights import init_weights

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")
ATOL = 1e-4


def test_chunked_equals_direct_on_model_like_fn():
    B, L, D = 16, 8, 4
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((D, D)).astype(np.float32))
    batch = {
        "vfeats": torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32)),
        "vmasks": torch.from_numpy((rng.uniform(size=(B, L)) > 0.3).astype(np.float32)),
        "scale": torch.tensor(2.0),  # not batched: goes to every chunk
    }

    def fn(b):
        h = torch.tanh(b["vfeats"] @ w) * b["vmasks"][..., None] * b["scale"]
        return {"pooled": h.sum(dim=1), "score": torch.softmax(h.mean(dim=2), dim=-1)}

    direct = fn(batch)
    for chunk in (4, 8, 16, 32):
        out = chunked_batch_apply(fn, batch, B, chunk)
        assert set(out) == set(direct)
        for k in direct:
            torch.testing.assert_close(out[k], direct[k], rtol=0, atol=1e-6,
                                       msg=f"chunk={chunk} key={k}")


def test_chunked_requires_divisibility():
    with pytest.raises(AssertionError):
        chunked_batch_apply(lambda b: b["x"], {"x": torch.ones(10, 3)}, 10, 4)


def test_chunked_seqpan_eval_matches_direct_and_jax():
    B, chunk = 16, 8
    updates = {"train.batch_size": B}
    jcfg, cfg = jload_config(CFG).updated(updates), load_config(CFG).updated(updates)
    ds, store = jmake_synthetic_data(jcfg, seed=0, n_train=4, n_test=B)
    jder = JDerived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    batch = next(JBatcher(ds["test_set"], store, jcfg, jder, "test").epoch(seed=0, shuffle=False))
    batch = {k: v for k, v in batch.items() if k != "num_valid"}
    assert batch["vfeats"].shape[0] == B
    entry = get_model_entry("SeqPAN")
    model = entry.model_cls(cfg, Derived(num_words=ds["n_words"], num_chars=ds["n_chars"]),
                            ds["word_vector"])
    init_weights(model.eval(), 3)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}

    def fwd_infer(b):
        out = model(b)
        return {"slogits": out["slogits"], "elogits": out["elogits"],
                "props": entry.infer_fn(out, b, cfg)}

    with torch.no_grad():
        direct = fwd_infer(tb)
        got = chunked_batch_apply(fwd_infer, tb, B, chunk)
    for k in direct:
        torch.testing.assert_close(got[k], direct[k], rtol=0, atol=0, msg=k)

    jentry = jget_model_entry("SeqPAN")
    jmodel = jentry.model_cls(jcfg, jder, ds["word_vector"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    variables = jax_variables(model, jax.eval_shape(
        lambda b: jmodel.init({"params": key, "dropout": key, "gumbel": key}, b, True), jb))

    def jfwd_infer(b):
        out = jmodel.apply(variables, b, True)
        return {"slogits": out["slogits"], "elogits": out["elogits"],
                "props": jentry.infer_fn(out, b, jcfg)}

    want = jax.jit(lambda b: jchunked(jfwd_infer, b, B, chunk))(jb)
    for k in ("slogits", "elogits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(got["props"].numpy(), np.asarray(want["props"]))
