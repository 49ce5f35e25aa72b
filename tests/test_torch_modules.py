"""Each port module that holds a kernel (DualAttentionBlock around
DualMultiAttention, CQAttention, TopSelfAttention), and the modules around
them, against its flax counterpart: same weights (carried by
``weights.from_jax_params``), same numpy inputs, f32, atol 1e-4 (the JAX
package's own per-layer bar).  On the CPU the port's wrappers run the
kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmrframe_tpu import layers as jl
from vmrframe_tpu_torch import layers as tl
from vmrframe_tpu_torch.weights import load_jax_params

ATOL = 1e-4
B, LV, LT, D, H = 3, 10, 7, 16, 4


def _lengths_mask(rng, B, L):
    """Random valid lengths; sample 0 is wholly padded."""
    lens = rng.integers(1, L + 1, B)
    lens[0] = 0
    return (np.arange(L)[None] < lens[:, None]).astype(np.float32)


def _carry(flax_module, torch_module, *args):
    """Init the flax module on ``args``, load its variables into the torch
    module, return (flax output, torch output) as numpy."""
    variables = flax_module.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
    load_jax_params(torch_module, variables["params"], variables.get("constants", {}))
    want = flax_module.apply(variables, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = torch_module(*(torch.from_numpy(np.asarray(a)) for a in args))
    return want, got


def _close(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("lf,lt", [(LV, LT), (LT, LV)])
def test_dual_attention_block(lf, lt):
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((B, lf, D), np.float32), rng.standard_normal((B, lt, D), np.float32)
    fm, tm = _lengths_mask(rng, B, lf), _lengths_mask(rng, B, lt)
    _close(*reversed(_carry(jl.DualAttentionBlock(D, H), tl.DualAttentionBlock(D, H),
                            x, y, fm, tm)))


@pytest.mark.parametrize("lc,lq", [(LV, LT), (LT, LV)])
def test_cq_attention(lc, lq):
    rng = np.random.default_rng(1)
    c, q = rng.standard_normal((B, lc, D), np.float32), rng.standard_normal((B, lq, D), np.float32)
    cm, qm = _lengths_mask(rng, B, lc), _lengths_mask(rng, B, lq)
    _close(*reversed(_carry(jl.CQAttention(D), tl.CQAttention(D), c, q, cm, qm)))


def test_top_self_attention():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, LV, D), np.float32)
    _close(*reversed(_carry(jl.TopSelfAttention(D, H), tl.TopSelfAttention(D, H),
                            x, _lengths_mask(rng, B, LV))))


def test_cq_concatenate():
    rng = np.random.default_rng(3)
    c, q = rng.standard_normal((B, LV, D), np.float32), rng.standard_normal((B, LT, D), np.float32)
    _close(*reversed(_carry(jl.CQConcatenate(D), tl.CQConcatenate(D), c, q,
                            _lengths_mask(rng, B, LT))))


def test_feature_encoder():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, LV, D), np.float32)
    _close(*reversed(_carry(jl.FeatureEncoder(D, max_pos_len=LV + 3, kernel_size=7, num_layers=4),
                            tl.FeatureEncoder(D, LV + 3, 7, 4), x)))


def test_seqpan_predictor():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, LV, D), np.float32)
    _close(*reversed(_carry(jl.SeqPANPredictor(D, LV, num_heads=4), tl.SeqPANPredictor(D, LV, 4),
                            x, _lengths_mask(rng, B, LV))))


def test_embedding():
    rng = np.random.default_rng(6)
    num_words, num_chars, word_dim, char_dim, C = 20, 12, 10, 6, 8
    word_vectors = rng.standard_normal((num_words - 2, word_dim)).astype(np.float32)
    tmask = _lengths_mask(rng, B, LT)
    words = (rng.integers(1, num_words, (B, LT)) * tmask).astype(np.int32)
    chars = rng.integers(1, num_chars, (B, LT, C)).astype(np.int32)
    chars[rng.random((B, LT, C)) < 0.3] = 0  # PAD chars inside words
    chars[words == 0] = 0
    flax_m = jl.Embedding(out_dim=D, word_dim=word_dim, char_dim=char_dim, num_chars=num_chars,
                          word_vectors=word_vectors)
    torch_m = tl.Embedding(D, word_dim, char_dim, num_chars, word_vectors)
    _close(*reversed(_carry(flax_m, torch_m, words, chars)))
