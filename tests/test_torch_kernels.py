"""The port's attention kernels, plain versions, against the JAX package's
Pallas kernels run in interpret mode on the CPU (f32, atol 1e-5).

The masks are random and include wholly masked rows and a wholly masked
sample: additive -1e30 must give such a row the uniform average over all
keys in both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmrframe_tpu.kernels.attention import (fused_cq_attention, fused_dual_attention,
                                            fused_masked_attention)
from vmrframe_tpu_torch.kernels import attention as K

ATOL = 1e-5


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mask(rng, *shape):
    """Random {0,1} mask over the last axis with some rows wholly masked and
    the first sample wholly masked."""
    m = (rng.random(shape) > 0.3).astype(np.float32)
    m[rng.random(shape[:-1]) < 0.2] = 0.0
    m[0] = 0.0
    return m


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("B,H,Lq,Lk,hd", [(3, 2, 5, 7, 4), (2, 4, 9, 9, 8)])
def test_masked_attention_plain_matches_pallas(B, H, Lq, Lk, hd):
    rng = np.random.default_rng(0)
    q, k, v = _normal(rng, B, H, Lq, hd), _normal(rng, B, H, Lk, hd), _normal(rng, B, H, Lk, hd)
    mask = _mask(rng, B, Lq, Lk)
    assert (mask.sum(-1) == 0).any() and (mask.sum(-1) > 0).any()
    want = fused_masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(mask), interpret=True)
    got = K.masked_attention_plain(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # a wholly masked query row is the plain mean of the values
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(v[0].mean(1, keepdims=True),
                                                               got[0].shape), atol=ATOL)


@pytest.mark.parametrize("L,M", [(6, 4), (4, 7)])
def test_dual_attention_plain_matches_pallas(L, M):
    rng = np.random.default_rng(1)
    B, H, hd = 3, 2, 8
    q, fk, fv = (_normal(rng, B, H, L, hd) for _ in range(3))
    tk, tv = _normal(rng, B, H, M, hd), _normal(rng, B, H, M, hd)
    s_mask, x_mask = _mask(rng, B, L, L), _mask(rng, B, L, M)
    want = fused_dual_attention(*(jnp.asarray(a) for a in (q, fk, fv, tk, tv, s_mask, x_mask)),
                                interpret=True)
    got = K.dual_attention_plain(*(_t(a) for a in (q, fk, fv, tk, tv, s_mask, x_mask)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("Lc,Lq", [(6, 4), (4, 9)])
def test_cq_attention_plain_matches_pallas(Lc, Lq):
    rng = np.random.default_rng(2)
    B, D = 3, 8
    c, q = _normal(rng, B, Lc, D), _normal(rng, B, Lq, D)
    w4C, w4Q, w4mlu = _normal(rng, D, 1), _normal(rng, D, 1), _normal(rng, 1, 1, D)
    c_mask = (rng.random((B, Lc)) > 0.3).astype(np.float32)
    q_mask = (rng.random((B, Lq)) > 0.3).astype(np.float32)
    c_mask[0] = 0.0  # every column softmax of sample 0 is wholly masked
    q_mask[1] = 0.0  # every row softmax of sample 1 is wholly masked
    args = (c, q, w4C, w4Q, w4mlu, c_mask, q_mask)
    want = fused_cq_attention(*(jnp.asarray(a) for a in args), interpret=True)
    got = K.cq_attention_plain(*(_t(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_wrappers_take_the_plain_path_on_cpu_and_count_no_launch():
    rng = np.random.default_rng(3)
    B, H, L, M, hd, D = 2, 2, 5, 3, 4, 8
    before = [fn.launches for fn in K.KERNELS]
    q, k, v = (_t(_normal(rng, B, H, L, hd)) for _ in range(3))
    mask = _t(_mask(rng, B, L, L))
    torch.testing.assert_close(K.fused_masked_attention(q, k, v, mask),
                               K.masked_attention_plain(q, k, v, mask), rtol=0, atol=0)
    tk, tv = _t(_normal(rng, B, H, M, hd)), _t(_normal(rng, B, H, M, hd))
    x_mask = _t(_mask(rng, B, L, M))
    for g, w in zip(K.fused_dual_attention(q, k, v, tk, tv, mask, x_mask),
                    K.dual_attention_plain(q, k, v, tk, tv, mask, x_mask)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    c, qq = _t(_normal(rng, B, L, D)), _t(_normal(rng, B, M, D))
    w = (_t(_normal(rng, D, 1)), _t(_normal(rng, D, 1)), _t(_normal(rng, 1, 1, D)))
    cm, qm = torch.ones(B, L), torch.ones(B, M)
    for g, want in zip(K.fused_cq_attention(c, qq, *w, cm, qm),
                       K.cq_attention_plain(c, qq, *w, cm, qm)):
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    assert [fn.launches for fn in K.KERNELS] == before

