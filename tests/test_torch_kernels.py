"""The port's attention kernels, plain versions, against the JAX package's
Pallas kernels run in interpret mode on the CPU (f32, atol 1e-5).

The masks are random and include wholly masked rows and a wholly masked
sample: additive -1e30 must give such a row the uniform average over all
keys in both frameworks.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

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



# ------------------------------------------------------------ limit functions


def test_limit_functions_match_what_the_wrappers_refuse():
    """Each kernel module's pure limit function, read by the models' gates
    before a launch and by the wrappers' raises: the edges of each limit."""
    from vmrframe_tpu_torch.kernels import dual_stack as S
    from vmrframe_tpu_torch.kernels import window_attention as W

    bf16, f32 = torch.bfloat16, torch.float32
    # #1/#2: head dims to 256 in both types, lengths from 1, shared memory
    assert K.attention_takes(bf16, 64, (64,), 256) and not K.attention_takes(bf16, 64, (64,), 257)
    assert K.attention_takes(f32, 64, (64, 30), 256)
    assert not K.attention_takes(f32, 64, (0,), 32) and not K.attention_takes(f32, 64, (64,), 0)
    assert not K.attention_takes(torch.float64, 64, (64,), 32)
    assert K.attention_takes(bf16, 256, (256, 30), 32)  # TACoS width
    assert not K.attention_takes(bf16, 512, (512, 512), 128)  # K and V of 1024 keys
    assert K.attention_shared_bytes(bf16, 512, (512, 512), 128) > K.SHARED_BYTES
    # #3: grids of 1-1024 a side, D to 8192
    assert K.cq_takes(1024, 30, 128) and K.cq_takes(1, 1, 1, f32)
    assert not K.cq_takes(1025, 30, 128) and not K.cq_takes(30, 1025, 128, f32)
    assert K.cq_takes(64, 30, 8192) and not K.cq_takes(64, 30, 8193)
    assert not K.cq_takes(0, 30, 128) and not K.cq_takes(64, 30, 128, torch.float64)
    with pytest.raises(ValueError, match="Lc and Lq from 1 to 1024"):
        K.cq_plan(1025, 30, 128)
    # #4: D = 128-1024 in steps of 128 (a cluster of D / 128 CTAs past 512),
    # every head count dividing it, any lengths
    assert S.takes(bf16, 128, 4, 64, 30) and S.takes(f32, 128, 32, 1, 1)
    assert S.takes(bf16, 256, 4, 64, 30) and S.takes(f32, 384, 32, 1, 1)  # head dim 12
    assert S.takes(bf16, 512, 4, 1, 1) and S.takes(bf16, 512, 2, 64, 30)  # head dim 256
    assert S.takes(bf16, 640, 4, 64, 30) and S.takes(f32, 1024, 1, 1, 1)  # head dims 160, 1024
    assert not S.takes(bf16, 1152, 4, 64, 30) and not S.takes(bf16, 64, 4, 64, 30)
    assert S.takes(bf16, 128, 64, 64, 30) and S.takes(f32, 384, 128, 1, 1)  # head dims 2, 3
    assert not S.takes(bf16, 128, 3, 64, 30) and not S.takes(bf16, 128, 4, 0, 30)
    # #5-#7: head dims 1-128, one key window within the padded length
    assert W.takes(2304, 128, 19) and not W.takes(2304, 129, 19) and not W.takes(2304, 0, 19)
    assert W.takes(300, 64, 19) and not W.takes(200, 64, 19)  # 384 = K_WIN at window 19
    with pytest.raises(ValueError, match="too small"):
        W._check_len(200, 19)


def test_gates_route_past_a_limit_to_the_plain_version():
    """Just past each limit the models' gates choose the plain route before
    any launch (on the card too): #5 at head dim 192, #3 at Lc 1025, #1 at
    head dim 264.  (#4 has no plain route on the card: its wrapper raises
    past its limit.)"""
    from vmrframe_tpu_torch.layers import actionformer as AF
    from vmrframe_tpu_torch.layers.attention import kernel_route

    module = torch.nn.Linear(1, 1).eval()
    assert kernel_route(module, 0.2, K.cq_takes(1024, 30, 128))
    assert not kernel_route(module, 0.2, K.cq_takes(1025, 30, 128))
    assert not kernel_route(module.train(), 0.2, True) and kernel_route(module, 0.0, True)
    assert not kernel_route(module, 0.0, K.attention_takes(torch.bfloat16, 64, (64,), 264))
    m = AF.MaskedMHCA(768, 4, window_size=19, pallas_min_len=256).eval()  # head dim 192
    assert not m.use_banded_kernel(2304, 2304)
    assert AF.MaskedMHCA(512, 4, window_size=19, pallas_min_len=256).eval().use_banded_kernel(
        2304, 2304)
