"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips where there is no card.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider -q

(``--noconftest`` because ``tests/conftest.py`` sets JAX up.)  Shapes are
ragged on purpose (lengths that are no multiple of a tile, head dims 16 and
32) and the masks hold wholly masked rows and a wholly masked sample.
Tolerances: f32 1e-4 (sums in another order); bf16 2**-6 of the largest
output magnitude (a few bf16 ulps).
"""

import pytest
import torch

from vmrframe_tpu_torch.kernels import attention as K

pytestmark = pytest.mark.gpu
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mask(g, B, L, device):
    lens = torch.randint(1, L + 1, (B,), generator=g)
    lens[0] = 0
    return (torch.arange(L)[None] < lens[:, None]).float().to(device)


def _close(got, want, dtype):
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple)
                                                              else (want,))
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and g_.dtype == w_.dtype
        assert torch.isfinite(g_.float()).all()
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6 * max(1.0, w_.float().abs().max())
        assert (g_.float() - w_.float()).abs().max() <= tol


def _heads(g, B, H, L, hd, dtype, device):
    return torch.randn(B, H, L, hd, generator=g).to(device, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,Lq,Lk,hd", [(3, 2, 37, 37, 16), (5, 4, 64, 64, 32),
                                          (2, 4, 30, 70, 32)])
def test_masked_attention_kernel(cuda, dtype, B, H, Lq, Lk, hd):
    g = torch.Generator().manual_seed(0)
    q, k, v = (_heads(g, B, H, L, hd, dtype, cuda) for L in (Lq, Lk, Lk))
    mask = _mask(g, B, Lq, cuda)[:, :, None] * _mask(g, B, Lk, cuda)[:, None, :]
    before = K.fused_masked_attention.launches
    got = K.fused_masked_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert K.fused_masked_attention.launches == before + 1
    _close(got, K.masked_attention_plain(q, k, v, mask), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("L,M", [(64, 30), (30, 64), (13, 5)])
def test_dual_attention_kernel_on_strided_views(cuda, dtype, L, M):
    """Inputs as the model passes them: head-split views of one projection."""
    g = torch.Generator().manual_seed(1)
    B, H, hd = 3, 4, 32
    split = lambda x: x.unflatten(-1, (H, hd)).transpose(1, 2)  # noqa: E731
    q, fk, fv = (split(t) for t in torch.randn(B, L, 3 * H * hd, generator=g)
                 .to(cuda, dtype).split(H * hd, dim=-1))
    tk, tv = (split(t) for t in torch.randn(B, M, 2 * H * hd, generator=g)
              .to(cuda, dtype).split(H * hd, dim=-1))
    fm, tm = _mask(g, B, L, cuda), _mask(g, B, M, cuda)
    s_mask, x_mask = fm[:, :, None] * fm[:, None, :], fm[:, :, None] * tm[:, None, :]
    before = K.fused_dual_attention.launches
    got = K.fused_dual_attention(q, fk, fv, tk, tv, s_mask, x_mask)
    torch.cuda.synchronize()
    assert K.fused_dual_attention.launches == before + 1
    _close(got, K.dual_attention_plain(q, fk, fv, tk, tv, s_mask, x_mask), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("Lc,Lq,D", [(64, 30, 128), (30, 64, 128), (11, 7, 24)])
def test_cq_attention_kernel(cuda, dtype, Lc, Lq, D):
    g = torch.Generator().manual_seed(2)
    B = 4
    c = torch.randn(B, Lc, D, generator=g).to(cuda, dtype)
    q = torch.randn(B, Lq, D, generator=g).to(cuda, dtype)
    w = [(torch.rand(*s, generator=g) * 0.4 - 0.2).to(cuda, dtype)
         for s in ((D, 1), (D, 1), (1, 1, D))]
    c_mask, q_mask = _mask(g, B, Lc, cuda), _mask(g, B, Lq, cuda)
    q_mask[1] = 0.0
    before = K.fused_cq_attention.launches
    got = K.fused_cq_attention(c, q, *w, c_mask, q_mask)
    torch.cuda.synchronize()
    assert K.fused_cq_attention.launches == before + 1
    _close(got, K.cq_attention_plain(c, q, *w, c_mask, q_mask), dtype)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(2, 2, 5, 8, device=cuda, dtype=torch.float16)
    mask = torch.ones(2, 5, 5, device=cuda)
    with pytest.raises(TypeError):
        K.fused_masked_attention(x, x, x, mask)
    x = x.float()
    with pytest.raises(ValueError):
        K.fused_masked_attention(x, x, x.cpu(), mask)
    with pytest.raises(ValueError):
        K.fused_masked_attention(x, x, x, mask[:, :4])


def test_seqpan_forward_on_kernels_matches_plain_on_cpu(cuda):
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.tools.serve import make_cfg
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    cfg = make_cfg(vlen=32, tlen=12, vdim=64, dim=32, batch_size=8, compute_dtype="float32")
    ds, store = make_synthetic_data(cfg, seed=0, n_train=8, n_test=8)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    batch = Batcher(ds["test_set"], store, cfg, der).make_batch(list(range(8)))
    before = [fn.launches for fn in K.KERNELS]
    outs = []
    for device in (cuda, "cpu"):
        ev = Evaluator(cfg, der, ds["word_vector"], device=device, seed=0)
        outs.append(ev.eval_step(ev.to_device(batch)))
    assert [fn.launches - b for fn, b in zip(K.KERNELS, before)] == [2, 4, 2]
    got, want = outs
    torch.testing.assert_close(got["props"].cpu(), want["props"], rtol=0, atol=0)
    torch.testing.assert_close(got["loss"].cpu(), want["loss"], rtol=0, atol=1e-4)
