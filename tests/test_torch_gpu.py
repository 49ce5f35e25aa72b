"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips where there is no card.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider -q

(``--noconftest`` because ``tests/conftest.py`` sets JAX up.)  Shapes are
ragged on purpose (lengths that are no multiple of a tile, head dims 1 to
1024) and the masks hold wholly masked rows and a wholly masked sample.
Tolerances: f32 1e-4 (sums in another order); bf16 2**-6 of the largest
output magnitude (a few bf16 ulps).
"""

import pytest
import torch

from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.kernels import dual_stack as S
from vmrframe_tpu_torch.kernels import window_attention as W

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


def _f32_cases(both, f32_only):
    """Each case (a tuple, or one value) in both types, then the f32 body's
    own cases."""
    def param(key, dtype, case):
        case = case if isinstance(case, tuple) else (case,)
        return pytest.param(dtype, *case, id="-".join(map(str, case + (key,))))

    return [param(key, dt, case) for case in both for key, dt in zip(("f32", "bf16"), DTYPES)] \
        + [param("f32", torch.float32, case) for case in f32_only]


@pytest.mark.parametrize("dtype,B,H,Lq,Lk,hd", _f32_cases(
    [(3, 2, 37, 37, 16), (5, 4, 64, 64, 32), (2, 4, 30, 70, 32)],
    # f32 (3xTF32 on the tensor cores): head dims 1, 4, 24, 33 (rows of
    # 33 floats: element loads, not 16-byte copies), 192 and 256 over 1, 65,
    # 129 and 256 keys; the last three stage K and V in 64-key chunks
    [(3, 2, 37, 1, 1), (3, 2, 37, 65, 4), (2, 4, 30, 129, 24), (2, 2, 64, 256, 33),
     (3, 2, 37, 65, 192), (2, 2, 129, 129, 192), (2, 2, 20, 256, 256), (2, 2, 129, 1, 256)]))
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
@pytest.mark.parametrize("B,Lc,Lq,D", [
    (4, 64, 30, 128), (4, 30, 64, 128), (4, 11, 7, 24),
    # SeqPAN's grids at TACoS (vlen 256) and ANet (vlen 100) width, both ways
    # round (CQAttention runs video-to-text and back), and the longest #3 takes
    (4, 30, 256, 128), (4, 256, 30, 128), (4, 100, 30, 128), (4, 30, 100, 128),
    (4, 30, 1024, 128), (4, 1024, 30, 128),
    # one position a side; past a 16-row tile on either side (the scores in
    # the scratch); the longest grid both ways; the serving batch
    (4, 1, 1, 1), (4, 65, 257, 128), (4, 257, 65, 128), (4, 1024, 1024, 128),
    (128, 64, 30, 128),
    # the sentence variants at D = 768: AlignFeature's grids, and BertSentence's
    # one text position as the query side and as the context side
    (4, 64, 30, 768), (4, 30, 64, 768), (4, 64, 1, 768), (4, 1, 64, 768)])
def test_cq_attention_kernel(cuda, dtype, B, Lc, Lq, D):
    g = torch.Generator().manual_seed(2)
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


def _long_attention_inputs(g, B, H, L, M, hd, dtype, device):
    """q, self k/v and cross k/v as head-split views of one projection
    each; masks with ragged lengths, a wholly masked sample (0) and wholly
    masked query rows (sample 1's rows past its length)."""
    split = lambda x: x.unflatten(-1, (H, hd)).transpose(1, 2)  # noqa: E731
    q, fk, fv = (split(t) for t in torch.randn(B, L, 3 * H * hd, generator=g)
                 .to(device, dtype).split(H * hd, dim=-1))
    tk, tv = (split(t) for t in torch.randn(B, M, 2 * H * hd, generator=g)
              .to(device, dtype).split(H * hd, dim=-1))
    fm, tm = _mask(g, B, L, device), _mask(g, B, M, device)
    fm[1, L // 2:] = 0.0
    return q, fk, fv, tk, tv, fm[:, :, None] * fm[:, None, :], fm[:, :, None] * tm[:, None, :]


@pytest.mark.parametrize("dtype,hd", _f32_cases(
    [16, 24, 32, 64, 128],
    # f32: head dims off the 8-column grid and past 128; views whose rows
    # are not 16-byte aligned (3 * 2 * hd floats apart, at offsets of 2 * hd)
    [1, 4, 33, 192, 256]))
def test_attention_kernels_at_long_grids(cuda, dtype, hd):
    """#1 and #2 at L = 256 against 30 (SeqPAN at TACoS width), every head
    dim the kernels take, on strided views: self (256 keys, several key
    chunks), cross (30 keys) and #1 with 256 queries over 30 keys and 30
    over 256."""
    g = torch.Generator().manual_seed(9)
    q, fk, fv, tk, tv, s_mask, x_mask = _long_attention_inputs(g, 3, 2, 256, 30, hd, dtype,
                                                               cuda)
    before = (K.fused_masked_attention.launches, K.fused_dual_attention.launches)
    got = K.fused_dual_attention(q, fk, fv, tk, tv, s_mask, x_mask)
    torch.cuda.synchronize()
    _close(got, K.dual_attention_plain(q, fk, fv, tk, tv, s_mask, x_mask), dtype)
    _close(K.fused_masked_attention(q, tk, tv, x_mask),
           K.masked_attention_plain(q, tk, tv, x_mask), dtype)
    _close(K.fused_masked_attention(tk, q, fv, x_mask.transpose(1, 2)),
           K.masked_attention_plain(tk, q, fv, x_mask.transpose(1, 2)), dtype)
    assert (K.fused_masked_attention.launches, K.fused_dual_attention.launches) == \
        (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("dtype,L,M,hd", _f32_cases([
    # BackBoneAlignFeature at D = 768, 4 heads: video 64 and text 30 rows
    (64, 30, 192), (30, 64, 192),
    # past 128 off the 16-column grid; the widest; several key chunks
    (37, 11, 136), (64, 30, 256), (150, 30, 192),
    # BackBoneBertSentence: one text position, as the cross keys and as the query
    (64, 1, 32), (1, 64, 32), (64, 1, 192), (1, 64, 192)],
    # f32: 65, 129 and 256 keys at head dims 1, 4, 33 and 256, one key at 256
    [(65, 129, 1), (129, 65, 4), (256, 65, 33), (129, 256, 256), (256, 1, 256)]))
def test_attention_kernels_past_head_dim_128_and_at_one_key(cuda, dtype, L, M, hd):
    """#2 and #1 (self and cross branches alone) at the sentence variants'
    shapes, on strided views, with wholly masked rows and samples."""
    g = torch.Generator().manual_seed(10)
    q, fk, fv, tk, tv, s_mask, x_mask = _long_attention_inputs(g, 3, 4, L, M, hd, dtype, cuda)
    before = (K.fused_masked_attention.launches, K.fused_dual_attention.launches)
    got = K.fused_dual_attention(q, fk, fv, tk, tv, s_mask, x_mask)
    torch.cuda.synchronize()
    _close(got, K.dual_attention_plain(q, fk, fv, tk, tv, s_mask, x_mask), dtype)
    _close(K.fused_masked_attention(q, fk, fv, s_mask),
           K.masked_attention_plain(q, fk, fv, s_mask), dtype)
    _close(K.fused_masked_attention(q, tk, tv, x_mask),
           K.masked_attention_plain(q, tk, tv, x_mask), dtype)
    assert (K.fused_masked_attention.launches, K.fused_dual_attention.launches) == \
        (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("L,M,hd", [
    # past head dim 128 with query rows off the 16-row grid: each output
    # half a work item of its own, the branches on warps of their own
    (45, 30, 200), (23, 64, 256), (77, 1, 144),
    # more items than warps (19 tiles, two branches), one cross key
    (300, 1, 32), (300, 30, 16),
    # head dims off the 4-column grid: outputs stored an element at a time
    (37, 65, 33), (30, 129, 1), (40, 30, 18),
    # 65, 129 and 256 keys: several 64-bit mask words a row
    (65, 129, 32), (129, 65, 64), (256, 256, 32)])
def test_bf16_work_items_against_plain(cuda, L, M, hd):
    """The bf16 body's work items (branch, output half, 16-row tile) and
    mask bits, on strided views with wholly masked rows and samples: #2,
    and #1 over each of its branches."""
    g = torch.Generator().manual_seed(11)
    dtype = torch.bfloat16
    q, fk, fv, tk, tv, s_mask, x_mask = _long_attention_inputs(g, 3, 4, L, M, hd, dtype, cuda)
    assert K.attention_bf16_plan(L, (L, M), hd)["round_rows"] >= L  # one round
    before = (K.fused_masked_attention.launches, K.fused_dual_attention.launches)
    got = K.fused_dual_attention(q, fk, fv, tk, tv, s_mask, x_mask)
    torch.cuda.synchronize()
    _close(got, K.dual_attention_plain(q, fk, fv, tk, tv, s_mask, x_mask), dtype)
    _close(K.fused_masked_attention(q, fk, fv, s_mask),
           K.masked_attention_plain(q, fk, fv, s_mask), dtype)
    _close(K.fused_masked_attention(q, tk, tv, x_mask),
           K.masked_attention_plain(q, tk, tv, x_mask), dtype)
    assert (K.fused_masked_attention.launches, K.fused_dual_attention.launches) == \
        (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("B,Lq,Lk,hd,rounds", [
    (2, 80, 256, 192, 2),  # K and V of 256 keys at 192 columns: 4 tiles fit, 3 a round
    (1, 2048, 1001, 16, 3),  # 128 tiles in three rounds; rows of 1001 keys unaligned
    (2, 1100, 1024, 32, 4),
    (2, 400, 60, 256, 2)])  # 60 keys: each block makes its own bits, a round at a time
def test_bf16_query_rows_in_rounds(cuda, B, Lq, Lk, hd, rounds):
    """#1 where K and V leave room for only part of the query rows: the
    block stages the rows and their mask bits (copied from the mask-bits
    pass past 64 keys, made by the block to 64) a round at a time."""
    g = torch.Generator().manual_seed(12)
    dtype = torch.bfloat16
    q, k, v = (_heads(g, B, 2, L, hd, dtype, cuda) for L in (Lq, Lk, Lk))
    mask = _mask(g, B, Lq, cuda)[:, :, None] * _mask(g, B, Lk, cuda)[:, None, :]
    assert -(-Lq // K.attention_bf16_plan(Lq, (Lk,), hd)["round_rows"]) == rounds
    got = K.fused_masked_attention(q, k, v, mask)
    torch.cuda.synchronize()
    _close(got, K.masked_attention_plain(q, k, v, mask), dtype)


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
    before = [fn.launches for fn in K.KERNELS]
    with pytest.raises(ValueError, match="head dim"):  # bf16 head dims end at 256
        y = torch.randn(1, 1, 8, 264, device=cuda, dtype=torch.bfloat16)
        K.fused_masked_attention(y, y, y, torch.ones(1, 8, 8, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):  # K and V of two 512-key branches
        y = torch.randn(1, 1, 512, 128, device=cuda, dtype=torch.bfloat16)
        m = torch.ones(1, 512, 512, device=cuda)
        K.fused_dual_attention(y, y, y, y, y, m, m)
    with pytest.raises(ValueError, match="1024"):  # CQ grids end at 1024 positions
        c, q = torch.randn(1, 1025, 128, device=cuda), torch.randn(1, 30, 128, device=cuda)
        w = torch.zeros(128, 1, device=cuda)
        K.fused_cq_attention(c, q, w, w, w.view(1, 1, 128), torch.ones(1, 1025, device=cuda),
                             torch.ones(1, 30, device=cuda))
    assert [fn.launches for fn in K.KERNELS] == before


def test_seqpan_forward_on_kernels_matches_plain_on_cpu(cuda):
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.testing import lift_drop_path, make_synthetic_data
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


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("T,window,hd", [
    (300, 19, 128), (1000, 19, 128), (513, 9, 64), (640, 37, 32), (700, 300, 64),
    # head dims off the 32/64/128 grid; window 300 takes two walks, and at
    # hd 64 and 128 its key union is staged in parts (two, three); window 75
    # at hd 128 streams the f32 body's union in chunks
    (1000, 19, 96), (513, 19, 24), (640, 37, 16), (700, 300, 24), (700, 300, 128),
    (1000, 75, 128)])
def test_banded_attention_kernel_on_strided_views(cuda, dtype, T, window, hd):
    """Head-split views of one (B, T, 3C) projection, ragged lengths, a
    wholly masked sample; every row is compared, padding rows included."""
    g = torch.Generator().manual_seed(3)
    B, H = 3, 4
    split = lambda x: x.unflatten(-1, (H, hd)).transpose(1, 2)  # noqa: E731
    q, k, v = (split(t) for t in torch.randn(B, T, 3 * H * hd, generator=g)
               .to(cuda, dtype).split(H * hd, dim=-1))
    mask = _mask(g, B, T, cuda)
    mask[2, 40:90] = 0.0  # a hole wider than the band: rows with no valid key
    before = W.banded_attention.launches
    got = W.banded_attention(q, k, v, mask, window)
    torch.cuda.synchronize()
    assert W.banded_attention.launches == before + 1
    assert got.transpose(1, 2).is_contiguous()  # (B, T, H, hd) memory
    _close(got, W.banded_attention_plain(q, k, v, mask, window), dtype)


def test_banded_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.randn(2, 2, 384, 64, device=cuda)
    mask = torch.ones(2, 384, device=cuda)
    with pytest.raises(TypeError):
        W.banded_attention(x.half(), x.half(), x.half(), mask, 19)
    with pytest.raises(ValueError, match="head dims"):  # every kernel ends at 128
        y = torch.randn(2, 2, 384, 160, device=cuda)
        W.banded_attention(y, y, y, mask, 19)
    with pytest.raises(ValueError, match="too small"):
        W.banded_attention(x[:, :, :200], x[:, :, :200], x[:, :, :200], mask[:, :200], 19)
    with pytest.raises(ValueError, match="unit stride"):
        y = x.transpose(2, 3).contiguous().transpose(2, 3)
        W.banded_attention(y, y, y, mask, 19)
    with pytest.raises(ValueError):
        W.banded_attention(x, x, x, mask[:, :100], 19)


def _banded_bwd_inputs(g, B, H, T, hd, dtype, device):
    """q, k, v as head-split views of one (B, T, 3C) projection, a cotangent
    in (B, T, H, hd) memory (as autograd hands it back for the forward's
    output), ragged lengths, a hole wider than the band, a masked sample."""
    split = lambda x: x.unflatten(-1, (H, hd)).transpose(1, 2)  # noqa: E731
    q, k, v = (split(t) for t in torch.randn(B, T, 3 * H * hd, generator=g)
               .to(device, dtype).split(H * hd, dim=-1))
    cot = torch.randn(B, T, H, hd, generator=g).to(device, dtype).transpose(1, 2)
    mask = _mask(g, B, T, device)
    mask[-1, 40:90] = 0.0
    return q, k, v, mask, cot


@pytest.mark.parametrize("dtype,T,window,hd", _f32_cases(
    [(300, 19, 128), (1000, 19, 128), (576, 19, 64), (640, 37, 32), (700, 300, 64),
     # T_pad == K_WIN == K2, the statistics slice as long as the sequence
     (384, 9, 128),
     # head dims the kernels zero-fill up to the next multiple of 16 (bf16) or 8 (f32)
     (1000, 19, 96), (576, 19, 24), (640, 37, 16), (1000, 19, 1), (640, 19, 8)],
    # f32 (3xTF32 on the tensor cores): spans past 64 keys (two walks of
    # dq), key and row unions streamed in parts at head dim 128 (window 75:
    # 224 rows, window 300: 448), head dims inside a bucket (5, 40, 72, 100)
    [(700, 300, 128), (1000, 75, 128), (640, 37, 5), (576, 19, 40), (1000, 19, 72),
     (1000, 19, 100)]))
def test_banded_backward_kernels_on_strided_views(cuda, dtype, T, window, hd):
    """#6 and #7 against their plain versions with a random cotangent on
    every row, padding rows included: sample 0 wholly masked (every row of
    its tiles takes the padding-row passes), the last one with a hole wider
    than the band."""
    g = torch.Generator().manual_seed(4)
    q, k, v, mask, cot = _banded_bwd_inputs(g, 3, 4, T, hd, dtype, cuda)
    before = (W.banded_attention_dq.launches, W.banded_attention_dkv.launches)
    dq = W.banded_attention_dq(q, k, v, mask, cot, window)
    dk, dv = W.banded_attention_dkv(q, k, v, mask, cot, window)
    torch.cuda.synchronize()
    assert (W.banded_attention_dq.launches, W.banded_attention_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    for t in (dq, dk, dv):
        assert t.transpose(1, 2).is_contiguous()  # (B, T, H, hd) memory
    _close(dq, W.banded_attention_dq_plain(q, k, v, mask, cot, window), dtype)
    _close((dk, dv), W.banded_attention_dkv_plain(q, k, v, mask, cot, window), dtype)


def test_banded_autograd_function_on_the_kernels(cuda):
    """The Function's grads on the card against torch.autograd through the
    plain forward, with the cotangent zero on rows that have no valid key
    (there the TPU backward is not the forward's exact gradient)."""
    g = torch.Generator().manual_seed(5)
    T, window = 1000, 19
    q, k, v, mask, cot = _banded_bwd_inputs(g, 3, 4, T, 128, torch.float32, cuda)
    i = torch.arange(T, device=cuda)
    band = (i[:, None] - i[None, :]).abs() <= window // 2
    has_key = ((band[None] & (mask[:, None, :] > 0)).any(-1)).float()  # (B, T)
    cot = cot * has_key[:, None, :, None]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = [fn.launches for fn in W.KERNELS]
    W.banded_attention(*leaves, mask, window).backward(cot)
    assert [fn.launches - b for fn, b in zip(W.KERNELS, before)] == [1, 1, 1]
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    W.banded_attention_plain(*ref, mask, window).backward(cot)
    for got, want in zip(leaves, ref):
        assert (got.grad - want.grad).abs().max() <= 1e-4


def test_banded_backward_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(2, 2, 384, 64, device=cuda)
    mask = torch.ones(2, 384, device=cuda)
    for fn in (W.banded_attention_dq, W.banded_attention_dkv):
        with pytest.raises(TypeError):
            fn(x.half(), x.half(), x.half(), mask, x.half(), 19)
        with pytest.raises(ValueError, match="share"):
            fn(x, x, x, mask, x.bfloat16(), 19)
        with pytest.raises(ValueError, match="head dims"):  # every kernel ends at 128
            y = torch.randn(2, 2, 384, 160, device=cuda)
            fn(y, y, y, mask, y, 19)
        with pytest.raises(ValueError, match="too small"):
            y = x[:, :, :200]
            fn(y, y, y, mask[:, :200], y, 19)
        with pytest.raises(ValueError, match="unit stride"):
            y = x.transpose(2, 3).contiguous().transpose(2, 3)
            fn(x, x, x, mask, y, 19)
        with pytest.raises(ValueError):
            fn(x, x, x, mask, x[:, :, :300], 19)


def _af_tiny(updates=None):
    """The long config cut to width 64 and 512 frames, pallas_min_len 256."""
    from pathlib import Path

    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.testing import make_synthetic_data

    long_cfg = Path(__file__).resolve().parent.parent / "configs" / "tacos_actionformer_long.yaml"
    cfg = load_config(str(long_cfg)).updated({
        "train.batch_size": 8, "train.compute_dtype": "float32", "model.vlen": 512,
        "model.vdim": 48, "actionformer.backbone_arch": [1, 2, 3], "actionformer.input_dim": 48,
        "actionformer.embd_dim": 64, "actionformer.fpn_dim": 64, "actionformer.head_dim": 64,
        "actionformer.n_head": 2, "actionformer.max_seq_len": 512,
        "actionformer.pallas_min_len": 256, **(updates or {})})
    ds, store = make_synthetic_data(cfg, seed=0, n_train=8, n_test=8)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=4)
    return cfg, ds, store, der


def test_actionformer_train_step_on_the_kernels_matches_plain_on_cpu(cuda):
    """droppath 0, so train mode is deterministic: the loss and every
    gradient of a train-mode forward, kernels on the card against the plain
    versions on the CPU, each gradient within 1e-3 of its max beyond the
    card's band-mask route's own distance to the CPU (the card's cuDNN
    convolution gradients differ from the CPU's on both routes alike).  Then
    one train step: 2 launches each of #5, #6, #7 (both stem blocks)."""
    from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher
    from vmrframe_tpu_torch.layers.actionformer import SHIFT_INVARIANT
    from vmrframe_tpu_torch.train.trainer import Trainer

    cfg, ds, store, der = _af_tiny({"actionformer.train_cfg.droppath": 0.0})
    batch = ActionFormerBatcher(ds["train_set"], store, cfg, der, "train").make_batch(
        list(range(6)))
    outs = {}
    for label, device, min_len in (("kernels", cuda, 256), ("band", cuda, -1),
                                   ("plain", "cpu", 256)):
        trainer = Trainer(cfg.updated({"actionformer.pallas_min_len": min_len}), der, None,
                          device=device)
        trainer.model.train()
        loss, grads, _, _ = trainer.loss_and_grads(trainer.to_device(batch))
        outs[label] = (float(loss.detach()), {k: v.cpu() for k, v in grads.items()})
    (loss_k, g_k), (_, g_b), (loss_p, g_p) = outs["kernels"], outs["band"], outs["plain"]
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    largest = max(v.abs().max().item() for v in g_p.values())
    for name, want in g_p.items():
        if name.endswith(SHIFT_INVARIANT):
            assert g_k[name].abs().max() <= 1e-3 * largest
            continue
        scale = want.abs().max().item()
        floor = (g_b[name] - want).abs().max().item()
        assert (g_k[name] - want).abs().max().item() <= floor + 1e-3 * scale, name

    trainer = Trainer(cfg, der, None, device=cuda)
    before = [fn.launches for fn in W.KERNELS]
    out = trainer.train_step(trainer.to_device(batch))
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(W.KERNELS, before)] == [2, 2, 2]
    assert torch.isfinite(out["loss"]) and trainer.optimizer.state["count"] == 1


def test_actionformer_forward_on_the_kernel_matches_plain_on_cpu(cuda):
    """The long config cut to width 64 and 512 frames, pallas_min_len 256:
    both stem blocks take the banded kernel on the card (2 launches per
    forward), the plain version on the CPU.  The AffineDropPath scales are
    drawn in [0.5, 1.5]: at their init of 1e-4 they would hide the branches."""
    from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher
    from vmrframe_tpu_torch.testing import lift_drop_path
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    cfg, ds, store, der = _af_tiny()
    batch = ActionFormerBatcher(ds["test_set"], store, cfg, der).make_batch(list(range(6)))
    before = W.banded_attention.launches
    outs = []
    for device in (cuda, "cpu"):
        ev = Evaluator(cfg, der, None, device=device, seed=0)
        lift_drop_path(ev.model, seed=0)
        dbatch = ev.to_device(batch)
        outs.append((ev.forward(dbatch), ev.eval_step(dbatch)))
    assert W.banded_attention.launches - before == 4  # 2 per forward, two forwards
    (got, got_step), (want, want_step) = outs
    for key in ("cls_logits", "offsets", "fpn_mask"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0, atol=1e-4)
    torch.testing.assert_close(got_step["loss"].cpu(), want_step["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(got_step["props"].cpu(), want_step["props"], rtol=0, atol=1e-4)


def _stack_inputs(g, B, Lv, Lt, dtype, device, D=128, H=4):
    """Two blocks with every leaf random, features, and masks of random
    lengths with sample 0 wholly masked."""
    from vmrframe_tpu_torch.layers.attention import DualAttentionBlock
    from vmrframe_tpu_torch.ops.precision import cast_module_
    from vmrframe_tpu_torch.weights import init_weights

    stacks = []
    for seed in (0, 1):
        block = init_weights(DualAttentionBlock(D, H), seed).eval()
        with torch.no_grad():
            for name, p in block.named_parameters():
                if "layer_norm" in name or name.endswith("bias_value"):
                    p.add_(0.1 * torch.randn(p.shape, generator=g))
            stacks.append(cast_module_(block.to(device), dtype).stacks())
    v = torch.randn(B, Lv, D, generator=g).to(device, dtype)
    t = torch.randn(B, Lt, D, generator=g).to(device, dtype)
    return v, t, _mask(g, B, Lv, device), _mask(g, B, Lt, device), *stacks, H


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Lv,Lt,H", [(5, 64, 30, 4), (3, 30, 64, 4), (2, 13, 5, 4), (1, 1, 1, 4),
                                       (3, 256, 30, 4), (3, 30, 256, 4), (2, 100, 100, 4),
                                       (2, 65, 129, 4), (3, 64, 30, 16), (2, 129, 65, 16),
                                       (3, 64, 30, 32), (2, 30, 256, 32), (2, 100, 100, 8),
                                       (2, 65, 129, 2), (2, 64, 30, 1)])
def test_dual_stack_kernel(cuda, dtype, B, Lv, Lt, H):
    """#4 against its plain version on every row: random lengths, a wholly
    masked sample, an odd batch, a short ragged pair, one position; SeqPAN's
    TACoS (256) and ANet (100) lengths on either side, and lengths one past
    a 64-row tile (65) and past two tiles and a 32-key chunk (129); 4 heads
    of 32, and the other head counts of D 128 from head dim 4 up: 16 and 32
    heads (head dims 8 and 4, padded to the mma's k and n in registers) one
    stage and past it, 8 heads of 16, 2 and 1 of 64 and 128."""
    g = torch.Generator().manual_seed(6)
    args = _stack_inputs(g, B, Lv, Lt, dtype, cuda, H=H)
    before = S.dual_attention_stack.launches
    got = S.dual_attention_stack(*args)
    torch.cuda.synchronize()
    assert S.dual_attention_stack.launches == before + 1
    assert all(o.is_contiguous() for o in got)
    _close(got, S.dual_attention_stack_plain(*args), dtype)


def test_dual_stack_kernel_with_an_empty_to_side_and_8_heads(cuda):
    """A valid video row facing a text side with no valid key averages that
    sample's own text rows, as the plain version does; 8 heads of 16."""
    g = torch.Generator().manual_seed(7)
    v, t, vm, tm, p1, p2, _ = _stack_inputs(g, 4, 64, 30, torch.float32, cuda, H=8)
    vm[1], tm[1] = 1.0, 0.0
    got = S.dual_attention_stack(v, t, vm, tm, p1, p2, 8)
    torch.cuda.synchronize()
    _close(got, S.dual_attention_stack_plain(v, t, vm, tm, p1, p2, 8), torch.float32)


WIDE = (256, 384, 512)  # #4's wider instances


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Lv,Lt", [(3, 64, 30), (2, 256, 30), (2, 13, 5)])
@pytest.mark.parametrize("H", [4, 8])
@pytest.mark.parametrize("D", WIDE)
def test_dual_stack_kernel_at_wider_d(cuda, D, H, B, Lv, Lt, dtype):
    """#4 at D 256, 384 and 512 against its plain version on every row: 4
    heads (head dims 64, 96, 128: a kernel of their own at each width) and 8
    (32, 48, 64: the shared kernel, 48 padded to 64); Charades lengths (the
    video side past a row tile of 32 or 16, its self attention in chunks
    with its values in A), 256 video rows, and a short pair that each width
    walks in one stage; sample 0 wholly masked."""
    g = torch.Generator().manual_seed(D + H + Lv)
    args = _stack_inputs(g, B, Lv, Lt, dtype, cuda, D=D, H=H)
    before = S.dual_attention_stack.launches
    got = S.dual_attention_stack(*args)
    torch.cuda.synchronize()
    assert S.dual_attention_stack.launches == before + 1
    _close(got, S.dual_attention_stack_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", WIDE)
def test_dual_stack_kernel_at_wider_d_with_an_empty_to_side(cuda, D, dtype):
    """A valid video row facing a text side with no valid key, at each wider
    width: the uniform average over that sample's own text rows, as the
    plain version gives it."""
    g = torch.Generator().manual_seed(D)
    v, t, vm, tm, p1, p2, H = _stack_inputs(g, 3, 40, 20, dtype, cuda, D=D)
    vm[1], tm[1] = 1.0, 0.0
    got = S.dual_attention_stack(v, t, vm, tm, p1, p2, H)
    torch.cuda.synchronize()
    _close(got, S.dual_attention_stack_plain(v, t, vm, tm, p1, p2, H), dtype)


# every (D, heads) of D <= 512 the gate passes whose head dim is past 128 or
# not a multiple of 4: the wide and the narrow heads
ODD_HEADS = [(D, H) for D in S.KERNEL_WIDTHS for H in range(1, D + 1)
             if D % H == 0 and ((D // H) % 4 or D // H > 128)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D,H", ODD_HEADS)
def test_dual_stack_kernel_at_wide_and_narrow_heads(cuda, D, H, dtype):
    """#4 at head dims 192-512 (loops to the head dim at run time) and 1, 2,
    3, 6 (element reads, statistics in device memory) against its plain
    version on every row: Charades lengths and a pair past every width's
    stage on both sides (the statistics' walk), sample 0 wholly masked; one
    launch a call."""
    g = torch.Generator().manual_seed(D + H)
    for Lv, Lt in ((64, 30), (70, 66)):
        args = _stack_inputs(g, 3, Lv, Lt, dtype, cuda, D=D, H=H)
        before = S.dual_attention_stack.launches
        got = S.dual_attention_stack(*args)
        torch.cuda.synchronize()
        assert S.dual_attention_stack.launches == before + 1
        _close(got, S.dual_attention_stack_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D,H", [(128, 128), (512, 1)])
def test_dual_stack_kernel_at_hd_1_and_512_with_an_empty_to_side(cuda, D, H, dtype):
    """A valid video row facing a text side with no valid key at head dims
    1 and 512: the uniform average over the sample's own text rows."""
    g = torch.Generator().manual_seed(D * H)
    v, t, vm, tm, p1, p2, _ = _stack_inputs(g, 3, 40, 20, dtype, cuda, D=D, H=H)
    vm[1], tm[1] = 1.0, 0.0
    got = S.dual_attention_stack(v, t, vm, tm, p1, p2, H)
    torch.cuda.synchronize()
    _close(got, S.dual_attention_stack_plain(v, t, vm, tm, p1, p2, H), dtype)


# every (D, heads) of the cluster widths, D 640-1024 (61 pairs): the exact
# heads (multiples of 4 up to 128, those past 128 / hd crossing a slice edge),
# the wide ones (160-1024, every one crossing) and the narrow ones (1, 2, 3,
# 5, 6, 7, 10, 14)
CLUSTER_HEADS = [(D, H) for D in S.CLUSTER_WIDTHS for H in range(1, D + 1) if D % H == 0]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D,H", CLUSTER_HEADS)
def test_dual_stack_kernel_at_cluster_widths(cuda, D, H, dtype):
    """#4 at D 640-1024 (a cluster of D / 128 CTAs a sample) at every head
    count against its plain version on every row: Charades lengths (the
    video side past a 32-row tile and a 32-key stage) and a pair past a
    stage on both sides, sample 0 wholly masked; one launch a call."""
    g = torch.Generator().manual_seed(D + H)
    for Lv, Lt in ((64, 30), (70, 33)):
        args = _stack_inputs(g, 3, Lv, Lt, dtype, cuda, D=D, H=H)
        before = S.dual_attention_stack.launches
        got = S.dual_attention_stack(*args)
        torch.cuda.synchronize()
        assert S.dual_attention_stack.launches == before + 1
        _close(got, S.dual_attention_stack_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D,H", [(768, 4), (1024, 4), (768, 256)])
def test_dual_stack_kernel_at_cluster_widths_with_an_empty_to_side(cuda, D, H, dtype):
    """A valid video row facing a text side with no valid key at D 768 and
    1024 (heads of 192 and 256 crossing slice edges; 256 narrow heads of 3):
    the uniform average over the sample's own text rows."""
    g = torch.Generator().manual_seed(D + H)
    v, t, vm, tm, p1, p2, _ = _stack_inputs(g, 3, 40, 20, dtype, cuda, D=D, H=H)
    vm[1], tm[1] = 1.0, 0.0
    got = S.dual_attention_stack(v, t, vm, tm, p1, p2, H)
    torch.cuda.synchronize()
    _close(got, S.dual_attention_stack_plain(v, t, vm, tm, p1, p2, H), dtype)


def test_dual_stack_takes_what_the_c_entry_takes(cuda):
    """``takes`` and the C entry accept the same set: every head count of D
    = 64-1152 in steps of 64 that ``takes`` accepts runs (f32 and bf16,
    against the plain version: every head dim of every width, 1-1024, those
    the shared kernel pads, loops over or reads element by element among
    them, and the cluster's at D 640-1024); every other one the C entry
    refuses with cudaErrorInvalidValue (1) before any launch, as it refuses
    narrow heads at D 128-512 without their statistics' scratch."""
    lib = S.load_kernels()
    for D in range(64, 1216, 64):
        for H in (h for h in range(1, D + 1) if D % h == 0):
            if not S.takes(torch.float32, D, H, 5, 3):
                assert lib.vmr_dual_stack(0, *[None] * 13, 2, D, 5, 3, H, None) == 1, (D, H)
                continue
            for dtype in DTYPES:
                g = torch.Generator().manual_seed(D * H)
                args = _stack_inputs(g, 2, 5, 3, dtype, cuda, D=D, H=H)
                got = S.dual_attention_stack(*args)
                torch.cuda.synchronize()
                _close(got, S.dual_attention_stack_plain(*args), dtype)
    assert not S.takes(torch.float32, 128, 4, 0, 3)
    assert lib.vmr_dual_stack(0, *[None] * 13, 2, 128, 0, 3, 4, None) == 1
    assert lib.vmr_dual_stack(0, *[None] * 13, 2, 128, 5, 3, 64, None) == 1  # no stat_scratch


def test_dual_stack_attention_is_on_the_tensor_cores():
    """#4's attention runs on mma.sync in both bodies: the CUDA-core
    routines it replaced are gone from the source (no card needed)."""
    from pathlib import Path

    src = (Path(S.__file__).parent / "csrc" / "dual_stack.cuh").read_text()  # the body
    for gone in ("attention_one", "attention_chunked", "task_scores", "task_pv"):
        assert gone not in src, gone
    for used in ("scores_bf16", "scores_tf32", "mma_bf16(", "mma_3xtf32<"):
        assert used in src, used


def test_dual_stack_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    """Either side of the limit: D 1152 (4 heads of 288, and 9 of 128) raises
    the ValueError that names the set, D 128 at 1 head (head dim 128) and at
    64 (head dim 2) run; f16 and mixed types raise too."""
    g = torch.Generator().manual_seed(8)
    v, t, vm, tm, p1, p2, H = _stack_inputs(g, 2, 16, 8, torch.float32, cuda)
    before = S.dual_attention_stack.launches
    for D, heads in ((1152, 4), (1152, 9)):  # D past the set
        with pytest.raises(ValueError, match=r"the kernel takes D in \(128, 256, 384, 512, 640, "
                                             r"768, 896, 1024\)"):
            wide = {k: torch.zeros(*(D if d == 128 else d for d in x.shape), device=cuda)
                    for k, x in p1.items()}
            S.dual_attention_stack(torch.zeros(2, 16, D, device=cuda),
                                   torch.zeros(2, 8, D, device=cuda), vm, tm, wide, wide, heads)
    with pytest.raises(TypeError):
        half = {k: x.half() for k, x in p1.items()}
        S.dual_attention_stack(v.half(), t.half(), vm, tm, half, half, H)
    with pytest.raises(ValueError, match="share"):
        S.dual_attention_stack(v, t, vm, tm, {**p1, "W": p1["W"].bfloat16()}, p2, H)
    assert S.dual_attention_stack.launches == before
    S.dual_attention_stack(v, t, vm, tm, p1, p2, 1)  # head dim 128
    S.dual_attention_stack(v, t, vm, tm, p1, p2, 64)  # head dim 2
    assert S.dual_attention_stack.launches == before + 2


def test_family_forward_with_the_fused_stack_matches_plain_on_cpu(cuda):
    """SeqPAN and BackBone at dim 128 with ``model.fused_dual_stack`` set: 1
    stack launch and no dual-attention launch per forward on the card; the
    plain version on the CPU; with the flag off, 4 dual launches."""
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.tools.serve import make_cfg
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    counted = (S.dual_attention_stack, K.fused_dual_attention)
    for model in ("SeqPAN", "BackBone"):
        cfg = make_cfg(vlen=32, tlen=12, vdim=64, dim=128, batch_size=8, compute_dtype="float32",
                       model=model, fused_dual_stack=True)
        ds, store = make_synthetic_data(cfg, seed=0, n_train=8, n_test=8)
        der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
        batch = Batcher(ds["test_set"], store, cfg, der).make_batch(list(range(6)))
        outs = []
        for run_cfg, device, want in ((cfg, cuda, [1, 0]), (cfg, "cpu", [0, 0]),
                                      (cfg.updated({"model.fused_dual_stack": False}), cuda,
                                       [0, 4])):
            before = [fn.launches for fn in counted]
            ev = Evaluator(run_cfg, der, ds["word_vector"], device=device, seed=0)
            outs.append(ev.forward(ev.to_device(batch)))
            assert [fn.launches - b for fn, b in zip(counted, before)] == want
        for other in outs[1:]:
            for key in ("slogits", "elogits"):
                torch.testing.assert_close(outs[0][key].cpu(), other[key].cpu(), rtol=0,
                                           atol=1e-3)


def test_seqpan_flag_on_at_d256_launches_the_stack(cuda):
    """SeqPAN at D 256 with ``model.fused_dual_stack`` set: #4 once and #2
    never per eval forward on the card (until now the plain stack ran
    there), and the CPU's plain path's logits within 1e-3 (f32)."""
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.tools.serve import make_cfg
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    cfg = make_cfg(vlen=40, tlen=12, vdim=64, dim=256, batch_size=8, compute_dtype="float32",
                   fused_dual_stack=True)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=8, n_test=8)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    batch = Batcher(ds["test_set"], store, cfg, der).make_batch(list(range(6)))
    counted = (S.dual_attention_stack, K.fused_dual_attention)
    outs = []
    for device, want in ((cuda, [1, 0]), ("cpu", [0, 0])):
        before = [fn.launches for fn in counted]
        ev = Evaluator(cfg, der, ds["word_vector"], device=device, seed=0)
        outs.append(ev.forward(ev.to_device(batch)))
        assert [fn.launches - b for fn, b in zip(counted, before)] == want
    for key in ("slogits", "elogits"):
        torch.testing.assert_close(outs[0][key].cpu(), outs[1][key], rtol=0, atol=1e-3)


def test_seqpan_flag_on_at_d768_launches_the_stack_once(cuda):
    """SeqPAN at D 768 (4 heads of 192, each crossing a 128-column slice
    edge) with ``model.fused_dual_stack`` set: one eval forward on the card
    launches #4/#2/#3/#1 1/0/2/2 times, in f32 within 1e-3 of the CPU's
    plain path and in bf16 with finite logits."""
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.tools.serve import make_cfg
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    cfg = make_cfg(vlen=40, tlen=12, vdim=64, dim=768, batch_size=8, compute_dtype="float32",
                   fused_dual_stack=True)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=8, n_test=8)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    batch = Batcher(ds["test_set"], store, cfg, der).make_batch(list(range(6)))
    counted = (S.dual_attention_stack, K.fused_dual_attention, K.fused_cq_attention,
               K.fused_masked_attention)
    outs = []
    for run_cfg, device, want in ((cfg, cuda, [1, 0, 2, 2]), (cfg, "cpu", [0, 0, 0, 0]),
                                  (cfg.updated({"train.compute_dtype": "bfloat16"}), cuda,
                                   [1, 0, 2, 2])):
        before = [fn.launches for fn in counted]
        ev = Evaluator(run_cfg, der, ds["word_vector"], device=device, seed=0)
        outs.append(ev.forward(ev.to_device(batch)))
        assert [fn.launches - b for fn, b in zip(counted, before)] == want
    for key in ("slogits", "elogits"):
        torch.testing.assert_close(outs[0][key].cpu(), outs[1][key], rtol=0, atol=1e-3)
        assert torch.isfinite(outs[2][key].float()).all()


@pytest.mark.parametrize("dim,heads", [(1152, 4), (1152, 9)])
def test_flag_on_past_the_stack_limit_raises(cuda, dim, heads):
    """A flag-on BackBone the gate passes (D a multiple of 128) at a width
    #4 does not take (D 1152, at 4 heads of 288 and 9 of 128) raises the
    wrapper's ValueError on the card, where the plain stack used to run
    without a word; on the CPU the plain stack runs."""
    from vmrframe_tpu_torch.testing import stack_past_limit_case

    model, batch = stack_past_limit_case(dim, heads)
    with torch.no_grad():
        assert torch.isfinite(model(batch)["slogits"]).all()
        before = S.dual_attention_stack.launches
        with pytest.raises(ValueError, match="the kernel takes D in"):
            model.to(cuda)({k: v.to(cuda) for k, v in batch.items()})
    assert S.dual_attention_stack.launches == before


# --------------------------------------- the train route's Functions of #1-#3


def _function_cases(g, dtype, device):
    """(Function, reference, inputs, number that take a gradient) of #1-#3
    at SeqPAN's Charades shapes cut to a few samples, with ragged masks."""
    B, H, L, M, hd, D = 5, 4, 64, 30, 32, 128
    vm, tm = _mask(g, B, L, device), _mask(g, B, M, device)
    s_mask, x_mask = vm[:, :, None] * vm[:, None], vm[:, :, None] * tm[:, None]
    q, f_k, f_v = (_heads(g, B, H, L, hd, dtype, device) for _ in range(3))
    t_k, t_v = (_heads(g, B, H, M, hd, dtype, device) for _ in range(2))
    c, qry = (torch.randn(B, n, D, generator=g).to(device, dtype) for n in (L, M))
    w4C, w4Q = (torch.randn(D, 1, generator=g).mul(0.1).to(device, dtype) for _ in range(2))
    w4mlu = torch.randn(1, 1, D, generator=g).mul(0.1).to(device, dtype)
    return [
        (K.masked_attention, K.masked_attention_reference, (q, f_k, f_v, s_mask), 3),
        (K.dual_attention, K.dual_attention_reference, (q, f_k, f_v, t_k, t_v, s_mask, x_mask),
         5),
        (K.cq_attention, K.cq_attention_reference, (c, qry, w4C, w4Q, w4mlu, vm, tm), 5),
    ]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_attention_functions_backward_on_the_card(cuda, dtype):
    """Each Function launches its kernel once and none in its backward; its
    gradients are autograd's through its reference formula on the same card."""
    g = torch.Generator().manual_seed(9)
    for fn, reference, args, n in _function_cases(g, dtype, cuda):
        leaves = [a.detach().clone().requires_grad_(i < n) for i, a in enumerate(args)]
        before = [f.launches for f in K.KERNELS]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        cots = [torch.randn(o.shape, generator=g).to(cuda, dtype) for o in outs]
        torch.autograd.backward(outs, cots)
        assert sum(f.launches - b for f, b in zip(K.KERNELS, before)) == 1
        ref = [a.detach().clone().requires_grad_(i < n) for i, a in enumerate(args)]
        want = reference(*ref)
        torch.autograd.backward(want if isinstance(want, tuple) else (want,), cots)
        for got, exp in zip(leaves[:n], ref[:n]):
            assert torch.isfinite(got.grad.float()).all()
            tol = 1e-4 * max(1.0, exp.grad.float().abs().max().item()) \
                if dtype == torch.float32 else 2.0 ** -6 * max(1.0, exp.grad.float().abs().max())
            assert (got.grad.float() - exp.grad.float()).abs().max() <= tol


def test_wrappers_raise_on_inputs_that_require_grad(cuda):
    """Outside its Function a raw launch would detach its outputs: with grad
    mode on and an input that requires grad, each wrapper raises and launches
    nothing; under no_grad it launches."""
    g = torch.Generator().manual_seed(10)
    before = [f.launches for f in K.KERNELS]
    for fn, _, args, n in _function_cases(g, torch.float32, cuda):
        wrapper = {K.masked_attention: K.fused_masked_attention,
                   K.dual_attention: K.fused_dual_attention,
                   K.cq_attention: K.fused_cq_attention}[fn]
        needy = [a.detach().clone().requires_grad_(i == 0) for i, a in enumerate(args)]
        counts = [f.launches for f in K.KERNELS]
        with pytest.raises(RuntimeError, match="detached"):
            wrapper(*needy)
        assert [f.launches for f in K.KERNELS] == counts
        with torch.no_grad():
            wrapper(*needy)
    assert [f.launches - b for f, b in zip(K.KERNELS, before)] == [1, 1, 1]


def test_seqpan_train_step_on_the_kernels_matches_plain_on_cpu(cuda):
    """droprate 0, one gumbel noise: the loss and every gradient of SeqPAN's
    train mode with #1-#3 on the card (2/4/2 launches, none in backward)
    against the plain versions on the CPU, each gradient within 1e-3 of its
    max, the label embeddings off their orthogonal init (where the
    orthogonality penalty has no gradient); then one bf16 train step at
    droprate 0.2, which launches none."""
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.models import seqpan
    from vmrframe_tpu_torch.testing import lift_label_embs, make_synthetic_data
    from vmrframe_tpu_torch.tools.serve import make_cfg
    from vmrframe_tpu_torch.train.trainer import Trainer

    cfg = make_cfg(vlen=32, tlen=12, vdim=64, dim=32, batch_size=8, compute_dtype="float32")
    cfg = cfg.updated({"model.droprate": 0.0, "train.lr": 1e-3, "train.warmup_proportion": 0.0,
                       "train.clip_norm": 1.0})
    ds, store = make_synthetic_data(cfg, seed=0, n_train=8, n_test=8)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=1)
    batch = Batcher(ds["train_set"], store, cfg, der, "train").make_batch(list(range(8)))
    noise = torch.empty(8, 32, 4).exponential_(generator=torch.Generator().manual_seed(0))
    noise = noise.log().neg()
    draw = seqpan.gumbel_noise
    seqpan.gumbel_noise = lambda logits, generator: noise.to(logits.device, logits.dtype)
    outs = {}
    try:
        for device in (cuda, "cpu"):
            trainer = Trainer(cfg, der, ds["word_vector"], device=device)
            lift_label_embs(trainer.model, seed=0)
            trainer.model.train()
            before = [f.launches for f in K.KERNELS]
            loss, grads, _, _ = trainer.loss_and_grads(trainer.to_device(batch))
            outs[str(device)] = (float(loss.detach()), {k: v.cpu() for k, v in grads.items()})
            want = [2, 4, 2] if device == cuda else [0, 0, 0]
            assert [f.launches - b for f, b in zip(K.KERNELS, before)] == want
    finally:
        seqpan.gumbel_noise = draw
    (loss_k, g_k), (loss_p, g_p) = outs["cuda"], outs["cpu"]
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    largest = max(v.abs().max().item() for v in g_p.values())
    for name, want in g_p.items():
        got = g_k[name]
        assert torch.isfinite(got).all(), name
        if name.endswith(seqpan.SHIFT_INVARIANT):
            assert got.abs().max() <= 1e-3 * largest, name
            continue
        assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item(), name

    trainer = Trainer(cfg.updated({"model.droprate": 0.2, "train.compute_dtype": "bfloat16"}),
                      der, ds["word_vector"], device=cuda)
    before = [f.launches for f in K.KERNELS]
    out = trainer.train_step(trainer.to_device(batch))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(K.KERNELS, before)] == [0, 0, 0]
    assert torch.isfinite(out["loss"]) and trainer.optimizer.state["count"] == 1


def _raw_batch(g, B=16, max_raw=90, D=64):
    """Padded raw features with lengths from 5 to ``max_raw`` and gt spans."""
    lens = torch.randint(5, max_raw + 1, (B,), generator=g)
    lens[:2] = torch.tensor([5, max_raw])
    raw = torch.randn(B, max_raw, D, generator=g) * (torch.arange(max_raw) < lens[:, None])[..., None]
    s = torch.rand(B, generator=g) * 0.8
    fracs = torch.stack([s, (s + torch.rand(B, generator=g) * 0.4).clamp(max=1.0)], 1)
    return raw, lens.to(torch.int32), fracs


@pytest.mark.parametrize("sample_type", ["truncation", "samelen"])
def test_input_pipeline_on_the_card_matches_the_cpu(cuda, sample_type):
    """``unchanged`` draws nothing: the card's resampling and labels equal
    the CPU's, f32 with TF32 off."""
    from vmrframe_tpu_torch.ops.input_pipeline import device_augment_resample

    args = _raw_batch(torch.Generator().manual_seed(0))
    cpu = device_augment_resample(*args, 3, vlen=32, sample_type=sample_type)
    card = device_augment_resample(*[a.to(cuda) for a in args], 3, vlen=32,
                                   sample_type=sample_type)
    for key, want in cpu.items():
        got = card[key].cpu()
        assert got.dtype == want.dtype and got.shape == want.shape, key
        tol = 0 if key in ("vmasks", "NER_labels") else 1e-5
        assert (got.float() - want.float()).abs().max() <= tol, key


@pytest.mark.parametrize("mode", ["erosion", "dilation"])
def test_input_pipeline_augments_on_the_card_keeping_the_gt(cuda, mode):
    from vmrframe_tpu_torch.ops.input_pipeline import device_augment_resample

    args = [a.to(cuda) for a in _raw_batch(torch.Generator().manual_seed(1))]
    out = device_augment_resample(*args, 7, vlen=32, aug_mode=mode, erosion_p=0.2)
    again = device_augment_resample(*args, 7, vlen=32, aug_mode=mode, erosion_p=0.2)
    assert out["vfeats"].shape == (16, 32, 64) and torch.isfinite(out["vfeats"]).all()
    assert (out["label1ds"].amax(-1) == 1).all()  # every sample keeps a gt span
    for key in out:
        assert torch.equal(out[key], again[key]), key


def test_gates_route_past_each_limit_to_the_plain_version(cuda):
    """Just past each kernel's limit (#5 at head dim 192, #3 at a
    1025-position context, #1 at head dim 264) the models' gates take the
    plain route on the card: no launch, and the CPU's values (f32, 1e-4).
    #4 raises instead (``test_flag_on_past_the_stack_limit_raises``)."""
    from vmrframe_tpu_torch.testing import past_limit_cases

    for name, (kernel, module, inputs) in past_limit_cases().items():
        with torch.no_grad():
            want = module(*inputs)
            before = kernel.launches
            got = module.to(cuda)(*({k: v.to(cuda) for k, v in x.items()} if isinstance(x, dict)
                                    else x.to(cuda) for x in inputs))
            torch.cuda.synchronize()
        assert kernel.launches == before, name
        want = want if isinstance(want, dict) else {"out": want}
        got = got if isinstance(got, dict) else {"out": got}
        for key, w_ in want.items():
            w_ = w_[0] if isinstance(w_, tuple) else w_
            g_ = got[key][0] if isinstance(got[key], tuple) else got[key]
            if torch.is_floating_point(w_):
                assert (g_.cpu() - w_).abs().max() <= 1e-4, (name, key)


def _zoo_counts(path, overrides, device):
    from vmrframe_tpu_torch.tools import bench_zoo

    _, trainer, train, test = bench_zoo.build_from(path, overrides, device)
    return (bench_zoo.count_flops(trainer, train, train=True),
            bench_zoo.count_flops(trainer, test, train=False))


def test_flop_count_on_the_card_is_the_cpus(cuda):
    """``tools/bench_zoo.py``'s count does not depend on the route: SeqPAN
    with its kernels launching (#1-#3 counted as their plain versions) and
    with the stack's flag on (#4's route), at droprate 0 so that the train
    step launches too, and BAN with cuDNN's LSTMs, on the card equal to the
    CPU's count at the same shapes."""
    seqpan = "tests/configs/charades_seqpan.yaml"
    base = {"model.dim": 128, "model.droprate": 0.0}
    want = _zoo_counts(seqpan, base, "cpu")
    from vmrframe_tpu_torch.kernels import attention as K

    before = K.fused_dual_attention.launches
    assert _zoo_counts(seqpan, base, cuda) == want
    assert K.fused_dual_attention.launches > before  # the kernel route ran
    assert _zoo_counts(seqpan, {**base, "model.fused_dual_stack": True}, cuda) == want
    ban = "tests/configs/charades_ban.json"
    assert _zoo_counts(ban, {}, cuda) == _zoo_counts(ban, {}, "cpu")


def test_nccl_world_one_trains_as_the_plain_trainer(cuda):
    """The trainer's data-parallel route (outputs gathered, gradients
    all-reduced) in a NCCL group of one: the plain trainer's losses."""
    import socket

    import torch.distributed as dist

    from vmrframe_tpu_torch.tools import bench_zoo

    overrides = {"model.dim": 128, "model.droprate": 0.0}
    losses = {}
    for label in ("plain", "ddp"):
        if label == "ddp":
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                    world_size=1, rank=0)
        try:
            _, trainer, train, _ = bench_zoo.build_from("tests/configs/charades_seqpan.yaml",
                                                        overrides, cuda)
            losses[label] = [float(trainer.train_step(train)["loss"]) for _ in range(3)]
        finally:
            if label == "ddp":
                dist.destroy_process_group()
    torch.testing.assert_close(torch.tensor(losses["ddp"]), torch.tensor(losses["plain"]),
                               rtol=1e-6, atol=0.0)
