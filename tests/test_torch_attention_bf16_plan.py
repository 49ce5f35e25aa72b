"""The bf16 body of #1/#2 (``attention_mma`` in ``csrc/attention.cu``) on
the CPU: its launch plan, its mask bits, and the plain versions it is held
to on the card against the Pallas kernels at head dim 192.

- ``attention_bf16_plan`` fits one block at every shape ``attention_takes``
  accepts, takes every shape the former body (a warp's own Q and mask tiles)
  took, and gives 8 or more warps at BackBoneAlignFeature's shapes;
- ``attention_shared_bytes`` and the refusal messages are the plan's, and
  the wrappers pass the plan to the C entries, which size nothing;
- the mask's bits, as ``mask_bits`` lays them out and ``chunk_scores``
  reads them, are the mask;
- the plain versions against the Pallas kernels in interpret mode at head
  dim 192 (1e-5), as ``tests/test_torch_long_grid.py`` holds them at L 256.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmrframe_tpu.kernels.attention import fused_dual_attention, fused_masked_attention
from vmrframe_tpu_torch.kernels import attention as K

CSRC = Path(K.__file__).resolve().parent / "csrc" / "attention.cu"
BF16 = torch.bfloat16
KERNEL_ATOL = 1e-5


def _former_bytes(Lq, Lks, hd):
    """The former bf16 body's shared memory: K and V of every branch and, for
    each of up to 8 warps, a 16-row Q tile and a (16, 64 + 8) mask tile."""
    stride = -(-hd // 16) * 16 + 8
    warps = min(8, -(-Lq // 16))
    return 2 * (16 * warps * (stride + 72) + stride * sum(2 * (-(-Lk // 16) * 16) for Lk in Lks))


def _grid():
    for hd in (1, 8, 16, 31, 32, 33, 64, 65, 100, 128, 129, 144, 192, 200, 255, 256):
        for Lq in (1, 16, 30, 64, 129, 256, 1024, 2048):
            for Lks in ((1,), (30,), (65,), (256,), (1024,), (2300,), (4000,), (Lq, 30),
                        (Lq, 1024), (Lq, Lq), (30, Lq)):
                yield Lq, Lks, hd


def test_bf16_plan_fits_every_shape_it_takes_and_every_former_one():
    taken = 0
    for Lq, Lks, hd in _grid():
        plan = K.attention_bf16_plan(Lq, Lks, hd)
        if _former_bytes(Lq, Lks, hd) <= K.SHARED_BYTES:
            assert plan is not None and K.attention_takes(BF16, Lq, Lks, hd), (Lq, Lks, hd)
        if not K.attention_takes(BF16, Lq, Lks, hd):
            continue
        taken += 1
        halves, most = K.mma_shape(hd)
        rows = plan["round_rows"]
        assert plan["shared_bytes"] <= K.SHARED_BYTES and rows % 16 == 0
        # the fewest even rounds: no round is empty, every row is in one
        rounds = -(-Lq // rows)
        assert rows * (rounds - 1) < Lq <= rows * rounds
        assert plan["items"] == rows // 16 * halves * len(Lks)
        assert 1 <= plan["warps"] <= min(most, plan["items"])
        kv, per_tile = K._bf16_bytes(Lks, hd)
        assert plan["shared_bytes"] == kv + rows // 16 * per_tile
    assert taken > 800


def test_bf16_plan_at_the_served_shapes():
    # BackBoneAlignFeature (D 768, 4 heads of 192): every query row in one
    # round, 8 or more warps: (branch, output half, tile) items
    for Lq, Lks in ((64, (64, 30)), (30, (30, 64)), (64, (64,))):
        plan = K.attention_bf16_plan(Lq, Lks, 192)
        assert plan["round_rows"] >= Lq and plan["warps"] >= 8, (Lq, Lks)
    assert K.attention_bf16_plan(64, (64, 30), 192)["warps"] == 16
    assert K.mma_shape(192) == (2, 16) and K.mma_shape(256) == (2, 8)
    assert K.mma_shape(128) == (1, 8) and K.mma_shape(32) == (1, 16)
    # SeqPAN at Charades and TACoS width (head dim 32): one item a
    # (branch, tile), the branches on warps of their own
    assert K.attention_bf16_plan(64, (64,), 32)["warps"] == 4
    assert K.attention_bf16_plan(64, (64, 30), 32)["warps"] == 8
    assert K.attention_bf16_plan(30, (30, 64), 32)["warps"] == 4
    assert K.attention_bf16_plan(256, (256, 30), 32)["round_rows"] == 256
    # the grid of SeqPAN's serving batch (128 samples, 4 heads): the warps
    # that finish 512 blocks in the fewest waves times turns of items, on a
    # tie the most blocks an SM (each choice the fastest of 4, 8 and 16 warps
    # on an H100, PERF.md): Charades 4 (four 4-warp blocks an SM hold the
    # grid at once), TACoS width and head dim 192 8
    for Lq, Lks, hd, warps in ((64, (64,), 32, 4), (64, (64, 30), 32, 4), (30, (30, 64), 32, 4),
                               (256, (256,), 32, 8), (256, (256, 30), 32, 8),
                               (30, (30, 256), 32, 4), (64, (64,), 192, 8),
                               (64, (64, 30), 192, 8), (30, (30, 64), 192, 8)):
        assert K.attention_bf16_plan(Lq, Lks, hd, blocks=512)["warps"] == warps, (Lq, Lks, hd)
    # a branch of more than 64 keys has its mask made into bits once for
    # every head, by a pass of its own; a shorter one's blocks make their own
    assert K.attention_bf16_plan(256, (256, 30), 32)["prebits"] == (True, False)
    assert K.attention_bf16_plan(30, (30, 256), 32)["prebits"] == (False, True)
    assert K.attention_bf16_plan(64, (64, 65), 192)["prebits"] == (False, True)
    ptrs, held = K._bits_scratch(BF16, 256, (256, 30), 32, 3, "cpu")
    assert ptrs[1] is None and held[0].shape == (3 * 256 * 4,) and held[0].dtype == torch.int64
    assert K._bits_scratch(torch.float32, 256, (256, 30), 32, 3, "cpu")[0] == [None, None]
    # a small grid keeps one warp an item
    assert K.attention_bf16_plan(256, (256, 30), 32, blocks=8)["warps"] == 16
    # whatever the grid, the warps stay within what the body's build takes
    for hd in (32, 64, 65, 128, 129, 192, 193, 256):
        for blocks in (1, 8, 512, 4096):
            plan = K.attention_bf16_plan(64, (64, 30), hd, blocks=blocks)
            assert 1 <= plan["warps"] <= min(K.mma_shape(hd)[1], plan["items"]), (hd, blocks)
    # memoized: the wrappers read the plan of a shape several times a call
    assert K.attention_bf16_plan(64, [64, 30], 192, 512) is \
        K.attention_bf16_plan(64, (64, 30), 192, blocks=512)
    # 1024 queries over 1024 keys at head dim 128: K and V take 278,528
    # bytes, more than a block has
    assert K.attention_bf16_plan(1024, (1024,), 128) is None
    # 2048 queries over 1024 keys at head dim 16: K and V take 98,304
    # bytes, a tile 2,816 (Q rows of 48 bytes, 16 mask words), so 47 tiles
    # fit and the 128 go in three rounds of 43
    plan = K.attention_bf16_plan(2048, (1024,), 16)
    assert plan["round_rows"] == 16 * 43 and plan["shared_bytes"] == 98_304 + 43 * 2_816


def test_shared_bytes_and_refusals_are_the_plans():
    for Lq, Lks, hd in ((64, (64, 30), 192), (256, (256, 30), 32), (30, (30, 256), 32)):
        assert K.attention_shared_bytes(BF16, Lq, Lks, hd) == \
            K.attention_bf16_plan(Lq, Lks, hd)["shared_bytes"]
        assert K._plan_args(BF16, Lq, Lks, hd) == \
            (0, K.attention_bf16_plan(Lq, Lks, hd)["warps"],
             K.attention_bf16_plan(Lq, Lks, hd)["round_rows"], 0,
             K.attention_shared_bytes(BF16, Lq, Lks, hd))
    # no plan: the refusal names what K, V and one tile would need
    kv, per_tile = K._bf16_bytes((512, 512), 128)
    need = K.attention_shared_bytes(BF16, 512, (512, 512), 128)
    assert need == kv + per_tile > K.SHARED_BYTES
    with pytest.raises(ValueError, match=f"need {need} bytes of shared memory"):
        K._check_attention(BF16, 512, (512, 512), 128, "test")


def test_plan_mirrors_the_kernel():
    """``mma_shape`` and ``MMA_CHUNK`` are ``MmaBody`` and ``kChunk`` in the
    source, and ``launch_mma`` sizes nothing: it launches the plan it is
    given (warps, query rows a round, shared memory)."""
    src = CSRC.read_text()
    body = re.search(r"struct MmaBody \{(.*?)\};", src, re.S).group(1)
    assert "kHalves = kQS ? 2 : 1;" in body and "kQS = HDK > 8;" in body
    assert "kWarps = HDK <= 4 || (HDK > 8 && HDK <= 12) ? 16 : 8;" in body
    assert re.search(r"constexpr int kChunk = (\d+);", src).group(1) == str(K.MMA_CHUNK)
    launch = re.search(r"int launch_mma\(.*?\n}\n", src, re.S).group(0)
    assert "sizeof" not in launch and "plan.bytes" in launch and "plan.round_rows" in launch
    assert "const MmaPlan mma{plan.nwarp, plan.kv_rows, plan.bytes};" in src


def _mask_bytes(mask_rows: np.ndarray, Lk: int) -> np.ndarray:
    """``mask_bits``' layout: per row, ceil(Lk / 64) little-endian 64-bit
    words, byte kb holding keys 8 kb .. 8 kb + 7, bit i set where key
    8 kb + i is not 0; 0 past Lk."""
    nch = -(-Lk // K.MMA_CHUNK)
    keys = np.zeros((mask_rows.shape[0], nch * 64), dtype=bool)
    keys[:, :Lk] = mask_rows != 0
    return np.packbits(keys.reshape(len(keys), -1, 8), axis=-1, bitorder="little")[..., 0]


@pytest.mark.parametrize("Lk", [1, 30, 64, 65, 129, 256])
def test_mask_bits_are_read_back_as_the_mask(Lk):
    """Lane (g, t) of a warp reads key 8j + 2t + e of a chunk, for row g,
    as bit 8j + e of the row's chunk word shifted right by 2t."""
    rng = np.random.default_rng(Lk)
    mask = (rng.random((16, Lk)) < 0.6).astype(np.float32)
    mask[3] = 0.0
    nch = -(-Lk // K.MMA_CHUNK)
    words = _mask_bytes(mask, Lk).view("<u8").reshape(16, nch)
    for row in range(16):
        for c in range(nch):
            for t in range(4):
                x = int(words[row, c]) >> (2 * t)
                for j in range(8):
                    for e in range(2):
                        key = 64 * c + 8 * j + 2 * t + e
                        want = key < Lk and mask[row, key] != 0
                        assert bool((x >> (8 * j + e)) & 1) == want, (row, key)


def _inputs(rng, B, H, L, M, hd):
    def lens(n):
        return (np.arange(n)[None] < np.r_[0, rng.integers(1, n + 1, B - 1)][:, None]) \
            .astype(np.float32)

    fm, tm = lens(L), lens(M)
    fm[1, L // 2:] = 0.0  # wholly masked query rows in sample 1; sample 0 wholly masked
    q, fk, fv = (rng.standard_normal((B, H, L, hd)).astype(np.float32) for _ in range(3))
    tk, tv = (rng.standard_normal((B, H, M, hd)).astype(np.float32) for _ in range(2))
    return q, fk, fv, tk, tv, fm[:, :, None] * fm[:, None, :], fm[:, :, None] * tm[:, None, :]


@pytest.mark.parametrize("L,M", [(64, 30), (30, 64)])
def test_plain_versions_match_pallas_at_head_dim_192(L, M):
    """BackBoneAlignFeature's shapes (4 heads of 192, video 64 and text 30
    rows), cut to 2 samples and 2 heads: #2, and #1 over the cross branch."""
    args = _inputs(np.random.default_rng(L), 2, 2, L, M, 192)
    want = fused_dual_attention(*(jnp.asarray(a) for a in args), interpret=True)
    got = K.dual_attention_plain(*(torch.from_numpy(a) for a in args))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=KERNEL_ATOL)
    q, _, _, tk, tv, _, x_mask = args
    want = fused_masked_attention(*(jnp.asarray(a) for a in (q, tk, tv, x_mask)), interpret=True)
    got = K.masked_attention_plain(*(torch.from_numpy(a) for a in (q, tk, tv, x_mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL)
