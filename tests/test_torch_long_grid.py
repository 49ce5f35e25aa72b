"""The port at SeqPAN's longer grids (TACoS: vlen 256; ANet: vlen 100)
against the JAX package, on the CPU.

- the plain versions of #1-#3 against the Pallas kernels in interpret mode
  at L = 256 (1e-5), CQ attention both ways round (30 by 256 and 256 by 30,
  D = 128), as SeqPAN's two CQAttention calls give it;
- the port's SeqPAN forward at vlen 256 (dim 32, 2 heads: narrow, long)
  against the JAX forward on carried-over weights (1e-4, spans equal);
- the launch plans of the CUDA wrappers: #3's fits one block's shared
  memory for every grid of 1 to 1024 positions a side in both types, with
  no scratch at SeqPAN's grids, and #1/#2's staging is sized and checked
  as their plans (``attention_f32_plan``, ``attention_bf16_plan``) lay it out.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.kernels.attention import (fused_cq_attention, fused_dual_attention,
                                            fused_masked_attention)
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.weights import load_jax_params

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")
KERNEL_ATOL, MODEL_ATOL = 1e-5, 1e-4
TACOS = {"model.vlen": 256, "model.dim": 32, "model.num_heads": 2, "train.batch_size": 2}


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _lengths_mask(rng, B, L):
    """(B, L) {0,1} of random valid lengths; sample 0 wholly padded."""
    lens = rng.integers(1, L + 1, B)
    lens[0] = 0
    return (np.arange(L)[None] < lens[:, None]).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("Lc,Lq", [(30, 256), (256, 30)])
def test_cq_attention_plain_matches_pallas_on_long_grids(Lc, Lq):
    rng = np.random.default_rng(10)
    B, D = 2, 128
    bound = np.sqrt(6.0 / (D + 1))
    w = [((rng.random(s) * 2 - 1) * bound).astype(np.float32) for s in ((D, 1), (D, 1), (1, 1, D))]
    c_mask, q_mask = _lengths_mask(rng, B, Lc), _lengths_mask(rng, B, Lq)
    args = (_normal(rng, B, Lc, D), _normal(rng, B, Lq, D), *w, c_mask, q_mask)
    want = fused_cq_attention(*(jnp.asarray(a) for a in args), interpret=True)
    got = K.cq_attention_plain(*(_t(a) for a in args))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=KERNEL_ATOL)


def _attention_inputs(rng, B=2, H=2, L=256, M=30, hd=32):
    fm, tm = _lengths_mask(rng, B, L), _lengths_mask(rng, B, M)
    fm[1, L // 2:] = 0.0  # wholly masked query rows in sample 1
    q, fk, fv = (_normal(rng, B, H, L, hd) for _ in range(3))
    tk, tv = _normal(rng, B, H, M, hd), _normal(rng, B, H, M, hd)
    return q, fk, fv, tk, tv, fm[:, :, None] * fm[:, None, :], fm[:, :, None] * tm[:, None, :]


def test_masked_attention_plain_matches_pallas_at_256():
    q, fk, fv, _, _, s_mask, _ = _attention_inputs(np.random.default_rng(11))
    want = fused_masked_attention(*(jnp.asarray(a) for a in (q, fk, fv, s_mask)), interpret=True)
    got = K.masked_attention_plain(*(_t(a) for a in (q, fk, fv, s_mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL)


def test_dual_attention_plain_matches_pallas_at_256():
    args = _attention_inputs(np.random.default_rng(12))
    want = fused_dual_attention(*(jnp.asarray(a) for a in args), interpret=True)
    got = K.dual_attention_plain(*(_t(a) for a in args))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=KERNEL_ATOL)


def test_seqpan_forward_at_tacos_length_matches_jax():
    """vlen 256 against tlen 16: CQ attention runs 256 by 16 and 16 by 256,
    the dual blocks self-attend over 256 positions.  The JAX model is
    applied op by op (no ``jit``)."""
    jcfg = jload_config(CFG).updated(TACOS)
    ds, store = jmake_synthetic_data(jcfg, seed=0, n_train=2, n_test=2)
    jder = JDerived(num_words=ds["n_words"], num_chars=ds["n_chars"], num_train_steps=2,
                    steps_per_epoch=1)
    batch = next(JBatcher(ds["test_set"], store, jcfg, jder, "test").epoch(seed=0, shuffle=False))
    batch = {k: v for k, v in batch.items() if k != "num_valid"}
    assert batch["vfeats"].shape[1] == 256
    entry = jget_model_entry("SeqPAN")
    jmodel = entry.model_cls(jcfg, jder, ds["word_vector"])
    rng = jax.random.PRNGKey(0)
    variables = jmodel.init({"params": rng, "dropout": rng, "gumbel": rng}, batch, True)
    want = jmodel.apply(variables, batch, True)
    want_props = entry.infer_fn(want, batch, jcfg)

    cfg = load_config(CFG).updated(TACOS)
    port = get_model_entry("SeqPAN")
    model = port.model_cls(cfg, Derived(num_words=ds["n_words"], num_chars=ds["n_chars"]),
                           ds["word_vector"]).eval()
    load_jax_params(model, variables["params"], variables["constants"])
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        got = model(tb)
        got_props = port.infer_fn(got, tb, cfg)
    for key in ("slogits", "elogits", "match_score"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=MODEL_ATOL,
                                   err_msg=key)
    np.testing.assert_array_equal(got_props.numpy(), np.asarray(want_props))


@pytest.mark.parametrize("D", [128, 24])
@pytest.mark.parametrize("Lc", [1, 2, 16, 30, 64, 100, 127, 255, 256, 257, 511, 1000, 1024])
def test_cq_plan_fits_a_block_for_every_grid(Lc, D):
    """For every Lq from 1 to 1024, in both types: the plan fits 232,448
    bytes and is the layout the kernel computes; its chunks are whole
    granules, the output chunk within the staged one; the scores are shared
    whenever they fit with the narrowest chunks, else all of them go to the
    scratch."""
    for dtype in (torch.bfloat16, torch.float32):
        size, gran = torch.finfo(dtype).bits // 8, K.CQ_COLS[dtype]
        for Lq in range(1, K.CQ_MAX_LEN + 1):
            plan = K.cq_plan(Lc, Lq, D, dtype)
            stage, out, shared = plan["stage_cols"], plan["out_cols"], plan["scores_shared"]
            assert plan["shared_bytes"] <= K.SHARED_BYTES
            assert plan["shared_bytes"] == K.cq_shared_bytes(Lc, Lq, stage, out, size, shared)
            assert stage % gran == 0 and out % gran == 0
            assert gran <= out <= stage <= -(-D // gran) * gran
            lcp, lqp = -(-Lc // 16) * 16, -(-Lq // 16) * 16
            scores = 2 * lcp * (lqp + K.CQ_SCORE_PAD)
            assert plan["scratch_floats"] == (0 if shared else scores)
            narrowest = K.cq_shared_bytes(Lc, Lq, gran, gran, size, True)
            assert shared == (narrowest <= K.SHARED_BYTES)


def test_cq_plan_at_the_serving_grids():
    """SeqPAN's grids at Charades, ANet and TACoS width, both ways round,
    keep everything in shared memory in both types: nothing goes to a
    scratch.  In bf16 c and q are staged once (all of D); at 30 by 256 the
    outputs go in two chunks of 64 columns.  1024 by 30 needs the scratch."""
    for dtype in (torch.bfloat16, torch.float32):
        for Lc, Lq in ((64, 30), (30, 64), (100, 30), (30, 100), (256, 30), (30, 256)):
            plan = K.cq_plan(Lc, Lq, 128, dtype)
            assert plan["scores_shared"] == 1 and plan["scratch_floats"] == 0, (Lc, Lq, dtype)
            if dtype == torch.bfloat16:
                assert plan["stage_cols"] == 128
    assert K.cq_plan(30, 256, 128)["out_cols"] == 64
    assert K.cq_plan(1024, 30, 128)["scores_shared"] == 0


@pytest.mark.parametrize("Lc,Lq,D", [(1025, 30, 128), (30, 1025, 128), (0, 30, 128),
                                     (30, 30, 8193)])
def test_cq_plan_raises_beyond_what_the_kernel_takes(Lc, Lq, D):
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="1024"):
            K.cq_plan(Lc, Lq, D, dtype)


@pytest.mark.parametrize("Lq,Lks,hd", [(64, (64, 30), 32), (30, (30, 64), 32),
                                       (256, (256, 30), 32), (30, (30, 256), 128),
                                       (256, (256, 30), 128), (512, (512,), 64),
                                       (64, (64, 30), 192), (30, (30, 64), 192),
                                       (64, (64, 1), 32), (1, (1, 64), 32),
                                       (64, (64,), 256)])
def test_attention_staging_fits_at_the_grids_the_tests_use(Lq, Lks, hd):
    for dtype in (torch.bfloat16, torch.float32):
        assert K.attention_shared_bytes(dtype, Lq, Lks, hd) <= K.SHARED_BYTES
        K._check_attention(dtype, Lq, Lks, hd, "test")
    # bf16: the plan the wrapper passes; one round of query rows to 256
    # rows at head dim 32 (512 over 512 keys at 64 go in two)
    plan = K.attention_bf16_plan(Lq, Lks, hd)
    assert plan["shared_bytes"] == K.attention_shared_bytes(torch.bfloat16, Lq, Lks, hd)
    assert plan["round_rows"] >= (Lq if hd <= 32 or Lq <= 64 else 16)


def test_attention_limits_name_what_the_kernel_takes():
    # Charades: K and V of 64 and 32 (30 padded) keys, rows of 32 + 8
    # columns; then the 64 query rows, each with a 64-bit mask word a branch
    assert K.attention_shared_bytes(torch.bfloat16, 64, (64, 30), 32) == \
        2 * 40 * (2 * 64 + 2 * 32) + 64 * (2 * 40 + 8 * 2)
    # f32: the branches in turn through one K and one V buffer of the longer
    # branch's 64 keys, rows of 32 + 4 floats; Q in registers
    assert K.attention_shared_bytes(torch.float32, 64, (64, 30), 32) == 4 * 36 * 2 * 64
    # both types take head dims to 256 (bf16 past 128: Q read from its rows)
    for dtype in (torch.bfloat16, torch.float32):
        K._check_attention(dtype, 8, (8,), 144, "test")
        with pytest.raises(ValueError, match="head dims up to 256"):
            K._check_attention(dtype, 8, (8,), 264, "test")
    # AlignFeature's dual attention at D = 768, 4 heads: K and V of 64 and 32
    # (30 padded) keys at 192 + 8 columns, 64 query rows and their mask bits;
    # about 101 KB (the former body's per-warp tiles took 111,616 bytes)
    assert K.attention_shared_bytes(torch.bfloat16, 64, (64, 30), 192) == \
        2 * 200 * (2 * 64 + 2 * 32) + 64 * (2 * 200 + 8 * 2) == 103_424
    with pytest.raises(ValueError, match="shared memory"):
        K._check_attention(torch.bfloat16, 512, (512, 512), 128, "test")
    with pytest.raises(ValueError, match="at least 1"):
        K._check_attention(torch.float32, 8, (0,), 32, "test")
