"""The port's measurement tools on the CPU: ``bench_zoo``'s FLOP count
against a count by hand and across routes, and one tiny run of each of
``bench_zoo``, ``bench_kernels``, ``bench_pipeline`` and ``flag_sweep``
writing valid JSON (``--device cpu``, where each kernel wrapper runs its
plain version).

The hand counts add up each matrix product and convolution of the eval
step (forward, loss, inference) at the test configs: 2 m k n for an
(m, k) x (k, n) product, 2 out_numel in_channels k for a convolution.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import json
import os

import pytest
import torch

from vmrframe_tpu_torch.tools import bench_zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQPAN, BAN = "tests/configs/charades_seqpan.yaml", "tests/configs/charades_ban.json"
LONG = "configs/tacos_actionformer_long.yaml"
AF_TINY = {  # the long config cut as tests/test_torch_actionformer.py cuts it, batch 2
    "train.batch_size": 2, "train.compute_dtype": "float32",
    "model.vlen": 512, "model.vdim": 24, "model.word_dim": 16, "model.char_dim": 8,
    "actionformer.backbone_arch": [1, 2, 3], "actionformer.input_dim": 24,
    "actionformer.embd_dim": 32, "actionformer.fpn_dim": 32, "actionformer.head_dim": 32,
    "actionformer.n_head": 2, "actionformer.max_seq_len": 512,
}


def mm(m, k, n):
    return 2 * m * k * n


def seqpan_eval_flops(B, Lv, Lt, D, H, vdim, word_dim, char_dim, n_char,
                      char_ch=(10, 20, 30, 40), K=7, layers=4):
    """SeqPAN's eval step by hand."""
    hd = D // H
    # char convs (kernel k, no padding), the word+char projection, the video's
    f = sum(2 * B * Lt * ch * (n_char - k + 1) * char_dim * k for k, ch in enumerate(char_ch, 1))
    f += mm(B * Lt, word_dim + sum(char_ch), D) + mm(B * Lv, vdim, D)

    def enc(L):  # a feature encoder: depthwise and pointwise convs
        return layers * (2 * B * D * L * K + mm(B * L, D, D))

    def dual(Lx, Ly):  # one DualAttentionBlock call
        g = mm(B * Lx, D, 3 * D) + mm(B * Ly, D, 2 * D)  # q, f_k, f_v; t_k, t_v
        g += 2 * mm(B * H * Lx, hd, Lx) + 2 * mm(B * H * Lx, hd, Ly)  # scores and p v, each side
        g += 2 * mm(D, D, D)  # the two folded dense-then-gate weights
        return g + mm(B * Lx, D, 9 * D)  # bilinear, dense, gate and block projections

    def cq(Lc, Lq):  # CQAttention: scores, c2q, S_t^T c, q2c; w4C, w4Q; the linear
        return 4 * mm(B * Lc, D, Lq) + mm(B * Lc, D, 1) + mm(B * Lq, D, 1) \
            + mm(B * Lc, 4 * D, D)

    f += enc(Lv) + enc(Lt) + 2 * (dual(Lv, Lt) + dual(Lt, Lv)) + cq(Lv, Lt) + cq(Lt, Lv)
    f += mm(B * Lt, D, 1) + mm(B * D, Lt, 1) + mm(B * Lv, 2 * D, D)  # weighted pool, concat
    f += mm(B * Lv, D, 4) + mm(B * Lv, 4, D)  # match head: logits, label embeddings
    pred = enc(Lv) + mm(B * Lv, D, 3 * D) + 2 * mm(B * H * Lv, hd, Lv) + 2 * mm(B * Lv, D, D)
    f += 2 * pred + 2 * mm(B * Lv, 2 * D, D) + 2 * mm(B * Lv, D, 1)  # start, end
    return f + mm(4, D, 4)  # the label embeddings' Gram matrix in the loss


def ban_eval_flops(B, Lv, Lt, Nv, Nt, vdim, qdim, dim, F, C, P, K, hg):
    """BAN's eval step by hand; Nv, Nt: valid video and text steps, K: the
    2D map's valid cells."""
    def lstm(N, i, h):  # both directions over N valid steps
        return 2 * (mm(N, i, 4 * h) + mm(N, h, 4 * h))

    f = lstm(Nv, vdim, dim) + lstm(Nt, qdim, dim)
    f += mm(B * Lv, F, 1) + mm(B * Lt, F, 1) + mm(B * Lv, F, Lt) + mm(B * Lv, Lt, F) \
        + mm(B * Lv, Lt, Lv) + mm(B * Lv, Lv, F)  # CQ attention
    f += lstm(Nv, 4 * F, dim)  # the cross encoder
    f += lstm(B * Lv, F, F) + lstm(B * Lv, 2 * F, F) + mm(B * Lv, 2 * F, F)  # boundary stream
    f += 2 * mm(B * Lv, F, F) + mm(B * K, F, F)  # the map's three terms
    f += mm(B * (K + 1), F, F) + mm(B * (K + 1), F, 1)  # predictor (+ the sentinel cell)
    f += mm(B * (K + 1), F, C) + mm(B * (K + 1), C, C)  # contrast encoder
    f += mm(B, 2 * dim, C) + mm(B, C, C)  # sentence projection
    f += mm(B * P, F + 2 * dim, F)  # proposals' position features
    f += mm(B * P * P, 2 * F, hg) + mm(B * P * P, 2 * hg, hg)  # two GCN blocks
    f += mm(B * P, hg, F) + mm(B * P, F, 1) + mm(B * P, hg, F) + mm(B * P, F, 2)
    return f + mm(B * K, C, 1)  # the contrastive similarity in the loss


def _eval_count(path, overrides=None):
    cfg, trainer, train, test = bench_zoo.build_from(path, overrides or {}, "cpu")
    return cfg, trainer, train, test, bench_zoo.count_flops(trainer, test, train=False)


def test_seqpan_count_is_the_hand_count():
    cfg, trainer, _, test, flops = _eval_count(SEQPAN)
    m = cfg.model
    n_char = test["char_ids"].shape[2]
    assert flops == seqpan_eval_flops(int(cfg.train.batch_size), m.vlen, m.tlen, m.dim,
                                      m.num_heads, m.vdim, m.word_dim, m.char_dim, n_char)


def test_ban_count_is_the_hand_count():
    from vmrframe_tpu_torch.data.labels import mask2d

    cfg, trainer, _, test, flops = _eval_count(BAN)
    m, g = cfg.model, cfg.gcn
    K = int(mask2d(m.vlen, m.pooling_counts).sum())
    P = m.topk * (m.neighbor + 1) + m.negative
    assert flops == ban_eval_flops(
        int(cfg.train.batch_size), m.vlen, m.tlen, int(test["vlens"].sum()),
        int(test["tlens"].sum()), m.vdim, m.query_embed_dim, m.dim, m.fuse_dim,
        m.contrast_dim, P, K, g.hidden_size)


def test_train_count_holds_the_backward():
    """The train count is the forward's and its backward's: more than twice
    the eval forward's, under four times it."""
    _, trainer, train, test, eval_flops = _eval_count(BAN)
    train_flops = bench_zoo.count_flops(trainer, train, train=True)
    assert 2 * eval_flops < train_flops < 4 * eval_flops


def test_count_does_not_depend_on_the_route():
    """The stack's flag (one #4 launch against four of #2) and ActionFormer's
    banded threshold (the kernels against the band-mask route) leave the
    count as it is, in eval and in train; the buffers come back unchanged."""
    counts = []
    for flag in (False, True):
        _, trainer, train, test, flops = _eval_count(SEQPAN, {"model.dim": 128,
                                                              "model.fused_dual_stack": flag})
        counts.append(flops)
    assert counts[0] == counts[1]
    counts = []
    for min_len in (256, -1):
        _, trainer, train, test = bench_zoo.build_from(
            LONG, {**AF_TINY, "actionformer.pallas_min_len": min_len}, "cpu")
        before = {k: v.clone() for k, v in trainer.model.named_buffers()}
        counts.append((bench_zoo.count_flops(trainer, test, train=False),
                       bench_zoo.count_flops(trainer, train, train=True)))
        for k, v in trainer.model.named_buffers():
            assert torch.equal(v, before[k])
    assert counts[0] == counts[1]


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_bench_zoo_writes_a_row(tmp_path):
    out = tmp_path / "zoo.json"
    rows = bench_zoo.main(["--models", "BAN", "--device", "cpu", "--steps", "1", "--reps", "1",
                           "--out", str(out)])
    row = _json(out)["results"][0]
    assert rows[0]["model"] == row["model"] == "BAN" and "error" not in row
    for key in ("train_ms_per_step", "eval_ms_per_step", "train_gflops_per_step",
                "eval_gflops_per_step", "train_mfu_pct", "eval_mfu_pct"):
        assert row[key] > 0, key
    assert row["train_launches_per_step"]["fused_dual_attention"] == 0  # no kernel in BAN


def test_bench_kernels_writes_a_row(tmp_path):
    from vmrframe_tpu_torch.tools import bench_kernels

    out = tmp_path / "kernels.json"
    bench_kernels.main(["--device", "cpu", "--batch", "2", "--kernels", "fused_masked_attention",
                        "--no-jax-shapes", "--out", str(out)])
    (row,) = _json(out)["kernels"]
    assert row["name"] == "fused_masked_attention"
    assert row["replaces"] == "vmrframe_tpu/kernels/attention.py:65"
    assert row["ms"] > 0 and row["plain_ms"] > 0 and row["library_ms"] > 0
    assert row["bound_ms"] > 0 and row["bound_by"] in ("bytes", "operations")


def test_f32_attention_bound_counts_the_3xtf32_rate():
    """#1/#2's f32 products run on the tensor cores as three TF32 products
    each: their bound divides by a third of TF32's peak, not by the CUDA
    cores' f32 rate; every other kernel's f32 keeps the f32 peak.  At TACoS
    width (B 128, 4 heads of 32, 256 queries over 256 keys) bytes bound #1."""
    from vmrframe_tpu_torch.tools import bench_kernels, h100

    f32, bf16 = torch.float32, torch.bfloat16
    assert h100.peak_ops(f32, "vmr::fused_dual_attention") == h100.TF32X3_OPS == 165e12
    assert h100.peak_ops("float32", "fused_masked_attention") == h100.TF32X3_OPS
    assert h100.peak_ops(f32, "fused_cq_attention") == h100.peak_ops(f32) == h100.PEAK_OPS[f32]
    assert h100.peak_ops(bf16, "fused_masked_attention") == h100.PEAK_OPS[bf16]
    q, mask = torch.empty(128, 4, 256, 32, device="meta"), torch.empty(128, 256, 256,
                                                                       device="meta")
    nbytes, ops = bench_kernels.work("fused_masked_attention", (q, q, q, mask))
    ms, by = bench_kernels.bound_ms("fused_masked_attention", (q, q, q, mask))
    assert by == "bytes" and ms == nbytes / h100.HBM_BYTES_PER_S * 1e3
    assert ops / h100.TF32X3_OPS < nbytes / h100.HBM_BYTES_PER_S < ops / h100.PEAK_OPS[f32]


def test_banded_f32_bound_counts_the_3xtf32_rate():
    """#5-#7's f32 products run in 3xTF32 too; at the long config's training
    shapes (B 2, 4 heads of 128, window 19) bytes bound the forward all the
    same: 0.00775 ms launch-weighted over T 2304 x2, 1152, 576."""
    from vmrframe_tpu_torch.tools import bench_kernels, h100

    for name in ("banded_attention", "banded_attention_dq", "banded_attention_dkv"):
        assert h100.peak_ops(torch.float32, name) == h100.TF32X3_OPS
    assert h100.peak_ops(torch.bfloat16, "banded_attention") == h100.PEAK_OPS[torch.bfloat16]
    rows = []
    for T, launches in bench_kernels.AF_LAUNCHES.items():
        qkv = torch.empty(bench_kernels.B_TRAIN, T, 3 * 4 * 128, device="meta")
        mask = torch.empty(bench_kernels.B_TRAIN, T, device="meta")
        ms, by = bench_kernels.bound_ms("banded_attention", (qkv, mask))
        nbytes, ops = bench_kernels.work("banded_attention", (qkv, mask))
        assert by == "bytes" and ops / h100.TF32X3_OPS < nbytes / h100.HBM_BYTES_PER_S
        rows.append((launches, ms))
    weighted = sum(n * ms for n, ms in rows) / sum(n for n, _ in rows)
    assert abs(weighted - 0.00775) < 5e-6


def test_bench_pipeline_writes_a_case(tmp_path):
    from vmrframe_tpu_torch.tools import bench_pipeline

    out = tmp_path / "pipeline.json"
    bench_pipeline.main(["--device", "cpu", "--batch-size", "2", "--warmup", "1", "--steps",
                         "1", "--cases", "charades_seqpan_erosion", "--out", str(out)])
    (case,) = _json(out)["results"]
    assert not case["host"]["device_pipeline"] and case["device"]["device_pipeline"]
    assert case["host"]["augmentation"] == ["erosion"] and case["speedup"] > 0


def test_flag_sweep_alternates_fresh_processes(tmp_path, monkeypatch):
    from vmrframe_tpu_torch.tools import flag_sweep

    monkeypatch.setitem(flag_sweep.SWEEPS, "tiny", (
        SEQPAN, "eval", {"model.dim": 128, "model.fused_dual_stack": False},
        {"model.dim": 128, "model.fused_dual_stack": True}))
    out = tmp_path / "sweep.json"
    flag_sweep.main(["--sweeps", "tiny", "--device", "cpu", "--pairs", "1", "--steps", "1",
                     "--reps", "1", "--out", str(out)])
    (res,) = _json(out)["results"]
    assert res["sweep"] == "tiny" and len(res["A"]["ms"]["runs"]) == 1
    assert res["ratio_b_over_a"] > 0 and res["pair_ratios"]


@pytest.mark.parametrize("name", ["bench_zoo", "bench_kernels", "bench_pipeline", "flag_sweep",
                                  "roofline", "trace_profile", "roofline_trace",
                                  "profile_batch", "profile_seqpan", "profile_model"])
def test_tools_never_write_the_jax_packages_docs(name):
    """Their default ``--out`` lies under ``chiprun_out/``, never ``docs/``."""
    import importlib

    mod = importlib.import_module(f"vmrframe_tpu_torch.tools.{name}")
    src = open(mod.__file__).read()
    assert 'default="chiprun_out/' in src and "docs/" not in src.replace("``docs/*.json``", "")
