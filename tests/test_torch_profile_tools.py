"""The port's profiling and roofline tools on the CPU (``tools/roofline.py``,
``trace_profile.py``, ``roofline_trace.py``, ``profile_batch.py``,
``profile_seqpan.py``, ``profile_model.py``):

- the traffic count by hand: a matrix product is 2 M N K FLOPs and
  (M K + K N + M N) x itemsize bytes; an elementwise add reads both
  inputs and writes its output; a view moves nothing; an in-place add reads
  and writes its tensor, a copy reads its source and writes its target, a
  ``new_zeros`` reads nothing, a gather reads the rows it returns;
- each hand-written kernel counted once, by the tensors it reads and
  writes: its bytes equal ``tools/bench_kernels.py``'s count (``work``) for
  #1-#7 at its own cases, its FLOPs those of its plain version;
- the count's FLOPs on SeqPAN's eval step equal ``bench_zoo.count_flops``';
- each tool's JSON from one CPU rep at the tiny test configs (on the CPU
  the operations are the host's and each wrapper runs its plain version);
- ``roofline_trace``'s floors on a small trace written here, by hand
  arithmetic: the join by name and shapes, the byte rate of the probe at
  each call's bytes, the FLOPs of a product at its type's peak, the copies
  left out of ``floor_no_copies_ms``, a row under its floor reported;
- a profile on the card run again while the profiler sees no device time,
  and a streaming probe timed by events where it never does.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import json
import os

import pytest
import torch

from vmrframe_tpu_torch.tools import roofline
from vmrframe_tpu_torch.tools.h100 import PEAK_OPS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQPAN = os.path.join(REPO, "tests", "configs", "charades_seqpan.yaml")


def _one(traffic, op):
    rows = [r for r in traffic["ops"] if r["op"] == op]
    assert len(rows) == 1, (op, [r["op"] for r in traffic["ops"]])
    return rows[0]


# ---------------------------------------------------------------- hand counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_traffic_count_by_hand(dtype):
    M, K, N = 6, 5, 3
    a, b = torch.randn(M, K, dtype=dtype), torch.randn(K, N, dtype=dtype)
    size = a.element_size()
    mm = _one(roofline.count_traffic(lambda: a @ b), "aten::mm")
    assert mm["flops"] == 2 * M * N * K and mm["calls"] == 1
    assert mm["bytes"] == (M * K + K * N + M * N) * size
    assert mm["shapes"] == [[M, K], [K, N]] and mm["dtype"] == str(dtype).split(".")[-1]

    c = torch.randn(M, K, dtype=dtype)
    t = roofline.count_traffic(lambda: (a + c).view(K, M).t())
    assert [r["op"] for r in t["ops"]] == ["aten::add"]  # the views move nothing
    assert t["bytes"] == 3 * M * K * size and t["flops"] == 0

    x, y = torch.randn(M, K, dtype=dtype), torch.empty(M, K, dtype=dtype)
    assert _one(roofline.count_traffic(lambda: x.add_(1.0)), "aten::add_")["bytes"] \
        == 2 * M * K * size
    assert _one(roofline.count_traffic(lambda: y.copy_(x)), "aten::copy_")["bytes"] \
        == 2 * M * K * size
    assert _one(roofline.count_traffic(lambda: x.new_zeros(())), "aten::new_zeros")["bytes"] \
        == size  # the input gives its type alone
    table, ids = torch.randn(1000, K, dtype=dtype), torch.tensor([3, 7, 7])
    emb = _one(roofline.count_traffic(lambda: torch.nn.functional.embedding(ids, table)),
               "aten::embedding")
    assert emb["bytes"] == 2 * 3 * K * size + 3 * 8


def test_kernel_bytes_equal_bench_kernels():
    """#1-#7 at the cases ``bench_kernels`` times (batch 2; the banded ones
    at T 384, 4 heads of 8), f32: one operation of the kernel's name,
    bytes equal to ``work``'s, FLOPs those its plain version counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from vmrframe_tpu_torch.kernels import attention as K
    from vmrframe_tpu_torch.kernels import dual_stack as S
    from vmrframe_tpu_torch.kernels import window_attention as W
    from vmrframe_tpu_torch.tools import bench_kernels as BK

    g = torch.Generator().manual_seed(0)
    names = BK.ATTENTION + (BK.STACK,)
    cases = BK.table_cases(g, names, batch=2)[0]
    cases["banded_attention"] = BK.banded_cases(g, (384,), batch=2, hd=8)
    for name in BK.BWD_KERNELS:
        cases[name] = BK.banded_bwd_cases(g, (384,), hd=8)
    fns = BK.functions(K, W, S)
    assert set(cases) == set(BK.KERNEL_NAMES)
    for name, shapes in cases.items():
        wrapper, plain = fns[name]
        for args in shapes:
            args = BK.cast_args(name, args, torch.float32)
            with torch.no_grad():
                traffic = roofline.count_traffic(lambda: wrapper(*args))
            row = _one(traffic, f"vmr::{name}")
            assert row["calls"] == 1 and row["bytes"] == BK.work(name, args)[0], name
            counter = FlopCounterMode(display=False)
            with counter, torch.no_grad():
                plain(*args)
            assert row["flops"] == counter.get_total_flops() > 0, name


def test_traffic_flops_equal_bench_zoo_count():
    from vmrframe_tpu_torch.tools import bench_zoo

    cfg, trainer, train, test = bench_zoo.build_from(SEQPAN, {}, "cpu")
    want = bench_zoo.count_flops(trainer, test, train=False)
    got = roofline.count_traffic(lambda: trainer.eval_step(test))
    assert got["flops"] == want > 0
    assert got["bytes"] > 0 and {r["op"] for r in got["ops"]} >= {
        "vmr::fused_masked_attention", "vmr::fused_dual_attention", "vmr::fused_cq_attention"}


# ------------------------------------------------------- the tools' JSON


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """roofline, trace_profile and roofline_trace run once at the tiny config."""
    from vmrframe_tpu_torch.tools import roofline_trace, trace_profile

    d = tmp_path_factory.mktemp("tools")
    common = ["--device", "cpu", "--config", SEQPAN, "--steps", "1", "--reps", "1"]
    roof = roofline.main(common + ["--batches", "4", "--chunk", "2", "--small",
                                   "--out", str(d / "roofline.json")])
    trace = trace_profile.main(common + ["--batch", "4", "--out", str(d / "trace.json")])
    rt = roofline_trace.main(["--trace", str(d / "trace.json"), "--probe",
                              str(d / "roofline.json"), "--out", str(d / "rt.json")])
    return {"dir": d, "roofline": roof, "trace": trace, "roofline_trace": rt}


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_roofline_writes_its_rows(outputs):
    rep = _json(outputs["dir"] / "roofline.json")
    probes = rep["probes"]
    assert probes["hbm"]["best_bytes_per_s"] > 0 and probes["launch"]["ms_per_kernel"] > 0
    assert probes["chain"]["best_bytes_per_s"] > 0
    (row,) = rep["rows"]
    assert row["batch"] == 4 and row["chunk"] == 2
    for key in ("measured_ms", "floor_ms", "measured_over_floor", "gflop", "traffic_mb",
                "device_ops", "qps"):
        assert row[key] > 0, key
    assert row["floor_ms"] == max(row["bytes_ms"], row["launch_ms"], row["flops_ms"])


def test_trace_profile_writes_its_rows(outputs):
    rep = _json(outputs["dir"] / "trace.json")
    assert rep["model"] == "SeqPAN_fwd_infer" and rep["batch"] == 4
    assert rep["rows"] and rep["top_sinks"] and rep["counted"]["ops"]
    assert abs(rep["ops_ms_per_step"] - rep["device_busy_ms_per_step"]) < 1e-6
    # on the CPU each wrapper runs its plain version inside its launch range
    assert rep["kernel_launches_per_step"] == {"#1": 2.0, "#2": 4.0, "#3": 2.0, "#4": 0.0,
                                               "#5": 0.0, "#6": 0.0, "#7": 0.0}
    cats = {r["category"] for r in rep["rows"]}
    assert {"gemm", "kernel #1", "kernel #2", "kernel #3"} <= cats
    assert all(r["chain"] for r in rep["rows"])


def test_roofline_trace_joins_the_cpu_trace(outputs):
    rt = _json(outputs["dir"] / "rt.json")
    assert rt["groups"] and rt["floor_ms"] > 0
    assert rt["floor_no_copies_ms"] <= rt["floor_ms"]
    joined = {g["op"] for g in rt["groups"]}
    assert {"vmr::fused_dual_attention", "aten::mm"} <= joined


def test_profile_batch_writes_its_rows(tmp_path):
    from vmrframe_tpu_torch.tools import profile_batch

    rep = profile_batch.main(["--device", "cpu", "--config", SEQPAN, "--batches", "2,4",
                              "--chunk", "2", "--steps", "1", "--reps", "1",
                              "--out", str(tmp_path / "pb.json")])
    assert _json(tmp_path / "pb.json") == json.loads(json.dumps(rep))
    assert [r["batch"] for r in rep["rows"]] == [2, 4]
    for row in rep["rows"]:
        for key in ("roll_only_ms", "fwd_only_ms", "fwd_infer_ms", "qps_fwd_infer", "gflop",
                    "traffic_mb", "device_ops"):
            assert row[key] > 0, key
    # the counted work doubles with the batch
    assert rep["rows"][1]["gflop"] == pytest.approx(2 * rep["rows"][0]["gflop"])


@pytest.mark.parametrize("grad", [False, True])
def test_profile_seqpan_writes_its_blocks(tmp_path, grad):
    from vmrframe_tpu_torch.tools import profile_seqpan

    rep = profile_seqpan.main(["--device", "cpu", "--config", SEQPAN, "--batch", "4",
                               "--steps", "1", "--reps", "1", "--out", str(tmp_path / "ps.json")]
                              + (["--grad"] if grad else []))
    assert set(profile_seqpan.BLOCKS) <= set(rep["ms"]) and "full_forward" in rep["ms"]
    assert ("infer_span" in rep["ms"]) != grad
    assert all(ms > 0 for ms in rep["ms"].values()) and rep["sum_weighted_blocks"] > 0
    assert _json(tmp_path / "ps.json")["grad"] == grad


def test_profile_model_writes_its_pieces(tmp_path):
    from vmrframe_tpu_torch.tools import bench_zoo, profile_model

    rep = profile_model.main(["--model", "BAN", "--device", "cpu", "--steps", "1", "--reps",
                              "1", "--out", str(tmp_path / "pm.json")])
    assert list(rep["pieces"]) == list(profile_model.PIECES)
    for row in rep["pieces"].values():
        assert row["ms"] > 0 and row["gflop"] > 0 and row["device_ops"] > 0
    # the train pieces read bench_zoo's train count, eval_step its eval count
    _, trainer, train, test = bench_zoo.build("BAN", "cpu")
    assert rep["pieces"]["full_train"]["gflop"] * 1e9 == pytest.approx(
        bench_zoo.count_flops(trainer, train, True), rel=1e-12)
    assert rep["pieces"]["eval_step"]["gflop"] * 1e9 == pytest.approx(
        bench_zoo.count_flops(trainer, test, False), rel=1e-12)
    assert rep["pieces"]["fwd_loss"]["gflop"] < rep["pieces"]["loss_and_grad"]["gflop"]


# ------------------------------------------------------ floors by hand


def test_roofline_trace_floors_by_hand():
    from vmrframe_tpu_torch.tools import roofline_trace as RT

    probe = {"points": [[1000, 1e9], [4000, 2e9], [16000, 4e9]]}
    assert roofline.rate_at(probe, 3000) == 4e9 and roofline.rate_at(probe, 1e6) == 4e9
    assert roofline.rate_at(probe, 16000) == 4e9
    # past the cache's size the rate falls: the window reaches down to half the traffic
    probe = {"points": [[1000, 1e9], [4000, 3e9], [16000, 2e9]]}
    assert roofline.rate_at(probe, 5000) == 3e9 and roofline.rate_at(probe, 500) == 3e9
    assert roofline.rate_at(probe, 10000) == 2e9
    counted = [
        # a product: 2 calls of 8000 bytes, 2e9 FLOPs each
        {"op": "aten::mm", "shapes": [[100, 10], [10, 20]], "dtype": "float32", "calls": 2,
         "flops": 4e9, "bytes": 16000},
        # a cast called from Python; an explicit copy of the same shapes elsewhere
        {"op": "aten::_to_copy", "shapes": [[50]], "dtype": "float32", "calls": 1,
         "flops": 0, "bytes": 300},
        {"op": "aten::copy_", "shapes": [[50], [50]], "dtype": "float32", "calls": 1,
         "flops": 0, "bytes": 400},
        {"op": "vmr::fused_masked_attention", "shapes": [], "dtype": "bfloat16", "calls": 2,
         "flops": 2e6, "bytes": 2000},
    ]
    rows = [
        {"name": "gemm_kernel", "chain": [["aten::mm", [[100, 10], [10, 20]]],
                                          ["aten::matmul", [[100, 10], [10, 20]]]],
         "category": "gemm", "ms_per_step": 0.05, "launches_per_step": 2},
        {"name": "Memcpy DtoD", "chain": [["aten::copy_", [[50], [50], []]],
                                          ["aten::_to_copy", [[50], [], []]]],
         "category": "copy/layout", "ms_per_step": 0.002, "launches_per_step": 1},
        {"name": "attention_mma", "chain": [["vmr::fused_masked_attention", []]],
         "category": "kernel #1", "ms_per_step": 0.01, "launches_per_step": 2},
        {"name": "elementwise_kernel", "chain": [["aten::mul", [[7]]]],
         "category": "elementwise", "ms_per_step": 0.003, "launches_per_step": 1},
    ]
    trace = {"rows": rows, "counted": {"ops": counted}, "step_ms": 0.5, "model": "m"}
    res = RT.decompose(trace, {"points": [[1000, 1e9], [4000, 2e9], [16000, 4e9]]})
    by_op = {g["op"]: g for g in res["groups"]}
    # mm: 8000 bytes a call at 4e9 (2e-6 s) against 2e9 FLOPs at the f32 peak
    mm = 2 * max(8000 / 4e9, 2e9 / PEAK_OPS[torch.float32]) * 1e3
    # the memcpy joins the cast that launched it (the outermost counted
    # operation of its chain), not the explicit copy: the best rate at 150
    # bytes or more
    copy = 300 / 4e9 * 1e3
    attn = 2 * max(1000 / 4e9, 1e6 / PEAK_OPS[torch.bfloat16]) * 1e3
    assert set(by_op) == {"aten::mm", "aten::_to_copy", "vmr::fused_masked_attention"}
    assert by_op["aten::mm"]["floor_ms"] == pytest.approx(mm)
    assert by_op["aten::_to_copy"]["floor_ms"] == pytest.approx(copy)
    assert by_op["vmr::fused_masked_attention"]["floor_ms"] == pytest.approx(attn)
    assert res["floor_ms"] == pytest.approx(mm + copy + attn)
    assert res["floor_no_copies_ms"] == pytest.approx(mm + attn)
    assert res["unjoined_ms"] == pytest.approx(0.003) and res["unjoined_ops"] == 1
    assert res["ops_ms_per_step"] == pytest.approx(0.065)
    # 0.05 ms measured against mm's floor of 0.0597: below it, reported
    assert [g["op"] for g in res["below_floor"]] == ["aten::mm"]
    assert res["min_measured_over_floor"] == pytest.approx(0.05 / mm)


def test_device_profile_runs_a_pass_again_while_the_profiler_sees_nothing(monkeypatch):
    """On the card a pass in which the profiler recorded no device operation
    is run again, up to ``PROFILE_TRIES`` passes: the first pass that sees
    device time is the report, and ``profile_passes`` counts the passes."""
    import contextlib

    from vmrframe_tpu_torch.tools import profile_serve as PS

    reports = iter([None, None, 0.5])
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(PS, "PROFILE_PAUSE_S", 0.0)
    monkeypatch.setattr(PS, "_card_report",
                        lambda prof, steps, ops: {"device_busy_ms_per_step": next(reports)})
    steps = []
    rep = PS._device_profile(lambda: steps.append(1), 2, device="cuda")
    assert rep == {"device_busy_ms_per_step": 0.5, "profile_passes": 3} and len(steps) == 6

    monkeypatch.setattr(PS, "_card_report",
                        lambda prof, steps, ops: {"device_busy_ms_per_step": None})
    rep = PS._device_profile(lambda: None, 2, device="cuda")
    assert rep == {"device_busy_ms_per_step": None, "profile_passes": PS.PROFILE_TRIES}


def test_probe_times_by_events_where_the_profiler_sees_nothing(monkeypatch):
    """A streaming probe the profiler saw no device time of in any pass is
    timed by ``bench_kernels.device_ms`` (CUDA events on the card, the host
    clock here) and says so; the others keep the profiler's time."""
    from vmrframe_tpu_torch.tools import profile_serve as PS

    monkeypatch.setattr(PS, "_device_profile",
                        lambda fn, reps, device: {"device_busy_ms_per_step": None})
    hbm = roofline.measure_hbm_bw("cpu", roofline.SMALL_PROBE_SIZES[:1], reps=1)
    (rates,) = hbm["by_buffer_size"].values()
    assert set(rates) == {"copy", "add", "sum", "zero", "cast"}
    assert all(r["timer"] == "cuda_events" and r["bytes_per_s"] > 0 for r in rates.values())
    monkeypatch.undo()
    hbm = roofline.measure_hbm_bw("cpu", roofline.SMALL_PROBE_SIZES[:1], reps=1)
    assert {r["timer"] for r in next(iter(hbm["by_buffer_size"].values())).values()} \
        == {"profiler"}
