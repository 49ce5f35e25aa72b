"""The port's serving path on the CPU: ``MomentRetrievalService`` with
``device="cpu"`` under concurrent ``predict`` calls, its HTTP API, checkpoint
loading, and the rule that entry points never fall back to the CPU on their
own.  (JAX is imported, as in every test process here, and kept on the CPU.)
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import json
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch

from vmrframe_tpu_torch.device import resolve_device
from vmrframe_tpu_torch.kernels import attention as K
from vmrframe_tpu_torch.tools.serve import build_service, make_cfg, make_http_server, selftest


def _tiny_cfg(batch_size=8, dtype="float32"):
    return make_cfg(vlen=16, tlen=8, vdim=32, dim=16, batch_size=batch_size,
                    compute_dtype=dtype)


@pytest.fixture(scope="module")
def served():
    service, dataset = build_service(_tiny_cfg(), n_synthetic=16, device="cpu")
    yield service, dataset
    service.close()
    assert not service._worker.is_alive()


def test_concurrent_predicts_are_micro_batched(served):
    service, dataset = served
    records = dataset["test_set"]
    before = service.metrics()
    launches = [fn.launches for fn in K.KERNELS]
    n = 40

    def one(i):
        rec = records[i % len(records)]
        return rec, service.predict(rec["vid"], rec["sentence"], rec["duration"], timeout=60)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: a lost counter update would show
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            results = list(ex.map(one, range(n)))
    finally:
        sys.setswitchinterval(interval)
    after = service.metrics()
    assert after["requests_ok"] - before["requests_ok"] == n
    assert after["requests_error"] == before["requests_error"]
    assert 1 <= after["batches"] - before["batches"] <= n
    assert after["device"] == "cpu"
    for rec, out in results:
        assert out["vid"] == rec["vid"] and out["sentence"] == rec["sentence"]
        s, e = out["pred_frac"]
        assert 0.0 <= s <= 1.0 and 0.0 <= e <= 1.0
        np.testing.assert_allclose(out["pred_time"], [s * rec["duration"], e * rec["duration"]],
                                   rtol=1e-6)
    # the same request gives the same answer, whatever batch it rode in
    rec, first = results[0]
    again = service.predict(rec["vid"], rec["sentence"], rec["duration"])
    np.testing.assert_allclose(again["pred_frac"], first["pred_frac"], atol=1e-6)
    # on the CPU the wrappers take the plain versions and launch nothing
    assert [fn.launches for fn in K.KERNELS] == launches


def test_http_round_trip(served):
    service, dataset = served
    server = make_http_server(service, 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"

    def post(body):
        req = urllib.request.Request(f"{url}/predict", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        rec = dataset["test_set"][0]
        one = post({"vid": rec["vid"], "sentence": rec["sentence"]})
        assert len(one["pred_time"]) == 2 and one["vid"] == rec["vid"]
        many = post([{"vid": r["vid"], "sentence": r["sentence"]}
                     for r in dataset["test_set"][:3]])
        assert [m["vid"] for m in many] == [r["vid"] for r in dataset["test_set"][:3]]
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as resp:
            assert json.loads(resp.read())["ok"] is True
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as resp:
            assert json.loads(resp.read())["default"]["requests_ok"] >= 4  # one entry per model
        with pytest.raises(urllib.error.HTTPError) as bad:
            post({"vid": "no-such-video", "sentence": "a person"})
        assert bad.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_selftest_over_http(served):
    service, dataset = served
    stats = selftest(service, dataset, 0, n_requests=24, concurrency=8)
    assert stats["requests"] == 24 and stats["device"] == "cpu"
    assert stats["qps"] > 0 and stats["p50_ms"] <= stats["p99_ms"]


def test_checkpoint_round_trip(served, tmp_path):
    service, _ = served
    path = tmp_path / "seqpan.pt"
    state = {k: v.clone() for k, v in service.evaluator.model.state_dict().items()}
    state["predictor.start_dense.bias"] += 1.0
    torch.save(state, path)
    other, _ = build_service(_tiny_cfg(), checkpoint=str(path), n_synthetic=16, device="cpu")
    try:
        got = other.evaluator.model.state_dict()
        assert set(got) == set(state)
        for k in state:
            torch.testing.assert_close(got[k], state[k], rtol=0, atol=0)
    finally:
        other.close()


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_service(_tiny_cfg(), n_synthetic=8)
    assert resolve_device("cpu") == torch.device("cpu")


def test_service_assembles_with_the_registered_batcher(served):
    from vmrframe_tpu_torch.data.batcher import Batcher

    service, _ = served
    assert service._batcher_cls is Batcher  # SeqPAN registers none: the base batcher


class _CountingStore:
    """A feature store that counts its reads."""

    def __init__(self, store):
        self.store, self.reads = store, 0

    def __contains__(self, vid):
        return vid in self.store

    def __getitem__(self, vid):
        self.reads += 1
        return self.store[vid]

    def lengths(self):
        return self.store.lengths()


def test_a_batch_reads_each_video_once_and_the_next_batch_reads_it_again(served):
    service, dataset = served
    rec = dataset["test_set"][0]
    store = _CountingStore(service.store)
    service.store = store
    try:
        records = [service._make_record(rec["vid"], s, rec["duration"])
                   for s in ("a person opens the door", "someone closes a window")]
        batch = service._assemble(records)
        assert store.reads == 1  # two requests, one video: one read
        np.testing.assert_array_equal(batch["vfeats"][0], batch["vfeats"][1])
        service._assemble(records[:1])
        assert store.reads == 2  # no cache outlives its batch
    finally:
        service.store = store.store


# ---------------------------------------------------------------- the router


@pytest.fixture(scope="module")
def routed():
    """SeqPAN, BackBone and BaseFast behind one ``ModelRouter`` over real
    HTTP, at a tiny width on the CPU."""
    from vmrframe_tpu_torch.tools.serve import ModelRouter

    services, dataset = {}, None
    for name, model in (("seqpan", "SeqPAN"), ("backbone", "BackBone"), ("basefast", "BaseFast")):
        cfg = make_cfg(vlen=16, tlen=8, vdim=32, dim=16, batch_size=4, compute_dtype="float32",
                       model=model)
        services[name], dataset = build_service(cfg, n_synthetic=16, device="cpu", flush_ms=1.0)
    router = ModelRouter(services)
    server = make_http_server(router, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield router, dataset, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    router.close()
    assert not any(s._worker.is_alive() for s in services.values())


def _call(url, body=None):
    """(status, JSON) of a GET, or of a POST when ``body`` is given."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_router_routes_by_path_then_body_then_default(routed):
    router, dataset, url = routed
    rec = dataset["test_set"][0]
    req = {"vid": rec["vid"], "sentence": rec["sentence"]}
    direct = {n: s.predict(rec["vid"], rec["sentence"])["pred_frac"]
              for n, s in router.services.items()}
    assert direct["seqpan"] != direct["backbone"] != direct["basefast"]
    code, out = _call(f"{url}/predict", req)
    assert (code, out["model"], out["pred_frac"]) == (200, "seqpan", direct["seqpan"])
    for name in router.services:
        code, out = _call(f"{url}/predict/{name}", req)
        assert (code, out["model"], out["pred_frac"]) == (200, name, direct[name])
        code, out = _call(f"{url}/predict", {**req, "model": name})
        assert (code, out["model"], out["pred_frac"]) == (200, name, direct[name])
    code, out = _call(f"{url}/predict/backbone", {**req, "model": "basefast"})  # the path wins
    assert (code, out["model"]) == (200, "backbone")
    code, many = _call(f"{url}/predict", [{**req, "model": "basefast"}, req])
    assert code == 200 and [m["model"] for m in many] == ["basefast", "seqpan"]
    for bad in (f"{url}/predict/nope", f"{url}/predict"):
        code, out = _call(bad, {**req, "model": "nope"})
        assert code == 400 and "unknown model" in out["error"]


def test_router_lists_models_health_and_metrics(routed):
    router, dataset, url = routed
    rec = dataset["test_set"][1]
    _call(f"{url}/predict/basefast", {"vid": rec["vid"], "sentence": rec["sentence"]})
    assert _call(f"{url}/models") == (200, {"models": ["backbone", "basefast", "seqpan"],
                                            "default": "seqpan"})
    code, health = _call(f"{url}/healthz")
    assert code == 200 and health["ok"] is True
    assert health["models"]["backbone"] == {"batch_size": 4, "model": "BackBone"}
    code, every = _call(f"{url}/metrics")
    assert code == 200 and set(every) == set(router.services)
    code, one = _call(f"{url}/metrics/basefast")
    assert code == 200 and one["requests_ok"] >= 1 and one["device"] == "cpu"
    assert _call(f"{url}/metrics/nope")[0] == 400
    assert _call(f"{url}/nothing")[0] == 404


def test_reload_swaps_weights_and_refuses_what_does_not_fit(routed, tmp_path):
    from vmrframe_tpu_torch.weights import init_weights

    router, dataset, url = routed
    rec = dataset["test_set"][2]
    req = {"vid": rec["vid"], "sentence": rec["sentence"]}
    service = router.get("backbone")
    before = _call(f"{url}/predict/backbone", req)[1]["pred_frac"]
    untouched = _call(f"{url}/predict/seqpan", req)[1]["pred_frac"]

    # other weights for BackBone: the same tree from another seed
    entry = service.evaluator.entry
    other = init_weights(entry.model_cls(service.cfg, service.derived,
                                         dataset["word_vector"]), seed=7).eval()
    path = tmp_path / "backbone.pt"
    torch.save(other.state_dict(), path)
    batch = service.evaluator.to_device(service._assemble(
        [service._make_record(rec["vid"], rec["sentence"], float(service.store.lengths()[rec["vid"]]))]))
    with torch.no_grad():
        want = entry.infer_fn(other(batch), batch, service.cfg)[0].tolist()

    assert _call(f"{url}/reload", {"model": "backbone", "checkpoint": str(path)}) == \
        (200, {"ok": True, "model": "backbone"})
    after = _call(f"{url}/predict/backbone", req)[1]["pred_frac"]
    assert after != before
    np.testing.assert_allclose(after, want, atol=1e-6)
    assert _call(f"{url}/predict/seqpan", req)[1]["pred_frac"] == untouched

    code, out = _call(f"{url}/reload", {"model": "backbone",
                                        "checkpoint": str(tmp_path / "missing.pt")})
    assert code == 400 and "FileNotFoundError" in out["error"]
    assert _call(f"{url}/reload", {"model": "nope", "checkpoint": str(path)})[0] == 400
    assert _call(f"{url}/reload", {"model": "backbone"})[0] == 400  # no checkpoint named

    # a checkpoint of another tree (BaseFast's), and one of another width: 500,
    # and nothing of them is loaded
    wrong = tmp_path / "basefast.pt"
    torch.save(router.get("basefast").evaluator.model.state_dict(), wrong)
    code, out = _call(f"{url}/reload", {"model": "backbone", "checkpoint": str(wrong)})
    assert code == 500 and "does not fit" in out["error"]
    wider = {k: (torch.zeros(v.shape[0] + 1, *v.shape[1:]) if k == "predictor.start_dense.bias"
                 else torch.zeros_like(v)) for k, v in other.state_dict().items()}
    torch.save(wider, wrong)
    code, out = _call(f"{url}/reload", {"model": "backbone", "checkpoint": str(wrong)})
    assert code == 500 and "predictor.start_dense.bias" in out["error"]
    assert _call(f"{url}/predict/backbone", req)[1]["pred_frac"] == after


@pytest.mark.parametrize("name,model,fused", [("seqpan_fused", "SeqPAN", True),
                                              ("backbone_fused", "BackBone", True),
                                              ("basefast", "BaseFast", False)])
def test_charades_width_config_files_state_what_make_cfg_builds(name, model, fused):
    from pathlib import Path

    from vmrframe_tpu_torch.config import load_config

    path = Path(__file__).resolve().parent.parent / "configs" / f"charades_{name}.yaml"
    want = make_cfg(model=model, fused_dual_stack=fused).to_dict()
    got = load_config(str(path)).to_dict()
    got["model"].setdefault("fused_dual_stack", False)
    assert got == want
