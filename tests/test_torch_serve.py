"""The port's serving path on the CPU: ``MomentRetrievalService`` with
``device="cpu"`` under concurrent ``predict`` calls, its HTTP API, checkpoint
loading, and the rule that entry points never fall back to the CPU on their
own.  (JAX is imported, as in every test process here, and kept on the CPU.)
"""

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
            assert json.loads(resp.read())["requests_ok"] >= 4
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
