"""Batched moment-retrieval serving (counterpart of ``vmrframe_tpu/tools/serve.py``).

- ``MomentRetrievalService`` turns (vid, sentence) requests into predicted
  [start, end] seconds: concurrent requests queue up and run together when
  ``batch_size`` have gathered or ``flush_ms`` has passed, one static-shape
  batch per forward (``train/evaluator.py``), on ``cuda`` by default;
- a localhost HTTP JSON API (stdlib ``ThreadingHTTPServer``):
  POST /predict {"vid": ..., "sentence": ...} or a list of them,
  GET /healthz, GET /metrics;
- ``--selftest`` boots the service on synthetic data, fires concurrent
  requests through real HTTP and prints latency percentiles and throughput.

The config is built in code (``make_cfg``: SeqPAN at Charades width) unless
``--config`` names a YAML file.  ``--checkpoint`` takes a ``torch.save``d
state_dict or an ``.npz`` of the JAX package's variables.

Usage:
  python -m vmrframe_tpu_torch.tools.serve --selftest [--device cuda]
  python -m vmrframe_tpu_torch.tools.serve --synthetic --port 8901
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from vmrframe_tpu_torch.config import Config, Derived, load_config


def make_cfg(vlen: int = 64, tlen: int = 30, vdim: int = 1024, dim: int = 128,
             batch_size: int = 128, compute_dtype: str = "bfloat16") -> Config:
    """SeqPAN at the width of its Charades-STA config."""
    return Config({
        "task": "charades",
        "train": {"batch_size": batch_size, "compute_dtype": compute_dtype},
        "dataprocess": {"video_augmentation": {"unchanged": None},
                        "sample_type": "truncation", "label_threshold": 0.01},
        "model": {"name": "SeqPAN", "vlen": vlen, "tlen": tlen, "vdim": vdim, "dim": dim,
                  "num_heads": 4, "word_dim": 300, "char_dim": 100, "droprate": 0.2},
    })


class MomentRetrievalService:
    """Owns an Evaluator; micro-batches requests onto its device."""

    def __init__(self, cfg, derived, word_dict, char_dict, word_vector, feature_store,
                 checkpoint: Optional[str] = None, batch_size: Optional[int] = None,
                 flush_ms: float = 5.0, device=None, seed: int = 0):
        from vmrframe_tpu_torch.train.evaluator import Evaluator

        self.cfg = cfg
        self.derived = derived
        self.word_dict = word_dict
        self.char_dict = char_dict
        self.store = feature_store
        self.batch_size = int(batch_size or cfg.train.batch_size)
        self.flush_ms = float(flush_ms)
        self.evaluator = Evaluator(cfg, derived, word_vector, device=device, seed=seed)
        if checkpoint:
            from vmrframe_tpu_torch.weights import load_checkpoint

            load_checkpoint(self.evaluator.model, checkpoint)
        self._stats_lock = threading.Lock()
        self._latencies: List[float] = []  # ring buffer, last 4096
        self._n_ok = 0
        self._n_err = 0
        self._n_batches = 0
        # pay the kernels' build and the first launches before serving traffic
        warm_vid = next(iter(feature_store.lengths()))
        self._run(self._assemble([self._make_record(warm_vid, "warm up", 1.0)]))

        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._worker.start()

    # ---------- request -> record -> batch ----------

    def _make_record(self, vid: str, sentence: str, duration: float) -> dict:
        from vmrframe_tpu_torch.data.tokenize import word_tokenize

        words = word_tokenize(sentence)[: int(self.cfg.model.tlen)]
        unk = self.word_dict.get("<UNK>", 1)
        cunk = self.char_dict.get("<UNK>", 1)
        return {
            "vid": vid,
            "se_time": [0.0, float(duration)],
            "duration": float(duration),
            "se_frac": [0.0, 1.0],
            "sentence": sentence,
            "words": words,
            "wids": [self.word_dict.get(w, unk) for w in words],
            "cids": [[self.char_dict.get(c, cunk) for c in w] for w in words],
        }

    def _assemble(self, records: List[dict]):
        """Static-shape batch of the SERVICE batch size (padded, sample_mask)."""
        from vmrframe_tpu_torch.data.batcher import Batcher

        b = Batcher(records, self.store, self.cfg, self.derived, batch_size=self.batch_size)
        return b.make_batch(list(range(len(records))))

    def _run(self, batch) -> np.ndarray:
        ev = self.evaluator
        metrics = ev.eval_step(ev.to_device(batch))
        props = metrics["props"].cpu().numpy()  # (B, 2) predicted fractions
        with self._stats_lock:
            self._n_batches += 1
        return props

    # ---------- micro-batching ----------

    def _dispatch_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            pending = [first]
            deadline = time.perf_counter() + self.flush_ms / 1e3
            while len(pending) < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    pending.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                props = self._run(self._assemble([p["record"] for p in pending]))
                for i, p in enumerate(pending):
                    dur = p["record"]["duration"]
                    p["result"] = {
                        "vid": p["record"]["vid"],
                        "sentence": p["record"]["sentence"],
                        "pred_time": [float(props[i, 0]) * dur, float(props[i, 1]) * dur],
                        "pred_frac": [float(props[i, 0]), float(props[i, 1])],
                    }
                    p["event"].set()
            except Exception as e:  # the loop must survive: report per request
                for p in pending:
                    p["error"] = f"{type(e).__name__}: {e}"
                    p["event"].set()

    def predict(self, vid: str, sentence: str, duration: Optional[float] = None,
                timeout: float = 60.0) -> Dict:
        """Thread-safe single prediction (micro-batched under the hood)."""
        if vid not in self.store:
            raise KeyError(f"unknown vid: {vid}")
        if duration is None:
            duration = float(self.store.lengths()[str(vid)])
        item = {"record": self._make_record(vid, sentence, duration),
                "event": threading.Event()}
        t0 = time.perf_counter()
        self._queue.put(item)
        if not item["event"].wait(timeout):
            with self._stats_lock:
                self._n_err += 1
            raise TimeoutError("prediction timed out")
        dt = time.perf_counter() - t0
        with self._stats_lock:
            if "error" in item:
                self._n_err += 1
            else:
                self._n_ok += 1
                self._latencies.append(dt)
                if len(self._latencies) > 4096:
                    del self._latencies[:2048]
        if "error" in item:
            raise RuntimeError(item["error"])
        return item["result"]

    def metrics(self) -> Dict:
        """Request and batch counters, latency percentiles (rolling window)."""
        with self._stats_lock:
            lat = sorted(self._latencies[-4096:])
            ok, err, batches = self._n_ok, self._n_err, self._n_batches
        pct = lambda p: round(lat[min(int(p * len(lat)), len(lat) - 1)] * 1e3, 2) \
            if lat else None  # noqa: E731
        return {"requests_ok": ok, "requests_error": err, "batches": batches,
                "batch_size": self.batch_size, "flush_ms": self.flush_ms,
                "device": str(self.evaluator.device),
                "p50_ms": pct(0.50), "p90_ms": pct(0.90), "p99_ms": pct(0.99)}

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)


# ---------- HTTP front end ----------


def make_http_server(service: MomentRetrievalService, port: int):
    """Bind 127.0.0.1:``port`` (0 picks a free port: read ``server_address``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        daemon_threads = True
        # the stdlib default backlog of 5 drops connections from a burst of
        # concurrent clients, and each retry costs the client a second
        request_queue_size = 1024

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload):
            body = json.dumps(payload).encode("utf8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "batch_size": service.batch_size,
                                 "model": str(service.cfg.model.name)})
            elif self.path == "/metrics":
                self._send(200, service.metrics())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                reqs = req if isinstance(req, list) else [req]
                out = [service.predict(r["vid"], r["sentence"], r.get("duration")) for r in reqs]
                self._send(200, out if isinstance(req, list) else out[0])
            except (KeyError, TimeoutError, RuntimeError, ValueError) as e:
                self._send(400, {"error": str(e)})

        def log_message(self, *a):  # quiet
            pass

    return Server(("127.0.0.1", port), Handler)


# ---------- bootstrapping ----------


def build_service(cfg: Optional[Config] = None, checkpoint: Optional[str] = None,
                  batch_size: Optional[int] = None, flush_ms: float = 5.0,
                  n_synthetic: int = 64, device=None):
    """A service over synthetic data (``testing.make_synthetic_data``) and
    the dataset it serves.  Real datasets need the port of
    ``data/datasets.py``, which has not been made yet."""
    from vmrframe_tpu_torch.testing import make_synthetic_data

    cfg = cfg or make_cfg()
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=n_synthetic, n_test=n_synthetic)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    return MomentRetrievalService(
        cfg, derived, dataset["word_dict"], dataset["char_dict"], dataset["word_vector"],
        store, checkpoint=checkpoint, batch_size=batch_size, flush_ms=flush_ms, device=device,
    ), dataset


def selftest(service: MomentRetrievalService, dataset, port: int = 0,
             n_requests: int = 256, concurrency: int = 32) -> dict:
    """Serve over HTTP, fire concurrent real-HTTP requests, report latency
    percentiles and throughput."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    server = make_http_server(service, port)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    records = dataset["test_set"]
    lat: List[float] = []
    lock = threading.Lock()

    def one(i):
        rec = records[i % len(records)]
        body = json.dumps({"vid": rec["vid"], "sentence": rec["sentence"],
                           "duration": rec["duration"]}).encode("utf8")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        dt = time.perf_counter() - t0
        if len(out.get("pred_time", ())) != 2:
            raise RuntimeError(f"malformed response: {out}")
        with lock:
            lat.append(dt)

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=concurrency) as ex:
            list(ex.map(one, range(n_requests)))
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    stats = {
        "requests": n_requests,
        "concurrency": concurrency,
        "batch_size": service.batch_size,
        "device": str(service.evaluator.device),
        "qps": n_requests / wall,
        "p50_ms": float(lat_ms[int(0.50 * len(lat_ms))]),
        "p90_ms": float(lat_ms[int(0.90 * len(lat_ms))]),
        "p99_ms": float(lat_ms[min(int(0.99 * len(lat_ms)), len(lat_ms) - 1)]),
    }
    print(json.dumps(stats))
    return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="YAML/JSON config (default: SeqPAN at Charades width, built in code)")
    ap.add_argument("--checkpoint", default=None,
                    help="torch.save'd state_dict, or .npz of the JAX variables")
    ap.add_argument("--port", type=int, default=8901)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--flush-ms", type=float, default=5.0)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                    help="serving compute dtype (default bf16)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()
    if not (args.synthetic or args.selftest):
        ap.error("only --synthetic data can be served until data/datasets.py is ported")

    cfg = load_config(args.config) if args.config else make_cfg()
    cfg = cfg.updated({"train.compute_dtype": args.dtype})
    service, dataset = build_service(cfg, args.checkpoint, args.batch_size, args.flush_ms,
                                     device=args.device)
    try:
        if args.selftest:
            selftest(service, dataset, args.port)
            return
        server = make_http_server(service, args.port)
        print(f"serving on http://127.0.0.1:{args.port}  (batch {service.batch_size}, "
              f"flush {service.flush_ms} ms, {service.evaluator.device})")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        service.close()


if __name__ == "__main__":
    main()
