"""Batched moment-retrieval serving (counterpart of ``vmrframe_tpu/tools/serve.py``).

- ``MomentRetrievalService`` turns (vid, sentence) requests into predicted
  [start, end] seconds: concurrent requests queue up and run together when
  ``batch_size`` have gathered or ``flush_ms`` has passed, one static-shape
  batch per forward (``train/evaluator.py``), on ``cuda`` by default;
- ``ModelRouter`` puts several named services behind one port: each keeps
  its own model and micro-batch queue, all share the one card;
- a localhost HTTP JSON API (stdlib ``ThreadingHTTPServer``):
  POST /predict {"vid": ..., "sentence": ...} or a list of them (the default
  model), POST /predict/<name> or a ``"model"`` field in the body (the path
  wins), GET /healthz, GET /models, GET /metrics (every model) and
  /metrics/<name>, POST /reload {"checkpoint": ..., "model": ...}: new
  weights swapped in between micro-batches (400 for a missing file or an
  unknown model, 500 for a checkpoint that does not fit: the old weights
  go on serving);
- ``--selftest`` boots the service, fires concurrent requests through real
  HTTP and prints latency percentiles and throughput.

A model's data come from its config's ``paths`` (the cached dataset of
``data/datasets.py`` and a lazy feature store) unless ``--synthetic`` is
given, or the config names no ``paths.feature_path`` (``make_cfg``; then
``--synthetic`` or ``--selftest`` is needed).

The config is built in code (``make_cfg``: SeqPAN at Charades width) unless
``--config`` names a YAML file: ``configs/tacos_actionformer_long.yaml``
serves ActionFormer on 2304-frame grids (the query text is carried and
unused: the model has no text branch).  ``--model NAME=CONFIG[:CKPT]``
(repeatable) adds named models beside it.  ``model.fused_dual_stack: true``
in a SeqPAN or BackBone config runs the dual-attention stack as one kernel
launch (``kernels/dual_stack.py``; off by default).  The batch comes from
the model's registered batcher.  A checkpoint is a ``torch.save``d
state_dict or an ``.npz`` of the JAX package's variables.

Usage:
  python -m vmrframe_tpu_torch.tools.serve --config data/config.json --port 8901
  python -m vmrframe_tpu_torch.tools.serve --selftest [--device cuda]
  python -m vmrframe_tpu_torch.tools.serve --synthetic --port 8901
  python -m vmrframe_tpu_torch.tools.serve --selftest --batch-size 8 \
      --config configs/tacos_actionformer_long.yaml
  python -m vmrframe_tpu_torch.tools.serve --synthetic \
      --model seqpan=configs/charades_seqpan_fused.yaml \
      --model backbone=configs/charades_backbone_fused.yaml \
      --model basefast=configs/charades_basefast.yaml
  python -m vmrframe_tpu_torch.tools.serve --synthetic \
      --model bertsentence=configs/charades_backbone_bertsentence.yaml \
      --model alignfeature=configs/charades_backbone_alignfeature.yaml \
      --model backbone_af=configs/charades_backbone_actionformer.yaml
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
             batch_size: int = 128, compute_dtype: str = "bfloat16", model: str = "SeqPAN",
             fused_dual_stack: bool = False) -> Config:
    """A SeqPAN-family model at the width of SeqPAN's Charades-STA config,
    with its train settings (50 epochs, AdamW 8e-4 with a 5% linear warmup,
    clip 1.0)."""
    return Config({
        "task": "charades",
        "paths": {"ckpt_dir": "ckpt/"},
        "train": {"epochs": 50, "batch_size": batch_size, "lr": 0.0008,
                  "warmup_proportion": 0.05, "clip_norm": 1.0, "compute_dtype": compute_dtype},
        "dataprocess": {"video_augmentation": {"unchanged": None},
                        "sample_type": "truncation", "label_threshold": 0.01},
        "model": {"name": model, "vlen": vlen, "tlen": tlen, "vdim": vdim, "dim": dim,
                  "num_heads": 4, "word_dim": 300, "char_dim": 100, "droprate": 0.2,
                  "fused_dual_stack": fused_dual_stack},
    })


class MomentRetrievalService:
    """Owns an Evaluator; micro-batches requests onto its device."""

    def __init__(self, cfg, derived, word_dict, char_dict, word_vector, feature_store,
                 checkpoint: Optional[str] = None, batch_size: Optional[int] = None,
                 flush_ms: float = 5.0, device=None, seed: int = 0):
        from vmrframe_tpu_torch.data.batcher import Batcher
        from vmrframe_tpu_torch.train.evaluator import Evaluator

        self.cfg = cfg
        self.derived = derived
        self.word_dict = word_dict
        self.char_dict = char_dict
        self.store = feature_store
        self.batch_size = int(batch_size or cfg.train.batch_size)
        self.flush_ms = float(flush_ms)
        self.evaluator = Evaluator(cfg, derived, word_vector, device=device, seed=seed)
        self._batcher_cls = self.evaluator.entry.batcher_cls or Batcher
        if checkpoint:
            from vmrframe_tpu_torch.weights import load_checkpoint

            load_checkpoint(self.evaluator.model, checkpoint)
        self._model_lock = threading.Lock()  # a forward, or a swap of the weights
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
        """Static-shape batch of the SERVICE batch size (padded, sample_mask),
        from the model's registered batcher."""
        b = self._batcher_cls(records, self.store, self.cfg, self.derived,
                              batch_size=self.batch_size)
        return b.make_batch(list(range(len(records))))

    def _run(self, batch) -> np.ndarray:
        ev = self.evaluator
        with self._model_lock:
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

    def reload_checkpoint(self, checkpoint: str) -> None:
        """Hot-swap the weights.  The checkpoint is read, checked against the
        model's names and shapes and staged on the model's device and types
        first; then the staged copy is swapped in between two micro-batches:
        a batch in flight finishes on the old weights, the next one runs the
        new.  A checkpoint that does not fit raises before anything changed."""
        from vmrframe_tpu_torch.weights import read_checkpoint

        state = read_checkpoint(checkpoint)
        model = self.evaluator.model
        current = model.state_dict()
        faults = [f"missing {k}" for k in current if k not in state]
        faults += [f"unexpected {k}" for k in state if k not in current]
        faults += [f"{k}: {tuple(state[k].shape)} for {tuple(v.shape)}"
                   for k, v in current.items() if k in state and state[k].shape != v.shape]
        if faults:
            raise RuntimeError(f"{checkpoint} does not fit {self.cfg.model.name}: "
                               + "; ".join(faults[:8]))
        staged = {k: state[k].to(device=v.device, dtype=v.dtype) for k, v in current.items()}
        with self._model_lock:
            model.load_state_dict(staged, strict=True)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)


# ---------- multi-model routing ----------


class ModelRouter:
    """Routes requests to one of several named ``MomentRetrievalService``s.
    Each owns its model and its micro-batch queue, so one model's traffic
    does not wait in another's queue; all run on the one card.

    Route selection, in precedence order: the URL path (``/predict/<name>``),
    a ``"model"`` field in the request body, the default (the first
    registered model)."""

    def __init__(self, services: Dict[str, MomentRetrievalService]):
        if not services:
            raise ValueError("ModelRouter needs at least one service")
        self.services = dict(services)
        self.default = next(iter(services))

    def get(self, name: Optional[str]) -> MomentRetrievalService:
        name = name or self.default
        if name not in self.services:
            raise KeyError(f"unknown model: {name!r} (have: {sorted(self.services)})")
        return self.services[name]

    def predict(self, vid: str, sentence: str, duration: Optional[float] = None,
                model: Optional[str] = None, timeout: float = 60.0) -> Dict:
        out = self.get(model).predict(vid, sentence, duration, timeout)
        out["model"] = model or self.default
        return out

    def close(self):
        for s in self.services.values():
            s.close()


# ---------- HTTP front end ----------


def make_http_server(service, port: int):
    """``service`` is a ``MomentRetrievalService`` (served as ``default``) or
    a ``ModelRouter``.  Binds 127.0.0.1:``port`` (0 picks a free port: read
    ``server_address``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    router = service if isinstance(service, ModelRouter) else ModelRouter({"default": service})

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

        def _body(self):
            return json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "models": {
                    n: {"batch_size": s.batch_size, "model": str(s.cfg.model.name)}
                    for n, s in router.services.items()}})
            elif self.path == "/models":
                self._send(200, {"models": sorted(router.services), "default": router.default})
            elif self.path.startswith("/metrics"):
                name = self.path[len("/metrics"):].strip("/") or None
                try:
                    if name:
                        self._send(200, router.get(name).metrics())
                    else:
                        self._send(200, {n: s.metrics() for n, s in router.services.items()})
                except KeyError as e:
                    self._send(400, {"error": str(e)})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path.startswith("/reload"):
                try:
                    req = self._body()
                    router.get(req.get("model")).reload_checkpoint(req["checkpoint"])
                    self._send(200, {"ok": True, "model": req.get("model") or router.default})
                except (KeyError, ValueError, FileNotFoundError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:  # a corrupt file, a tree of another shape
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if not self.path.startswith("/predict"):
                self._send(404, {"error": "not found"})
                return
            path_model = self.path[len("/predict"):].strip("/") or None
            try:
                req = self._body()
                reqs = req if isinstance(req, list) else [req]
                out = [router.predict(r["vid"], r["sentence"], r.get("duration"),
                                      model=path_model or r.get("model")) for r in reqs]
                self._send(200, out if isinstance(req, list) else out[0])
            except (KeyError, TimeoutError, RuntimeError, ValueError) as e:
                self._send(400, {"error": str(e)})

        def log_message(self, *a):  # quiet
            pass

    return Server(("127.0.0.1", port), Handler)


# ---------- bootstrapping ----------


def build_service(cfg: Optional[Config] = None, checkpoint: Optional[str] = None,
                  batch_size: Optional[int] = None, flush_ms: float = 5.0,
                  n_synthetic: int = 64, device=None, synthetic: bool = True):
    """A service and the dataset it serves.  ``synthetic``: deterministic
    random data (``testing.make_synthetic_data``); otherwise the files of
    ``cfg.paths``: the cached dataset (``data/datasets.py``, built on first
    use) and a lazy feature store, which reads each video when a request
    names it."""
    cfg = cfg or make_cfg()
    if synthetic:
        from vmrframe_tpu_torch.testing import make_synthetic_data

        dataset, store = make_synthetic_data(cfg, seed=0, n_train=n_synthetic,
                                             n_test=n_synthetic)
    else:
        from vmrframe_tpu_torch.data.datasets import load_dataset
        from vmrframe_tpu_torch.data.features import open_feature_store

        store = open_feature_store(cfg.paths.feature_path, cfg.model.vlen, lazy=True)
        dataset = load_dataset(cfg, Derived(), vfeat_lens=store.lengths())
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    return MomentRetrievalService(
        cfg, derived, dataset["word_dict"], dataset["char_dict"], dataset["word_vector"],
        store, checkpoint=checkpoint, batch_size=batch_size, flush_ms=flush_ms, device=device,
    ), dataset


def selftest(service, dataset, port: int = 0,
             n_requests: int = 256, concurrency: int = 32) -> dict:
    """Serve over HTTP (a service, or a router's default model), fire
    concurrent real-HTTP requests, report latency percentiles and throughput."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    served = service.get(None) if isinstance(service, ModelRouter) else service
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
        "batch_size": served.batch_size,
        "device": str(served.evaluator.device),
        "qps": n_requests / wall,
        "p50_ms": float(lat_ms[int(0.50 * len(lat_ms))]),
        "p90_ms": float(lat_ms[int(0.90 * len(lat_ms))]),
        "p99_ms": float(lat_ms[min(int(0.99 * len(lat_ms)), len(lat_ms) - 1)]),
    }
    print(json.dumps(stats))
    return stats


def model_spec(spec: str):
    """(name, config path, checkpoint or None) of a ``--model
    NAME=CONFIG[:CKPT]`` argument; raises ``ValueError`` without ``=CONFIG``."""
    name, _, rest = spec.partition("=")
    if not name or not rest:
        raise ValueError(f"--model needs NAME=CONFIG[:CKPT], got {spec!r}")
    config, _, checkpoint = rest.partition(":")
    return name, config, checkpoint or None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="YAML/JSON config, served as 'default' (without --config and "
                         "--model: SeqPAN at Charades width, built in code)")
    ap.add_argument("--checkpoint", default=None,
                    help="torch.save'd state_dict, or .npz of the JAX variables")
    ap.add_argument("--model", action="append", default=None, metavar="NAME=CONFIG[:CKPT]",
                    help="serve several models behind one port (repeatable); route with "
                         "POST /predict/<NAME> or a 'model' body field.  Additive with "
                         "--config, which registers as 'default'.")
    ap.add_argument("--port", type=int, default=8901)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--flush-ms", type=float, default=5.0)
    ap.add_argument("--synthetic", action="store_true",
                    help="serve deterministic random data instead of the config's files")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                    help="serving compute dtype (default bf16)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()

    def build(cfg, checkpoint):
        cfg = cfg.updated({"train.compute_dtype": args.dtype})
        has_files = bool((cfg.get("paths") or {}).get("feature_path"))
        if not (has_files or args.synthetic or args.selftest):
            ap.error("the config names no paths.feature_path: pass --synthetic")
        return build_service(cfg, checkpoint, args.batch_size, args.flush_ms,
                             device=args.device, synthetic=args.synthetic or not has_files)

    services: Dict[str, MomentRetrievalService] = {}
    dataset = None
    if args.config or not args.model:
        cfg = load_config(args.config) if args.config else make_cfg()
        services["default"], dataset = build(cfg, args.checkpoint)
    for spec in args.model or []:
        try:
            name, cfg_path, ckpt = model_spec(spec)
        except ValueError as e:
            ap.error(str(e))
        services[name], ds = build(load_config(cfg_path), ckpt)
        dataset = dataset or ds
    router = ModelRouter(services)
    service = next(iter(services.values()))
    try:
        if args.selftest:
            selftest(router, dataset, args.port)
            return
        server = make_http_server(router, args.port)
        print(f"serving {sorted(services)} on http://127.0.0.1:{args.port}  "
              f"(batch {service.batch_size}, flush {service.flush_ms} ms, "
              f"{service.evaluator.device})")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        router.close()


if __name__ == "__main__":
    main()
