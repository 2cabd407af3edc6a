"""Stdlib HTTP front + CLI of the PyTorch port's server (counterpart of the
JAX package's `serving/server.py`).

Endpoints:
  POST /predict  — body {"video": nested-list clip} (or {"slow":…,"fast":…}
                   for SlowFast), clip shaped (T,H,W,C) or (V,T,H,W,C);
                   responds {"logits": […], "top1": k, "latency_ms": x}.
                   The body may carry "priority" ("realtime" | "batch")
                   and "deadline_ms" for the default scheduler.
  GET  /healthz  — liveness + model identity (load balancers poll this).
  GET  /stats    — ServingStats.snapshot(): p50/p95/p99 latency, queue
                   depth, batch fill, throughput, rejections by cause, sheds.
  GET  /metrics  — Prometheus text exposition of the registry the /stats
                   counters read (obs/registry.py): request, batch,
                   rejection and shed counters, the latency histogram
                   (buckets from --serve.latency_buckets_ms), queue depth
                   and uptime gauges.
  POST /drain    — controller-initiated drain: admission flips to DRAINING
                   (/healthz 503, new work sheds, queued work flushes); the
                   process keeps serving its queue and is reaped apart.
/stream, /profile and /history answer 404 until their slices of the port
land (ROADMAP.md).

Handler threads only parse JSON and block on a future; all device work is
serialised behind one flush thread: the continuous-batching
`fleet/scheduler.Scheduler` by default (deadlines, priority classes, EDF
launches, shed before a deadline miss), or the MicroBatcher with
`--serve.scheduler micro`. `--serve.quantization int8` (or an int8
artifact) serves int8 weights (serving/quantize.py). Error mapping: bad
request -> 400, shed or queue full -> 503 + Retry-After (a deadline shed
too), request budget exceeded -> 504 + Retry-After. SIGTERM on the CLI path
drains: stop admitting, flush in-flight futures, exit 0.

    python -m pytorchvideo_accelerate_tpu_torch.serving.server \\
        --serve.checkpoint ART [--serve.quantization int8] [--cpu]
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence

import numpy as np

from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
from pytorchvideo_accelerate_tpu_torch.serving.admission import (
    DRAINING,
    AdmissionController,
)
from pytorchvideo_accelerate_tpu_torch.serving.batcher import (
    MicroBatcher,
    QueueFullError,
)
from pytorchvideo_accelerate_tpu_torch.serving.engine import (
    CLIP_KEYS,
    InferenceEngine,
)
from pytorchvideo_accelerate_tpu_torch.serving.quantize import QUANT_MODES
from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats

logger = logging.getLogger("pva_tpu_torch")


class _Handler(BaseHTTPRequestHandler):
    server_version = "pva-tpu-torch-serve/0.4"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102
        logger.debug("http: " + fmt, *args)

    def _reply(self, code: int, payload: dict,
               headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            # a shed leaves the request body unread: this connection
            # cannot be reused, say so
            self.send_header("Connection", "close")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reject(self, code: int, message: str, retry_after_s: float) -> None:
        """503/504 with Retry-After."""
        self._reply(code, {"error": message, "retry_after_s": retry_after_s},
                    headers={"Retry-After":
                             str(max(int(round(retry_after_s)), 1))})

    def do_GET(self):  # noqa: N802 - stdlib API
        srv: "InferenceServer" = self.server.owner
        if self.path == "/healthz":
            eng = srv.engine
            state = srv.admission.state()
            health = {
                "status": state,
                "model": eng.model_name,
                "num_classes": eng.num_classes,
                "input_dtype": eng.input_dtype,
                "buckets": list(eng.buckets),
                "platform": srv.platform,
                "queue_depth": srv.batcher.queue_depth(),
                "streaming": False,
            }
            if srv.expected_spec is not None:  # per-request (T, H, W, C)
                health["clip_spec"] = {k: list(v[1:])
                                       for k, v in srv.expected_spec.items()}
            self._reply(503 if state == DRAINING else 200, health)
        elif self.path == "/stats":
            self._reply(200, srv.stats.snapshot())
        elif self.path == "/metrics":
            body = srv.stats.registry.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802 - stdlib API
        srv: "InferenceServer" = self.server.owner
        if self.path == "/drain":
            # flip admission to DRAINING without tearing the server down;
            # reading the (empty) body keeps the keep-alive stream clean
            length = int(self.headers.get("Content-Length", 0))
            if length:
                self.rfile.read(length)
            srv.admission.start_draining()
            self._reply(200, {"draining": True,
                              "status": srv.admission.state(),
                              "queue_depth": srv.batcher.queue_depth()})
            return
        if self.path != "/predict":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        # admission control before the body is read: a shed must be the
        # cheapest response the server can produce
        admitted, retry_after = srv.admission.admit(srv.batcher.queue_depth())
        if not admitted:
            state = srv.admission.state()
            srv.stats.observe_shed(state)
            self.close_connection = True
            self._reject(503, f"load shed (service {state}); retry later",
                         retry_after)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            clip = {k: np.asarray(body[k], dtype=srv.engine.input_dtype)
                    for k in CLIP_KEYS if k in body}
            if not clip:
                raise ValueError(
                    "body needs 'video' (or 'slow'+'fast') nested lists")
            srv.check_geometry(clip)
            # per-request scheduling hints, only for a front that reads them
            kwargs = {}
            if getattr(srv.batcher, "supports_priority", False):
                if "priority" in body:
                    kwargs["priority"] = str(body["priority"])
                if "deadline_ms" in body:
                    kwargs["deadline_ms"] = float(body["deadline_ms"])
        except (ValueError, TypeError, KeyError) as e:
            srv.stats.observe_rejected("400")
            self._reply(400, {"error": f"bad request: {e}"})
            return
        try:
            future = srv.batcher.submit(clip, **kwargs)
        except QueueFullError as e:
            # the batcher already counted this one (cause "503")
            self._reject(503, str(e), e.retry_after_s)
            return
        except ValueError as e:
            srv.stats.observe_rejected("400")
            self._reply(400, {"error": f"bad request: {e}"})
            return
        t0 = time.monotonic()
        try:
            logits = future.result(timeout=srv.request_timeout_s)
        except FutureTimeout:
            if future.cancel():
                # shed before the engine touched it: a true rejection
                srv.stats.observe_rejected("504")
            else:
                # the flush thread already claimed it and counts it as
                # completed; a 504 count too would double-book it
                logger.warning("504 after engine claim (request completed "
                               "but the client timed out)")
            self._reject(504, f"request exceeded {srv.request_timeout_s}s "
                         "budget", srv.admission.retry_after_s)
            return
        except QueueFullError as e:
            # shed after admission (the scheduler's shed before a deadline
            # miss resolves the future with ShedError): 503 + Retry-After
            self._reject(503, str(e), e.retry_after_s)
            return
        except Exception as e:  # noqa: BLE001 - batch failure surfaced per-request
            srv.stats.observe_error()
            self._reply(500, {"error": f"inference failed: {e}"})
            return
        self._reply(200, {
            "logits": np.asarray(logits, np.float32).tolist(),
            "top1": int(np.argmax(logits)),
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
        })


class InferenceServer:
    """ThreadingHTTPServer wrapper owning engine + front (Scheduler or
    MicroBatcher) + stats."""

    def __init__(self, engine: InferenceEngine, batcher,
                 stats: ServingStats, host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 30.0,
                 expected_spec: Optional[dict] = None,
                 admission: Optional[AdmissionController] = None,
                 drain_grace_s: float = 10.0):
        self.engine = engine
        self.batcher = batcher
        self.stats = stats
        self.request_timeout_s = request_timeout_s
        self.drain_grace_s = drain_grace_s
        if admission is None:  # direct construction (tests, embedding)
            q = getattr(batcher, "_q", None)
            admission = AdmissionController(
                max_queue=getattr(batcher, "max_queue", 0)
                or getattr(q, "maxsize", 0) or 256)
        if admission.queue_depth_fn is None:
            admission.queue_depth_fn = batcher.queue_depth
        self.admission = admission
        # clip name -> (1, T, H, W, C) from the artifact's config (None =
        # accept any geometry)
        self.expected_spec = expected_spec
        self.platform = engine.device.type
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.owner = self  # handler back-reference
        self._thread = None
        self._closed = False

    @property
    def address(self) -> tuple:
        """Actual (host, port) bound — port 0 resolves here."""
        return self.httpd.server_address[:2]

    def check_geometry(self, clip: dict) -> None:
        """400-guard: requests must carry the serving geometry declared by
        the artifact; only a leading view axis is free."""
        if self.expected_spec is None:
            return
        if sorted(clip) != sorted(self.expected_spec):
            raise ValueError(
                f"request clips {sorted(clip)} != served model's "
                f"{sorted(self.expected_spec)}")
        for k, v in clip.items():
            want = tuple(self.expected_spec[k][1:])  # (T, H, W, C)
            got = tuple(v.shape[-4:]) if v.ndim == 5 else tuple(v.shape)
            if got != want:
                raise ValueError(
                    f"clip {k!r} geometry {tuple(v.shape)} does not match "
                    f"the served model's (T,H,W,C)={want} "
                    "(an optional leading view axis is allowed)")

    def start(self) -> "InferenceServer":
        """Serve on a background thread (tests / embedding)."""
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="pva-serve-http", daemon=True)
        self._thread.start()
        return self

    def drain(self, grace_s: Optional[float] = None) -> None:
        """Graceful shutdown: stop admitting, flush in-flight futures within
        the grace budget, then close."""
        self.admission.start_draining()
        if not self.batcher.drain(self.drain_grace_s if grace_s is None
                                  else grace_s):
            logger.warning("drain: queue not empty at grace deadline; "
                           "remaining requests will be failed by close()")
        self.close()

    def serve_forever(self) -> None:
        """Serve on the calling thread (the CLI path); SIGTERM drains."""
        if self.drain_grace_s > 0:
            def on_term(signum, frame):
                logger.info("SIGTERM: draining")
                # httpd.shutdown() must run off the serve_forever thread
                threading.Thread(target=self.drain, name="pva-serve-drain",
                                 daemon=True).start()

            signal.signal(signal.SIGTERM, on_term)
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    def close(self) -> None:
        # idempotent: the drain path closes, then serve_forever's finally
        if self._closed:
            return
        self._closed = True
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.batcher.close()


def build_server(cfg) -> InferenceServer:
    """serve.* config block -> a ready (not yet started) InferenceServer on
    the CUDA card, or on the CPU with `--cpu`."""
    from pytorchvideo_accelerate_tpu_torch.models import model_input_spec

    s = cfg.serve
    if not s.checkpoint:
        raise SystemExit(
            "serving needs --serve.checkpoint pointing at an "
            "export_inference artifact")
    if s.scheduler not in ("edf", "micro"):
        raise SystemExit(
            f"unknown --serve.scheduler {s.scheduler!r} (edf | micro)")
    if s.streaming:
        raise SystemExit("--serve.streaming is not ported yet (ROADMAP.md)")
    if s.quantization not in QUANT_MODES:
        raise SystemExit(
            f"unknown --serve.quantization {s.quantization!r} "
            f"({' | '.join(QUANT_MODES)})")
    latency_buckets = None
    if s.latency_buckets_ms:
        try:
            latency_buckets = sorted(
                float(b) / 1e3 for b in s.latency_buckets_ms.split(",") if b)
        except ValueError:
            raise SystemExit(
                f"--serve.latency_buckets_ms {s.latency_buckets_ms!r}: "
                "expected comma-separated millisecond bounds, e.g. "
                "'5,10,25,50,100,250,1000'")
    stats = ServingStats(window=s.stats_window,
                         latency_buckets=latency_buckets)
    engine = InferenceEngine.from_artifact(
        s.checkpoint, device="cpu" if cfg.cpu else None,
        max_batch_size=s.max_batch_size, stats=stats,
        quantization=s.quantization if s.quantization != "off" else None)
    # run every bucket once for the training run's clip geometry before
    # the front takes a request: the first requests pay no first-call cost,
    # and the scheduler's service-time EWMA starts from warm launches (a
    # cold one would shed realtime requests for nothing); the same spec
    # then 400-guards /predict against off-geometry requests
    spec = model_input_spec(engine.artifact_config.model,
                            engine.artifact_config.data)
    engine.warmup({k: np.zeros(shape[1:], engine.input_dtype)
                   for k, shape in spec.items()})
    if s.scheduler == "edf":
        # serve.max_wait_ms is the batch class's coalescing dial; the
        # realtime class is work-conserving
        batcher = Scheduler(
            engine, max_queue=s.max_queue, stats=stats,
            realtime_deadline_ms=s.realtime_deadline_ms,
            batch_deadline_ms=s.batch_deadline_ms,
            batch_max_wait_ms=s.max_wait_ms, retry_after_s=s.retry_after_s)
    else:
        batcher = MicroBatcher(engine, max_wait_ms=s.max_wait_ms,
                               max_queue=s.max_queue, stats=stats,
                               retry_after_s=s.retry_after_s)
    stats.queue_depth_fn = batcher.queue_depth
    admission = AdmissionController(
        max_queue=s.max_queue, shed_frac=s.shed_queue_frac,
        recover_frac=s.recover_queue_frac, retry_after_s=s.retry_after_s,
        on_state_change=lambda old, new: logger.warning(
            "serving state %s -> %s", old, new))
    return InferenceServer(engine, batcher, stats, host=s.host, port=s.port,
                           request_timeout_s=s.request_timeout_s,
                           expected_spec=spec, admission=admission,
                           drain_grace_s=s.drain_grace_s)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """`--serve.checkpoint PATH [--serve.port N] [--cpu]`."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli

    logging.basicConfig(level=logging.INFO)
    server = build_server(parse_cli(argv))
    host, port = server.address
    print(f"pva-tpu-torch-serve: http://{host}:{port}  model="
          f"{server.engine.model_name} buckets={server.engine.buckets} "
          f"device={server.engine.device}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
