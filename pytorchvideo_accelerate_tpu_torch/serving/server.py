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
                   depth, batch fill, throughput, rejections by cause, sheds;
                   and `slowest_traces` ([{trace_id, latency_ms}]) once a
                   traced request has completed.
  GET  /metrics  — Prometheus text exposition of the registry the /stats
                   counters read (obs/registry.py): request, batch,
                   rejection and shed counters, the latency histogram
                   (buckets from --serve.latency_buckets_ms), queue depth
                   and uptime gauges.
  GET  /history  — the metrics-history ring (obs/history.py) as JSON
                   series, with the alert rules' state: `?window_s=S`
                   trims to the trailing S seconds, `?keys=a,b` names flat
                   scrape keys; 400 on a bad query, 503 while the ring is
                   disarmed (`--obs.enabled false` or
                   `--obs.history_ticks 0`).
  POST /drain    — controller-initiated drain: admission flips to DRAINING
                   (/healthz 503, new work sheds, queued work flushes); the
                   process keeps serving its queue and is reaped apart.
  POST /profile?seconds=S — a torch.profiler window of S seconds (0 < S <=
                   120, default 3) on the live server (obs/profiler.py),
                   published as <checkpoint.output_dir>/profile_<tag>/
                   trace.json: 202 with the tag, 409 while a window is open,
                   503 with the obs layer off.
  POST /stream   — one streaming-session advance (`--serve.streaming`,
                   streaming/engine.py): body {"session": id, "frames": s
                   new frames (s,H,W,C), "window": optional resendable
                   (T,H,W,C), "stride": int, "end": bool, "priority" /
                   "deadline_ms" as /predict}; responds {"logits", "top1",
                   "session", "latency_ms"} over the session's rolling
                   window. A session is established by a body with a
                   "window" (and "stride", or "frames" whose length is the
                   stride); an advance for a session this server does not
                   hold and that carries no window answers 409 (resend the
                   window); a session past the budget
                   (`--serve.stream_session_budget_mb`) 503 + Retry-After.
                   Without `--serve.streaming` it answers 400.

Tracing (`--obs.trace_sample_rate R`, R > 0, obs on; obs/trace.py): a
/predict with a `traceparent` header continues that trace, one without
starts a trace head-sampled at rate R; the submit carries the context into
the scheduler, whose wait and device dispatch join the trace, and the reply
(a traced rejection too) echoes `x-pva-trace-id`. The ring is dumped to
<checkpoint.output_dir>/trace_ring.json by `drain()` and on SIGTERM.

Telemetry (`obs.*`, on by default): `build_server` configures the span
collector and the flight recorder (installed on
`<checkpoint.output_dir>/flight_record.json`), arms the memory ledger
(the engine's resident weights, `pva_hbm_*` on /metrics), the history
ring and the burn-rate alert engine (`obs/alerts.py default_rules`) on the
stats registry; a ticker thread ticks the alert engine, and so the history,
once a second while the server runs. A drain and a SIGTERM leave records
in the flight recorder, and SIGTERM dumps it before draining.

Handler threads only parse JSON and block on a future; all device work is
serialised behind one flush thread: the continuous-batching
`fleet/scheduler.Scheduler` by default (deadlines, priority classes, EDF
launches, shed before a deadline miss), or the MicroBatcher with
`--serve.scheduler micro`. `--serve.streaming` wraps the engine in a
`StreamingEngine` (`--serve.stream_trunk full|causal|windowed`, the
session budget and TTL, `--serve.stream_strides` warmed at build) and needs
the EDF scheduler. `--serve.quantization int8` (or an int8
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
from urllib.parse import parse_qs, urlparse

import numpy as np

from pytorchvideo_accelerate_tpu_torch import obs
from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
from pytorchvideo_accelerate_tpu_torch.obs import alerts as obs_alerts
from pytorchvideo_accelerate_tpu_torch.obs import history as obs_history
from pytorchvideo_accelerate_tpu_torch.obs import memory as obs_memory
from pytorchvideo_accelerate_tpu_torch.obs import profiler as obs_profiler
from pytorchvideo_accelerate_tpu_torch.obs import trace
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
from pytorchvideo_accelerate_tpu_torch.streaming import (
    SessionUnknownError,
    StreamingEngine,
)

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

    def _reject(self, code: int, message: str, retry_after_s: float,
                headers: Optional[Dict[str, str]] = None) -> None:
        """503/504 with Retry-After (and any extra headers, e.g. the trace
        id echo)."""
        hdrs = {"Retry-After": str(max(int(round(retry_after_s)), 1))}
        hdrs.update(headers or {})
        self._reply(code, {"error": message, "retry_after_s": retry_after_s},
                    headers=hdrs)

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
                # whether /stream serves sessions here
                "streaming": bool(getattr(srv.batcher, "supports_sessions",
                                          False)),
            }
            if srv.expected_spec is not None:  # per-request (T, H, W, C)
                health["clip_spec"] = {k: list(v[1:])
                                       for k, v in srv.expected_spec.items()}
            self._reply(503 if state == DRAINING else 200, health)
        elif self.path == "/stats":
            snap = srv.stats.snapshot()
            # the slowest traced completions name trace ids to pull from
            # the merged timeline
            slowest = srv.stats.slowest_traces()
            if slowest:
                snap["slowest_traces"] = slowest
            self._reply(200, snap)
        elif self.path == "/metrics":
            body = srv.stats.registry.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.split("?", 1)[0] == "/history":
            # 503 while the ring is disarmed: a scraper tells "off" from
            # "empty"
            hist = obs_history.get_history()
            if hist is None:
                self._reply(503, {"error": "metrics history disarmed "
                                           "(obs.history_ticks=0?)"})
                return
            try:
                q = parse_qs(urlparse(self.path).query)
                window_s = (float(q["window_s"][0])
                            if "window_s" in q else None)
                keys = (sorted({k for tok in q["keys"]
                                for k in tok.split(",") if k})
                        if "keys" in q else None)
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad query: {e}"})
                return
            payload = hist.to_json(keys=keys, window_s=window_s)
            engine = obs_alerts.get_engine()
            if engine is not None:
                payload["alerts"] = engine.snapshot()["rules"]
                payload["alerts_active"] = engine.active()
            self._reply(200, payload)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802 - stdlib API
        srv: "InferenceServer" = self.server.owner
        if self.path == "/stream":
            self._do_stream(srv)
            return
        if self.path == "/drain":
            # flip admission to DRAINING without tearing the server down;
            # reading the (empty) body keeps the keep-alive stream clean
            length = int(self.headers.get("Content-Length", 0))
            if length:
                self.rfile.read(length)
            srv.admission.start_draining()
            obs.get_recorder().record("serving", "drain-requested")
            self._reply(200, {"draining": True,
                              "status": srv.admission.state(),
                              "queue_depth": srv.batcher.queue_depth()})
            return
        if self.path.split("?", 1)[0] == "/profile":
            self._do_profile(srv)
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
        # continue an incoming `traceparent` (the head already sampled it)
        # or start a head-sampled trace; the submit captures the context,
        # so the scheduler's wait and dispatch join it. Sheds above stay
        # untraced: a shed stays the cheapest reply
        handle, echo = self._trace_root("http_predict")
        with handle:
            self._predict(srv, clip, kwargs, echo)

    def _trace_root(self, name: str):
        """(the request's trace root, or the no-op; the trace id echo
        header, or None): an incoming `traceparent` is continued (the head
        already sampled it), else the local head-sampling decision."""
        rt = trace.get_tracer()
        if rt is None:
            return trace.NOOP, None
        tp = self.headers.get("traceparent")
        handle = rt.continue_trace(tp, name) if tp else None
        if handle is None:  # absent, malformed or unsampled header
            handle = rt.start(name)
        if handle is None:
            return trace.NOOP, None
        return handle, {"x-pva-trace-id": handle.ctx.trace_id}

    def _predict(self, srv: "InferenceServer", clip: dict, kwargs: dict,
                 echo: Optional[Dict[str, str]]) -> None:
        try:
            future = srv.batcher.submit(clip, **kwargs)
        except QueueFullError as e:
            # the batcher already counted this one (cause "503")
            self._reject(503, str(e), e.retry_after_s, headers=echo)
            return
        except ValueError as e:
            srv.stats.observe_rejected("400")
            self._reply(400, {"error": f"bad request: {e}"}, headers=echo)
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
                         "budget", srv.admission.retry_after_s, headers=echo)
            return
        except QueueFullError as e:
            # shed after admission (the scheduler's shed before a deadline
            # miss resolves the future with ShedError): 503 + Retry-After
            self._reject(503, str(e), e.retry_after_s, headers=echo)
            return
        except Exception as e:  # noqa: BLE001 - batch failure surfaced per-request
            srv.stats.observe_error()
            self._reply(500, {"error": f"inference failed: {e}"},
                        headers=echo)
            return
        self._reply(200, {
            "logits": np.asarray(logits, np.float32).tolist(),
            "top1": int(np.argmax(logits)),
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
        }, headers=echo)

    def _do_stream(self, srv: "InferenceServer") -> None:
        """POST /stream: one incremental session advance (the module
        docstring's body). Error map: admission or budget shed -> 503 +
        Retry-After, malformed -> 400, an unknown session with no window ->
        409, the request budget missed -> 504."""
        # the shed-before-body-read admission of /predict: a shed stays the
        # cheapest response under overload
        admitted, retry_after = srv.admission.admit(srv.batcher.queue_depth())
        if not admitted:
            state = srv.admission.state()
            srv.stats.observe_shed(state)
            self.close_connection = True
            self._reject(503, f"load shed (service {state}); retry later",
                         retry_after)
            return
        if not getattr(srv.batcher, "supports_sessions", False):
            length = int(self.headers.get("Content-Length", 0))
            if length:  # keep the keep-alive stream clean
                self.rfile.read(length)
            srv.stats.observe_rejected("400")
            self._reply(400, {"error": "this replica serves no streaming "
                                       "sessions (serve.streaming off)"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            sid = str(body.get("session") or "")
            if not sid:
                raise ValueError("body needs a 'session' id")
            dtype = srv.engine.input_dtype
            clip = {}
            if body.get("frames") is not None:
                clip["video"] = np.asarray(body["frames"], dtype=dtype)
            session = {"sid": sid, "end": bool(body.get("end"))}
            if body.get("window") is not None:
                session["window"] = np.asarray(body["window"], dtype=dtype)
            if body.get("stride") is not None:
                session["stride"] = int(body["stride"])
            kwargs: dict = {"session": session}
            if "priority" in body:
                kwargs["priority"] = str(body["priority"])
            if "deadline_ms" in body:
                kwargs["deadline_ms"] = float(body["deadline_ms"])
        except (ValueError, TypeError, KeyError) as e:
            srv.stats.observe_rejected("400")
            self._reply(400, {"error": f"bad request: {e}"})
            return
        handle, echo = self._trace_root("http_stream")
        with handle:
            try:
                future = srv.batcher.submit(clip, **kwargs)
            except QueueFullError as e:
                self._reject(503, str(e), e.retry_after_s, headers=echo)
                return
            except ValueError as e:
                srv.stats.observe_rejected("400")
                self._reply(400, {"error": f"bad request: {e}"}, headers=echo)
                return
            t0 = time.monotonic()
            try:
                logits = future.result(timeout=srv.request_timeout_s)
            except FutureTimeout:
                if future.cancel():
                    srv.stats.observe_rejected("504")
                else:
                    logger.warning("504 after engine claim (stream advance "
                                   "completed but the client timed out)")
                self._reject(504, f"request exceeded {srv.request_timeout_s}s "
                             "budget", srv.admission.retry_after_s, headers=echo)
                return
            except QueueFullError as e:
                self._reject(503, str(e), e.retry_after_s, headers=echo)
                return
            except SessionUnknownError as e:
                # not a bad request: the client holds the stream and can
                # re-establish; 409 tells it to resend its window
                self._reply(409, {"error": str(e)}, headers=echo)
                return
            except ValueError as e:
                srv.stats.observe_rejected("400")
                self._reply(400, {"error": f"bad request: {e}"}, headers=echo)
                return
            except Exception as e:  # noqa: BLE001 - per-request failure
                srv.stats.observe_error()
                self._reply(500, {"error": f"inference failed: {e}"},
                            headers=echo)
                return
            self._reply(200, {
                "logits": np.asarray(logits, np.float32).tolist(),
                "top1": int(np.argmax(logits)),
                "session": sid,
                "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
            }, headers=echo)

    def _do_profile(self, srv: "InferenceServer") -> None:
        """POST /profile?seconds=S: a torch.profiler window on the live
        server, closed by a background thread and published atomically as
        <output_dir>/profile_<tag>/ (obs/profiler.py). 202 with the pending
        tag, 409 while a window is open, 503 when the profiler is
        disarmed, 400 on a bad query."""
        length = int(self.headers.get("Content-Length", 0))
        if length:  # keep the keep-alive stream clean
            self.rfile.read(length)
        prof = obs_profiler.get_profiler()
        if prof is None:
            self._reply(503, {"error": "profiler disarmed (obs.enabled "
                                       "off or no output_dir)"})
            return
        try:
            q = parse_qs(urlparse(self.path).query)
            seconds = float(q.get("seconds", ["3"])[0])
            if not 0 < seconds <= 120:
                raise ValueError("seconds must be in (0, 120]")
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": f"bad query: {e}"})
            return
        tag = prof.capture_for(seconds)
        if tag is None:
            self._reply(409, {"error": "a profile capture is already "
                                       "running", "busy": True})
            return
        obs.get_recorder().record("profile", "capture-requested",
                                  seconds=seconds, tag=tag)
        self._reply(202, {"capturing": True, "seconds": seconds,
                          "tag": tag})


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
        # the alert engine's cadence: a ticker thread while the server
        # runs, when an engine is armed (each tick also appends a scrape to
        # the /history ring); 0 disables it
        self.alert_tick_s = 1.0
        self._tick_stop: Optional[threading.Event] = None
        self._tick_thread = None

    def _start_alert_ticker(self) -> None:
        engine = obs_alerts.get_engine()
        if engine is None or self.alert_tick_s <= 0 \
                or self._tick_thread is not None:
            return
        stop = threading.Event()

        def _loop():
            while not stop.wait(self.alert_tick_s):
                try:
                    engine.tick()
                except Exception:  # noqa: BLE001 - the ticker must survive
                    logger.exception("alert tick failed")

        self._tick_stop = stop
        self._tick_thread = threading.Thread(target=_loop, name="pva-serve-alerts",
                                             daemon=True)
        self._tick_thread.start()

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
        self._start_alert_ticker()
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
        trace.dump()  # the trace ring (a no-op when disarmed)

    def serve_forever(self) -> None:
        """Serve on the calling thread (the CLI path); SIGTERM drains. The
        drain handler replaces the flight recorder's dump-only SIGTERM
        hook, so it records the signal and dumps the ring itself first."""
        if self.drain_grace_s > 0:
            def on_term(signum, frame):
                logger.info("SIGTERM: draining")
                obs.get_recorder().record("signal", "SIGTERM-drain")
                obs.get_recorder().dump()
                trace.dump()  # the trace ring too (a no-op when disarmed)
                # httpd.shutdown() must run off the serve_forever thread
                threading.Thread(target=self.drain, name="pva-serve-drain",
                                 daemon=True).start()

            signal.signal(signal.SIGTERM, on_term)
        self._start_alert_ticker()
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
        if self._tick_stop is not None:
            self._tick_stop.set()
            if self._tick_thread is not None:
                self._tick_thread.join(timeout=5.0)
            self._tick_thread = self._tick_stop = None
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.batcher.close()
        self.engine.release_memory()


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
    if s.streaming and s.scheduler != "edf":
        raise SystemExit(
            "--serve.streaming needs the continuous-batching "
            "scheduler (--serve.scheduler edf); the MicroBatcher has "
            "no session launch path")
    if s.quantization not in QUANT_MODES:
        raise SystemExit(
            f"unknown --serve.quantization {s.quantization!r} "
            f"({' | '.join(QUANT_MODES)})")
    # telemetry: the training run's obs.* block; a killed server leaves the
    # same flight_record.json a training run does
    obs.configure(enabled=cfg.obs.enabled,
                  capacity=cfg.obs.flight_recorder_events)
    if cfg.obs.enabled:
        obs.get_recorder().install(cfg.checkpoint.output_dir)
    # tracing: head-sample this share of /predict requests (an incoming
    # traceparent is always continued); disarmed at rate 0 or with obs off
    trace.configure_tracing(
        cfg.obs.trace_sample_rate if cfg.obs.enabled else 0.0, seed=cfg.seed,
        capacity=cfg.obs.trace_ring_events,
        output_dir=cfg.checkpoint.output_dir)
    # POST /profile's capture singleton: the card's kernels too, unless
    # serving on the CPU
    obs_profiler.configure(enabled=cfg.obs.enabled,
                           output_dir=cfg.checkpoint.output_dir,
                           recorder=obs.get_recorder(), cuda=not cfg.cpu)
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
    # the ledger, the history ring and the alert engine on the stats
    # registry, so /metrics and /history carry them; disarmed with obs off
    obs_memory.configure(enabled=cfg.obs.enabled and cfg.obs.memory_ledger,
                         recorder=obs.get_recorder(), registry=stats.registry,
                         device="cpu" if cfg.cpu else None)
    hist = obs_history.configure(
        enabled=cfg.obs.enabled and cfg.obs.history_ticks > 0,
        capacity=cfg.obs.history_ticks, registry=stats.registry)
    obs_alerts.configure(enabled=hist is not None, history=hist,
                         registry=stats.registry, recorder=obs.get_recorder())
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
    front_engine = engine
    if s.streaming:
        # /stream advances run incrementally against device-resident
        # session rings; /predict still serves one-shot requests through
        # the same wrapped engine
        front_engine = StreamingEngine(
            engine, session_budget_mb=s.stream_session_budget_mb,
            session_ttl_s=s.stream_session_ttl_s,
            retry_after_s=s.retry_after_s, trunk=s.stream_trunk)
        # run establish and advance at every (stride, bucket) of the served
        # window (SlowFast's: its fast pathway) before the front takes a
        # request: a first advance paying first-call costs on the flush
        # thread would stall the launch and poison the service-time EWMA
        _, t, h, w, c = spec["video" if "video" in spec else "fast"]
        for tok in s.stream_strides.split(","):
            if not tok.strip():
                continue
            try:
                n = front_engine.warmup_stream(t, h, w, c, int(tok))
                logger.info("stream warmup: stride %s -> %d steps",
                            tok.strip(), n)
            except Exception as e:  # noqa: BLE001 - a stride this model refuses
                logger.warning("stream warmup skipped stride %s: %s",
                               tok.strip(), e)
    if s.scheduler == "edf":
        # serve.max_wait_ms is the batch class's coalescing dial; the
        # realtime class is work-conserving
        batcher = Scheduler(
            front_engine, max_queue=s.max_queue, stats=stats,
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
        on_state_change=lambda old, new: (
            logger.warning("serving state %s -> %s", old, new),
            obs.get_recorder().record("serving", "state-change",
                                      old=old, new=new)))
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
