"""Replica pool: N serving replicas behind health-gated membership (the
port's copy of the JAX package's `fleet/pool.py`).

A replica is one `InferenceEngine` behind one `Scheduler`: in this process
(`LocalReplica`; on a machine with several cards each takes its own
`cuda:i`, on one card they share `cuda:0`) or in another process behind
HTTP (`HttpReplica`, one `pva-torch-serve` per card or host). The pool owns
MEMBERSHIP: a poller thread re-checks every replica's health each
`health_interval_s`, driven by the replica's `/healthz` admission state, so
a replica that is merely shedding (`degraded`) stays routable while a
`draining` or dead one leaves the rotation; the router reports observed
deaths (`mark_down`) for an immediate route-around without waiting out a
poll. A down replica whose probe recovers rejoins.

Process replicas are spawned by the operator (or `spawn_serving_process`
below), never supervised here: restart policy belongs to the platform; the
pool keeps traffic off a dead replica and notices a resurrection.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from pytorchvideo_accelerate_tpu_torch import obs
from pytorchvideo_accelerate_tpu_torch.obs import trace
from pytorchvideo_accelerate_tpu_torch.serving.batcher import QueueFullError

logger = logging.getLogger("pva_tpu_torch")

# /healthz states that keep a replica routable: "degraded" is a replica
# shedding at its own door and still serving; pulling it would turn one
# replica's overload into fleet capacity loss
ROUTABLE_STATES = ("healthy", "degraded")


class ReplicaDeadError(RuntimeError):
    """The replica cannot take (or finish) this request at the transport
    level: a closed scheduler, a refused or reset connection. The router
    treats it as a route-around signal, never a client-visible failure."""


class LocalReplica:
    """In-process replica: one engine behind one `Scheduler`."""

    def __init__(self, name: str, scheduler, stats=None,
                 model: Optional[str] = None):
        self.name = name
        self.scheduler = scheduler
        self.stats = stats if stats is not None else scheduler.stats
        # the model family served here (the multi-model routing key); the
        # engine's own name when it declares one
        if model is None:
            try:
                model = getattr(scheduler.current_engine(), "model_name", None)
            except Exception:
                model = None
        self.model = model
        self._draining = False

    def submit(self, clip, **kwargs) -> Future:
        try:
            inner = self.scheduler.submit(clip, **kwargs)
        except (QueueFullError, ValueError):
            raise  # a shed (503) or a bad request (400) is not death
        except RuntimeError as e:  # a closed scheduler: a dead replica
            raise ReplicaDeadError(f"{self.name}: {e}") from e
        # a replica that dies AFTER accepting (close() fails its pending
        # futures) surfaces as ReplicaDeadError so the router re-dispatches.
        # Death is read from the scheduler's closed latch, never from an
        # exception's text: an engine error must propagate untranslated.
        outer: Future = Future()

        def done(f, name=self.name):
            err = f.exception()
            try:
                if err is None:
                    outer.set_result(f.result())
                elif (isinstance(err, RuntimeError)
                      and not isinstance(err, QueueFullError)
                      and self.scheduler._closed.is_set()):
                    outer.set_exception(ReplicaDeadError(f"{name}: {err}"))
                else:
                    outer.set_exception(err)
            except Exception:  # outer cancelled by the caller
                pass

        inner.add_done_callback(done)
        return outer

    def health(self) -> str:
        if self.scheduler._closed.is_set():
            return "dead"
        return "draining" if self._draining else "healthy"

    def drain(self) -> bool:
        """Scale-down actuator: report `draining` from here on, so the
        poller takes this replica out of the rotation within one health
        interval. Idempotent."""
        self._draining = True
        return True

    def queue_depth(self) -> int:
        try:
            return self.scheduler.queue_depth()
        except Exception:
            return 0

    def snapshot(self) -> Dict[str, float]:
        return self.stats.snapshot() if self.stats is not None else {}

    def close(self) -> None:
        self.scheduler.close()


class HttpReplica:
    """Process replica behind a `pva-torch-serve` HTTP endpoint.

    `submit` returns a Future resolved by a small worker pool posting
    `/predict` (or `/stream` for a session advance); HTTP 503 resolves to
    `QueueFullError` (the shed contract, Retry-After honoured), failures of
    the connection to `ReplicaDeadError`, so the router routes around a
    killed process."""

    def __init__(self, name: str, url: str, *, pid: Optional[int] = None,
                 timeout_s: float = 30.0, health_timeout_s: float = 2.0,
                 workers: int = 8, model: Optional[str] = None):
        self.name = name
        self.url = url.rstrip("/")
        self.pid = pid
        self.timeout_s = float(timeout_s)
        self.health_timeout_s = float(health_timeout_s)
        self.model = model  # multi-model routing key (None: unlabelled)
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=f"pva-http-{name}")

    def _predict(self, clip, kwargs, ctx=None) -> np.ndarray:
        # the worker re-attaches the submitter's trace context and wraps the
        # round trip in an `http_hop` span; the outgoing `traceparent`
        # carries that span's id, so the server's `http_predict` trace
        # parents onto this hop in the merged timeline
        with trace.attach(ctx), trace.span("http_hop", replica=self.name):
            body = {k: np.asarray(v).tolist() for k, v in clip.items()}
            if kwargs.get("priority") is not None:
                body["priority"] = kwargs["priority"]
            if kwargs.get("deadline_ms") is not None:
                body["deadline_ms"] = float(kwargs["deadline_ms"])
            path = "/predict"
            session = kwargs.get("session")
            if session is not None:
                # a streaming advance goes to /stream: "video" carries the
                # new frames, the envelope the id (and the resendable
                # window when the caller ships it)
                path = "/stream"
                body["session"] = str(session.get("sid"))
                if session.get("window") is not None:
                    body["window"] = np.asarray(session["window"]).tolist()
                if session.get("stride"):
                    body["stride"] = int(session["stride"])
                if session.get("end"):
                    body["end"] = True
                body["frames"] = body.pop("video", None)
            headers = {"Content-Type": "application/json"}
            tp = trace.current_traceparent()
            if tp:
                headers["traceparent"] = tp
            req = urllib.request.Request(
                self.url + path, data=json.dumps(body).encode(),
                headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                    out = json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    retry_after = float(e.headers.get("Retry-After", 1) or 1)
                    raise QueueFullError(f"{self.name}: shed (503)",
                                         retry_after_s=retry_after) from e
                if e.code == 400:
                    raise ValueError(f"{self.name}: bad request: "
                                     f"{e.read()[:200]!r}") from e
                if e.code == 409:
                    # a session this replica does not hold and no window
                    # rode along: the caller resends its window
                    from pytorchvideo_accelerate_tpu_torch.streaming.session import (
                        SessionUnknownError,
                    )

                    raise SessionUnknownError(
                        f"{self.name}: session unknown (409); resend "
                        "window") from e
                raise RuntimeError(f"{self.name}: HTTP {e.code}") from e
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                raise ReplicaDeadError(f"{self.name}: {e}") from e
            return np.asarray(out["logits"], np.float32)

    def submit(self, clip, **kwargs) -> Future:
        # the trace context is captured on the caller's thread and shipped
        # to the worker with the payload
        return self._pool.submit(self._predict, dict(clip), kwargs,
                                 trace.capture())

    def health(self) -> str:
        try:
            with urllib.request.urlopen(self.url + "/healthz",
                                        timeout=self.health_timeout_s) as r:
                return str(json.loads(r.read()).get("status", "healthy"))
        except urllib.error.HTTPError as e:
            if e.code == 503:  # draining replies 503 with a status body
                try:
                    return str(json.loads(e.read()).get("status", "draining"))
                except Exception:
                    return "draining"
            return "dead"
        except Exception:
            return "dead"

    def queue_depth(self) -> int:
        try:
            with urllib.request.urlopen(self.url + "/healthz",
                                        timeout=self.health_timeout_s) as r:
                return int(json.loads(r.read()).get("queue_depth", 0))
        except Exception:
            return 0

    def snapshot(self) -> Dict[str, float]:
        try:
            with urllib.request.urlopen(self.url + "/stats",
                                        timeout=self.health_timeout_s) as r:
                return {k: float(v) for k, v in json.loads(r.read()).items()
                        if isinstance(v, (int, float))}
        except Exception:
            return {}

    def drain(self) -> bool:
        """Scale-down actuator: POST /drain flips the remote admission state
        to DRAINING; the replica then answers /healthz with 503 and the
        poller pulls it. False (never raises) on an unreachable replica."""
        req = urllib.request.Request(
            self.url + "/drain", data=b"{}", method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.health_timeout_s) as r:
                return bool(json.loads(r.read()).get("draining", True))
        except Exception:
            return False

    def close(self) -> None:
        self._pool.shutdown(wait=False)


class ReplicaPool:
    """Health-gated replica membership and the poller that keeps it."""

    def __init__(self, replicas: Sequence, *, health_interval_s: float = 0.5,
                 registry=None, name: str = "fleet",
                 on_change: Optional[Callable[[str, bool], None]] = None):
        if not replicas:
            raise ValueError("a replica pool needs at least one replica")
        self.replicas: List = list(replicas)
        self.name = name
        self.health_interval_s = max(float(health_interval_s), 0.01)
        self.on_change = on_change
        self._lock = threading.Lock()
        self._down: frozenset = frozenset()
        self._closed = False
        reg = registry if registry is not None else obs.get_registry()
        # labelled per pool, so two pools on one registry never share a
        # callback; close() drops this pool's callback
        self._g_healthy = reg.gauge(
            "pva_fleet_healthy_replicas",
            "replicas currently in the routable set, by pool",
            labelnames=("pool",))
        self._g_healthy.set_function(
            lambda: float(len(self.routable())), pool=self.name)
        self._poller = threading.Thread(target=self._poll_loop,
                                        name="pva-fleet-health", daemon=True)
        self._poller.start()

    # --- membership -------------------------------------------------------

    def routable(self) -> List:
        with self._lock:
            down = self._down
        return [r for r in self.replicas if r.name not in down]

    def add_replica(self, replica) -> None:
        """Controller actuator (scale-up): join the rotation, routable at
        once; the poller takes over from here."""
        with self._lock:
            if any(r.name == replica.name for r in self.replicas):
                raise ValueError(f"replica {replica.name!r} already pooled")
            # a new list: the poller and routable() iterate snapshots
            self.replicas = self.replicas + [replica]
            self._down = frozenset(self._down - {replica.name})
        logger.info("fleet: replica %s joined the pool", replica.name)
        obs.get_recorder().record("fleet", "membership",
                                  replica=replica.name, joined=True)

    def remove_replica(self, replica, *, close: bool = True) -> None:
        """Controller actuator (reap): leave the pool for good. Unlike
        `mark_down` this is no health verdict the poller can revert."""
        with self._lock:
            self.replicas = [r for r in self.replicas
                             if r.name != replica.name]
            self._down = frozenset(self._down - {replica.name})
        logger.info("fleet: replica %s removed from the pool", replica.name)
        obs.get_recorder().record("fleet", "membership",
                                  replica=replica.name, removed=True)
        if close:
            try:
                replica.close()
            except Exception:
                logger.exception("fleet: closing replica %s failed",
                                 replica.name)

    def mark_down(self, replica) -> None:
        """A death the router observed: out of the rotation now; the poller
        restores it if its health probe recovers."""
        self._set_down(replica.name, True)

    def _set_down(self, name: str, down: bool) -> None:
        changed = False
        with self._lock:
            new = (self._down | {name}) if down else (self._down - {name})
            if new != self._down:
                self._down = frozenset(new)
                changed = True
        if changed:
            logger.warning("fleet: replica %s %s", name,
                           "left the routable set" if down else "rejoined")
            obs.get_recorder().record("fleet", "membership", replica=name,
                                      routable=not down)
            if self.on_change is not None:
                try:
                    self.on_change(name, not down)
                except Exception:  # an observer must not break routing
                    pass

    def _poll_loop(self) -> None:
        while not self._closed:
            for replica in list(self.replicas):
                if self._closed:
                    return
                try:
                    state = replica.health()
                except Exception:  # a broken probe reads as dead
                    state = "dead"
                self._set_down(replica.name, state not in ROUTABLE_STATES)
            time.sleep(self.health_interval_s)

    def close(self) -> None:
        self._closed = True
        self._poller.join(timeout=5.0)
        # a closed pool must not be kept alive (and scraped) by /metrics
        self._g_healthy.set_function(None, pool=self.name)
        self._g_healthy.set(0.0, pool=self.name)
        for replica in self.replicas:
            try:
                replica.close()
            except Exception:
                logger.exception("fleet: closing replica %s failed",
                                 replica.name)


def read_line_with_deadline(proc, timeout_s: float, *,
                            match: Optional[str] = None,
                            name: str = "pva-proc-read"):
    """The first stdout line of a child process (the first containing
    `match` when given) within a deadline, read on a daemon thread:
    `readline()` blocks forever, and a child that wedges before printing
    its bind line would otherwise hang the caller. Returns `(line, eof)`:
    line None on the deadline or at EOF, eof True when the child's stdout
    closed without the line (a dead child, not a timeout). The caller owns
    the error message and the kill."""
    box: dict = {}

    def read():
        for raw in proc.stdout:
            if match is None or match in raw:
                box["line"] = raw
                return
        box["eof"] = True

    reader = threading.Thread(target=read, name=name, daemon=True)
    reader.start()
    reader.join(timeout=timeout_s)
    return box.get("line"), bool(box.get("eof"))


def spawn_serving_process(artifact: str, *, port: int = 0,
                          device: Optional[str] = None,
                          extra_args: Sequence[str] = (),
                          startup_timeout_s: float = 120.0):
    """Spawn one `pva-torch-serve` process for `artifact` and return
    `(subprocess.Popen, HttpReplica)` once it prints its bound address.

    `device="cpu"` serves on the CPU (`--cpu`): the port's entry points run
    on the card unless asked. The CALLER owns the process (terminate or
    kill, then reap); the pool only routes around it."""
    cmd = [sys.executable, "-m", "pytorchvideo_accelerate_tpu_torch.serving.server",
           "--serve.checkpoint", artifact, "--serve.port", str(port),
           *(["--cpu"] if device == "cpu" else []), *extra_args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    line, eof = read_line_with_deadline(proc, startup_timeout_s,
                                        match="pva-tpu-torch-serve: http://",
                                        name="pva-fleet-spawn-read")
    if line is None:
        code = proc.poll()
        proc.kill()
        proc.wait()
        raise RuntimeError(
            f"serving process exited {code} before binding"
            if eof or code is not None
            else f"serving process did not bind within {startup_timeout_s}s")
    url = line.split()[1]
    return proc, HttpReplica(f"proc-{proc.pid}", url, pid=proc.pid)
