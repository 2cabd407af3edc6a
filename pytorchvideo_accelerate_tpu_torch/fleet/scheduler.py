"""Continuous-batching scheduler: deadlines, priority classes, EDF launches
(the port's copy of the JAX package's `fleet/scheduler.py`). Each launch is
the `serve.flush` fault point (reliability/faults.py): an injected raise fails
that launch's futures, never the flush thread.

The server's default front (`--serve.scheduler edf`). Per launch:

- every pending request carries an absolute deadline (its priority class's
  default or an explicit `deadline_ms`) and a priority class: `realtime`
  (launch now, work-conserving) or `batch` (coalesce toward full buckets
  until `batch_max_wait_ms` or deadline pressure);
- the next launch is chosen earliest-deadline-first (realtime strictly
  before batch), then filled with same-geometry pending requests in EDF
  order up to the largest bucket: the engine never idles while compatible
  work is queued, and arrivals join the next launch while one runs;
- shed before a deadline miss: a request whose remaining slack is smaller
  than the measured service time (a per-bucket EWMA) fails at once with
  `ShedError`, a `QueueFullError`, so the HTTP front answers 503 +
  Retry-After instead of spending a launch on an answer the client would
  time out on.

The interface is the `MicroBatcher`'s (`submit`/`queue_depth`/`drain`/
`close`), and so are the padding and the masked-row convention (padded rows
never resolve into a response). One flush thread serialises launches;
`swap_engine` installs another engine with the same buckets between
launches, so a launch runs start to finish on one engine; a streaming engine
(streaming/engine.py) takes the old one's live sessions over there, under
the launch lock (`carry_state_from`).

Streaming sessions (`submit(..., session=)`): a session advance rides the
same queue, deadlines and sheds, keyed apart from stateless clips of the
same shape (`("stream",) + geometry`), and launches through the engine's
`advance_batch` under a `stream_dispatch` span; an item's error fails that
item's future only. `supports_sessions` reads the current engine.

Tracing (obs/trace.py): each request carries its submitter's trace context
across the pending-queue hop; a traced request's wait is a `sched_wait`
trace event, the launch a `device_dispatch` span under the launch's first
traced request, and the latencies reach the stats with their trace ids.

The service-time EWMA starts at the first launch: the engine must be warm
before the scheduler takes requests (`build_server` runs every bucket
first), or the first launch's one-off costs (kernel builds, cuDNN's
algorithm search) shed realtime requests for nothing.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pytorchvideo_accelerate_tpu_torch.obs import trace
from pytorchvideo_accelerate_tpu_torch.reliability.faults import fault_point
from pytorchvideo_accelerate_tpu_torch.serving.batcher import QueueFullError
from pytorchvideo_accelerate_tpu_torch.serving.engine import CLIP_KEYS, clip_key

logger = logging.getLogger("pva_tpu_torch")

REALTIME, BATCH = "realtime", "batch"
PRIORITIES = (REALTIME, BATCH)

# EWMA smoothing of the per-bucket service time the shed decision reads:
# heavy enough to ride out one slow launch, light enough to track a change
# of engine within a few launches
_SVC_ALPHA = 0.3
# margin on the estimated service time before a deadline counts as
# unmeetable (and before batch coalescing gives way to deadline pressure)
_SHED_SAFETY = 1.2


class ShedError(QueueFullError):
    """A request shed before a certain deadline miss. A `QueueFullError`,
    so the HTTP front answers it like any shed: 503 + Retry-After."""


@dataclass
class _SchedRequest:
    clip: Dict[str, np.ndarray]
    future: Future
    t_enqueue: float
    deadline: float  # absolute time.monotonic()
    priority: str
    key: tuple  # clip geometry: only same-shaped requests share a launch
    seq: int = 0
    # the submitter's trace context, carried across the pending-queue hop
    # (None: tracing disarmed or the caller untraced)
    ctx: Optional[object] = None
    # a streaming-session advance: {"sid", "window", "stride", "end"}
    session: Optional[dict] = None

    def rank(self) -> Tuple[int, float, int]:
        """EDF order, realtime class strictly first; seq breaks ties FIFO."""
        return (0 if self.priority == REALTIME else 1, self.deadline, self.seq)


class Scheduler:
    """Continuous-batching EDF scheduler over one engine.

    Thread safety: `_pending` and `_svc` live under `_lock` (the
    condition's mutex); `engine` lives under `_launch_lock`, held for
    exactly one launch at a time. `swap_engine` blocks on it, which is the
    drain-then-swap order. The two locks are never nested, and the bucket
    geometry is cached as immutables, so `_loop` never reads `engine`
    while it holds `_lock`."""

    # the HTTP front forwards per-request priority and deadline only to a
    # front that declares it (the MicroBatcher ignores both by design)
    supports_priority = True

    @property
    def supports_sessions(self) -> bool:
        """True iff the current engine runs session advances
        (`StreamingEngine.advance_batch`)."""
        return bool(getattr(self.engine, "supports_sessions", False))

    def __init__(self, engine, *, max_queue: int = 256, stats=None,
                 realtime_deadline_ms: float = 500.0,
                 batch_deadline_ms: float = 5000.0,
                 batch_max_wait_ms: float = 20.0,
                 retry_after_s: float = 1.0):
        self.engine = engine
        self.stats = stats
        self.max_queue = max(int(max_queue), 1)
        self.retry_after_s = float(retry_after_s)
        self.batch_max_wait_s = max(batch_max_wait_ms, 0.0) / 1e3
        self._default_deadline_s = {
            REALTIME: max(realtime_deadline_ms, 1.0) / 1e3,
            BATCH: max(batch_deadline_ms, 1.0) / 1e3,
        }
        # `swap_engine` refuses another ladder, so these never go stale
        self._buckets: Tuple[int, ...] = tuple(engine.buckets)
        self._cap = self._buckets[-1]
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._launch_lock = threading.Lock()
        self._pending: List[_SchedRequest] = []
        self._svc: Dict[int, float] = {}  # bucket -> EWMA service seconds
        self._seq = 0
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="pva-fleet-scheduler", daemon=True)
        self._thread.start()

    # --- client side ------------------------------------------------------

    def submit(self, clip: Dict[str, np.ndarray], *,
               priority: str = REALTIME,
               deadline_ms: Optional[float] = None,
               session: Optional[dict] = None) -> Future:
        """Enqueue ONE clip (leaves (T, H, W, C) or (V, T, H, W, C)) and get
        a Future resolving to its f32 logits (num_classes,). A full queue
        raises `QueueFullError` here; an unmeetable deadline resolves the
        future with `ShedError`.

        `session` marks a streaming-session advance: ``{"sid": str,
        "window": optional resendable (T, H, W, C), "stride": optional int,
        "end": bool}`` with the s new frames as the "video" clip; it needs
        a session-capable engine."""
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}")
        clips = {k: np.asarray(v) for k, v in clip.items() if k in CLIP_KEYS}
        if session is not None:
            if not self.supports_sessions:
                raise ValueError(
                    "this replica serves no streaming sessions "
                    "(engine lacks advance_batch; serve.streaming off?)")
            if not session.get("sid"):
                raise ValueError("session request carries no 'sid'")
            win = session.get("window")
            if not clips and win is None:
                raise ValueError(
                    "session request needs new frames ('video') or a "
                    "resendable 'window'")
            geo = (clip_key(clips) if clips
                   else (("window", tuple(np.shape(win))),))
            key = ("stream",) + geo
        elif not clips:
            raise ValueError("request has neither 'video' nor 'slow'/'fast'")
        else:
            for k, v in clips.items():
                if v.ndim not in (4, 5):
                    raise ValueError(
                        f"clip {k!r} must be (T,H,W,C) or (V,T,H,W,C), "
                        f"got shape {v.shape}")
            key = clip_key(clips)
        if self._closed.is_set():
            raise RuntimeError("scheduler is closed")
        now = time.monotonic()
        ttl = (self._default_deadline_s[priority]
               if deadline_ms is None else max(float(deadline_ms), 1.0) / 1e3)
        req = _SchedRequest(clip=clips, future=Future(), t_enqueue=now,
                            deadline=now + ttl, priority=priority,
                            key=key, ctx=trace.capture(), session=session)
        with self._lock:
            if self._closed.is_set():
                raise RuntimeError("scheduler is closed")
            if len(self._pending) >= self.max_queue:
                if self.stats is not None:
                    self.stats.observe_rejected("503")
                raise QueueFullError(
                    f"scheduler queue full ({self.max_queue}); retry later",
                    retry_after_s=self.retry_after_s)
            self._seq += 1
            req.seq = self._seq
            self._pending.append(req)
            self._cond.notify()
        return req.future

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Wait for the pending queue to flush; True when it emptied in
        time (the caller stops admitting first)."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while time.monotonic() < deadline:
            if self.queue_depth() == 0:
                return True
            time.sleep(0.01)
        return self.queue_depth() == 0

    def close(self) -> None:
        """Stop the flush thread; pending requests are failed, not
        dropped."""
        if self._closed.is_set():
            return
        self._closed.set()
        with self._lock:
            self._cond.notify_all()
        self._thread.join(timeout=30.0)
        with self._lock:
            leftovers, self._pending = self._pending, []
        for req in leftovers:
            if not req.future.done():
                try:
                    req.future.set_exception(RuntimeError("scheduler closed"))
                except Exception:  # lost the race to the flush thread
                    pass

    # --- engine swap ------------------------------------------------------

    def current_engine(self):
        """The engine the next launch will use."""
        with self._launch_lock:
            return self.engine

    def swap_engine(self, new_engine) -> float:
        """Install `new_engine` between launches; returns the blackout in
        seconds (waiting out the launch in flight, the state carry, then
        the swap). The caller warms `new_engine` first (a streaming one
        with `prepare_carry_from`); its buckets must be this scheduler's
        (queued requests' padding plans assume them)."""
        if tuple(new_engine.buckets) != self._buckets:
            raise ValueError(
                f"hot-swap changes the bucket ladder {self._buckets} -> "
                f"{tuple(new_engine.buckets)}; restart the replica instead "
                "(in-flight padding plans assume stable buckets)")
        t0 = time.perf_counter()
        with self._launch_lock:
            # the streaming state carry happens here, with the old engine
            # quiesced by the launch lock: sessions established or advanced
            # any earlier would be lost or stale on the new engine
            old = self.engine
            if (hasattr(new_engine, "carry_state_from")
                    and hasattr(old, "table") and old is not new_engine):
                new_engine.carry_state_from(old)
            self.engine = new_engine
        return time.perf_counter() - t0

    # --- flush thread -----------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._closed.is_set():
                    break
                now = time.monotonic()
                shed = self._reap(now)
                group = self._collect(now)
                if group is None and not shed:
                    self._cond.wait(timeout=self._wait_s(now))
                    continue
            # futures resolve outside _lock: a done-callback may call
            # submit() or queue_depth(); launches run unlocked so arrivals
            # keep queueing into the next launch
            for req, err in shed:
                try:
                    req.future.set_exception(err)
                except Exception:
                    pass
                if self.stats is not None:
                    self.stats.observe_shed("deadline")
            if group is not None:
                self._launch(group)

    def _estimate_s(self, bucket: int) -> float:
        """Measured service time of `bucket`, else of the nearest larger
        known bucket, else the largest known (0.0 before the first launch:
        no shedding on guesses)."""
        if bucket in self._svc:
            return self._svc[bucket]
        known = sorted(self._svc)
        for b in known:
            if b >= bucket:
                return self._svc[b]
        return self._svc[known[-1]] if known else 0.0

    def _reap(self, now: float) -> List[tuple]:
        """Caller holds `_lock`. Drop cancelled requests and pull out every
        request that can no longer meet its deadline; returns [(request,
        ShedError)] for the caller to resolve after releasing the lock."""
        keep: List[_SchedRequest] = []
        shed: List[tuple] = []
        est = self._estimate_s(self._bucket_for(1)) * _SHED_SAFETY
        for req in self._pending:
            if req.future.done():
                continue  # cancelled by the HTTP front's timeout path
            if req.deadline - now <= est:
                shed.append((req, ShedError(
                    f"deadline unmeetable (slack "
                    f"{max(req.deadline - now, 0) * 1e3:.1f} ms < "
                    f"est service {est * 1e3:.1f} ms); retry later",
                    retry_after_s=self.retry_after_s)))
                continue
            keep.append(req)
        self._pending = keep
        return shed

    def _collect(self, now: float) -> Optional[List[_SchedRequest]]:
        """Caller holds `_lock`. The next launch (the EDF head and its
        same-geometry cohort), or None while coalescing continues."""
        if not self._pending:
            return None
        head = min(self._pending, key=_SchedRequest.rank)
        group = sorted((r for r in self._pending if r.key == head.key),
                       key=_SchedRequest.rank)[:self._cap]
        est = self._estimate_s(self._bucket_for(len(group)))
        launch_now = (
            head.priority == REALTIME            # work-conserving class
            or len(group) >= self._cap           # a full largest bucket
            or now - head.t_enqueue >= self.batch_max_wait_s
            or head.deadline - now <= est * _SHED_SAFETY * 2.0)
        if not launch_now:
            return None
        launched = set(id(r) for r in group)
        self._pending = [r for r in self._pending if id(r) not in launched]
        return group

    def _wait_s(self, now: float) -> float:
        """Caller holds `_lock`: sleep until the earliest trigger (a batch
        coalescing deadline or a request deadline), at most 0.1 s."""
        w = 0.1
        for req in self._pending:
            w = min(w, req.t_enqueue + self.batch_max_wait_s - now,
                    max(req.deadline - now, 0.0))
        return max(w, 0.001)

    def _launch(self, reqs: List[_SchedRequest]) -> None:
        try:
            fault_point("serve.flush")
            reqs = [r for r in reqs
                    if r.future.set_running_or_notify_cancel()]
            if not reqs:
                return
            if reqs[0].session is not None:
                self._launch_stream(reqs)
                return
            n = len(reqs)
            bucket = self._bucket_for(n)
            stacked: Dict[str, np.ndarray] = {}
            for k in reqs[0].clip:
                rows = np.stack([r.clip[k] for r in reqs])
                if bucket > n:  # zero rows, masked out below
                    pad = np.zeros((bucket - n,) + rows.shape[1:], rows.dtype)
                    rows = np.concatenate([rows, pad], axis=0)
                stacked[k] = rows
            # 1.0 = real request, 0.0 = padding (the eval path's convention)
            stacked["mask"] = np.asarray([1.0] * n + [0.0] * (bucket - n),
                                         np.float32)
            head_ctx = self._trace_waits(reqs)
            t0 = time.perf_counter()
            # one engine for the whole launch: swap_engine waits on this lock
            with trace.attach(head_ctx):
                with trace.span("device_dispatch", batch=n, bucket=bucket):
                    with self._launch_lock:
                        logits = self.engine.predict(stacked)
            # padded rows are sliced away: response i is row i only
            self._resolve(reqs, bucket, time.perf_counter() - t0,
                          [logits[i] for i in range(n)])
        except Exception as e:  # noqa: BLE001 - fail the requests, not the thread
            logger.exception("fleet launch failed")
            for req in reqs:
                if not req.future.done():
                    try:
                        req.future.set_exception(e)
                    except Exception:
                        pass

    def _trace_waits(self, reqs: List[_SchedRequest]):
        """Traced requests record their scheduler wait; returns the first
        traced request's context, which the launch runs under (disarmed:
        one global read, None)."""
        rt = trace.get_tracer()
        head_ctx = None
        if rt is not None:
            now_w, now_m = time.time(), time.monotonic()
            for req in reqs:
                if req.ctx is not None:
                    if head_ctx is None:
                        head_ctx = req.ctx
                    waited = now_m - req.t_enqueue
                    rt.event(req.ctx, "sched_wait", now_w - waited,
                             waited, priority=req.priority)
        return head_ctx

    def _resolve(self, reqs: List[_SchedRequest], bucket: int, svc: float,
                 outs: list) -> None:
        """Resolve each request with its output (an exception fails that
        request alone), count the batch, and update the service EWMA."""
        done = time.monotonic()
        latencies = []
        for req, out in zip(reqs, outs):
            latencies.append(done - req.t_enqueue)
            try:
                if isinstance(out, BaseException):
                    req.future.set_exception(out)
                else:
                    req.future.set_result(out)
            except Exception:
                pass  # cancelled between claim and resolve
        if self.stats is not None:
            self.stats.observe_batch(
                len(reqs), bucket, latencies,
                trace_ids=[getattr(r.ctx, "trace_id", None) for r in reqs])
        with self._lock:
            prev = self._svc.get(bucket)
            self._svc[bucket] = (svc if prev is None else
                                 (1 - _SVC_ALPHA) * prev + _SVC_ALPHA * svc)

    def _launch_stream(self, reqs: List[_SchedRequest]) -> None:
        """One launch of streaming-session advances: the engine owns slot
        resolution, bucket padding and the incremental step
        (`StreamingEngine.advance_batch`); the scheduler keeps the claim,
        trace and stats discipline of a stateless launch. Each item
        resolves alone: one malformed session never fails its neighbours."""
        items = []
        for req in reqs:
            s = req.session or {}
            items.append({
                "sid": s.get("sid"),
                "frames": req.clip.get("video"),
                "window": s.get("window"),
                "stride": s.get("stride"),
                "end": bool(s.get("end")),
            })
        bucket = self._bucket_for(len(reqs))
        head_ctx = self._trace_waits(reqs)
        t0 = time.perf_counter()
        with trace.attach(head_ctx):
            with trace.span("stream_dispatch", batch=len(reqs), bucket=bucket):
                with self._launch_lock:
                    outs = self.engine.advance_batch(items)
        self._resolve(reqs, bucket, time.perf_counter() - t0, outs)
