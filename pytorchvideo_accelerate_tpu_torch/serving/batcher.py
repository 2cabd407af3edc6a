"""Micro-batching in front of the device (counterpart of the JAX package's
`serving/batcher.py`).

A bounded queue feeds one flush thread that launches a batch when
`max_batch_size` requests wait OR the oldest has waited `max_wait_ms`. Each
launch is padded up to the engine's nearest bucket with zero rows + a mask,
and each request's future resolves with exactly its own row. A full queue
raises `QueueFullError` at submit time (the HTTP front maps it to 503).
A batch that raises fails its own requests' futures (the HTTP front's
500), never the flush thread; each batch run is the `serve.flush` fault
point (reliability/faults.py). Tracing (obs/trace.py): each request
carries its submitter's trace context across the queue hop; a traced
request gets its queue wait as a `queue_wait` trace event, the launch runs
as a `device_dispatch` span under the batch's first traced request, and
the latencies reach the stats with their trace ids.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from pytorchvideo_accelerate_tpu_torch.obs import trace
from pytorchvideo_accelerate_tpu_torch.reliability.faults import fault_point
from pytorchvideo_accelerate_tpu_torch.serving.engine import CLIP_KEYS, clip_key

logger = logging.getLogger("pva_tpu_torch")


class QueueFullError(RuntimeError):
    """Request queue at serve.max_queue; carries `retry_after_s` for the
    503 + Retry-After reply."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


@dataclass
class _Request:
    clip: Dict[str, np.ndarray]
    future: Future
    t_enqueue: float
    key: tuple  # clip geometry: only same-shaped requests batch together
    # the submitter's trace context, carried with the payload across the
    # queue hop (None when tracing is disarmed or the caller is untraced)
    ctx: Optional[object] = None


_STOP = object()


class MicroBatcher:
    """Bounded request queue + flush thread over an `InferenceEngine`."""

    def __init__(self, engine, *, max_batch_size: Optional[int] = None,
                 max_wait_ms: float = 5.0, max_queue: int = 256, stats=None,
                 retry_after_s: float = 1.0):
        self.retry_after_s = float(retry_after_s)
        self.engine = engine
        top = engine.buckets[-1]
        self.max_batch_size = min(max_batch_size or top, top)
        self.max_wait_s = max(max_wait_ms, 0.0) / 1e3
        self.stats = stats
        self._q: "queue.Queue" = queue.Queue(maxsize=max(max_queue, 1))
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="pva-serve-batcher", daemon=True)
        self._thread.start()

    # --- client side ------------------------------------------------------

    def submit(self, clip: Dict[str, np.ndarray]) -> Future:
        """Enqueue ONE clip — leaves (T, H, W, C) or (V, T, H, W, C) — and
        get a Future resolving to its f32 logits (num_classes,)."""
        clips = {k: np.asarray(v) for k, v in clip.items() if k in CLIP_KEYS}
        if not clips:
            raise ValueError("request has neither 'video' nor 'slow'/'fast'")
        for k, v in clips.items():
            if v.ndim not in (4, 5):
                raise ValueError(
                    f"clip {k!r} must be (T,H,W,C) or (V,T,H,W,C), "
                    f"got shape {v.shape}")
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        req = _Request(clip=clips, future=Future(),
                       t_enqueue=time.monotonic(), key=clip_key(clips),
                       ctx=trace.capture())
        try:
            self._q.put_nowait(req)
        except queue.Full:
            if self.stats is not None:
                self.stats.observe_rejected()
            raise QueueFullError(
                f"request queue full ({self._q.maxsize}); retry later",
                retry_after_s=self.retry_after_s) from None
        if self._closed.is_set() and not req.future.done():
            # close() may have drained the queue between the closed-check
            # and the put: nothing will serve this request, fail it now
            try:
                req.future.set_exception(RuntimeError("batcher closed"))
            except Exception:  # lost the race to the flush thread: resolved
                pass
        return req.future

    def queue_depth(self) -> int:
        return self._q.qsize()

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Wait for the queue to flush; True when it emptied in time."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while time.monotonic() < deadline:
            if self._q.qsize() == 0:
                return True
            time.sleep(0.01)
        return self._q.qsize() == 0

    def close(self) -> None:
        """Stop the flush thread; pending requests are failed, not dropped."""
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            self._q.put_nowait(_STOP)  # wake a blocked get()
        except queue.Full:
            pass  # the loop's bounded get() re-checks _closed within 100 ms
        self._thread.join(timeout=30.0)
        leftovers: List[_Request] = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                leftovers.append(item)
        for req in leftovers:
            req.future.set_exception(RuntimeError("batcher closed"))

    # --- flush thread -----------------------------------------------------

    def _loop(self) -> None:
        while not self._closed.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is _STOP:
                break
            batch = [first]
            deadline = first.t_enqueue + self.max_wait_s
            while len(batch) < self.max_batch_size:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=wait)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    self._closed.set()
                    break
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch: List[_Request]) -> None:
        # only identically-shaped requests share a forward
        groups: Dict[tuple, List[_Request]] = {}
        for req in batch:
            groups.setdefault(req.key, []).append(req)
        for reqs in groups.values():
            try:
                self._run(reqs)
            except Exception as e:  # noqa: BLE001 - fail the requests, not the thread
                logger.exception("serving batch failed")
                for req in reqs:
                    if not req.future.done():
                        req.future.set_exception(e)

    def _run(self, reqs: List[_Request]) -> None:
        # an injected raise fails this batch's futures in `_flush`, as a
        # real engine failure does
        fault_point("serve.flush")
        # claim each future first: a caller-cancelled future (the HTTP
        # front's timeout path) drops out here, and a claimed one can no
        # longer be cancelled while set_result runs below
        reqs = [r for r in reqs if r.future.set_running_or_notify_cancel()]
        if not reqs:
            return
        n = len(reqs)
        bucket = self.engine.bucket_for(n)
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
        # each traced request's queue wait is a trace event; the dispatch
        # runs under the first traced request's context. Disarmed: one
        # global read and the shared no-ops
        rt = trace.get_tracer()
        head_ctx = None
        if rt is not None:
            now_w, now_m = time.time(), time.monotonic()
            for req in reqs:
                if req.ctx is not None:
                    if head_ctx is None:
                        head_ctx = req.ctx
                    waited = now_m - req.t_enqueue
                    rt.event(req.ctx, "queue_wait", now_w - waited, waited)
        with trace.attach(head_ctx):
            with trace.span("device_dispatch", batch=n, bucket=bucket):
                logits = self.engine.predict(stacked)
        done = time.monotonic()
        # padded rows are sliced away here: response i carries row i only
        latencies = []
        for i, req in enumerate(reqs):
            latencies.append(done - req.t_enqueue)
            req.future.set_result(logits[i])
        if self.stats is not None:
            self.stats.observe_batch(
                n, bucket, latencies,
                trace_ids=[getattr(r.ctx, "trace_id", None) for r in reqs])
