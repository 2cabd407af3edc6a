"""Serving statistics for `/stats` and `/metrics` (counterpart of the JAX
package's `serving/stats.py`, without its trace exemplars).

`snapshot()` returns a flat {str: float}: latency percentiles (enqueue ->
response, ms) over the last `window` completed requests, batch-fill ratio
(real rows / padded bucket rows), throughput over the window span, the live
queue depth, and cumulative counters with rejections split by HTTP cause
("400" bad request, "503" queue full, "504" budget) and sheds apart from
them.

The counters and the latency histogram live in this object's own
`obs.registry.Registry`: `/metrics` renders it and `/stats` reads the same
counter objects, so the two surfaces cannot drift. Names, labels and help
strings are the JAX package's, so one dashboard reads both servers.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence

from pytorchvideo_accelerate_tpu_torch.obs.registry import (
    DEFAULT_BUCKETS,
    Registry,
    family_buckets,
)

# request latencies are enqueue -> response: sub-ms through multi-second
# (a deep queue); the shared bounds plus a 30 s tail for the
# request_timeout_s budget region
LATENCY_BUCKETS = DEFAULT_BUCKETS + (30.0,)


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * len(sorted_vals) + 0.5)) - 1))
    return float(sorted_vals[idx])


def _window_stats(lat: list, fills: list) -> Dict[str, float]:
    """Percentiles, fill ratio and throughput of raw window samples."""
    vals = sorted(v for _, v in lat)
    out = {"p50_ms": round(_percentile(vals, 50) * 1e3, 3),
           "p95_ms": round(_percentile(vals, 95) * 1e3, 3),
           "p99_ms": round(_percentile(vals, 99) * 1e3, 3)}
    real = sum(n for n, _ in fills)
    padded = sum(b for _, b in fills)
    out["batch_fill_ratio"] = round(real / padded, 4) if padded else 0.0
    # requests completed per second between the oldest and newest entries
    # (0 with fewer than 2 completions: no span to divide by)
    if len(lat) >= 2 and lat[-1][0] > lat[0][0]:
        out["throughput_rps"] = round(
            (len(lat) - 1) / (lat[-1][0] - lat[0][0]), 3)
    else:
        out["throughput_rps"] = 0.0
    return out


class ServingStats:
    """Thread-safe rolling serving metrics over a private registry (several
    servers in one process must not share counters or gauge callbacks)."""

    def __init__(self, window: int = 1024,
                 queue_depth_fn: Optional[Callable[[], int]] = None,
                 latency_buckets: Optional[Sequence[float]] = None):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=max(window, 1))     # (done_ts, latency_s)
        self._fills = deque(maxlen=max(window, 1))   # (n_real, bucket)
        self.queue_depth_fn = queue_depth_fn
        self._started = time.monotonic()
        self.registry = Registry()
        self._c_requests = self.registry.counter(
            "pva_serving_requests_total", "requests completed successfully")
        self._c_batches = self.registry.counter(
            "pva_serving_batches_total", "batches launched on the engine")
        self._c_rejected = self.registry.counter(
            "pva_serving_rejected_total",
            "requests rejected before completion, by HTTP cause",
            labelnames=("cause",))
        self._c_errors = self.registry.counter(
            "pva_serving_errors_total",
            "requests failed by an engine/batch error (HTTP 500)")
        # a shed is admission control or the scheduler's deadline check
        # working as designed, apart from a hard queue-full 503
        self._c_shed = self.registry.counter(
            "pva_serving_shed_total",
            "requests shed by admission control (503 + Retry-After), "
            "by service state", labelnames=("state",))
        self._c_compiles = self.registry.counter(
            "pva_serving_compiled_buckets_total",
            "new (bucket, views) shapes compiled by the engine")
        # explicit per-instance bounds win, then a registered family
        # default (obs.registry.set_family_buckets), then the shared ladder
        self._h_latency = self.registry.histogram(
            "pva_serving_request_latency_seconds",
            "enqueue-to-response latency of completed requests",
            buckets=(tuple(latency_buckets) if latency_buckets
                     else family_buckets("pva_serving_request_latency_seconds",
                                         default=LATENCY_BUCKETS)))
        self.registry.gauge(
            "pva_serving_queue_depth",
            "requests queued but not yet batched").set_function(
                lambda: float(self.queue_depth_fn())
                if self.queue_depth_fn is not None else 0.0)
        self.registry.gauge(
            "pva_serving_uptime_seconds",
            "seconds since this ServingStats was created").set_function(
                lambda: time.monotonic() - self._started)

    def observe_batch(self, n_real: int, bucket: int,
                      latencies_s: Sequence[float]) -> None:
        now = time.monotonic()
        self._c_requests.inc(len(latencies_s))
        self._c_batches.inc()
        for lat in latencies_s:
            self._h_latency.observe(lat)
        with self._lock:
            self._fills.append((int(n_real), int(bucket)))
            for lat in latencies_s:
                self._lat.append((now, float(lat)))

    def observe_rejected(self, cause: str = "503", n: int = 1) -> None:
        """A request refused before completion; `cause` is the HTTP status."""
        self._c_rejected.inc(n, cause=str(cause))

    def observe_shed(self, state: str = "degraded", n: int = 1) -> None:
        """A request shed with 503 + Retry-After before it ran: by admission
        control ("degraded" | "draining") or by the scheduler ("deadline")."""
        self._c_shed.inc(n, state=str(state))

    def observe_error(self, n: int = 1) -> None:
        """A request failed by an engine/batch exception (HTTP 500)."""
        self._c_errors.inc(n)

    def observe_compile(self) -> None:
        self._c_compiles.inc()

    def window(self) -> tuple:
        """Raw window samples for pooling across replicas: (latencies
        [(done_ts, latency_s)], fills [(n_real, bucket)])."""
        with self._lock:
            return list(self._lat), list(self._fills)

    @staticmethod
    def merge(stats_list: Sequence["ServingStats"],
              extra: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """Aggregate across replicas: counters sum, percentiles over the
        POOLED raw windows (never an average of percentiles). Each replica's
        `shed` counts what it shed itself; router-level sheds ride in `extra`
        and are not folded into `shed`, so a shed counts once."""
        keys = ("requests", "batches", "errors", "rejected",
                "rejected_400", "rejected_503", "rejected_504", "shed",
                "compiled_buckets")
        out: Dict[str, float] = {k: 0.0 for k in keys}
        lat: list = []
        fills: list = []
        for st in stats_list:
            snap = st.snapshot()
            for k in keys:
                out[k] += snap.get(k, 0.0)
            w_lat, w_fills = st.window()
            lat.extend(w_lat)
            fills.extend(w_fills)
        lat.sort(key=lambda s: s[0])
        out.update(_window_stats(lat, fills))
        out["replicas"] = float(len(stats_list))
        out.update(extra or {})
        return out

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            lat = list(self._lat)
            fills = list(self._fills)
        out: Dict[str, float] = {
            "requests": self._c_requests.total(),
            "batches": self._c_batches.total(),
            "errors": self._c_errors.total(),
            "compiled_buckets": self._c_compiles.total(),
            "uptime_s": round(time.monotonic() - self._started, 3),
        }
        # one locked read feeds both the split and the aggregate
        rejected = {labels.get("cause"): v
                    for labels, v in self._c_rejected.samples()}
        out["rejected"] = float(sum(rejected.values()))
        for cause in ("400", "503", "504"):
            out[f"rejected_{cause}"] = float(rejected.get(cause, 0.0))
        out["shed"] = self._c_shed.total()
        out.update(_window_stats(lat, fills))
        if self.queue_depth_fn is not None:
            try:
                out["queue_depth"] = float(self.queue_depth_fn())
            except Exception:  # a closing batcher must not break /stats
                out["queue_depth"] = 0.0
        return out
