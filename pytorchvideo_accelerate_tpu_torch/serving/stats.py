"""Serving statistics for `/stats` (counterpart of the JAX package's
`serving/stats.py` without the Prometheus registry).

`snapshot()` returns a flat {str: float}: latency percentiles (enqueue ->
response, ms) over the last `window` completed requests, batch-fill ratio
(real rows / padded bucket rows), throughput over the window span, the live
queue depth, and cumulative counters with rejections split by HTTP cause
("400" bad request, "503" queue full, "504" budget) and admission sheds
apart from them.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Callable, Dict, Optional, Sequence


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * len(sorted_vals) + 0.5)) - 1))
    return float(sorted_vals[idx])


class ServingStats:
    """Thread-safe rolling serving metrics."""

    def __init__(self, window: int = 1024,
                 queue_depth_fn: Optional[Callable[[], int]] = None):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=max(window, 1))     # (done_ts, latency_s)
        self._fills = deque(maxlen=max(window, 1))   # (n_real, bucket)
        self._counts: Counter = Counter()
        self.queue_depth_fn = queue_depth_fn
        self._started = time.monotonic()

    def observe_batch(self, n_real: int, bucket: int,
                      latencies_s: Sequence[float]) -> None:
        now = time.monotonic()
        with self._lock:
            self._counts["requests"] += len(latencies_s)
            self._counts["batches"] += 1
            self._fills.append((int(n_real), int(bucket)))
            for lat in latencies_s:
                self._lat.append((now, float(lat)))

    def observe_rejected(self, cause: str = "503", n: int = 1) -> None:
        """A request refused before completion; `cause` is the HTTP status."""
        with self._lock:
            self._counts[f"rejected_{cause}"] += n

    def observe_shed(self, n: int = 1) -> None:
        """A request shed by admission control before it touched the queue."""
        with self._lock:
            self._counts["shed"] += n

    def observe_error(self, n: int = 1) -> None:
        """A request failed by an engine/batch exception (HTTP 500)."""
        with self._lock:
            self._counts["errors"] += n

    def observe_compile(self) -> None:
        with self._lock:
            self._counts["compiled_buckets"] += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            lat = list(self._lat)
            fills = list(self._fills)
            counts = dict(self._counts)
        out: Dict[str, float] = {
            k: float(counts.get(k, 0))
            for k in ("requests", "batches", "errors", "compiled_buckets")}
        out["uptime_s"] = round(time.monotonic() - self._started, 3)
        for cause in ("400", "503", "504"):
            out[f"rejected_{cause}"] = float(counts.get(f"rejected_{cause}", 0))
        out["rejected"] = sum(out[f"rejected_{c}"] for c in ("400", "503", "504"))
        out["shed"] = float(counts.get("shed", 0))
        vals = sorted(v for _, v in lat)
        out["p50_ms"] = round(_percentile(vals, 50) * 1e3, 3)
        out["p95_ms"] = round(_percentile(vals, 95) * 1e3, 3)
        out["p99_ms"] = round(_percentile(vals, 99) * 1e3, 3)
        real = sum(n for n, _ in fills)
        padded = sum(b for _, b in fills)
        out["batch_fill_ratio"] = round(real / padded, 4) if padded else 0.0
        if len(lat) >= 2 and lat[-1][0] > lat[0][0]:
            out["throughput_rps"] = round(
                (len(lat) - 1) / (lat[-1][0] - lat[0][0]), 3)
        else:
            out["throughput_rps"] = 0.0
        if self.queue_depth_fn is not None:
            out["queue_depth"] = float(self.queue_depth_fn())
        return out
