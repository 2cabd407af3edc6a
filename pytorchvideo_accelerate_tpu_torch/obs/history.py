"""Bounded time series over `Registry.scrape()` ticks (the port's copy of
the JAX package's `obs/history.py`).

`/metrics` and `Registry.scrape()` are instants. `MetricsHistory` keeps a
bounded ring of (timestamp, flat scrape dict) ticks, with window reads
(`series` / `window_mean` / `ratio`; the JAX module's `rate`, `latest` and
`ewma` come with the fleet controller that reads them) over the same keys
the scrape emits (``name{label="v"}`` flat keys, histogram
``_sum``/``_count`` pairs). `obs/alerts.py` evaluates its burn-rate rules
over it, the serving server exposes it as `GET /history`, and the trainer
ticks it at every `log_every` boundary.

Ticks are pulled, not pushed: whoever owns a cadence (the alert engine's
tick, the trainer, a test) calls `tick()`; `now=` injects the clock.
Module-level `get_history()` is one global read; nothing ticks until
`configure()` arms a ring. Stdlib only.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from pytorchvideo_accelerate_tpu_torch.utils.sync import make_lock, shared_state

_DEFAULT: Optional["MetricsHistory"] = None


@shared_state("_ticks", "_head", "_total_ticks")
class MetricsHistory:
    """Ring of (ts, scrape) ticks; reads race the ticker thread."""

    def __init__(self, registry=None, capacity: int = 512,
                 prefix: str = "pva_"):
        from pytorchvideo_accelerate_tpu_torch.obs.registry import get_registry

        if capacity < 2:
            raise ValueError("history needs >= 2 ticks to hold a window")
        self._lock = make_lock("obs.MetricsHistory._lock")
        self.capacity = int(capacity)
        self.prefix = prefix
        self.registry = registry if registry is not None else get_registry()
        self._ticks: List[Tuple[float, Dict[str, float]]] = []
        self._head = 0  # ring start index once the list is full
        self._total_ticks = 0

    # --- writing ------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Dict[str, float]:
        """Scrape the registry and append one tick (evicting the oldest
        past capacity). Returns the scrape so a caller can piggyback."""
        snap = self.registry.scrape(self.prefix)
        ts = time.time() if now is None else float(now)
        with self._lock:
            if len(self._ticks) < self.capacity:
                self._ticks.append((ts, snap))
            else:
                self._ticks[self._head] = (ts, snap)
                self._head = (self._head + 1) % self.capacity
            self._total_ticks += 1
        return snap

    # --- reading ------------------------------------------------------------

    def _ordered(self) -> List[Tuple[float, Dict[str, float]]]:
        with self._lock:
            if len(self._ticks) < self.capacity:
                return list(self._ticks)
            return self._ticks[self._head:] + self._ticks[:self._head]

    def series(self, key: str, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """(ts, value) points for one flat scrape key, oldest first,
        optionally restricted to the trailing `window_s` seconds.

        A bare metric name that only exists labeled (``key{...}``) reads
        as the SUM across its label values per tick — so a rule over
        ``pva_serving_shed_total`` sees all shed causes without having to
        enumerate ``{state=...}`` variants."""
        ticks = self._ordered()
        if window_s is not None:
            cutoff = (time.time() if now is None else now) - window_s
            ticks = [t for t in ticks if t[0] >= cutoff]
        out: List[Tuple[float, float]] = []
        probe = key + "{"
        for ts, snap in ticks:
            if key in snap:
                out.append((ts, snap[key]))
                continue
            vals = [v for k, v in snap.items() if k.startswith(probe)]
            if vals:
                out.append((ts, sum(vals)))
        return out

    def ewma(self, key: str, halflife_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Irregular-interval EWMA over the whole retained series (the fleet
        controller's `SignalReader` read): alpha per step from the actual
        tick gap."""
        pts = self.series(key)
        if not pts:
            return None
        acc = pts[0][1]
        prev_ts = pts[0][0]
        for ts, v in pts[1:]:
            dt = max(0.0, ts - prev_ts)
            alpha = 1.0 - 0.5 ** (dt / halflife_s) if halflife_s > 0 else 1.0
            acc += alpha * (v - acc)
            prev_ts = ts
        return acc

    def window_mean(self, key: str, window_s: float,
                    now: Optional[float] = None) -> Optional[float]:
        pts = self.series(key, window_s=window_s, now=now)
        if not pts:
            return None
        return sum(v for _, v in pts) / len(pts)

    def ratio(self, num_key: str, den_key: str, window_s: float,
              now: Optional[float] = None) -> Optional[float]:
        """delta(num)/delta(den) over the window — the error-fraction /
        shed-fraction read for counter pairs (and histogram _sum/_count
        pairs, which gives a true windowed mean latency). None when the
        denominator did not move."""
        npts = self.series(num_key, window_s=window_s, now=now)
        dpts = self.series(den_key, window_s=window_s, now=now)
        if len(npts) < 2 or len(dpts) < 2:
            return None
        dden = dpts[-1][1] - dpts[0][1]
        if dden <= 0:
            return None
        return max(0.0, (npts[-1][1] - npts[0][1])) / dden

    # --- export -------------------------------------------------------------

    def occupancy(self) -> int:
        with self._lock:
            return len(self._ticks)

    def total_ticks(self) -> int:
        with self._lock:
            return self._total_ticks

    def snapshot(self) -> Dict:
        ticks = self._ordered()
        return {
            "capacity": self.capacity,
            "occupancy": len(ticks),
            "total_ticks": self.total_ticks(),
            "span_s": (ticks[-1][0] - ticks[0][0]) if len(ticks) > 1 else 0.0,
        }

    def to_json(self, keys: Optional[List[str]] = None,
                window_s: Optional[float] = None) -> Dict:
        """The `GET /history` payload: ring metadata + per-key series
        (every retained key when `keys` is None — bounded by capacity, so
        the response is bounded too)."""
        ticks = self._ordered()
        if window_s is not None:
            cutoff = time.time() - window_s
            ticks = [t for t in ticks if t[0] >= cutoff]
        if keys is None:
            seen = {}
            for _, snap in ticks:
                seen.update(dict.fromkeys(snap))
            keys = sorted(seen)
        out = self.snapshot()
        out["series"] = {
            k: [[round(ts, 3), v] for ts, snap in ticks
                if (v := snap.get(k)) is not None]
            for k in keys}
        return out


def get_history() -> Optional[MetricsHistory]:
    return _DEFAULT


def configure(enabled: bool = True, **kwargs) -> Optional[MetricsHistory]:
    """Arm (or disarm) the process-default history ring."""
    global _DEFAULT
    _DEFAULT = MetricsHistory(**kwargs) if enabled else None
    return _DEFAULT
