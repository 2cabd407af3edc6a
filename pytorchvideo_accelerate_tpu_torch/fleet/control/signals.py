"""Registry-fed control signals: what the fleet controller acts on (the
port's copy of the JAX package's `fleet/control/signals.py`).

The autoscaler/canary loops must argue from the SAME numbers a human
watching `/metrics` sees — not from a private side-channel that can
drift. `SignalReader.read()` therefore sources every scalar it can from
the router's obs registry (`Registry.scrape()` — the exact series the
Prometheus endpoint renders: `pva_fleet_healthy_replicas{pool=}`,
`pva_fleet_outstanding{pool=,replica=}`, `pva_fleet_shed_total{pool=}`)
and takes only the pooled latency percentiles from
`Router.fleet_snapshot()` — raw latency windows never cross the metrics
wire (cumulative histograms lose the rolling-window property), and
percentiles-of-percentiles would lie (stats.py `merge`).

`ControlSignals` is deliberately a plain frozen snapshot: one read per
control tick, decisions on the snapshot, never live reads mid-decision —
a controller that reads twice can see two different fleets and flap.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


logger = logging.getLogger("pva_tpu_torch")


@dataclass(frozen=True)
class ControlSignals:
    """One control tick's view of the fleet (all floats; -1 = unknown)."""

    t: float                 # monotonic read time
    routable: float          # replicas in the routable set (registry gauge)
    members: float           # total pool membership (routable + down)
    outstanding: float       # in-flight requests, summed over replicas
    queue_depth: float       # router-tracked dispatched-not-settled depth
    p99_ms: float            # pooled-window p99 (0.0 = no windowed samples)
    throughput_rps: float    # pooled-window completion rate
    shed_total: float        # cumulative router sheds (counter, monotonic)
    per_replica_outstanding: Dict[str, float] = field(default_factory=dict)

    def queue_per_replica(self) -> float:
        """Backlog pressure normalized by serving capacity."""
        return self.queue_depth / max(self.routable, 1.0)


class SignalReader:
    """Reads `ControlSignals` off a router's registry + pooled windows.

    With a shared `MetricsHistory` attached, each `read()`
    also appends a scrape tick to the ring, and `ewma()` serves smoothed
    series straight from that shared history — so the autoscaler, the
    alert rules, and `/history` all argue from ONE retained time base
    instead of per-consumer private smoothing state.
    """

    # prefix of every router/pool series in the registry scrape
    _FLEET_PREFIX = "pva_fleet_"

    def __init__(self, router, *, model: Optional[str] = None,
                 history=None):
        self.router = router
        self.model = model
        self._pool_label = router.pool.name
        self.history = history  # obs.history.MetricsHistory or None
        self._last: Optional[ControlSignals] = None
        if history is not None:
            # the two control-loop series exist nowhere else in the
            # registry (p99 comes from pooled windows, queue-per-replica
            # is a derived ratio): publish them as live gauges off the
            # last read snapshot so the history ring retains them
            pool = self._pool_label
            router.registry.gauge(
                "pva_fleet_queue_per_replica",
                "router backlog normalized by routable capacity",
                labelnames=("pool",),
            ).set_function(
                lambda: (self._last.queue_per_replica()
                         if self._last is not None else 0.0), pool=pool)
            router.registry.gauge(
                "pva_fleet_p99_ms",
                "pooled-window p99 latency as read by the control loop",
                labelnames=("pool",),
            ).set_function(
                lambda: (self._last.p99_ms
                         if self._last is not None else 0.0), pool=pool)

    def ewma(self, name: str, halflife_s: float) -> Optional[float]:
        """EWMA of a pool-labeled fleet series from the shared history
        ring; None when no history is attached or the series is empty."""
        if self.history is None:
            return None
        return self.history.ewma(
            f'{name}{{pool="{self._pool_label}"}}', halflife_s)

    def _series(self, scrape: Dict[str, float], name: str,
                **labels: str) -> float:
        """One sample from a scrape dict, keyed the way render() keys it."""
        if not labels:
            return float(scrape.get(name, 0.0))
        inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
        return float(scrape.get(f"{name}{{{inner}}}", 0.0))

    def read(self, model: Optional[str] = None) -> ControlSignals:
        model = model if model is not None else self.model
        scrape = self.router.registry.scrape(self._FLEET_PREFIX)
        routable = self._series(scrape, "pva_fleet_healthy_replicas",
                                pool=self._pool_label)
        shed = self._series(scrape, "pva_fleet_shed_total",
                            pool=self._pool_label)
        per_replica = {}
        prefix = 'pva_fleet_outstanding{pool="%s",replica="' % self._pool_label
        for key, v in scrape.items():
            if key.startswith(prefix):
                per_replica[key[len(prefix):-2]] = float(v)
        # pooled-window percentiles: the one signal the registry cannot
        # carry (see module docstring); same snapshot call /stats serves
        snap = self.router.fleet_snapshot(model=model)
        sig = ControlSignals(
            t=time.monotonic(),
            routable=routable,
            members=float(snap.get("replicas_total",
                                   snap.get("replicas", 0.0))),
            outstanding=sum(per_replica.values()),
            queue_depth=float(self.router.queue_depth()),
            p99_ms=float(snap.get("p99_ms", 0.0)),
            throughput_rps=float(snap.get("throughput_rps", 0.0)),
            shed_total=shed,
            per_replica_outstanding=per_replica,
        )
        self._last = sig
        if self.history is not None:
            # one scrape tick per control read: the shared ring's cadence
            # IS the control cadence (the gauges above read self._last)
            self.history.tick()
        return sig
