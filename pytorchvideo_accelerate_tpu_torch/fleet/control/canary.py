"""Canary rollout: fractional hot-swap, direction-aware verdict,
escalation-ladder rollback (the port's copy of the JAX package's
`fleet/control/canary.py`).

The third control loop: a new artifact never cuts over the whole fleet
at once. `start_rollout` hot-swaps it onto `fraction` of the routable
replicas (blue/green per replica — `fleet/hotswap.swap_replica`, so
cutover blackout stays bounded and pre-warmed), keeping each victim's
BLUE engine for the rollback path. Traffic then splits naturally through
the router, and `evaluate()` compares canary-vs-baseline the only honest
way this repo knows:

- **pooled windows, post-rollout only**: raw latency samples from each
  side's `ServingStats.window()`, filtered to completions AFTER the
  cutover timestamp and pooled before taking percentiles (never
  percentiles-of-percentiles), plus counter DELTAS since cutover for
  errors/sheds (cumulative counters would charge pre-rollout history to
  the canary);
- **direction-aware deltas**: the comparison reuses
  `analysis/perfdiff.diff_rounds` — p99 up is bad, throughput down is
  bad, the same thresholds and vocabulary as a cross-round perf gate —
  so a canary verdict and a round-to-round diff argue from one
  definition of "regressed";
- **exemplar-linked traces**: the verdict carries the canary side's
  `slowest_traces`, so a rollback isn't an anonymous number — it names
  the trace ids of the requests that condemned the artifact.

Regression handling follows TrainGuard's escalation-ladder discipline
(reliability/guard.py): a single bad window is a STRIKE (recorded,
observed again), `rollback_after` consecutive strikes trigger the
auto-rollback — every canary replica swaps back to its kept blue engine
— and a clean window resets the ladder. A clean verdict `promote()`s the
green artifact onto the remaining replicas, replica-by-replica, zero
downtime.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from pytorchvideo_accelerate_tpu_torch import obs
from pytorchvideo_accelerate_tpu_torch.analysis.perfdiff import diff_rounds
from pytorchvideo_accelerate_tpu_torch.fleet.hotswap import swap_replica
from pytorchvideo_accelerate_tpu_torch.serving.stats import _percentile

logger = logging.getLogger("pva_tpu_torch")


class CanaryController:
    """Fractional blue/green rollout with auto-rollback over a `Router`."""

    # counter keys whose DELTA since cutover feeds the verdict
    _DELTA_KEYS = ("requests", "errors", "shed", "rejected")

    def __init__(self, router, *, fraction: Optional[float] = None,
                 threshold: Optional[float] = None,
                 rollback_after: Optional[int] = None,
                 prewarm: bool = True, fleet=None):
        # dial defaults are the control.* config block's (single source
        # of truth for the canary discipline)
        from pytorchvideo_accelerate_tpu_torch.config import ControlConfig

        dials = ControlConfig()
        if fraction is None:
            fraction = dials.canary_fraction
        if threshold is None:
            threshold = dials.canary_threshold
        if rollback_after is None:
            rollback_after = dials.canary_rollback_after
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1], "
                             f"got {fraction}")
        self.router = router
        self.pool = router.pool
        # optional MultiModelFleet: families then come from fleet.models()
        # and each family's model_snapshot rides the verdict (replicas of
        # a family carry stats minted by fleet.stats_for, so each side's
        # windows pool on the family's own latency ladder)
        self.fleet = fleet
        self.fraction = float(fraction)
        self.threshold = float(threshold)
        self.rollback_after = max(int(rollback_after), 1)
        self.prewarm = bool(prewarm)
        self._lock = threading.Lock()
        self.state = "idle"  # idle -> canary -> rolled_back | promoted
        self.history: List[dict] = []
        self._strikes = 0
        self._blues: Dict[str, object] = {}   # replica name -> kept engine
        self._base_counts: Dict[str, Dict[str, float]] = {}
        self._canaries: List = []
        self._green_factory: Optional[Callable] = None
        self._t_rollout = 0.0

    # --- rollout ----------------------------------------------------------

    def start_rollout(self, green_factory: Callable[[object], object],
                      label: str = "canary") -> dict:
        """Swap green onto `fraction` of the routable replicas.
        `green_factory(replica)` builds a fresh green engine for that
        replica (its own device and stats — the hot_swap contract)."""
        with self._lock:
            if self.state == "canary":
                raise RuntimeError("a canary rollout is already in flight")
            self.state = "canary"
            self._strikes = 0
        routable = [r for r in self.pool.routable()
                    if hasattr(r, "scheduler")]
        if not routable:
            with self._lock:
                self.state = "idle"
            raise RuntimeError("no routable in-process replicas to canary")
        n = max(1, int(len(routable) * self.fraction))
        # never canary the WHOLE fleet unless fraction says exactly that:
        # the baseline side must keep at least one replica to compare
        # against (and to serve, should the canary be a brick)
        if self.fraction < 1.0:
            n = min(n, len(routable) - 1) or 1
        self._canaries = routable[:n]
        self._green_factory = green_factory
        # counter baselines for BOTH sides, captured before the first swap:
        # deltas since this instant are what evaluate() compares
        with self._lock:
            for r in routable:
                self._base_counts[r.name] = self._counts(r)
        blackouts = {}
        for replica in self._canaries:
            blue = replica.scheduler.current_engine()
            with self._lock:
                self._blues[replica.name] = blue
            green = green_factory(replica)
            blackouts[replica.name] = round(
                swap_replica(replica, green, prewarm=self.prewarm) * 1e3, 3)
        self._t_rollout = time.monotonic()
        entry = {"t": self._t_rollout, "event": "rollout", "label": label,
                 "canaries": [r.name for r in self._canaries],
                 "blackout_ms": blackouts}
        with self._lock:
            self.history.append(entry)
        logger.info("canary: %s on %s (blackouts %s)", label,
                    entry["canaries"], blackouts)
        obs.get_recorder().record("fleet", "canary-rollout", label=label,
                                  replicas=",".join(entry["canaries"]))
        return entry

    # --- observation ------------------------------------------------------

    @staticmethod
    def _counts(replica) -> Dict[str, float]:
        snap = replica.stats.snapshot() if replica.stats is not None else {}
        return {k: float(snap.get(k, 0.0))
                for k in CanaryController._DELTA_KEYS}

    def _families(self, baseline_side) -> List[str]:
        """Model families present across both sides: the attached fleet's
        registration-stable enumeration when one was given, else the
        replicas' own `model` labels (unlabeled replicas -> no families ->
        pool-level comparison)."""
        if self.fleet is not None:
            return list(self.fleet.models())
        seen: List[str] = []
        for r in list(self._canaries) + list(baseline_side):
            m = getattr(r, "model", None)
            if m is not None and m not in seen:
                seen.append(m)
        return seen

    def _side_stats(self, replicas) -> Dict[str, float]:
        """Pooled post-rollout window + counter deltas for one side."""
        lat: List[float] = []
        out = {k: 0.0 for k in self._DELTA_KEYS}
        n_stats = 0
        for r in replicas:
            if r.stats is None:
                continue
            n_stats += 1
            w, _ = r.stats.window()
            lat.extend(v for ts, v in w if ts >= self._t_rollout)
            base = self._base_counts.get(r.name, {})
            for k, v in self._counts(r).items():
                out[k] += v - base.get(k, 0.0)
        vals = sorted(lat)
        out["completions"] = float(len(vals))
        out["serve_p50_ms"] = round(_percentile(vals, 50) * 1e3, 3)
        out["serve_p99_ms"] = round(_percentile(vals, 99) * 1e3, 3)
        span = time.monotonic() - self._t_rollout
        # PER-REPLICA completion rate: the two sides hold different
        # replica counts by construction (that's what a canary is), so a
        # side-absolute rps would read "canary is 1/N of the fleet" as a
        # throughput regression every single time
        out["serve_rps"] = (round(len(vals) / span / max(n_stats, 1), 3)
                            if span > 0 else 0.0)
        out["error_frac"] = (out["errors"] / out["requests"]
                             if out["requests"] > 0 else 0.0)
        return out

    def evaluate(self) -> dict:
        """One observation window -> a ladder verdict. Returns the verdict
        dict; `action` is "observe" (clean or a first strike), "rollback"
        (the ladder fired and the fleet was restored), and
        `rolled_back`/`strikes` carry the ladder state.

        Multi-model pools: the comparison
        runs PER FAMILY — each side's windows pool only within one
        `replica.model` — because a pool-wide pooled window dilutes a
        regression that lives in one family (and a traffic-mix shift
        between a fast and a slow family reads as a phantom one). A
        regression in ANY family strikes the ladder, tagged
        ``<family>:<key>``. Single-family (or unlabeled) pools keep the
        original pool-level comparison and verdict shape exactly."""
        with self._lock:
            if self.state != "canary":
                raise RuntimeError(f"no canary in flight (state "
                                   f"{self.state!r})")
        baseline_side = [r for r in self.pool.replicas
                         if r not in self._canaries
                         and getattr(r, "stats", None) is not None]
        canary = self._side_stats(self._canaries)
        baseline = self._side_stats(baseline_side)
        # the cross-round perf gate's own direction-aware comparison:
        # baseline plays the "old" round, the canary the "new" one
        diff = diff_rounds(baseline, canary, threshold=self.threshold)
        families = self._families(baseline_side)
        per_family: Dict[str, dict] = {}
        if len(families) > 1:
            regressions = []
            for family in families:
                c_side = [r for r in self._canaries
                          if getattr(r, "model", None) == family]
                b_side = [r for r in baseline_side
                          if getattr(r, "model", None) == family]
                entry: dict = {"canaries": len(c_side),
                               "baselines": len(b_side)}
                if self.fleet is not None:
                    entry["snapshot"] = self.fleet.model_snapshot(family)
                if not c_side or not b_side:
                    # an uncompared family is a recorded fact, never a
                    # silent pass OR a phantom strike
                    entry["skipped"] = ("no canary replicas" if not c_side
                                        else "no baseline replicas")
                    per_family[family] = entry
                    continue
                fc = self._side_stats(c_side)
                fb = self._side_stats(b_side)
                fdiff = diff_rounds(fb, fc, threshold=self.threshold)
                fregs = list(fdiff["regressions"])
                if fc["error_frac"] > fb["error_frac"] and fc["errors"] > 0:
                    fregs.append("canary_error_frac")
                entry.update(canary=fc, baseline=fb,
                             regressions=sorted(fregs))
                per_family[family] = entry
                regressions.extend(f"{family}:{k}" for k in fregs)
        else:
            regressions = list(diff["regressions"])
            if (canary["error_frac"] > baseline["error_frac"]
                    and canary["errors"] > 0):
                regressions.append("canary_error_frac")
        slowest: List[dict] = []
        for r in self._canaries:
            if getattr(r, "stats", None) is not None:
                slowest.extend(r.stats.slowest_traces(k=3))
        slowest.sort(key=lambda d: -d.get("latency_ms", 0.0))
        verdict = {
            "t": time.monotonic(),
            "event": "evaluate",
            "regressions": sorted(regressions),
            "canary": canary,
            "baseline": baseline,
            "keys": diff["keys"],
            # exemplar-linked evidence: the traces that condemned (or
            # acquitted) the artifact, worst first
            "slowest_traces": slowest[:5],
        }
        if per_family:
            verdict["families"] = per_family
        if regressions:
            with self._lock:
                self._strikes += 1
                strikes = self._strikes
            verdict["strikes"] = strikes
            if strikes >= self.rollback_after:
                verdict["action"] = "rollback"
                verdict.update(self.rollback())
            else:
                # below the ladder threshold: recorded, observed again
                verdict["action"] = "observe"
                verdict["rolled_back"] = False
        else:
            with self._lock:
                self._strikes = 0  # a clean window resets the ladder
            verdict["strikes"] = 0
            verdict["action"] = "observe"
            verdict["rolled_back"] = False
        with self._lock:
            self.history.append(verdict)
        obs.get_recorder().record(
            "fleet", "canary-evaluate", action=verdict["action"],
            strikes=verdict["strikes"],
            regressions=",".join(verdict["regressions"]))
        return verdict

    # --- resolution -------------------------------------------------------

    def rollback(self) -> dict:
        """Swap every canary replica back to its kept blue engine."""
        blackouts = {}
        for replica in self._canaries:
            blue = self._blues.get(replica.name)
            if blue is None:
                continue
            # blue's compiled cache is intact — no prewarm needed
            blackouts[replica.name] = round(
                swap_replica(replica, blue, prewarm=False) * 1e3, 3)
        with self._lock:
            self.state = "rolled_back"
            self._blues.clear()
        logger.warning("canary: ROLLED BACK (blackouts %s)", blackouts)
        obs.get_recorder().record("fleet", "canary-rollback",
                                  replicas=",".join(blackouts))
        return {"rolled_back": True, "rollback_blackout_ms": blackouts}

    def promote(self) -> dict:
        """Clean canary -> cut the REST of the fleet over to green,
        replica-by-replica (the rest keep serving — zero downtime)."""
        with self._lock:
            if self.state != "canary":
                raise RuntimeError(f"nothing to promote (state "
                                   f"{self.state!r})")
            if self._strikes:
                raise RuntimeError(
                    f"refusing to promote with {self._strikes} strike(s) "
                    "on the ladder; evaluate() a clean window first")
        blackouts = {}
        canary_names = {r.name for r in self._canaries}
        for replica in self.pool.routable():
            if replica.name in canary_names or not hasattr(replica,
                                                           "scheduler"):
                continue
            green = self._green_factory(replica)
            blackouts[replica.name] = round(
                swap_replica(replica, green, prewarm=self.prewarm) * 1e3, 3)
        with self._lock:
            self.state = "promoted"
            self._blues.clear()
        logger.info("canary: promoted fleet-wide (blackouts %s)", blackouts)
        obs.get_recorder().record("fleet", "canary-promote",
                                  replicas=",".join(blackouts))
        return {"promoted": True, "promote_blackout_ms": blackouts}
