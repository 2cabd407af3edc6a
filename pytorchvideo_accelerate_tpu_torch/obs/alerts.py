"""Multi-window SLO burn-rate alerting over the metrics history (the
port's copy of the JAX package's `obs/alerts.py`).

A rule fires only when both a fast and a slow window burn past its `burn`
factor, and clears only after both have been below the lower `clear_burn`
for `hold_clear` consecutive ticks (hysteresis: one recovered tick never
toggles an alert). A rule reads one series of `MetricsHistory`:

- ``kind="gauge"`` — window mean of an instantaneous value; burn = mean /
  objective.
- ``kind="ratio"`` — delta(num) / delta(den) of a counter pair over the
  window (shed or error fraction; a histogram's _sum/_count pair gives a
  windowed mean); burn = ratio / objective.

`AlertEngine.tick()` drives `history.tick()`, evaluates every rule,
publishes `pva_alert_active{rule=}` and
`pva_alert_transitions_total{rule=,to=}`, and drops fire/clear events into
the flight ring. The serving server's ticker thread calls it once a second.
Module-level `get_engine()` is one global read; nothing evaluates until
`configure()` arms an engine. Stdlib only.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pytorchvideo_accelerate_tpu_torch.obs.history import MetricsHistory
from pytorchvideo_accelerate_tpu_torch.utils.sync import make_lock, shared_state

_DEFAULT: Optional["AlertEngine"] = None


@dataclass(frozen=True)
class AlertRule:
    """One multi-window burn-rate rule over a history series."""

    name: str
    objective: float            # the SLO: "p99 <= 80ms" -> 80.0
    key: str = ""               # gauge kind: the flat scrape key
    num: str = ""               # ratio kind: counter-pair keys
    den: str = ""
    kind: str = "gauge"         # "gauge" | "ratio"
    fast_s: float = 60.0
    slow_s: float = 300.0
    burn: float = 1.0           # fire when BOTH windows >= burn
    clear_burn: float = 0.9     # clear only below this (hysteresis)
    hold_clear: int = 2         # ...for this many consecutive ticks

    def __post_init__(self):
        if self.kind not in ("gauge", "ratio"):
            raise ValueError(f"unknown rule kind {self.kind!r}")
        if self.objective <= 0:
            raise ValueError("objective must be positive")
        if self.fast_s >= self.slow_s:
            raise ValueError("fast window must be shorter than slow")
        if self.clear_burn > self.burn:
            raise ValueError("clear_burn above burn would flap by design")

    def _read(self, history: MetricsHistory, window_s: float,
              now: float) -> Optional[float]:
        if self.kind == "gauge":
            return history.window_mean(self.key, window_s, now=now)
        return history.ratio(self.num, self.den, window_s, now=now)

    def burn_rates(self, history: MetricsHistory,
                   now: float) -> Dict[str, Optional[float]]:
        """{"fast": x, "slow": y} burn factors (value/objective); None
        where the window holds no data — an empty window never burns."""
        out = {}
        for label, win in (("fast", self.fast_s), ("slow", self.slow_s)):
            v = self._read(history, win, now)
            out[label] = None if v is None else v / self.objective
        return out


@dataclass
class _RuleState:
    active: bool = False
    since: float = 0.0
    clear_streak: int = 0
    fires: int = 0
    last_burn: Dict[str, Optional[float]] = field(default_factory=dict)
    cleared_at: Optional[float] = None


@shared_state("_state")
class AlertEngine:
    """Evaluates the rule set each tick; ticks race snapshot readers
    (the /history handler)."""

    def __init__(self, history: MetricsHistory,
                 rules: List[AlertRule], registry=None, recorder=None):
        from pytorchvideo_accelerate_tpu_torch.obs.registry import get_registry

        names = [r.name for r in rules]
        if len(names) != len(set(names)):
            raise ValueError("duplicate rule names")
        self._lock = make_lock("obs.AlertEngine._lock")
        self.history = history
        self.rules = list(rules)
        self.registry = registry if registry is not None else get_registry()
        self.recorder = recorder
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self._g_active = self.registry.gauge(
            "pva_alert_active", "1 while the burn-rate rule is firing",
            labelnames=("rule",))
        self._c_transitions = self.registry.counter(
            "pva_alert_transitions_total",
            "fire/clear transitions per rule (a fire is ONE transition "
            "however long the burn lasts — the flap detector)",
            labelnames=("rule", "to"))
        for r in self.rules:
            self._g_active.set(0, rule=r.name)

    def tick(self, now: Optional[float] = None) -> List[str]:
        """One control tick: scrape into the history, evaluate every
        rule, publish transitions. Returns currently-active rule names."""
        ts = time.time() if now is None else float(now)
        self.history.tick(now=ts)
        active: List[str] = []
        for rule in self.rules:
            burns = rule.burn_rates(self.history, ts)
            burning = all(b is not None and b >= rule.burn
                          for b in burns.values())
            calm = all(b is None or b < rule.clear_burn
                       for b in burns.values())
            with self._lock:
                st = self._state[rule.name]
                st.last_burn = burns
                fired = cleared = False
                if not st.active and burning:
                    st.active, st.since = True, ts
                    st.clear_streak = 0
                    st.fires += 1
                    fired = True
                elif st.active:
                    # hysteresis: clear_burn is below burn AND the calm
                    # must hold for hold_clear consecutive ticks
                    st.clear_streak = st.clear_streak + 1 if calm else 0
                    if st.clear_streak >= rule.hold_clear:
                        st.active = False
                        st.cleared_at = ts
                        cleared = True
                is_active = st.active
            if fired:
                self._g_active.set(1, rule=rule.name)
                self._c_transitions.inc(rule=rule.name, to="firing")
                if self.recorder is not None:
                    self.recorder.warn(
                        f"alert firing: {rule.name}", rule=rule.name,
                        fast_burn=burns.get("fast"),
                        slow_burn=burns.get("slow"),
                        objective=rule.objective)
            elif cleared:
                self._g_active.set(0, rule=rule.name)
                self._c_transitions.inc(rule=rule.name, to="clear")
                if self.recorder is not None:
                    self.recorder.record(
                        "alert", "clear", rule=rule.name,
                        active_s=round(ts - self._state[rule.name].since, 3))
            if is_active:
                active.append(rule.name)
        return active

    def active(self) -> List[str]:
        with self._lock:
            return sorted(n for n, st in self._state.items() if st.active)

    def snapshot(self) -> Dict:
        """History occupancy plus per-rule state (active, fire count, last
        burn factors, last clear)."""
        with self._lock:
            rules = {
                n: {"active": st.active, "fires": st.fires,
                    "since": st.since if st.active else None,
                    "cleared_at": st.cleared_at,
                    "last_burn": dict(st.last_burn)}
                for n, st in self._state.items()}
        return {"history": self.history.snapshot(), "rules": rules,
                "active": sorted(n for n, r in rules.items() if r["active"])}


def default_rules() -> List[AlertRule]:
    """The shipped serving-SLO rule set: mean latency, shed fraction, error
    fraction."""
    return [
        # windowed mean latency via the histogram's _sum/_count pair
        # (serving/stats.py names); label-summed series (history.series)
        # let the shed rule read across its {state=} variants
        AlertRule(name="serve_latency_burn", kind="ratio",
                  num="pva_serving_request_latency_seconds_sum",
                  den="pva_serving_request_latency_seconds_count",
                  objective=0.080, fast_s=30.0, slow_s=120.0),
        AlertRule(name="shed_burn", kind="ratio",
                  num="pva_serving_shed_total",
                  den="pva_serving_requests_total",
                  objective=0.05, fast_s=30.0, slow_s=120.0),
        AlertRule(name="error_burn", kind="ratio",
                  num="pva_serving_errors_total",
                  den="pva_serving_requests_total",
                  objective=0.01, fast_s=30.0, slow_s=120.0),
    ]


def get_engine() -> Optional[AlertEngine]:
    return _DEFAULT


def configure(enabled: bool = True, history: Optional[MetricsHistory] = None,
              rules: Optional[List[AlertRule]] = None,
              **kwargs) -> Optional[AlertEngine]:
    """Arm (or disarm) the process-default alert engine (building a
    history ring too when none is supplied)."""
    global _DEFAULT
    if not enabled:
        _DEFAULT = None
        return None
    if history is None:
        from pytorchvideo_accelerate_tpu_torch.obs import history as history_mod

        history = history_mod.get_history() or history_mod.configure()
    _DEFAULT = AlertEngine(history, rules or default_rules(), **kwargs)
    return _DEFAULT
