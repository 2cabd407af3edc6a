"""Seeded, deterministic fault injection (the port's copy of the JAX
package's `reliability/faults.py`).

Named fault points sit at the real hazard sites of the data -> train ->
serve path:

    decode.read      data/decode.py            unreadable or corrupt video
    prefetch.h2d     data/device_prefetch.py   slow or failing host-to-card copy
    ckpt.write       reliability/atomic.py     an artifact write dies
    tracker.log      trainer/tracking.py       tracker backend outage
    serve.flush      serving/batcher.py,       inference batch failure
                     fleet/scheduler.py
    step.dispatch    trainer/loop.py           slow, failing or NaN step
    collective.sync  parallel/hangcheck.py     wedged or straggling collective

Disarmed (the default, and always in production) `fault_point()` costs one
module-global read: it loads `_plan`, sees None and returns. Armed, each hit
of a point is numbered, and every fire decision is a pure function of
`(plan.seed, point, hit_index)` (`_hit_roll`, crc32), so the same plan
fires the same hits, run after run and in either package. Concurrent
callers make the interleaving nondeterministic, never the set of fired
hits.

Fault kinds:

- ``raise``: raise `InjectedFault` (an OSError, so the decode and IO
  handlers treat it like the real failure it stands in for);
- ``delay``: sleep `delay_s` (a slow worker, a straggling rank);
- ``partial_write``: truncate the in-flight file (the `write_path=` the
  call site passed) to half, then raise: the mid-write kill that must never
  leave a truncated file behind the atomic writer;
- ``kill_thread``: raise `InjectedThreadKill` (a BaseException, so it
  escapes `except Exception` recovery the way a thread's death does);
- ``nan``: non-raising: `fault_point` returns ``"nan"`` and the call site
  acts on it (the train loop NaN-poisons the dispatched batch through
  `reliability/guard.py poison_batch`).

`fault_point()` returns the fired kind for the non-raising kinds
(``"delay"`` after sleeping, ``"nan"`` at once) and None when nothing
fired. A spec with `path_substr` fires only at hits whose call-site `path`
contains it (a per-clip failure; `collective_section` passes its section's
detail, so a spec can pin one collective). Hit numbering is per point
whatever the path.

Every fire increments `pva_fault_injected_total{point=...}` in the metric
registry and records a ``fault`` event (its `fault_kind` and `hit`) in the
flight recorder. A plan is armed only by a harness or a test (`arm`),
never by a flag or a config knob, as in the JAX package.
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


class InjectedFault(OSError):
    """An injected failure. An OSError on purpose: the call sites' own
    handlers (decode retries, the quarantine, write retries) must treat it
    like the outage it simulates."""


class InjectedThreadKill(BaseException):
    """An injected worker death: escapes `except Exception` recovery."""


@dataclass
class FaultSpec:
    """One fault point's behaviour under a plan.

    `at_hits` (exact 0-based hit indices) wins over `p` (per-hit fire
    probability, decided by the deterministic per-hit roll). `max_fires`
    bounds the fires (0: unlimited). `path_substr` (when set) gates the
    spec to hits whose call-site `path` contains it."""

    point: str
    kind: str = "raise"  # raise | delay | partial_write | kill_thread | nan
    p: float = 1.0
    at_hits: Tuple[int, ...] = ()
    max_fires: int = 0
    delay_s: float = 0.01
    message: str = ""
    path_substr: str = ""

    _KINDS = ("raise", "delay", "partial_write", "kill_thread", "nan")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(
                f"fault kind must be one of {self._KINDS}, got {self.kind!r}")
        self.at_hits = tuple(int(h) for h in self.at_hits)


def _hit_roll(seed: int, point: str, hit: int) -> float:
    """Deterministic per-hit uniform in [0, 1): stable across processes and
    packages (crc32, not `hash()`, which is salted per interpreter)."""
    h = zlib.crc32(f"{seed}:{point}:{hit}".encode())
    return (h & 0xFFFFFFFF) / 2**32


class FaultPlan:
    """A seeded set of FaultSpecs; `arm(plan)` makes it live process-wide.

    Hit numbering and the fired history are kept under one lock (the decode
    pool and the serving threads hit points concurrently)."""

    def __init__(self, seed: int, specs: List[FaultSpec]):
        self.seed = int(seed)
        self.specs: Dict[str, List[FaultSpec]] = {}
        for s in specs:
            self.specs.setdefault(s.point, []).append(s)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._fires: Dict[int, int] = {}  # id(spec) -> fires so far
        self.history: List[dict] = []

    def _decide(self, point: str,
                path: Optional[str] = None) -> Optional[Tuple[FaultSpec, int]]:
        """Number this hit and pick the firing spec, if any: bookkeeping
        under the lock, the action outside it."""
        with self._lock:
            hit = self._hits.get(point, 0)
            self._hits[point] = hit + 1
            for spec in self.specs.get(point, ()):
                fires = self._fires.get(id(spec), 0)
                if spec.max_fires and fires >= spec.max_fires:
                    continue
                if spec.path_substr and spec.path_substr not in (path or ""):
                    continue
                if spec.at_hits:
                    fire = hit in spec.at_hits
                else:
                    fire = _hit_roll(self.seed, point, hit) < spec.p
                if fire:
                    self._fires[id(spec)] = fires + 1
                    self.history.append(
                        {"point": point, "hit": hit, "kind": spec.kind,
                         "ts": round(time.time(), 6)})
                    return spec, hit
            return None

    def hit(self, point: str, path: Optional[str] = None,
            write_path: Optional[str] = None) -> Optional[str]:
        decision = self._decide(point, path)
        if decision is None:
            return None
        spec, hit = decision
        _publish_fire(point, spec.kind, hit)
        msg = spec.message or f"injected {spec.kind} at {point} (hit {hit})"
        if spec.kind == "delay":
            time.sleep(spec.delay_s)
            return "delay"
        if spec.kind == "nan":
            return "nan"  # the call site acts on it
        if spec.kind == "partial_write":
            # truncate only a write_path the call site declared in-flight
            # scratch; `path` is evidence (a source video) and is never
            # touched: at a read point this degrades to a plain raise
            if write_path:
                try:
                    with open(write_path, "r+b") as f:
                        f.truncate(max(f.seek(0, 2) // 2, 0))
                except OSError:
                    pass  # nothing written yet: the raise alone suffices
            raise InjectedFault(msg)
        if spec.kind == "kill_thread":
            raise InjectedThreadKill(msg)
        raise InjectedFault(msg)


def _publish_fire(point: str, kind: str, hit: int) -> None:
    """The fire's evidence: the counter and a flight-recorder event
    ("fault", point) with `fault_kind` and `hit`. (The JAX module passes the
    kind as `kind=`, which collides with `FlightRecorder.record`'s own
    argument; its swallowed TypeError leaves the JAX record without it.)"""
    from pytorchvideo_accelerate_tpu_torch.obs import get_recorder, get_registry

    get_registry().counter(
        "pva_fault_injected_total",
        "faults fired by the armed fault plan, by point",
        labelnames=("point",)).inc(point=point)
    get_recorder().record("fault", point, fault_kind=kind, hit=hit)


# the armed plan or None: module-global, so the disarmed check is one load
_plan: Optional[FaultPlan] = None
# kept through disarm, so a harness can read the fired sequence afterwards
_last_plan: Optional[FaultPlan] = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Install `plan` process-wide (harnesses and tests only)."""
    global _plan, _last_plan
    _plan = _last_plan = plan
    return plan


def disarm() -> None:
    global _plan
    _plan = None


def current_plan() -> Optional[FaultPlan]:
    return _plan


def fault_history() -> List[dict]:
    """The fired sequence of the current (or last armed) plan."""
    plan = _plan or _last_plan
    if plan is None:
        return []
    with plan._lock:
        return list(plan.history)


def fault_point(name: str, path: Optional[str] = None,
                write_path: Optional[str] = None) -> Optional[str]:
    """A named hazard site. Disarmed: one global read, then None. Armed:
    number the hit and maybe fire; the non-raising kinds return their
    kind. `write_path`: the in-flight scratch file of a write site
    (``partial_write`` truncates it before raising); `path`: evidence and
    the `path_substr` match target, never modified."""
    plan = _plan
    if plan is None:
        return None
    return plan.hit(name, path, write_path)
