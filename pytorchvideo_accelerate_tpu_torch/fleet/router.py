"""Least-outstanding-requests router over a `ReplicaPool` (the port's copy
of the JAX package's `fleet/router.py`).

One router fronts N replicas and speaks the same interface as a
`MicroBatcher`/`Scheduler` (`submit`/`queue_depth`/`drain`/`close`), so an
`InferenceServer` (and its admission, drain and Retry-After vocabulary)
works unchanged with a fleet behind it.

Routing policy, per request:

- **affinity-then-least-outstanding**: a streaming-session request
  (`session={"sid": ...}`) routes to the replica that HOLDS the session's
  device-resident ring (streaming/engine.py) — the affinity map
  is router-tracked, updated at every successful dispatch; when the
  affinity replica is down/shedding, the request falls through to the
  ordinary policy and the ACCEPTING replica becomes the new affinity —
  deterministic re-establish from the request's resendable window makes
  the move client-invisible;
- stateless requests (and affinity fall-through) pick the ROUTABLE
  replica (pool membership, health-gated) with the fewest outstanding
  requests (router-tracked; queue depth would lag and cost an RPC for
  HTTP replicas), FIFO-seq tiebreak;
- a replica-level shed (`QueueFullError`) tries the next-least-loaded
  replica before giving up: one hot replica must not shed traffic the
  rest of the fleet has capacity for. Only when EVERY candidate sheds
  (or none is routable) does the router itself shed — 503 + Retry-After;
- **route-around on death**: a `ReplicaDeadError` (closed scheduler,
  refused/reset connection) marks the replica down in the pool
  immediately and re-dispatches the request — including requests already
  in flight when the replica died (inference is idempotent, so the
  at-least-once retry is safe). A client only sees a failure when the
  whole fleet is gone or retries are exhausted.

Per-replica traffic is published with REPLICA LABELS into an obs registry
(`pva_fleet_routed_total{replica=...}`, `pva_fleet_outstanding{replica=…}`)
and `fleet_snapshot()` merges replica `ServingStats` windows into honest
fleet percentiles (`ServingStats.merge` — pooled samples, not averaged
percentiles, sheds counted exactly once).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

from pytorchvideo_accelerate_tpu_torch import obs
from pytorchvideo_accelerate_tpu_torch.config import FleetConfig
from pytorchvideo_accelerate_tpu_torch.fleet.pool import ReplicaDeadError, ReplicaPool
from pytorchvideo_accelerate_tpu_torch.obs import trace
from pytorchvideo_accelerate_tpu_torch.serving.batcher import QueueFullError
from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats

logger = logging.getLogger("pva_tpu_torch")


# affinity-map bound: sessions beyond this evict oldest-first — a stream
# that outlives its map entry just re-establishes from its resendable
# window on its next advance (correct, merely one launch less warm)
MAX_AFFINITY_SESSIONS = 65536


class Router:
    """Affinity-then-least-outstanding routing + route-around over a
    `ReplicaPool`."""

    supports_priority = True
    # session envelopes forward through `submit(..., session=...)`; the
    # REPLICA's scheduler decides capability (a non-stream replica answers
    # with a 400-shaped ValueError the client sees)
    supports_sessions = True

    def __init__(self, pool: ReplicaPool, *, retries: Optional[int] = None,
                 retry_after_s: float = 1.0, registry=None):
        self.pool = pool
        if retries is None:  # the tier default: fleet.route_retries
            retries = FleetConfig().route_retries
        self.retries = max(int(retries), 0)
        self.retry_after_s = float(retry_after_s)
        self.registry = registry if registry is not None else obs.get_registry()
        self._lock = threading.Lock()
        self._outstanding: Dict[str, int] = {}
        self._rr = 0  # rotation counter: round-robin among outstanding ties
        # session id -> replica name holding its ring (insertion-ordered
        # dict = oldest-first eviction past the bound)
        self._affinity: Dict[str, str] = {}
        # every series is scoped by the POOL's name: registry metrics are
        # get-or-create by name, so two routers on the process-default
        # registry would otherwise sum each other's sheds/retries into
        # both fleet_snapshots (the pool-gauge lesson, pool.py)
        self._pool_label = pool.name
        self._c_routed = self.registry.counter(
            "pva_fleet_routed_total",
            "requests dispatched, by pool and replica",
            labelnames=("pool", "replica"))
        self._c_retried = self.registry.counter(
            "pva_fleet_retried_total",
            "requests re-dispatched around a death or a replica shed, "
            "by pool", labelnames=("pool",))
        self._c_shed = self.registry.counter(
            "pva_fleet_shed_total",
            "requests shed at the router (no routable capacity), by pool",
            labelnames=("pool",))
        self._g_outstanding = self.registry.gauge(
            "pva_fleet_outstanding",
            "requests in flight, by pool and replica",
            labelnames=("pool", "replica"))
        # multi-model serving: per-model-family traffic under the shared
        # pool (fleet/control/multimodel.py). Separate series,
        # not extra labels on the unlabeled ones above — metric label
        # schemas are get-or-create by name and must never be widened
        self._c_model_routed = self.registry.counter(
            "pva_fleet_model_routed_total",
            "requests dispatched, by pool and model family",
            labelnames=("pool", "model"))
        self._c_model_shed = self.registry.counter(
            "pva_fleet_model_shed_total",
            "requests shed at the router, by pool and model family",
            labelnames=("pool", "model"))

    # --- the batcher interface -------------------------------------------

    def submit(self, clip, *, priority: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               session: Optional[dict] = None,
               model: Optional[str] = None) -> Future:
        """Route ONE request; returns a Future that survives replica death
        (re-dispatched) and resolves with logits, `QueueFullError` (shed),
        or the terminal error once retries are exhausted. A `session`
        envelope routes with affinity (see module docstring) and carries
        the resendable window a survivor re-establishes from when the
        affinity replica dies mid-flight. A `model` narrows the candidate
        set to replicas serving that model family (multi-model pools);
        the request sheds — per-model labeled — when none is routable."""
        kwargs: dict = {}
        if priority is not None:
            kwargs["priority"] = priority
        if deadline_ms is not None:
            kwargs["deadline_ms"] = deadline_ms
        if session is not None:
            kwargs["session"] = session
        outer: Future = Future()
        # capture the submitter's trace context ONCE: first dispatch runs
        # on this thread (context already active), but a re-dispatch after
        # a death/shed runs on a done-callback thread with no context —
        # the captured value re-attaches it there (trace.attach)
        self._dispatch(outer, clip, kwargs, self.retries,
                       ctx=trace.capture(), model=model)
        return outer

    def queue_depth(self) -> int:
        """Requests dispatched but not yet settled, router-tracked. NOT a
        per-replica RPC sum: this runs on the admission hot path (the HTTP
        front calls it before reading every request body), and a blocking
        /healthz GET per HttpReplica per request would turn the cheapest
        response into up-to-seconds of blocking under exactly the overload
        admission exists for."""
        with self._lock:
            return sum(self._outstanding.values())

    def drain(self, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while time.monotonic() < deadline:
            if not self._any_outstanding():
                return True
            time.sleep(0.01)
        # in-flight launches count: reporting drained while one is still
        # mid-predict would let the close() that follows fail its future
        return not self._any_outstanding()

    def close(self) -> None:
        self.pool.close()

    # --- dispatch ---------------------------------------------------------

    def _any_outstanding(self) -> bool:
        with self._lock:
            return any(v > 0 for v in self._outstanding.values())

    def _pick(self, exclude: frozenset, sid: Optional[str] = None,
              model: Optional[str] = None) -> List:
        """Routable replicas, least-outstanding first; ties rotate
        round-robin (an idle fleet must spread load, not pile onto the
        alphabetically-first replica). A session id promotes its affinity
        replica to the FRONT of the order — the rest stay as the shed/
        death fallback chain, so losing the affinity replica degrades to
        ordinary routing instead of failing. A model narrows candidates
        to the replicas serving that family."""
        candidates = [r for r in self.pool.routable()
                      if r.name not in exclude
                      and (model is None
                           or getattr(r, "model", None) == model)]
        if not candidates:
            return []
        with self._lock:
            order = {r.name: self._outstanding.get(r.name, 0)
                     for r in candidates}
            self._rr += 1
            rot = self._rr % len(candidates)
            pinned = self._affinity.get(sid) if sid else None
        rotated = candidates[rot:] + candidates[:rot]
        picked = sorted(rotated, key=lambda r: order[r.name])  # stable sort
        if pinned is not None:
            picked.sort(key=lambda r: r.name != pinned)  # stable: pin first
        return picked

    def _record_affinity(self, sid: str, replica_name: str) -> None:
        with self._lock:
            moved = self._affinity.pop(sid, None)
            self._affinity[sid] = replica_name  # re-insert = LRU refresh
            while len(self._affinity) > MAX_AFFINITY_SESSIONS:
                self._affinity.pop(next(iter(self._affinity)))
        if moved is not None and moved != replica_name:
            logger.info("fleet: session %s re-routed %s -> %s", sid,
                        moved, replica_name)

    def forget_session(self, sid: str) -> None:
        with self._lock:
            self._affinity.pop(sid, None)

    def sessions_on(self, replica_name: str) -> List[str]:
        """Session ids whose affinity pins `replica_name` — the controller
        reads this to re-home a scale-down victim's live streams before
        reaping it (each forgotten session re-establishes elsewhere from
        its resendable window on its next advance)."""
        with self._lock:
            return [sid for sid, holder in self._affinity.items()
                    if holder == replica_name]

    def _track(self, name: str, delta: int) -> None:
        with self._lock:
            n = max(self._outstanding.get(name, 0) + delta, 0)
            self._outstanding[name] = n
            # gauge published under the SAME lock: out-of-order sets from
            # a racing dispatch/settle pair would leave it stale forever
            self._g_outstanding.set(float(n), pool=self._pool_label,
                                    replica=name)

    def _dispatch(self, outer: Future, clip, kwargs, attempts_left: int,
                  exclude: frozenset = frozenset(), ctx=None,
                  model: Optional[str] = None) -> None:
        if outer.cancelled():  # the client gave up (504) before dispatch
            return
        last_shed: Optional[QueueFullError] = None
        session = kwargs.get("session")
        sid = str(session["sid"]) if session and session.get("sid") else None
        for replica in self._pick(exclude, sid=sid, model=model):
            try:
                with trace.attach(ctx):
                    inner = replica.submit(clip, **kwargs)
            except QueueFullError as e:
                last_shed = e  # this replica sheds; try the next one
                continue
            except ReplicaDeadError:
                self.pool.mark_down(replica)
                continue
            if sid is not None:
                # the ACCEPTING replica holds (or will now establish) the
                # session ring: later advances pin here; a fall-through
                # move re-establishes deterministically from the
                # request's resendable window on the new replica
                self._record_affinity(sid, replica.name)
                if session.get("end"):
                    self.forget_session(sid)
            # the request is now engine-bound: mark the outer future
            # RUNNING so a later client cancel (the 504 path) loses the
            # race — exactly the MicroBatcher/Scheduler claim semantics —
            # instead of counting engine-claimed work as a true rejection.
            # running() guard, not try/except: a re-dispatch arrives here
            # already RUNNING, and the stdlib logs CRITICAL before raising
            if not outer.running() and not outer.set_running_or_notify_cancel():
                # cancelled in the dispatch gap: the inner request will
                # complete and be dropped at settle; nothing to deliver
                self._c_routed.inc(pool=self._pool_label,
                               replica=replica.name)
                if model is not None:
                    self._c_model_routed.inc(pool=self._pool_label,
                                             model=model)
                self._track(replica.name, +1)
                inner.add_done_callback(
                    lambda f, r=replica: self._track(r.name, -1))
                return
            self._c_routed.inc(pool=self._pool_label,
                               replica=replica.name)
            if model is not None:
                self._c_model_routed.inc(pool=self._pool_label, model=model)
            self._track(replica.name, +1)
            inner.add_done_callback(
                lambda f, r=replica: self._settle(
                    outer, clip, kwargs, attempts_left, r, f, ctx=ctx,
                    model=model))
            return
        # nothing took it: the ROUTER sheds (every candidate shed or died)
        self._c_shed.inc(pool=self._pool_label)
        if model is not None:
            self._c_model_shed.inc(pool=self._pool_label, model=model)
        err = last_shed if last_shed is not None else QueueFullError(
            "no routable replicas", retry_after_s=self.retry_after_s)
        self._fail(outer, err)

    def _settle(self, outer: Future, clip, kwargs, attempts_left: int,
                replica, inner: Future, ctx=None,
                model: Optional[str] = None) -> None:
        self._track(replica.name, -1)
        if outer.cancelled():
            return
        err = inner.exception()
        if err is None:
            try:
                outer.set_result(inner.result())
            except Exception:  # outer cancelled in the gap
                pass
            return
        if isinstance(err, ReplicaDeadError) and attempts_left > 0:
            # the replica died with this request in flight: route around it
            # and re-dispatch (idempotent inference -> at-least-once retry)
            self.pool.mark_down(replica)
            self._c_retried.inc(pool=self._pool_label)
            logger.warning("fleet: %s died mid-request; re-dispatching",
                           replica.name)
            self._dispatch(outer, clip, kwargs, attempts_left - 1,
                           exclude=frozenset({replica.name}), ctx=ctx,
                           model=model)
            return
        if isinstance(err, ReplicaDeadError):
            self.pool.mark_down(replica)
        if isinstance(err, QueueFullError) and attempts_left > 0:
            # a shed that arrived via the FUTURE (HttpReplica's 503, or a
            # scheduler deadline shed): one hot replica must not shed
            # traffic the rest of the fleet has capacity for — try the
            # next-least-loaded replica before surfacing the 503. The
            # replica is NOT marked down: shedding is it working.
            self._c_retried.inc(pool=self._pool_label)
            self._dispatch(outer, clip, kwargs, attempts_left - 1,
                           exclude=frozenset({replica.name}), ctx=ctx,
                           model=model)
            return
        self._fail(outer, err)

    @staticmethod
    def _fail(outer: Future, err: BaseException) -> None:
        if not outer.done():
            try:
                outer.set_exception(err)
            except Exception:
                pass

    # --- fleet-wide observability ----------------------------------------

    # counter keys summable from a remote replica's /stats snapshot
    _SNAPSHOT_COUNTERS = ("requests", "batches", "errors", "rejected",
                          "rejected_400", "rejected_503", "rejected_504",
                          "shed", "compiled_buckets")

    def fleet_snapshot(self, model: Optional[str] = None) -> Dict[str, float]:
        """Cross-replica aggregate: pooled latency percentiles + summed
        counters (`ServingStats.merge`), plus the router's own counters.
        Router sheds ride as `router_shed` — NEVER folded into the replica
        `shed` sum, so a shed is counted exactly once wherever it
        happened. `model` restricts the replica set (and the labeled
        router counters) to one model family — the per-model view the
        multi-model controller compares against its budget.

        HttpReplica counters are summed from their `/stats` snapshots;
        their raw latency WINDOWS are not available over the wire, so the
        percentiles cover window-bearing (in-process) replicas only —
        `replicas_windowed` says how many that is, so an all-HTTP fleet's
        0.0 percentiles read as "no windows", never as "no latency"."""
        members = [r for r in list(self.pool.replicas)
                   if model is None or getattr(r, "model", None) == model]
        local = [r for r in members
                 if getattr(r, "stats", None) is not None]
        remote = [r for r in members if r not in local]
        with self._lock:
            outstanding = dict(self._outstanding)
            affine = len(self._affinity)
        if model is None:
            shed = self._c_shed.value(pool=self._pool_label)
        else:
            shed = self._c_model_shed.value(pool=self._pool_label,
                                            model=model)
        merged = ServingStats.merge([r.stats for r in local], extra={
            "sessions_affine": float(affine),
            "router_shed": shed,
            "router_retries": self._c_retried.value(pool=self._pool_label),
            "replicas_routable": float(len(
                [r for r in self.pool.routable() if r in members])),
            "replicas_total": float(len(members)),
            "outstanding": float(sum(outstanding.values())),
        })
        for replica in remote:
            snap = replica.snapshot()  # {} when the replica is unreachable
            for key in self._SNAPSHOT_COUNTERS:
                merged[key] = merged.get(key, 0.0) + float(snap.get(key, 0.0))
        merged["replicas"] = float(len(members))
        merged["replicas_windowed"] = float(len(local))
        if model is not None:
            merged["model_routed"] = self._c_model_routed.value(
                pool=self._pool_label, model=model)
        return merged
