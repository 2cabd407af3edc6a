"""SLO-driven replica autoscaler: the damped resize loop (the port's copy
of the JAX package's `fleet/control/autoscaler.py`).

The fleet has sensors
(registry gauges, pooled percentiles) and actuators
(`spawn_serving_process`, pool membership, admission drain, session
re-home) but nothing that ACTS. The `Autoscaler` ticks on a fixed
interval; each tick reads one `ControlSignals` snapshot (signals.py) and
moves a TARGET replica count by at most one step, then reconciles
membership toward the target:

- **up** when smoothed backlog per routable replica crosses `queue_high`
  or smoothed p99 crosses the SLO — actuated by `spawn_fn` (default:
  `spawn_serving_process(artifact)`), the new member joining the pool as
  soon as its bind handshake lands;
- **down** when backlog falls under `queue_low` AND p99 sits under
  `downscale_frac * SLO` — the victim is first flipped to DRAINING via
  the admission state machine (`replica.drain()` — POST /drain for
  process replicas), its live streaming sessions are re-homed by
  forgetting their router affinity (each re-establishes elsewhere from
  its resendable window, deterministically), its in-flight requests are given `drain_grace_s` to
  settle, and only then is it removed and reaped;
- **replace** when a member stays dead for `dead_after_ticks`
  consecutive ticks: the corpse leaves membership and the ordinary
  reconcile spawns its successor — the dead replica is never counted
  against the target twice.

Damping is threefold — EWMA smoothing on both signals (`ewma_alpha`),
hysteresis between the up/down watermarks, and a `cooldown_s` dead time
after every action — because an undamped controller and an open-loop
load generator form a textbook oscillator. The last routable replica is
never drained, no matter what the signals say: a fleet that scales to
zero under a monitoring blip has no path back.

Every decision lands in `history` (monotonic timestamp, action, the
signal values that justified it), the convergence evidence, and in
the obs flight recorder.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, List, Optional

from pytorchvideo_accelerate_tpu_torch import obs
from pytorchvideo_accelerate_tpu_torch.fleet.control.signals import SignalReader

logger = logging.getLogger("pva_tpu_torch")


class Autoscaler:
    """Damped closed-loop replica-count controller over a `Router`."""

    def __init__(self, router, *,
                 spawn_fn: Optional[Callable[[], object]] = None,
                 reap_fn: Optional[Callable[[object], None]] = None,
                 artifact: str = "",
                 min_replicas: int = 1, max_replicas: int = 8,
                 slo_p99_ms: float = 500.0,
                 queue_high: float = 4.0, queue_low: float = 0.5,
                 downscale_frac: float = 0.5,
                 cooldown_s: float = 2.0, interval_s: float = 0.25,
                 ewma_alpha: float = 0.5, drain_grace_s: float = 5.0,
                 dead_after_ticks: int = 3,
                 reader: Optional[SignalReader] = None,
                 model: Optional[str] = None):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1 (a fleet that can "
                             "scale to zero has no path back)")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas {max_replicas} < min_replicas "
                             f"{min_replicas}")
        if queue_low >= queue_high:
            raise ValueError("queue_low must sit strictly under queue_high "
                             "(the hysteresis band IS the damping)")
        self.router = router
        self.pool = router.pool
        self.reader = reader if reader is not None else SignalReader(
            router, model=model)
        self.model = model
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.slo_p99_ms = float(slo_p99_ms)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.downscale_frac = float(downscale_frac)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = max(float(interval_s), 0.01)
        self.ewma_alpha = min(max(float(ewma_alpha), 0.01), 1.0)
        self.drain_grace_s = float(drain_grace_s)
        self.dead_after_ticks = max(int(dead_after_ticks), 1)
        if spawn_fn is None:
            if not artifact:
                raise ValueError(
                    "Autoscaler needs spawn_fn or an artifact path for the "
                    "default spawn_serving_process actuator")
            spawn_fn = self._default_spawn(artifact)
        self.spawn_fn = spawn_fn
        self.reap_fn = reap_fn
        self._lock = threading.Lock()
        self.target = max(len(self.pool.routable()), self.min_replicas)
        self.history: List[dict] = []
        self._q_ewma = 0.0
        self._p99_ewma = 0.0
        self._last_action_t = 0.0   # 0 = no cooldown on the first action
        self._down_streak: dict = {}   # replica name -> consecutive down ticks
        self._spawned: dict = {}       # replica name -> spawn handle (reap arg)
        self._closed = False
        self._thread = None

    # --- actuators --------------------------------------------------------

    def _default_spawn(self, artifact: str):
        """Production actuator: one `pva-torch-serve` process per scale-up,
        reaped (terminate -> kill) when its replica is scaled back down."""
        from pytorchvideo_accelerate_tpu_torch.fleet.pool import (
            spawn_serving_process,
        )

        def spawn():
            proc, replica = spawn_serving_process(artifact)
            replica._proc = proc  # the reap handle rides on the replica
            return replica

        if self.reap_fn is None:
            def reap(replica):
                proc = getattr(replica, "_proc", None)
                if proc is None:
                    return
                proc.terminate()
                try:
                    proc.wait(timeout=5.0)
                except Exception:
                    proc.kill()
                    proc.wait()

            self.reap_fn = reap
        return spawn

    # --- the control loop -------------------------------------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop,
                                        name="pva-fleet-autoscale",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._closed:
            try:
                self.step()
            except Exception:
                # a broken tick must not kill the controller: the fleet
                # keeps its current size and the next tick retries
                logger.exception("autoscaler: control tick failed")
            time.sleep(self.interval_s)

    def close(self) -> None:
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def step(self) -> str:
        """One control tick: read -> smooth -> decide -> reconcile.
        Returns the action taken ("up" | "down" | "replace" | "hold")."""
        sig = self.reader.read()
        a = self.ewma_alpha
        with self._lock:
            self._q_ewma = a * sig.queue_per_replica() + (1 - a) * self._q_ewma
            self._p99_ewma = a * sig.p99_ms + (1 - a) * self._p99_ewma
            q, p99 = self._q_ewma, self._p99_ewma
        if getattr(self.reader, "history", None) is not None:
            # smooth off the SHARED history ring when the
            # reader carries one — same time base the alert rules and
            # /history serve, instead of this controller's private
            # accumulators (which stay warm as the fallback). halflife is
            # ewma_alpha expressed per control interval.
            hl = (-self.interval_s * math.log(2.0) / math.log(1.0 - a)
                  if a < 1.0 else 0.0)
            q_h = self.reader.ewma("pva_fleet_queue_per_replica", hl)
            p99_h = self.reader.ewma("pva_fleet_p99_ms", hl)
            if q_h is not None:
                q = q_h
            if p99_h is not None:
                p99 = p99_h
        action = self._reap_confirmed_dead(sig)
        if action is None:
            action = self._decide(sig, q, p99)
        if action != "hold":
            self._record(action, sig, q, p99)
        return action

    def _decide(self, sig, q: float, p99: float) -> str:
        now = time.monotonic()
        with self._lock:
            cooling = now - self._last_action_t < self.cooldown_s
            target = self.target
        pressure = q > self.queue_high or p99 > self.slo_p99_ms
        idle = (q < self.queue_low
                and p99 < self.downscale_frac * self.slo_p99_ms)
        if pressure and target < self.max_replicas and not cooling:
            with self._lock:
                self.target = target + 1
        elif idle and target > self.min_replicas and not cooling:
            with self._lock:
                self.target = target - 1
        return self._reconcile()

    def _reconcile(self) -> str:
        """Drive membership toward the target, one replica per tick (the
        single-step move is part of the damping)."""
        members = list(self.pool.replicas)
        routable = self.pool.routable()
        with self._lock:
            target = self.target
        if len(members) < target:
            return "up" if self._spawn_one() else "hold"
        if len(routable) > target:
            return "down" if self._drain_one(routable) else "hold"
        return "hold"

    # --- scale-up ---------------------------------------------------------

    def _spawn_one(self) -> bool:
        try:
            replica = self.spawn_fn()
        except Exception:
            logger.exception("autoscaler: spawn failed; holding")
            return False
        try:
            self.pool.add_replica(replica)
        except ValueError:
            # name collision (a resurrection raced us): reap the orphan
            self._reap(replica)
            return False
        with self._lock:
            self._spawned[replica.name] = replica
        return True

    # --- scale-down: drain -> re-home -> settle -> reap -------------------

    def _drain_one(self, routable) -> bool:
        if len(routable) <= 1:
            return False  # never drain the last routable replica
        victim = self._pick_victim(routable)
        if victim is None:
            return False
        # 1. admission first: the replica stops admitting and /healthz goes
        # 503, so the poller pulls it within one interval — then mark it
        # down explicitly so the router routes around it NOW
        victim.drain()
        self.pool.mark_down(victim)
        # 2. re-home live streaming sessions: dropping the affinity pin
        # makes each session's next advance route to a surviving replica,
        # where the deterministic re-establish protocol rebuilds its ring
        # from the client's resendable window (raw and KV rings alike)
        moved = self.router.sessions_on(victim.name)
        for sid in moved:
            self.router.forget_session(sid)
        if moved:
            logger.info("autoscaler: re-homing %d session(s) off %s",
                        len(moved), victim.name)
        # 3. give in-flight requests the grace budget to settle
        deadline = time.monotonic() + self.drain_grace_s
        while time.monotonic() < deadline:
            with self.router._lock:
                left = self.router._outstanding.get(victim.name, 0)
            if left <= 0:
                break
            time.sleep(0.02)
        # 4. reap: out of membership for good, then the process (if ours)
        self.pool.remove_replica(victim, close=True)
        self._reap(victim)
        with self._lock:
            self._down_streak.pop(victim.name, None)
        obs.get_recorder().record("fleet", "scale-down", victim=victim.name,
                                  sessions_rehomed=len(moved))
        return True

    def _pick_victim(self, routable):
        """Fewest pinned sessions loses (cheapest re-home); self-spawned
        replicas break ties (we own their processes and can reap them)."""
        with self._lock:
            spawned = set(self._spawned)
        return min(
            routable,
            key=lambda r: (len(self.router.sessions_on(r.name)),
                           r.name not in spawned, r.name),
            default=None)

    def _reap(self, replica) -> None:
        with self._lock:
            self._spawned.pop(replica.name, None)
        if self.reap_fn is not None:
            try:
                self.reap_fn(replica)
            except Exception:
                logger.exception("autoscaler: reap of %s failed",
                                 replica.name)

    # --- dead-member replacement -----------------------------------------

    def _reap_confirmed_dead(self, sig) -> Optional[str]:
        """A member that stays unroutable for `dead_after_ticks` ticks is a
        corpse: remove it so the reconcile pass spawns its replacement —
        membership reflects reality, the target is never double-counted
        against a dead name. Never removes the last member (min_replicas
        floors the target; a fully-dead fleet keeps one name for the
        poller to watch for resurrection)."""
        members = list(self.pool.replicas)
        routable_names = {r.name for r in self.pool.routable()}
        victim = None
        with self._lock:
            for r in members:
                if r.name in routable_names:
                    self._down_streak.pop(r.name, None)
                    continue
                streak = self._down_streak.get(r.name, 0) + 1
                self._down_streak[r.name] = streak
                if (streak >= self.dead_after_ticks and victim is None
                        and len(members) > 1):
                    victim = r
        if victim is None:
            return None
        try:
            state = victim.health()
        except Exception:
            state = "dead"
        if state != "dead":  # draining/degraded members are not corpses
            return None
        logger.warning("autoscaler: %s confirmed dead after %d ticks; "
                       "replacing", victim.name, self.dead_after_ticks)
        for sid in self.router.sessions_on(victim.name):
            self.router.forget_session(sid)  # survivors re-establish
        self.pool.remove_replica(victim, close=True)
        self._reap(victim)
        with self._lock:
            self._down_streak.pop(victim.name, None)
        self._spawn_one()  # reconcile immediately: replace, don't wait
        return "replace"

    # --- evidence ---------------------------------------------------------

    def _record(self, action: str, sig, q: float, p99: float) -> None:
        entry = {
            "t": time.monotonic(), "action": action,
            "target": self.target,
            "routable": len(self.pool.routable()),
            "members": len(self.pool.replicas),
            "queue_per_replica": round(q, 3),
            "p99_ms": round(p99, 3),
            "shed_total": sig.shed_total,
        }
        with self._lock:
            self._last_action_t = entry["t"]
            self.history.append(entry)
        logger.info("autoscaler: %s -> target %d (q/replica %.2f, "
                    "p99 %.0f ms)", action, entry["target"], q, p99)
        obs.get_recorder().record("fleet", "autoscale", **entry)

    def actions_since(self, t: float) -> List[dict]:
        with self._lock:
            return [e for e in self.history if e["t"] >= t]
