"""Session table: ids -> ring-slot leases, under a TTL and a device-memory
budget (the port's copy of the JAX package's `streaming/session.py`).

A streaming session is device state: its rolling window ring occupies a
slot of a preallocated ring pool (streaming/engine.py). So admission is a
memory decision, not a queue decision: the table refuses a new session
when every slot of its geometry's pool is held by a live session
(`SessionAdmissionError`, a `QueueFullError`: the HTTP front answers 503 +
Retry-After), and reclaims slots from sessions idle past `ttl_s` (a stream
that stopped advancing is a leak, not a client).

The table is host bookkeeping only, sid -> (pool key, slot, write offset,
stride), and knows nothing of torch: the engine owns the device tensors
and calls in here. Every mutation runs under one `threading.Lock`: the
scheduler's flush thread advances sessions while the HTTP front
establishes or ends them and a hot swap carries the whole table to
another engine.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pytorchvideo_accelerate_tpu_torch.serving.batcher import QueueFullError

logger = logging.getLogger("pva_tpu_torch")


class SessionError(ValueError):
    """Malformed streaming request (geometry or stride mismatch) -> 400."""


class SessionUnknownError(SessionError):
    """An advance for a session this replica does not hold, with no
    resendable window to re-establish from -> 409: the client resends its
    window."""


class SessionAdmissionError(QueueFullError):
    """No free ring slot and no TTL-expired session to evict: the session
    budget is exhausted -> 503 + Retry-After."""


@dataclass
class SessionState:
    """Host-side record of one device-resident session."""

    sid: str
    pool_key: tuple     # ring geometry key (the engine's vocabulary)
    slot: int           # row of the geometry's ring pool
    stride: int         # frames per advance, fixed at establish
    window: int         # ring length T (frames)
    off: int = 0        # next write offset (a multiple of stride; the oldest frame)
    frames_seen: int = 0
    last_active: float = field(default_factory=time.monotonic)


class SessionTable:
    """sid -> `SessionState`, slot free lists per ring pool, TTL and budget
    admission. The engine registers each pool's capacity once
    (`register_pool`) and then leases and frees slots through here."""

    def __init__(self, *, ttl_s: float = 120.0, retry_after_s: float = 1.0,
                 registry=None, name: str = "stream"):
        from pytorchvideo_accelerate_tpu_torch.obs.registry import get_registry

        self.ttl_s = float(ttl_s)
        self.retry_after_s = float(retry_after_s)
        self.name = name
        self._lock = threading.Lock()
        self._sessions: Dict[str, SessionState] = {}
        self._free: Dict[tuple, List[int]] = {}
        reg = registry if registry is not None else get_registry()
        self._g_live = reg.gauge(
            "pva_stream_sessions", "live streaming sessions, by table",
            labelnames=("table",))
        self._g_live.set_function(lambda: float(len(self._sessions)),
                                  table=name)
        self._c_evicted = reg.counter(
            "pva_stream_evicted_total",
            "sessions reclaimed by TTL eviction, by table",
            labelnames=("table",))

    # --- pools ------------------------------------------------------------

    def register_pool(self, pool_key: tuple, capacity: int) -> None:
        """Declare a ring pool of `capacity` leasable slots (idempotent)."""
        with self._lock:
            if pool_key not in self._free:
                self._free[pool_key] = list(range(int(capacity)))

    def pool_capacity(self, pool_key: tuple) -> int:
        with self._lock:
            free = len(self._free.get(pool_key, ()))
        return free + sum(1 for s in self.sessions()
                          if s.pool_key == pool_key)

    # --- lifecycle --------------------------------------------------------

    def establish(self, sid: str, pool_key: tuple, *, stride: int,
                  window: int) -> SessionState:
        """Lease a slot for `sid`, replacing any earlier incarnation of the
        same id (a client re-establish after a replica death or a hot swap
        is the same stream, not a second one). Evicts the least recently
        active TTL-expired session of the pool when no slot is free;
        raises `SessionAdmissionError` when every holder is live."""
        now = time.monotonic()
        with self._lock:
            prior = self._sessions.pop(sid, None)
            if prior is not None and prior.pool_key == pool_key:
                slot = prior.slot  # same geometry: reuse the lease
            else:
                if prior is not None:  # geometry changed: free the old lease
                    self._free[prior.pool_key].append(prior.slot)
                slot = self._lease_locked(pool_key, now)
            state = SessionState(sid=sid, pool_key=pool_key, slot=slot,
                                 stride=int(stride), window=int(window),
                                 last_active=now)
            self._sessions[sid] = state
            return state

    def _lease_locked(self, pool_key: tuple, now: float) -> int:
        """Caller holds `_lock`: pop a free slot, or reclaim the stalest
        TTL-expired session's slot, or refuse admission."""
        free = self._free.get(pool_key)
        if free is None:
            raise SessionError(f"no ring pool registered for {pool_key}")
        if free:
            return free.pop()
        # budget full: reclaim the stalest expired session (never a live
        # one: a session mid-advance must not lose its ring under itself)
        victim = None
        for s in self._sessions.values():
            if s.pool_key != pool_key or now - s.last_active < self.ttl_s:
                continue
            if victim is None or s.last_active < victim.last_active:
                victim = s
        if victim is None:
            raise SessionAdmissionError(
                f"session budget exhausted ({self.name}: every ring slot "
                "held by a live session); retry later",
                retry_after_s=self.retry_after_s)
        del self._sessions[victim.sid]
        self._c_evicted.inc(table=self.name)
        logger.info("stream: evicted idle session %s (%.1fs > ttl %.1fs)",
                    victim.sid, now - victim.last_active, self.ttl_s)
        return victim.slot

    def get(self, sid: str) -> Optional[SessionState]:
        with self._lock:
            return self._sessions.get(sid)

    def advanced(self, sid: str, frames: int) -> None:
        """Commit one successful advance: rotate the write offset and
        refresh the TTL clock. The engine calls this after the device
        update landed, so a failed launch never moves the window."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                return
            s.off = (s.off + frames) % s.window
            s.frames_seen += frames
            s.last_active = time.monotonic()

    def end(self, sid: str) -> bool:
        """Client-initiated close: free the slot now (no TTL wait)."""
        with self._lock:
            s = self._sessions.pop(sid, None)
            if s is None:
                return False
            self._free[s.pool_key].append(s.slot)
            return True

    def sweep(self) -> int:
        """Reclaim every TTL-expired session; returns the count. Called
        from the advance path (no poller thread to leak)."""
        now = time.monotonic()
        evicted = 0
        with self._lock:
            for sid in [sid for sid, s in self._sessions.items()
                        if now - s.last_active >= self.ttl_s]:
                s = self._sessions.pop(sid)
                self._free[s.pool_key].append(s.slot)
                self._c_evicted.inc(table=self.name)
                evicted += 1
        if evicted:
            logger.info("stream: TTL sweep reclaimed %d session(s)", evicted)
        return evicted

    def sessions(self) -> List[SessionState]:
        with self._lock:
            return list(self._sessions.values())

    def adopt(self, other: "SessionTable") -> None:
        """Hot-swap state carry: take over `other`'s sessions and slot free
        lists wholesale (the ring pools move separately,
        `StreamingEngine.carry_state_from`). Lock order: self, then other."""
        with self._lock:
            with other._lock:
                self._sessions = dict(other._sessions)
                self._free = {k: list(v) for k, v in other._free.items()}

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            live = len(self._sessions)
            free = sum(len(v) for v in self._free.values())
        return {"sessions_live": float(live), "slots_free": float(free),
                "evicted": self._c_evicted.value(table=self.name)}
