"""Admission control + service health state machine (counterpart of the JAX
package's `serving/admission.py`).

healthy / degraded / draining, driven by queue depth and the drain signal:
past `shed_hwm` queued requests the server sheds with 503 + Retry-After
before latency collapses; below `recover_lwm` it recovers (hysteresis).
`draining` (SIGTERM) sheds everything and turns /healthz non-200.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

HEALTHY, DEGRADED, DRAINING = "healthy", "degraded", "draining"


class AdmissionController:
    """Queue-depth load shedding with hysteresis + a drain latch.
    Thread-safe: `admit()` runs on every HTTP handler thread."""

    def __init__(self, max_queue: int, shed_frac: float = 0.9,
                 recover_frac: float = 0.5, retry_after_s: float = 1.0,
                 on_state_change: Optional[Callable[[str, str], None]] = None):
        if not 0.0 < shed_frac <= 1.0:
            raise ValueError(f"shed_frac must be in (0, 1], got {shed_frac}")
        if not 0.0 <= recover_frac <= shed_frac:
            raise ValueError(
                f"recover_frac must be in [0, shed_frac], got {recover_frac}")
        self.max_queue = max(int(max_queue), 1)
        self.shed_hwm = max(int(self.max_queue * shed_frac), 1)
        self.recover_lwm = int(self.max_queue * recover_frac)
        self.retry_after_s = float(retry_after_s)
        self.on_state_change = on_state_change  # (old, new) observer
        # live depth source (MicroBatcher.queue_depth): lets /healthz reads
        # recover degraded -> healthy on an idle server
        self.queue_depth_fn: Optional[Callable[[], int]] = None
        self._lock = threading.Lock()
        self._state = HEALTHY

    def state(self) -> str:
        with self._lock:
            state = self._state
        if state == DEGRADED and self.queue_depth_fn is not None:
            if int(self.queue_depth_fn()) <= self.recover_lwm:
                self._transition(HEALTHY)
                return HEALTHY
        return state

    def _transition(self, new: str) -> None:
        """Caller holds no lock; the observer runs outside it."""
        with self._lock:
            old = self._state
            if old == new or old == DRAINING:  # draining never un-drains
                return
            self._state = new
        if self.on_state_change is not None:
            self.on_state_change(old, new)

    def start_draining(self) -> None:
        """Drain latch (SIGTERM): every later request sheds."""
        self._transition(DRAINING)

    def admit(self, queue_depth: int) -> Tuple[bool, float]:
        """(admit?, retry_after_s), called before submit with the live queue
        depth; also drives the healthy <-> degraded hysteresis."""
        with self._lock:
            state = self._state
        if state == DRAINING:
            return False, self.retry_after_s
        if queue_depth >= self.shed_hwm:
            self._transition(DEGRADED)
            return False, self.retry_after_s
        if state == DEGRADED and queue_depth <= self.recover_lwm:
            self._transition(HEALTHY)
        return True, 0.0
