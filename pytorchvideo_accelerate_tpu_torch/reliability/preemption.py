"""Preemption grace path: SIGTERM/SIGINT -> finish the step, save, exit 0
(the port's copy of the JAX package's `reliability/preemption.py`).

The trainer installs the process-default `PreemptionGuard` around `fit()`
(`reliability.graceful_shutdown`, on by default) and polls
`guard.requested` once per optimizer step: an Event read, no lock and no
device sync. On a request it leaves the epoch loop after the step in
flight, writes a checkpoint of kind "preempt" at the consumed loader
position and the `emergency_checkpoint.json` record, dumps the flight
record, skips eval and returns `preempted: True`;
`--resume_from_checkpoint auto` then lands on that step.

While the guard is installed the first SIGTERM/SIGINT does not reach the
flight recorder's dump-and-die handler: the guard records a "preempt"
event and dumps the flight record itself (evidence even if the drain then
hangs), then drains.

A second signal restores the previous disposition and re-delivers the
signal, so a grace path that hangs can still be killed. `uninstall()` (the
`fit()` finally) restores the previous handlers exactly.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, Optional

from pytorchvideo_accelerate_tpu_torch.obs import get_recorder
from pytorchvideo_accelerate_tpu_torch.reliability.atomic import atomic_write_json

EMERGENCY_RECORD = "emergency_checkpoint.json"

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionGuard:
    """Signal-to-Event adapter with a two-strikes escalation."""

    def __init__(self):
        self._requested = threading.Event()
        self.reason: str = ""
        self._prev: Dict[int, object] = {}
        self._installed = False

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def request(self, reason: str = "api") -> None:
        """Programmatic preemption (tests, embedding runtimes)."""
        if not self._requested.is_set():
            self.reason = reason
            self._requested.set()
            get_recorder().record("preempt", reason)

    def _handler(self, signum, frame) -> None:
        if self._requested.is_set():
            # second strike: the grace path is stuck or the operator means
            # it; restore the previous disposition and re-deliver
            self._restore(signum)
            os.kill(os.getpid(), signum)
            return
        name = signal.Signals(signum).name
        self.reason = name
        self._requested.set()
        get_recorder().record("preempt", name)
        get_recorder().dump()  # evidence even if the drain then hangs

    def install(self) -> bool:
        """Take over SIGTERM/SIGINT and clear any earlier request; returns
        False off the main thread (where `signal.signal` raises: the guard
        then serves only `request()`/`requested`)."""
        if self._installed:
            return True
        self._requested.clear()
        self.reason = ""
        try:
            for sig in _SIGNALS:
                self._prev[sig] = signal.getsignal(sig)
                signal.signal(sig, self._handler)
        except (ValueError, OSError):  # not the main thread
            self._prev.clear()
            return False
        self._installed = True
        return True

    def _restore(self, signum) -> None:
        prev = self._prev.get(signum)
        if prev is not None:
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass

    def uninstall(self) -> None:
        if self._installed:
            for sig in _SIGNALS:
                self._restore(sig)
            self._prev.clear()
            self._installed = False
        self._requested.clear()


_DEFAULT = PreemptionGuard()


def get_guard() -> PreemptionGuard:
    """The process-default guard (the trainer installs and uninstalls it
    around fit(); tests reach the same instance to request or observe)."""
    return _DEFAULT


def record_emergency(output_dir: str, *, step: int, epoch: int,
                     checkpoint_dir: str, reason: str = "") -> Optional[str]:
    """Atomically write `<output_dir>/emergency_checkpoint.json`, the record
    operators read to find where a preempted run stopped. Best effort: a
    failing record write does not turn a saved checkpoint into a crash."""
    try:
        return atomic_write_json(
            os.path.join(output_dir, EMERGENCY_RECORD),
            {"step": int(step), "epoch": int(epoch),
             "checkpoint_dir": checkpoint_dir, "reason": reason,
             "pid": os.getpid(), "ts": round(time.time(), 6)})
    except OSError:
        return None


def read_emergency_record(output_dir: str) -> Optional[dict]:
    path = os.path.join(output_dir, EMERGENCY_RECORD)
    try:
        with open(path) as f:
            out = json.load(f)
        out["path"] = path
        return out
    except (OSError, ValueError):
        return None
