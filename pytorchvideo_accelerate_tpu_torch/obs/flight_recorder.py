"""Flight recorder: a bounded in-memory ring of recent telemetry events,
dumped to `<output_dir>/flight_record.json` when the process dies (the
port's copy of the JAX package's `obs/flight_recorder.py`). Ranks that
share an output directory name their files apart: rank 0 writes
`flight_record.json`, rank r `flight_record.rank<r>.json` (`file_name`,
set by `install`).

Spans, sampled metrics, warnings and exceptions append here cheaply (one
deque append under a lock; the deque's maxlen bounds memory). Dump paths:

- **exception**: `Trainer.fit()` dumps on any exception out of its epoch
  loop, and `install()` chains `sys.excepthook` for crashes outside it;
- **SIGTERM**: `install()` chains a handler so an external kill leaves
  evidence behind (while `fit()` runs, the preemption guard takes SIGTERM
  first, records it and dumps itself: reliability/preemption.py);
- **preemption**: the trainer's grace path dumps after its checkpoint;
- **stall**: the hang watchdog (obs/watchdog.py) dumps after its report.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import List, Optional

from pytorchvideo_accelerate_tpu_torch.utils.sync import shared_state

_MIN_CAPACITY = 16
FILE_NAME = "flight_record.json"


def rank_file_name(rank: int) -> str:
    """The dump's file name for process `rank` of a group (rank 0, or no
    group: `flight_record.json`)."""
    return FILE_NAME if rank == 0 else f"flight_record.rank{rank}.json"


@shared_state("_events", "_output_dir", "_installed")
class FlightRecorder:
    """Thread-safe bounded event ring and crash-dump plumbing."""

    def __init__(self, capacity: int = 512):
        # RLock: the SIGTERM handler runs on the main thread and calls
        # record()/dump(); if the signal interrupted that thread inside
        # record(), a plain lock would deadlock
        self._lock = threading.RLock()
        self._events: deque = deque(maxlen=max(capacity, _MIN_CAPACITY))
        self._output_dir = ""
        self.file_name = FILE_NAME
        self._installed = False

    # --- recording --------------------------------------------------------

    def record(self, kind: str, name: str, **fields) -> None:
        evt = {"ts": round(time.time(), 6),
               "thread": threading.current_thread().name,
               "kind": kind, "name": str(name)}
        if fields:
            evt.update(fields)
        with self._lock:
            self._events.append(evt)

    def warn(self, message: str, **fields) -> None:
        self.record("warning", message, **fields)

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._events = deque(self._events,
                                 maxlen=max(capacity, _MIN_CAPACITY))

    def snapshot(self, last: Optional[int] = None) -> List[dict]:
        with self._lock:
            events = list(self._events)
        return events[-last:] if last else events

    # --- dumping ----------------------------------------------------------

    def default_path(self) -> Optional[str]:
        with self._lock:
            out_dir = self._output_dir
        if not out_dir:
            return None
        return os.path.join(out_dir, self.file_name)

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write the ring to `path` (default: the installed output dir).
        Returns the written path, or None when there is nowhere to write or
        the write failed: a dying process must not die twice over its own
        black box."""
        path = path or self.default_path()
        if not path:
            return None
        payload = {"dumped_at": round(time.time(), 6), "pid": os.getpid(),
                   "events": self.snapshot()}
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=str)
        except OSError:
            return None
        return path

    # --- crash hooks ------------------------------------------------------

    def install(self, output_dir: str, file_name: str = FILE_NAME) -> None:
        """Point dumps at `output_dir/file_name` and (once per process)
        chain sys.excepthook and SIGTERM so an uncaught crash or an
        external kill flushes the ring. Later calls only move the output
        dir and the name."""
        with self._lock:
            if output_dir:
                self._output_dir = output_dir
            self.file_name = file_name
            if self._installed:
                return
            self._installed = True

        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            self.record("exception", exc_type.__name__,
                        message=str(exc)[:500])
            self.dump()
            prev_hook(exc_type, exc, tb)

        sys.excepthook = hook

        try:
            prev = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                self.record("signal", "SIGTERM")
                self.dump()
                if callable(prev):
                    prev(signum, frame)
                elif prev is signal.SIG_IGN:
                    return  # keep an ignore disposition: dump, survive
                else:  # the default disposition: die of it
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, on_term)
        except (ValueError, OSError):  # not the main thread: hooks only
            pass


_DEFAULT = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _DEFAULT
