"""Heartbeat hang watchdog: the evidence before the external kill (the
port's copy of the JAX package's `obs/watchdog.py`).

A wedged collective, a stuck host-to-card copy or a deadlocked queue
leaves the process idle until the process group's timeout or an outer
`timeout -k` kills it blind. Each component (the train loop, the device
prefetchers, the collective sections of `parallel/hangcheck.py`) calls
`heartbeat(name)` when it makes progress; a daemon thread checks the ages,
and the first component past `timeout_s` triggers one stall dump:

- the stalled names, and for each one inside a section the detail it is
  wedged in (``[watchdog] collective wedged inside 'barrier host=1/2
  name=checkpoint_close' for 10.1s``);
- the open span stacks (`obs.spans.current_stacks`);
- every thread's Python stack (``--- thread <name> (<ident>) ---``);

all to stderr, then a ``watchdog`` ``stall`` event in the flight recorder,
which is dumped to `<output_dir>/<recorder.file_name>` (rank 0's
`flight_record.json`, rank r's `flight_record.rank<r>.json`).

The watchdog never kills: a false positive (a long first step) costs one
noisy dump. A stalled name fires once and re-arms at its next heartbeat.
Components that finish call `clear(name)`, so an idle phase (between
epochs, a drained prefetcher) is no stall. `section(name, detail)` adds
the attribution: while a component is inside a section, its stall is
reported as wedged inside that detail; leaving the section clears the
component (no collective in flight is idle, never a stall).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple


class Watchdog:
    """No-progress detector over named heartbeats."""

    def __init__(self, timeout_s: float, output_dir: str = "",
                 recorder=None, collector=None,
                 on_stall: Optional[Callable[[List[str]], None]] = None,
                 poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.output_dir = output_dir
        self.recorder = recorder      # FlightRecorder or None
        self.collector = collector    # SpanCollector or None (open spans)
        self.on_stall = on_stall      # called after the dump (tests, ops)
        self._poll_s = poll_s or min(max(self.timeout_s / 4.0, 0.02), 5.0)
        self._lock = threading.Lock()
        self._beats: Dict[str, float] = {}  # name -> last monotonic beat
        self._fired = set()  # names already dumped for the current stall
        self._sections: Dict[str, Tuple[str, float]] = {}  # name -> (detail, t)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0
        self.last_stalled: List[str] = []
        # stalled name -> (detail, seconds inside) for the components that
        # were inside a section when they stalled
        self.last_attribution: Dict[str, Tuple[str, float]] = {}

    # --- component side ---------------------------------------------------

    def heartbeat(self, name: str = "main") -> None:
        """Progress ping; the first ping registers the component."""
        with self._lock:
            self._beats[name] = time.monotonic()
            self._fired.discard(name)

    def beat_fn(self, name: str) -> Callable[[], None]:
        """A zero-argument pinger for components that take a callable."""
        return lambda: self.heartbeat(name)

    def clear(self, name: str) -> None:
        """Deregister a component that finished (not a stall)."""
        with self._lock:
            self._beats.pop(name, None)
            self._fired.discard(name)
            self._sections.pop(name, None)

    @contextlib.contextmanager
    def section(self, name: str, detail: str = ""):
        """An attributed progress window: a heartbeat, and `name` marked as
        inside `detail`, on entry; a stall while open reports the detail.
        Exit clears the component."""
        now = time.monotonic()
        with self._lock:
            self._beats[name] = now
            self._fired.discard(name)
            self._sections[name] = (detail, now)
        try:
            yield
        finally:
            self.clear(name)

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "Watchdog":
        thread = self._thread
        if thread is not None and thread.is_alive():
            # polling already, or a stopped poller still in a slow dump:
            # never a second one
            return self
        self._stop.clear()  # a stopped watchdog can be restarted
        thread = threading.Thread(target=self._run, name="pva-watchdog",
                                  daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self._poll_s * 4 + 1.0)
            if not thread.is_alive():
                with self._lock:
                    if self._thread is thread:  # a racing start() may have
                        self._thread = None     # installed a fresh poller

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            self.check()

    # --- detection --------------------------------------------------------

    def check(self, now: Optional[float] = None) -> List[str]:
        """One poll: returns (and dumps for) the newly stalled components.
        Public so tests drive detection deterministically."""
        now = time.monotonic() if now is None else now
        with self._lock:
            stalled = sorted(
                name for name, t in self._beats.items()
                if name not in self._fired and now - t > self.timeout_s)
            self._fired.update(stalled)
        if stalled:
            self._fire(stalled)
        return stalled

    def _fire(self, stalled: List[str]) -> None:
        now = time.monotonic()
        with self._lock:
            self.stall_count += 1
            self.last_stalled = list(stalled)
            attribution = {
                name: (detail, round(now - t, 3))
                for name, (detail, t) in self._sections.items()
                if name in stalled}
            self.last_attribution = attribution
        lines = [
            f"[watchdog] NO PROGRESS from {', '.join(stalled)} for "
            f"> {self.timeout_s:g}s — dumping all-thread stacks + flight "
            "record before an external timeout kills the process blind",
        ]
        for name, (detail, age) in attribution.items():
            # the collective-hang verdict: wedged inside an attributed
            # operation, not merely quiet between them
            lines.append(f"[watchdog] {name} wedged inside '{detail}' "
                         f"for {age:g}s")
        if self.collector is not None:
            open_spans = self.collector.current_stacks()
            if open_spans:
                lines.append(f"[watchdog] open spans: {open_spans}")
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            lines.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
            lines.append("".join(traceback.format_stack(frame)).rstrip())
        print("\n".join(lines), file=sys.stderr, flush=True)
        if self.recorder is not None:
            self.recorder.record(
                "watchdog", "stall", stalled=list(stalled),
                timeout_s=self.timeout_s,
                **({"attribution": {n: f"{d} ({a:g}s)"
                                    for n, (d, a) in attribution.items()}}
                   if attribution else {}))
            path = self.recorder.dump(
                os.path.join(self.output_dir, self.recorder.file_name)
                if self.output_dir else None)
            if path:
                print(f"[watchdog] flight record dumped to {path}",
                      file=sys.stderr, flush=True)
        if self.on_stall is not None:
            try:
                self.on_stall(list(stalled))
            except Exception:  # the hook must not kill the poll thread
                pass
