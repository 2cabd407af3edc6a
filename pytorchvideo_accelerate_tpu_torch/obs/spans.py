"""Near-zero-overhead wall-time spans: `with span("step"): ...` (the port's
copy of the JAX package's `obs/spans.py`).

The timing primitive of the telemetry layer. The device prefetcher, the
train loop and the checkpointer wrap their blocking sections in named
spans; the trainer drains the aggregated window every `log_every` steps
into a per-window wall-time breakdown (`obs/input_wait_s`, `obs/h2d_s`,
`obs/step_s`, ...) that goes out through the trackers, and each completed
span is also appended to the flight recorder's ring, so a crash dump
carries the recent timeline.

- **Overhead.** Disabled, `span()` returns one shared no-op context
  manager. Enabled: two `perf_counter` calls and one dict update under a
  lock.
- **Per-thread nesting.** Each thread keeps its own stack; `current_stacks()`
  shows every thread's open spans.
- **Consumer against background.** Spans recorded on worker threads (`h2d`,
  ...) overlap the step loop's wall time; `BACKGROUND` names them so the
  per-window sum uses the consumer's spans only.
- **Tracing.** Under an armed tracer (`obs/trace.py`), a span opened on a
  thread with an active trace context is also a trace event carrying the
  trace and parent ids; disarmed, the hook is one module-global read.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

from pytorchvideo_accelerate_tpu_torch.obs.trace import get_tracer as _get_tracer
from pytorchvideo_accelerate_tpu_torch.utils.sync import make_lock, shared_state


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("_c", "name", "_t0", "_trace")

    def __init__(self, collector: "SpanCollector", name: str):
        self._c = collector
        self.name = name
        self._t0 = 0.0
        self._trace = None

    def __enter__(self):
        self._c._push(self.name)
        # the tracer hook: with a trace active on this thread the span is
        # also a trace event
        rt = _get_tracer()
        self._trace = rt.span_begin(self.name) if rt is not None else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        tok = self._trace
        if tok is not None:
            tok.end(error=exc_type is not None)
            self._trace = None
        self._c._pop(self.name)
        self._c.observe(self.name, dt, error=exc_type is not None)
        return False


# span names recorded on worker threads, or nested inside another consumer
# span: the per-window "components sum to wall time" check excludes them
# (they are reported, not summed)
BACKGROUND = frozenset({"h2d", "decode", "serve_flush",
                        "eval_input_wait", "eval_h2d"})

# per-sample spans are too chatty for the flight ring; they still
# aggregate into the window
RECORDER_EXCLUDE = frozenset({"decode"})


@shared_state("_window", "recorder")
class SpanCollector:
    """Thread-safe span aggregator: per-name (total_s, count) windows plus
    per-thread open-span stacks."""

    def __init__(self, enabled: bool = True, recorder=None):
        self.enabled = enabled
        self.recorder = recorder  # FlightRecorder or None
        self._lock = make_lock("SpanCollector._lock")
        self._window: Dict[str, list] = {}
        self._tls = threading.local()
        # thread ident -> (thread name, live stack list): the same lists the
        # threading.local holds
        self._stacks: Dict[int, tuple] = {}

    # --- recording --------------------------------------------------------

    def span(self, name: str):
        """Context manager timing a named section (no-op when disabled)."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name)

    def observe(self, name: str, dur_s: float, error: bool = False) -> None:
        """Record an externally timed duration (the prefetcher measures its
        queue wait once and feeds both its own wait_s and this window)."""
        if not self.enabled:
            return
        with self._lock:
            entry = self._window.setdefault(name, [0.0, 0])
            entry[0] += dur_s
            entry[1] += 1
        rec = self.recorder
        if rec is not None and name not in RECORDER_EXCLUDE:
            if error:
                rec.record("span", name, dur_s=round(dur_s, 6), error=True)
            else:
                rec.record("span", name, dur_s=round(dur_s, 6))

    # --- nesting stacks ---------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
            t = threading.current_thread()
            with self._lock:
                if len(self._stacks) > 32:  # prune dead threads' leftovers
                    alive = {th.ident for th in threading.enumerate()}
                    for ident in [i for i, (_, s) in self._stacks.items()
                                  if not s and i not in alive]:
                        del self._stacks[ident]
                self._stacks[t.ident] = (t.name, st)
        return st

    def _push(self, name: str) -> None:
        self._stack().append(name)

    def _pop(self, name: str) -> None:
        st = self._stack()
        if st and st[-1] == name:
            st.pop()

    def current_stacks(self) -> Dict[str, list]:
        """{"thread_name-ident": [outer, ..., inner]} for every thread with
        an open span (the ident keeps two threads of one name apart)."""
        with self._lock:
            return {f"{name}-{ident}": list(st)
                    for ident, (name, st) in self._stacks.items() if st}

    # --- draining ---------------------------------------------------------

    def pop_window(self) -> Dict[str, Tuple[float, int]]:
        """Drain and return {name: (total_s, count)} accumulated since the
        last drain (the per-`log_every` breakdown window)."""
        with self._lock:
            window, self._window = self._window, {}
        return {k: (v[0], v[1]) for k, v in window.items()}


_DEFAULT = SpanCollector()


def get_collector() -> SpanCollector:
    return _DEFAULT


def span(name: str):
    """`with span("step"): ...` against the process-default collector."""
    return _DEFAULT.span(name)


def observe(name: str, dur_s: float) -> None:
    _DEFAULT.observe(name, dur_s)


def current_stacks() -> Dict[str, list]:
    return _DEFAULT.current_stacks()
