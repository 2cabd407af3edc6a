"""End-to-end distributed tracing: one request's (or one train step's) life
across threads, queues and processes as one correlated timeline (the port's
copy of the JAX package's `obs/trace.py`).

The spans of `obs/spans.py` answer "how much time went where, in
aggregate"; this module answers "what happened to this request": a
`TraceContext` (trace_id / span_id / parent_id) is made at a head (an HTTP
request, a train step), carried through every cross-thread and
cross-process handoff the port owns (the device-prefetch worker, the
scheduler and batcher queues, the `traceparent` HTTP header), and every
completed span lands in a bounded per-process ring as a Chrome / Perfetto
trace event. `pva-torch-trace` (obs/tracetool.py) merges the rings and
flight records of N processes into one timeline.

- **Disarmed costs one global read.** The tracer is a module global
  (`_tracer`, None by default, armed only by `obs.trace_sample_rate > 0`);
  every hot-path helper reads it, checks for None and returns a shared
  no-op or None: no allocation, no lock, no id.
- **Head-based sampling.** The decision is made once, where the trace
  starts (`Tracer.start`), from a `random.Random(seed)`: one seed gives the
  same decisions here and in the JAX package. Everything downstream only
  asks "is there an active context?"; a continued trace (an incoming
  `traceparent` with the sampled flag) is always recorded, because the head
  already decided.
- **Bounded memory.** Completed spans append to a deque ring (`maxlen`);
  export and dump snapshot it as Chrome trace-event JSON (`ph: "X"`,
  wall-clock microseconds, so merges of several processes align).
- **Self-audited overhead.** `overhead_s` = the live event and start counts
  times a per-event cost calibrated when the tracer is armed (the best of
  three timed passes over the real record path: id draw, event dict, ring
  append), not a clock read per event, which would cost more than the
  bookkeeping it measures.

Stdlib only: worker threads, the server and the merge CLI import it.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from pytorchvideo_accelerate_tpu_torch.utils.sync import make_lock, shared_state

# The armed tracer or None. Module-global by design: the disarmed check
# must be one load, and arming is a whole-process decision made at
# configure time.
_tracer: Optional["Tracer"] = None

TRACE_RING_DEFAULT = 4096
TRACE_FILE = "trace_ring.json"  # dump() destination under output_dir


def rank_file_name(rank: int) -> str:
    """The ring's file name for process `rank` of a group (rank 0, or no
    group: `trace_ring.json`), so ranks sharing an output dir keep theirs."""
    return TRACE_FILE if rank == 0 else f"trace_ring.rank{rank}.json"


class _Noop:
    """Shared do-nothing stand-in for every disarmed/unsampled path."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def finish(self, **tags):
        return None


NOOP = _Noop()


class TraceContext:
    """One position in a trace: (trace_id, span_id, parent_id). Immutable
    by convention; `child()` derives the next hop. Existence IS the
    sampling verdict — unsampled traces never materialize a context."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _new_span_id(), self.span_id)

    def __repr__(self) -> str:  # debug output
        return (f"TraceContext({self.trace_id[:8]}…/{self.span_id}"
                + (f"<-{self.parent_id}" if self.parent_id else "") + ")")


# id stream: urandom-SEEDED but then pure-Python getrandbits — NOT the
# seeded sampling RNG (two processes sharing a sampling seed must make the
# same DECISIONS without colliding on ids), and NOT uuid4 per id (an
# urandom syscall per span costs far more than the rest of the
# bookkeeping). Reseeded on pid change
# so a fork can never replay the parent's stream. C-level getrandbits is
# atomic under the GIL.
_ids = random.Random(int.from_bytes(os.urandom(16), "big"))
_ids_pid = os.getpid()


def _id_rng() -> random.Random:
    global _ids, _ids_pid
    pid = os.getpid()
    if pid != _ids_pid:
        _ids = random.Random(int.from_bytes(os.urandom(16), "big") ^ pid)
        _ids_pid = pid
    return _ids


def _new_trace_id() -> str:
    return f"{_id_rng().getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_id_rng().getrandbits(64):016x}"


# --- W3C traceparent (the HTTP hop format) ----------------------------------

def format_traceparent(ctx: TraceContext) -> str:
    """`00-<trace_id>-<span_id>-01`: version 00, sampled flag set (only
    sampled traces ever have a context to format)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(header: str) -> Optional[TraceContext]:
    """Parse an incoming `traceparent`; None for malformed/unsampled
    headers (a bad header must degrade to "untraced", never to a 500).
    The returned context's span_id is the REMOTE span — callers derive
    their local spans via `child()`."""
    try:
        parts = header.strip().split("-")
        if len(parts) != 4:
            return None
        version, trace_id, span_id, flags = parts
        int(version, 16), int(flags, 16)  # hex-validate
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        int(trace_id, 16), int(span_id, 16)
        if not int(flags, 16) & 0x01:
            return None  # head decided NOT to sample: honor it
        return TraceContext(trace_id, span_id)
    except (ValueError, AttributeError):
        return None


# --- live pieces ------------------------------------------------------------

class _Activate:
    """Push/pop an existing context on the calling thread's stack (the
    `attach` half of the capture/attach handoff pattern)."""

    __slots__ = ("_tracer", "ctx")

    def __init__(self, tracer: "Tracer", ctx: TraceContext):
        self._tracer = tracer
        self.ctx = ctx

    def __enter__(self):
        self._tracer._push(self.ctx)
        return self

    def __exit__(self, *exc):
        self._tracer._pop()
        return False


class _SpanToken:
    """One in-flight child span (obs.span integration + `trace.span`)."""

    __slots__ = ("_tracer", "ctx", "name", "_t0_wall", "_t0_perf", "_tags")

    def __init__(self, tracer: "Tracer", ctx: TraceContext, name: str,
                 tags: Optional[dict] = None):
        self._tracer = tracer
        self.ctx = ctx
        self.name = name
        self._tags = tags
        self._t0_wall = time.time()
        self._t0_perf = time.perf_counter()

    def end(self, error: bool = False, **tags) -> None:
        dur = time.perf_counter() - self._t0_perf
        self._tracer._pop()
        all_tags = dict(self._tags or {})
        all_tags.update(tags)
        if error:
            all_tags["error"] = True
        self._tracer._record(self.name, self.ctx, self._t0_wall, dur,
                             all_tags)


class _TraceSpan:
    """`with trace.span("device_dispatch", bucket=4): ...` — a child span
    under the CURRENT context (no-op handled by the module helper)."""

    __slots__ = ("_tracer", "name", "_tags", "_tok")

    def __init__(self, tracer: "Tracer", name: str, tags: dict):
        self._tracer = tracer
        self.name = name
        self._tags = tags
        self._tok: Optional[_SpanToken] = None

    def __enter__(self):
        self._tok = self._tracer.span_begin(self.name, self._tags)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._tok is not None:
            self._tok.end(error=exc_type is not None)
        return False


class TraceHandle:
    """A root (or continued) span. Two usage shapes:

    - synchronous: `with tracer.start("train_step", gstep=g) or NOOP: ...`
      — activates the context for the block, records the root event on
      exit;
    - asynchronous (the load generator, HTTP fronts): keep the handle,
      `attach(handle.ctx)` around the submit, `handle.finish(...)` when
      the future resolves. `finish` is once-only, so entering AND
      finishing cannot double-record."""

    __slots__ = ("_tracer", "ctx", "name", "_tags", "_t0_wall", "_t0_perf",
                 "_done", "_entered")

    def __init__(self, tracer: "Tracer", ctx: TraceContext, name: str,
                 tags: dict):
        self._tracer = tracer
        self.ctx = ctx
        self.name = name
        self._tags = tags
        self._t0_wall = time.time()
        self._t0_perf = time.perf_counter()
        self._done = False
        self._entered = False

    def __enter__(self):
        self._tracer._push(self.ctx)
        self._entered = True
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._pop()
        self._entered = False
        self.finish(**({"error": True} if exc_type is not None else {}))
        return False

    def finish(self, **tags) -> None:
        """Record the root event (idempotent; async completions race a
        with-exit only in caller bugs, and the first writer wins)."""
        if self._done:
            return
        self._done = True
        dur = time.perf_counter() - self._t0_perf
        all_tags = dict(self._tags)
        all_tags.update(tags)
        self._tracer._record(self.name, self.ctx, self._t0_wall, dur,
                             all_tags)


@shared_state("_events", "_started", "_sampled", "_forced", "_continued",
              "_appended", "_overhead_s", "_last_export")
class Tracer:
    """Head-sampled tracer + bounded per-process trace-event ring."""

    def __init__(self, sample_rate: float = 1.0, seed: int = 0,
                 capacity: int = TRACE_RING_DEFAULT, output_dir: str = "",
                 file_name: str = TRACE_FILE):
        if not 0.0 <= float(sample_rate) <= 1.0:
            raise ValueError(
                f"trace_sample_rate must be in [0, 1], got {sample_rate}")
        self.sample_rate = float(sample_rate)
        self.seed = int(seed)
        self.output_dir = output_dir
        self.file_name = file_name
        self._lock = make_lock("Tracer._lock")
        # seeded decision stream: deterministic under a seed (forced starts
        # and continuations deliberately do NOT consume from it)
        self._rng = random.Random(seed)
        self._events: deque = deque(maxlen=max(int(capacity), 16))
        self._tls = threading.local()
        self._started = 0    # start() calls (sampled or not)
        self._sampled = 0    # roots that got a context (incl. forced)
        self._forced = 0     # force=True roots (debug probes) among sampled
        self._continued = 0  # traces continued from a remote parent
        self._appended = 0   # events ever recorded (ring may have evicted)
        self._overhead_s = 0.0  # calibrated bookkeeping CPU-time estimate
        self._last_export = ""
        # one-time calibration of the per-event bookkeeping cost on THIS
        # host: ids + timing reads + event-dict build + bounded append —
        # the same work _record and span_begin/TraceHandle do per event.
        # Billed per live event instead of measured live (module
        # docstring's overhead note); min of repeated perf_counter runs
        # filters a preemption landing inside one calibration pass.
        tmp: deque = deque(maxlen=64)
        parent = TraceContext(_new_trace_id(), _new_span_id())
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(256):
                ctx = parent.child()
                tmp.append({
                    "name": "calibrate", "ph": "X",
                    "ts": round(time.time() * 1e6, 1),
                    "dur": round(time.perf_counter() * 1e6, 1),
                    "pid": os.getpid(), "tid": threading.get_ident(),
                    "args": {"trace_id": ctx.trace_id,
                             "span_id": ctx.span_id,
                             "parent_id": ctx.parent_id,
                             "thread": threading.current_thread().name},
                })
            best = min(best, (time.perf_counter() - t0) / 256)
        self._event_cost_s = max(best, 0.0)

    # --- per-thread context stack ----------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, ctx: TraceContext) -> None:
        self._stack().append(ctx)

    def _pop(self) -> None:
        st = self._stack()
        if st:
            st.pop()

    def current(self) -> Optional[TraceContext]:
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def activate(self, ctx: TraceContext) -> _Activate:
        """Re-establish a captured context on THIS thread (the consumer
        half of a queue/thread handoff)."""
        return _Activate(self, ctx)

    # --- roots ------------------------------------------------------------

    def start(self, name: str, force: bool = False,
              **tags) -> Optional[TraceHandle]:
        """Start a new trace at a head. Returns None when the head-based
        sampler says no (callers fall back to `or NOOP`); `force=True`
        bypasses sampling for debug probes without consuming the seeded
        decision stream."""
        with self._lock:
            self._started += 1
            sampled = force or (self.sample_rate > 0.0
                                and self._rng.random() < self.sample_rate)
            if sampled:
                self._sampled += 1
                if force:
                    self._forced += 1
            # bill the head's id generation + handle allocation (below,
            # when sampled) at the calibrated per-event rate
            self._overhead_s += self._event_cost_s
        if not sampled:
            return None
        ctx = TraceContext(_new_trace_id(), _new_span_id())
        return TraceHandle(self, ctx, name, tags)

    def continue_trace(self, header, name: str,
                       **tags) -> Optional[TraceHandle]:
        """Continue a trace from an incoming `traceparent` header (or an
        explicit TraceContext). The remote head already sampled this trace,
        so the local rate is irrelevant; None only for malformed headers."""
        ctx = (header if isinstance(header, TraceContext)
               else parse_traceparent(header or ""))
        if ctx is None:
            return None
        with self._lock:
            self._continued += 1
        return TraceHandle(self, ctx.child(), name, tags)

    # --- spans ------------------------------------------------------------

    def span_begin(self, name: str,
                   tags: Optional[dict] = None) -> Optional[_SpanToken]:
        """Open a child span under the current context; None when no trace
        is active on this thread (the obs.span integration point — an
        untraced span costs exactly this check)."""
        cur = self.current()
        if cur is None:
            return None
        ctx = cur.child()
        self._push(ctx)
        return _SpanToken(self, ctx, name, tags)

    def span(self, name: str, **tags):
        """Context-manager child span (module helper `trace.span` adds the
        disarmed short-circuit)."""
        if self.current() is None:
            return NOOP
        return _TraceSpan(self, name, tags)

    def event(self, ctx: TraceContext, name: str, t0_wall: float,
              dur_s: float, **tags) -> None:
        """Record a completed child span under `ctx` with externally
        measured timing (queue waits: the producer stamped t_enqueue, the
        consumer knows the wait — no token ever lived across the hop)."""
        self._record(name, ctx.child(), t0_wall, dur_s, tags)

    # --- ring -------------------------------------------------------------

    def _record(self, name: str, ctx: TraceContext, t0_wall: float,
                dur_s: float, tags: Optional[dict]) -> None:
        args: Dict[str, object] = {
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "thread": threading.current_thread().name,
        }
        if ctx.parent_id:
            args["parent_id"] = ctx.parent_id
        if tags:
            args.update(tags)
        evt = {
            "name": name,
            "ph": "X",  # complete event: wall-clock start + duration
            "ts": round(t0_wall * 1e6, 1),
            "dur": round(dur_s * 1e6, 1),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": args,
        }
        with self._lock:
            self._events.append(evt)
            self._appended += 1
            # calibrated accounting (×2: the begin side — span_begin /
            # token or handle construction with its clock reads — costs
            # about the same as this record path)
            self._overhead_s += self._event_cost_s * 2

    # --- export -----------------------------------------------------------

    def export(self) -> dict:
        """Snapshot the ring as a Chrome/Perfetto trace-event JSON dict."""
        with self._lock:
            events = list(self._events)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"pid": os.getpid(),
                          "sample_rate": self.sample_rate,
                          "seed": self.seed},
        }

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write the ring to `path` (default `<output_dir>/<file_name>`).
        Returns the written path, or None when there is nowhere to write or
        the write failed — the trace ring must never crash a dying process
        (the flight-recorder contract)."""
        if path is None:
            if not self.output_dir:
                return None
            path = os.path.join(self.output_dir, self.file_name)
        payload = self.export()
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # tmp + rename: a reader (pva-torch-trace) must never see a
            # torn ring, and two processes
            # mis-configured onto one output_dir degrade to last-writer-
            # wins instead of interleaved garbage
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:
            return None
        with self._lock:
            self._last_export = path
        return path

    # --- introspection ----------------------------------------------------

    def overhead_s(self) -> float:
        with self._lock:
            return self._overhead_s

    def slowest(self, k: int = 5) -> List[dict]:
        """Top-k ring events by duration among ROOT spans (no parent_id):
        the "which requests were slow" view."""
        with self._lock:
            events = list(self._events)
        roots = [e for e in events if "parent_id" not in e["args"]]
        roots.sort(key=lambda e: -e["dur"])
        return [{"trace_id": e["args"]["trace_id"], "name": e["name"],
                 "dur_ms": round(e["dur"] / 1e3, 3)} for e in roots[:k]]

    def stats(self) -> dict:
        with self._lock:
            started, sampled = self._started, self._sampled
            forced = self._forced
            continued, appended = self._continued, self._appended
            overhead, last = self._overhead_s, self._last_export
            ring_len = len(self._events)
            capacity = self._events.maxlen
        return {
            "sample_rate": self.sample_rate,
            "started": started,
            "sampled": sampled,
            "forced": forced,
            "sampled_frac": round(sampled / started, 4) if started else 0.0,
            "continued": continued,
            "events_recorded": appended,
            "ring_occupancy": ring_len,
            "ring_capacity": capacity,
            "events_evicted": max(appended - ring_len, 0),
            "overhead_s": round(overhead, 6),
            "last_export": last,
        }


# --- module API (the one-global-read hot path) ------------------------------

def get_tracer() -> Optional[Tracer]:
    return _tracer


def configure_tracing(sample_rate: float, seed: int = 0,
                      capacity: int = TRACE_RING_DEFAULT,
                      output_dir: str = "",
                      file_name: str = TRACE_FILE) -> Optional[Tracer]:
    """Arm (sample_rate > 0) or disarm (0) process-wide tracing: called
    from the Trainer's and the server's `obs.trace_sample_rate` wiring,
    never per request."""
    global _tracer
    if sample_rate <= 0.0:
        _tracer = None
        return None
    _tracer = Tracer(sample_rate=sample_rate, seed=seed, capacity=capacity,
                     output_dir=output_dir, file_name=file_name)
    return _tracer


def disable_tracing() -> None:
    global _tracer
    _tracer = None


def capture() -> Optional[TraceContext]:
    """The producer half of a handoff: grab the current context (or None)
    to ship alongside a queue payload / thread start. One global read when
    disarmed."""
    rt = _tracer
    return None if rt is None else rt.current()


def attach(ctx: Optional[TraceContext]):
    """The consumer half: re-establish a captured context on this thread.
    Shared no-op when disarmed or when there was nothing to carry."""
    rt = _tracer
    if rt is None or ctx is None:
        return NOOP
    return rt.activate(ctx)


def root(name: str, **tags):
    """Start-or-noop: `with trace.root("train_step", gstep=g): ...`."""
    rt = _tracer
    if rt is None:
        return NOOP
    return rt.start(name, **tags) or NOOP


def span(name: str, **tags):
    """Child-span-or-noop under the current context."""
    rt = _tracer
    if rt is None:
        return NOOP
    return rt.span(name, **tags)


def current_traceparent() -> Optional[str]:
    """The outgoing HTTP header for the current context, or None."""
    rt = _tracer
    if rt is None:
        return None
    cur = rt.current()
    return None if cur is None else format_traceparent(cur)


def dump(path: Optional[str] = None) -> Optional[str]:
    rt = _tracer
    return None if rt is None else rt.dump(path)


def snapshot() -> dict:
    """Ring occupancy, sampled fraction, slowest traces, last export
    path."""
    rt = _tracer
    if rt is None:
        return {"enabled": False}
    out = {"enabled": True}
    out.update(rt.stats())
    out["slowest_traces"] = rt.slowest()
    return out
