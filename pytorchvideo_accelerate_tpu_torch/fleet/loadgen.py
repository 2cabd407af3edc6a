"""Open-loop load harness and the `pva-torch-loadgen` CLI (the port's copy of
the JAX package's `fleet/loadgen.py`).

The honesty this module exists for: a CLOSED-loop client (submit, wait,
submit) measures the server at whatever rate the server allows — when the
server slows down, the client politely slows down with it, and the p99 you
report is fiction ("coordinated omission"). Production traffic does not
wait: arrivals keep coming at the offered rate while the queue grows. So
this harness is OPEN-loop by construction:

- arrivals are a seeded **Poisson process** at ``rate_rps`` (exponential
  inter-arrival gaps), scheduled against the wall clock — a submission is
  never delayed because an earlier request is still in flight;
- if the generator itself falls behind the schedule (a submit blocked, the
  host stalled), it says so: ``max_arrival_lag_ms`` reports how late the
  worst arrival fired and ``open_loop_ok`` is False past a tolerance —
  numbers from a degraded-to-closed-loop run must not read as open-loop;
- request sizes follow a **heavy-tailed clip mix**: mostly single-view
  clips with a tail of multi-view requests (the serving tier's free
  geometry axis), weights configurable — fleets die on their tail
  geometry, not their median.

Completion futures resolve off the arrival thread; the report classifies
every request exactly once: completed (latency percentiles computed over
these), **shed** (the 503 family — `QueueFullError`/`ShedError`, admission
or deadline sheds doing their job), or **failed** (everything else — the
number a healthy fleet keeps at zero). SLO verdicts (`slo_p99_ms`) are
asserted over completions.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from pytorchvideo_accelerate_tpu_torch.config import FleetConfig
from pytorchvideo_accelerate_tpu_torch.obs import trace
from pytorchvideo_accelerate_tpu_torch.serving.batcher import QueueFullError
from pytorchvideo_accelerate_tpu_torch.serving.stats import _percentile

# the heavy-tail view mix: (views, weight) — most requests are one clip,
# a tail re-runs the multi-view eval protocol per request
DEFAULT_VIEW_MIX = ((1, 0.85), (2, 0.12), (4, 0.03))

# arrivals later than this against their schedule mean the generator
# degraded toward closed-loop; the report flags it instead of hiding it
OPEN_LOOP_LAG_TOLERANCE_MS = 250.0


# --- piecewise traffic profiles (step / ramp / spike) -----------------------
#
# A profile is a sequence of segments, each (duration_s, rate) for a
# constant-rate step or (duration_s, rate_start, rate_end) for a linear
# ramp. Arrivals inside every segment are still a seeded Poisson process
# (ramps via thinning against the segment's max rate), so the open-loop
# honesty fields — max_arrival_lag_ms / open_loop_ok, measured against the
# composite schedule — mean exactly what they mean for a constant rate.
# This is what lets the autoscaler convergence proof drive a real traffic
# STEP instead of a constant offered rate.

def step_profile(*segments) -> List[tuple]:
    """Validate/normalize a piecewise profile: each segment is
    (duration_s, rate) or (duration_s, rate_start, rate_end)."""
    out = []
    for seg in segments:
        seg = tuple(float(x) for x in seg)
        if len(seg) == 2:
            seg = (seg[0], seg[1], seg[1])
        if len(seg) != 3:
            raise ValueError(f"profile segment {seg!r}: want "
                             "(duration_s, rate) or (duration_s, r0, r1)")
        if seg[0] <= 0 or seg[1] < 0 or seg[2] < 0:
            raise ValueError(f"profile segment {seg!r}: duration must be "
                             "positive and rates non-negative")
        out.append(seg)
    if not out:
        raise ValueError("profile needs at least one segment")
    return out


def ramp_profile(duration_s: float, start_rps: float,
                 end_rps: float) -> List[tuple]:
    """One linear ramp from start_rps to end_rps over duration_s."""
    return step_profile((duration_s, start_rps, end_rps))


def spike_profile(base_rps: float, spike_rps: float, *, duration_s: float,
                  spike_at_s: float, spike_s: float) -> List[tuple]:
    """Constant base rate with one rectangular spike riding on top."""
    if not 0.0 < spike_at_s < spike_at_s + spike_s < duration_s:
        raise ValueError("spike must fit strictly inside the run window")
    return step_profile(
        (spike_at_s, base_rps), (spike_s, spike_rps),
        (duration_s - spike_at_s - spike_s, base_rps))


def _segment_arrivals(rng: np.random.Generator, duration_s: float,
                      r0: float, r1: float) -> np.ndarray:
    """Seeded Poisson arrivals on [0, duration_s) at a rate moving
    linearly r0 -> r1 (constant when equal); ramps by thinning a
    homogeneous process at the segment's max rate."""
    rmax = max(r0, r1)
    if rmax <= 0 or duration_s <= 0:
        return np.empty(0, np.float64)
    draw = max(int(rmax * duration_s * 2), 16)
    t = np.cumsum(rng.exponential(1.0 / rmax, size=draw))
    while t.size and t[-1] < duration_s:  # extend until past the window
        t = np.concatenate(
            [t, t[-1] + np.cumsum(rng.exponential(1.0 / rmax, size=draw))])
    t = t[t < duration_s]
    if r0 != r1 and t.size:
        keep = rng.random(t.size) < (r0 + (r1 - r0) * t / duration_s) / rmax
        t = t[keep]
    return t


def piecewise_arrivals(rng: np.random.Generator,
                       profile: Sequence[tuple]) -> np.ndarray:
    """Concatenated arrival times for a normalized profile, sorted,
    offset per segment start."""
    chunks, t_off = [], 0.0
    for dur, r0, r1 in profile:
        chunks.append(_segment_arrivals(rng, dur, r0, r1) + t_off)
        t_off += dur
    return np.concatenate(chunks) if chunks else np.empty(0, np.float64)


def profile_duration_s(profile: Sequence[tuple]) -> float:
    return float(sum(seg[0] for seg in profile))


def profile_mean_rps(profile: Sequence[tuple]) -> float:
    total = profile_duration_s(profile)
    if total <= 0:
        return 0.0
    return float(sum(dur * (r0 + r1) / 2.0
                     for dur, r0, r1 in profile) / total)


def _classify_outcome(err) -> str:
    """One rule for both generators: completed / shed (the 503 family) /
    failed — every request classified exactly once."""
    if err is None:
        return "ok"
    if isinstance(err, QueueFullError):
        return "shed"
    return "failed"


def _await_stragglers(gen, offered: int) -> list:
    """Shared grace-wait: the open loop ends at the schedule; stragglers
    get a bounded grace, then whatever never resolved counts as lost
    (-> failed) in the caller's accounting. `gen` carries `_lock`,
    `_done`, and `grace_s` (both generator classes)."""
    deadline = time.monotonic() + gen.grace_s
    while time.monotonic() < deadline:
        with gen._lock:
            if len(gen._done) >= offered:
                break
        time.sleep(0.01)
    with gen._lock:
        return list(gen._done)


def heavy_tail_clip_factory(base_clip: Dict[str, np.ndarray],
                            view_mix: Sequence = DEFAULT_VIEW_MIX
                            ) -> Callable:
    """Clip factory over one base geometry: returns `factory(rng) -> clip`
    drawing a view count from the heavy-tailed mix (views=1 keeps the bare
    rank-4 clip; V>1 stacks the clip into a (V, T, H, W, C) request)."""
    views = np.asarray([v for v, _ in view_mix], np.int64)
    weights = np.asarray([w for _, w in view_mix], np.float64)
    weights = weights / weights.sum()

    def factory(rng: np.random.Generator) -> Dict[str, np.ndarray]:
        v = int(rng.choice(views, p=weights))
        if v <= 1:
            return dict(base_clip)
        return {k: np.stack([arr] * v) for k, arr in base_clip.items()}

    return factory


class LoadGen:
    """One open-loop run against any `submit(clip, **kw) -> Future` front
    (a `Scheduler`, a `Router`, an `HttpReplica`)."""

    def __init__(self, submit, *, rate_rps: float = 0.0,
                 duration_s: float = 0.0,
                 clip_factory: Callable, seed: int = 0,
                 priority: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 profile: Optional[Sequence[tuple]] = None,
                 grace_s: float = 15.0):
        # a piecewise profile REPLACES the constant (rate_rps, duration_s)
        # pair; rate/duration then derive from the profile for reporting
        self.profile = step_profile(*profile) if profile is not None else None
        if self.profile is not None:
            rate_rps = profile_mean_rps(self.profile)
            duration_s = profile_duration_s(self.profile)
        if rate_rps <= 0 or duration_s <= 0:
            raise ValueError("rate_rps and duration_s must be positive")
        self.submit = submit
        self.rate_rps = float(rate_rps)
        self.duration_s = float(duration_s)
        self.clip_factory = clip_factory
        self.seed = int(seed)
        self.priority = priority
        self.deadline_ms = deadline_ms
        self.grace_s = float(grace_s)
        self._lock = threading.Lock()
        # (outcome, latency_s) per finished request; outcomes:
        # "ok" | "shed" | "failed"
        self._done: List = []

    def _record(self, outcome: str, latency_s: float) -> None:
        with self._lock:
            self._done.append((outcome, latency_s))

    def _on_done(self, t_submit: float, future, handle=None) -> None:
        latency = time.monotonic() - t_submit
        try:
            err = future.exception()
        except Exception as e:  # cancelled
            err = e
        outcome = _classify_outcome(err)
        self._record(outcome, latency)
        if handle is not None:
            # close the request's root trace span with its verdict — the
            # client-side end of the merged timeline
            handle.finish(outcome=outcome)

    def run(self) -> Dict[str, float]:
        """Blocking: generate the arrival schedule, fire it, wait out the
        stragglers (bounded by `grace_s`), return the report dict."""
        rng = np.random.default_rng(self.seed)
        if self.profile is not None:
            arrivals = piecewise_arrivals(rng, self.profile)
        else:
            gaps = rng.exponential(1.0 / self.rate_rps,
                                   size=max(int(self.rate_rps
                                                * self.duration_s * 2), 16))
            arrivals = np.cumsum(gaps)
            arrivals = arrivals[arrivals < self.duration_s]
        kwargs: dict = {}
        if self.priority is not None:
            kwargs["priority"] = self.priority
        if self.deadline_ms is not None:
            kwargs["deadline_ms"] = self.deadline_ms
        offered = 0
        max_lag = 0.0
        # distributed tracing: each arrival is a trace HEAD — the sampled
        # ones get a root span finished with the request's outcome when
        # its future resolves (disarmed: one global read before the loop)
        tracer = trace.get_tracer()
        t0 = time.monotonic()
        for t_arr in arrivals:
            now = time.monotonic() - t0
            if now < t_arr:
                time.sleep(t_arr - now)
            lag = (time.monotonic() - t0) - t_arr
            max_lag = max(max_lag, lag)
            clip = self.clip_factory(rng)
            offered += 1
            handle = (tracer.start("request", seq=offered)
                      if tracer is not None else None)
            t_submit = time.monotonic()
            try:
                with trace.attach(handle.ctx if handle is not None
                                  else None):
                    fut = self.submit(clip, **kwargs)
            except QueueFullError:
                self._record("shed", 0.0)
                if handle is not None:
                    handle.finish(outcome="shed")
                continue
            except Exception:  # noqa: BLE001 - a dead front is a failure
                self._record("failed", 0.0)
                if handle is not None:
                    handle.finish(outcome="failed")
                continue
            fut.add_done_callback(
                lambda f, t=t_submit, h=handle: self._on_done(t, f, h))
        wall = time.monotonic() - t0
        done = _await_stragglers(self, offered)
        lat_ok = sorted(lat for oc, lat in done if oc == "ok")
        completed = len(lat_ok)
        shed = sum(1 for oc, _ in done if oc == "shed")
        failed = sum(1 for oc, _ in done if oc == "failed")
        lost = offered - len(done)  # never resolved within grace
        report = {
            "offered": float(offered),
            "offered_rps": round(offered / wall, 3) if wall > 0 else 0.0,
            "completed": float(completed),
            "achieved_rps": round(completed / wall, 3) if wall > 0 else 0.0,
            "shed": float(shed),
            "failed": float(failed + lost),
            "shed_frac": round(shed / offered, 4) if offered else 0.0,
            "p50_ms": round(_percentile(lat_ok, 50) * 1e3, 3),
            "p95_ms": round(_percentile(lat_ok, 95) * 1e3, 3),
            "p99_ms": round(_percentile(lat_ok, 99) * 1e3, 3),
            "max_arrival_lag_ms": round(max_lag * 1e3, 3),
            "open_loop_ok": bool(max_lag * 1e3
                                 <= OPEN_LOOP_LAG_TOLERANCE_MS),
            "duration_s": round(wall, 3),
        }
        return report


def assert_slo(report: Dict[str, float], *, slo_p99_ms: float,
               max_shed_frac: float = 1.0) -> List[str]:
    """SLO verdicts as a list of violations (empty = pass): p99 under the
    SLO, zero non-shed failures, the run genuinely open-loop, and (when
    bounded) the shed fraction under its budget."""
    violations = []
    if report["completed"] <= 0:
        violations.append("no requests completed")
    if report["p99_ms"] > slo_p99_ms:
        violations.append(
            f"p99 {report['p99_ms']} ms > SLO {slo_p99_ms} ms")
    if report["failed"] > 0:
        violations.append(f"{int(report['failed'])} non-shed failures")
    if not report["open_loop_ok"]:
        violations.append(
            f"arrival schedule slipped {report['max_arrival_lag_ms']} ms "
            "(degraded toward closed-loop; numbers untrustworthy)")
    if report["shed_frac"] > max_shed_frac:
        violations.append(
            f"shed_frac {report['shed_frac']} > budget {max_shed_frac}")
    return violations


class StreamLoadGen:
    """Open-loop STREAM arrivals (streaming/engine.py): streams —
    not independent requests — arrive as a seeded Poisson process at
    ``stream_rate_sps``; each stream lives for a HEAVY-TAILED number of
    advances (bounded Pareto — fleets die on the long-running tail
    streams that pin session slots, not on the median), and emits one
    label per ``advance_interval_s``.

    Honesty rules, inherited from `LoadGen` and tightened for labels:

    - the whole (stream x advance) event schedule is precomputed and
      fired against the wall clock — an advance is never delayed because
      an earlier one is in flight, and ``max_arrival_lag_ms`` /
      ``open_loop_ok`` flag a generator that degraded toward closed-loop;
    - **per-session label-latency honesty**: a label's latency is
      measured from its SCHEDULED advance time, not from whenever the
      generator got around to submitting it — a backed-up session cannot
      hide queueing delay the way a submit-anchored clock would
      (coordinated omission, applied per session);
    - every advance is classified exactly once: completed / shed
      (`QueueFullError` family) / failed.

    Each stream's first advance carries the establish window + stride;
    subsequent advances ship only the ``stride`` new frames, with the
    client-maintained resendable window attached when ``attach_window``
    (the re-establish-anywhere contract replica death recovery needs);
    the last advance carries ``end=True``."""

    def __init__(self, submit, *, stream_rate_sps: float = 0.0,
                 duration_s: float = 0.0,
                 window: int, stride: int, frame_shape: tuple,
                 advance_interval_s: float, seed: int = 0,
                 mean_advances: float = 8.0, max_advances: int = 64,
                 attach_window: bool = True, dtype: str = "float32",
                 priority: Optional[str] = None,
                 profile: Optional[Sequence[tuple]] = None,
                 grace_s: float = 15.0):
        # piecewise profile over STREAM arrivals (advances still pace at
        # advance_interval_s per stream) — same semantics as LoadGen
        self.profile = step_profile(*profile) if profile is not None else None
        if self.profile is not None:
            stream_rate_sps = profile_mean_rps(self.profile)
            duration_s = profile_duration_s(self.profile)
        if stream_rate_sps <= 0 or duration_s <= 0:
            raise ValueError("stream_rate_sps and duration_s must be "
                             "positive")
        if window % stride:
            raise ValueError("stride must divide the window")
        self.submit = submit
        self.stream_rate_sps = float(stream_rate_sps)
        self.duration_s = float(duration_s)
        self.window = int(window)
        self.stride = int(stride)
        self.frame_shape = tuple(frame_shape)  # (H, W, C)
        self.advance_interval_s = float(advance_interval_s)
        self.seed = int(seed)
        self.mean_advances = float(mean_advances)
        self.max_advances = int(max_advances)
        self.attach_window = bool(attach_window)
        self.dtype = dtype
        self.priority = priority
        self.grace_s = float(grace_s)
        self._lock = threading.Lock()
        self._done: List = []  # (outcome, label_latency_s)

    def _schedule(self, rng) -> List[tuple]:
        """-> [(t, stream_idx, k, n_stream)] sorted by time: Poisson
        stream arrivals x heavy-tail per-stream advance counts."""
        if self.profile is not None:
            arrivals = piecewise_arrivals(rng, self.profile)
        else:
            gaps = rng.exponential(
                1.0 / self.stream_rate_sps,
                size=max(int(self.stream_rate_sps * self.duration_s * 2), 8))
            arrivals = np.cumsum(gaps)
            arrivals = arrivals[arrivals < self.duration_s]
        events = []
        for i, t_arr in enumerate(arrivals):
            # bounded Pareto (alpha 1.5): mostly short streams, a heavy
            # tail of long ones; +1 so every stream emits >= 1 label
            n = int(min(1 + rng.pareto(1.5) * self.mean_advances / 3.0,
                        self.max_advances))
            for k in range(n):
                events.append((t_arr + k * self.advance_interval_s, i, k, n))
        events.sort()
        return events

    def _record(self, outcome: str, latency_s: float) -> None:
        with self._lock:
            self._done.append((outcome, latency_s))

    def _on_done(self, t_sched: float, t0: float, future) -> None:
        # label latency anchored to the SCHEDULED time (see class docs)
        latency = time.monotonic() - (t0 + t_sched)
        try:
            err = future.exception()
        except Exception as e:  # cancelled
            err = e
        self._record(_classify_outcome(err), latency)

    def run(self) -> Dict[str, float]:
        rng = np.random.default_rng(self.seed)
        events = self._schedule(rng)
        windows: Dict[int, np.ndarray] = {}
        shape = (self.window,) + self.frame_shape
        offered = 0
        max_lag = 0.0
        t0 = time.monotonic()
        for t_evt, i, k, n in events:
            now = time.monotonic() - t0
            if now < t_evt:
                time.sleep(t_evt - now)
            max_lag = max(max_lag, (time.monotonic() - t0) - t_evt)
            if k == 0:
                windows[i] = rng.standard_normal(shape).astype(self.dtype)
            frames = rng.standard_normal(
                (self.stride,) + self.frame_shape).astype(self.dtype)
            windows[i] = np.concatenate([windows[i][self.stride:], frames],
                                        axis=0)
            session: dict = {"sid": f"lg-{self.seed}-{i}",
                             "stride": self.stride,
                             "end": k == n - 1}
            if k == 0 or self.attach_window:
                session["window"] = windows[i]
            kwargs: dict = {"session": session}
            if self.priority is not None:
                kwargs["priority"] = self.priority
            offered += 1
            try:
                fut = self.submit({"video": frames}, **kwargs)
            except QueueFullError:
                self._record("shed", 0.0)
                continue
            except Exception:  # noqa: BLE001 - a dead front is a failure
                self._record("failed", 0.0)
                continue
            fut.add_done_callback(
                lambda f, t=t_evt: self._on_done(t, t0, f))
            if k == n - 1:
                windows.pop(i, None)
        wall = time.monotonic() - t0
        done = _await_stragglers(self, offered)
        lat_ok = sorted(lat for oc, lat in done if oc == "ok")
        completed = len(lat_ok)
        shed = sum(1 for oc, _ in done if oc == "shed")
        failed = sum(1 for oc, _ in done if oc == "failed")
        lost = offered - len(done)
        n_streams = len({i for _, i, _, _ in events})
        return {
            "streams": float(n_streams),
            "advances_offered": float(offered),
            "completed": float(completed),
            "achieved_lps": round(completed / wall, 3) if wall > 0 else 0.0,
            "shed": float(shed),
            "failed": float(failed + lost),
            "shed_frac": round(shed / offered, 4) if offered else 0.0,
            "label_p50_ms": round(_percentile(lat_ok, 50) * 1e3, 3),
            "label_p99_ms": round(_percentile(lat_ok, 99) * 1e3, 3),
            "max_arrival_lag_ms": round(max_lag * 1e3, 3),
            "open_loop_ok": bool(max_lag * 1e3
                                 <= OPEN_LOOP_LAG_TOLERANCE_MS),
            "duration_s": round(wall, 3),
        }


def _http_clip_factory(url: str) -> Callable:
    """Build the clip factory from a live server's /healthz clip spec."""
    import urllib.request

    with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                timeout=10) as r:
        health = json.loads(r.read())
    spec = health.get("clip_spec")
    if not spec:
        raise SystemExit(
            "server reports no clip_spec on /healthz; pass explicit "
            "--frames/--crop geometry")
    dtype = health.get("input_dtype", "float32")
    base = {k: np.zeros(tuple(shape), dtype) for k, shape in spec.items()}
    return heavy_tail_clip_factory(base)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """`pva-torch-loadgen --url http://host:port --rps 100 --duration 10`.

    Drives a serving endpoint (single replica or a fleet router front)
    with the open-loop harness and prints ONE JSON report line; exit 0
    iff the SLO held (p99 under --slo_p99_ms, zero non-shed failures,
    schedule kept)."""
    ap = argparse.ArgumentParser(
        prog="pva-torch-loadgen",
        description="open-loop (Poisson) load harness for the serving "
                    "tier (fleet/loadgen.py)")
    ap.add_argument("--url", default="",
                    help="endpoint base URL (e.g. http://127.0.0.1:8100)")
    # the harness defaults are the fleet.* config block's
    fleet_defaults = FleetConfig()
    ap.add_argument("--rps", type=float, default=fleet_defaults.loadgen_rps,
                    help="offered arrival rate (Poisson)")
    ap.add_argument("--duration", type=float,
                    default=fleet_defaults.loadgen_duration_s,
                    help="arrival window seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--priority", choices=("realtime", "batch"),
                    default=None,
                    help="priority class (schedulers that support it)")
    ap.add_argument("--deadline_ms", type=float, default=None)
    ap.add_argument("--slo_p99_ms", type=float, default=1000.0)
    ap.add_argument("--max_shed_frac", type=float, default=1.0)
    ap.add_argument("--selftest", action="store_true",
                    help="drive an in-process stub fleet instead of --url "
                         "(harness plumbing check, no model)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0

    if args.selftest:
        report = _selftest(args)
    else:
        if not args.url:
            print("pva-torch-loadgen: --url required (or --selftest)",
                  file=sys.stderr)
            return 2
        from pytorchvideo_accelerate_tpu_torch.fleet.pool import HttpReplica

        # worker pool sized for the OFFERED concurrency (Little's law at
        # the SLO latency, with headroom): the default 8 workers would
        # silently cap in-flight requests and degrade the harness to
        # closed-loop-of-8 without ever tripping the arrival-lag check
        workers = max(16, min(int(args.rps * max(args.slo_p99_ms, 1000.0)
                                  / 1e3 * 2), 256))
        replica = HttpReplica("target", args.url, workers=workers)
        gen = LoadGen(replica.submit, rate_rps=args.rps,
                      duration_s=args.duration,
                      clip_factory=_http_clip_factory(args.url),
                      seed=args.seed, priority=args.priority,
                      deadline_ms=args.deadline_ms)
        report = gen.run()
        replica.close()
    violations = assert_slo(report, slo_p99_ms=args.slo_p99_ms,
                            max_shed_frac=args.max_shed_frac)
    report["slo_ok"] = not violations
    for v in violations:
        print(f"SLO VIOLATION: {v}", file=sys.stderr)
    print(json.dumps(report))
    return 0 if not violations else 1


def _selftest(args) -> Dict[str, float]:
    """In-process harness check: 2 stub replicas behind a router."""
    from pytorchvideo_accelerate_tpu_torch.fleet.pool import (
        LocalReplica,
        ReplicaPool,
    )
    from pytorchvideo_accelerate_tpu_torch.fleet.router import Router
    from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
    from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats
    from pytorchvideo_accelerate_tpu_torch.serving.stub import StubEngine

    replicas = []
    for i in range(2):
        stats = ServingStats(window=512)
        sched = Scheduler(StubEngine(forward_s=0.002), stats=stats,
                          max_queue=256)
        replicas.append(LocalReplica(f"selftest-{i}", sched))
    pool = ReplicaPool(replicas, health_interval_s=0.2)
    router = Router(pool)
    base = {"video": np.zeros((2, 4, 4, 3), np.float32)}
    try:
        gen = LoadGen(router.submit, rate_rps=args.rps,
                      duration_s=min(args.duration, 5.0),
                      clip_factory=heavy_tail_clip_factory(base),
                      seed=args.seed, priority=args.priority,
                      deadline_ms=args.deadline_ms)
        return gen.run()
    finally:
        router.close()


if __name__ == "__main__":
    sys.exit(main())
