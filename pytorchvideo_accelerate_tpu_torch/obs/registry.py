"""Process-wide metric registry with Prometheus text exposition (the
port's copy of the JAX package's `obs/registry.py`, without histogram
exemplars).

The serving server's `/metrics` renders a `Registry` verbatim and `/stats`
reads the same counter objects, so the two surfaces cannot drift. Metric
names, help strings, labels and the rendered text are the JAX package's,
so one scraper configuration reads both servers. Stdlib only: the text
exposition format v0.0.4,

    # HELP name help text
    # TYPE name counter
    name{label="value"} 42
    hist_bucket{le="0.05"} 3 ... hist_sum 0.2 / hist_count 9

Thread safety: one lock per metric; the registry locks only creation and
lookup.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a trailing .0, floats via
    repr (full precision), special-cased non-finites."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help or name
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def header(self) -> str:
        return (f"# HELP {self.name} {self.help}\n"
                f"# TYPE {self.name} {self.kind}\n")

    def render(self) -> str:  # pragma: no cover - interface
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic counter, optionally labeled (e.g. rejected{cause="503"});
    `total()` is the cross-label aggregate `/stats` reads."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum over every label combination (the `/stats` aggregate view)."""
        with self._lock:
            return sum(self._values.values()) if self._values else 0.0

    def samples(self) -> Iterable[Tuple[Dict[str, str], float]]:
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            yield dict(zip(self.labelnames, key)), v

    def render(self) -> str:
        with self._lock:
            items = sorted(self._values.items())
        if not items:
            if self.labelnames:  # no label combination seen yet: header only
                return self.header()
            items = [((), 0.0)]  # unlabeled counters render an explicit 0
        lines = [self.header()]
        for key, v in items:
            lines.append(
                f"{self.name}{_label_str(self.labelnames, key)} {_fmt(v)}\n")
        return "".join(lines)


class Gauge(_Metric):
    """Point-in-time value, optionally labeled; `set_function` registers a
    live callback read at render/value time (queue depth, uptime)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._fns: Dict[Tuple[str, ...], Callable[[], float]] = {}

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def set_function(self, fn: Optional[Callable[[], float]],
                     **labels: str) -> None:
        """Register a live read callback; `None` deregisters it (owners of
        short-lived objects MUST clear their closure on close, or the
        registry pins them alive and scrapes stale values forever)."""
        key = self._key(labels)
        with self._lock:
            if fn is None:
                self._fns.pop(key, None)
            else:
                self._fns[key] = fn

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            fn = self._fns.get(key)
            if fn is None:
                return self._values.get(key, 0.0)
        try:  # callback runs OUTSIDE the lock: it may itself take locks
            return float(fn())
        except Exception:  # a dying callback must not break the scrape
            return float("nan")

    def samples(self) -> Iterable[Tuple[Dict[str, str], float]]:
        with self._lock:
            keys = sorted(set(self._values) | set(self._fns))
        for key in keys:
            labels = dict(zip(self.labelnames, key))
            yield labels, self.value(**labels)

    def render(self) -> str:
        with self._lock:
            keys = sorted(set(self._values) | set(self._fns))
        if not keys:
            if self.labelnames:  # no label combination seen yet
                return self.header()
            keys = [()]  # unlabeled gauges render an explicit 0
        lines = [self.header()]
        for key in keys:
            labels = dict(zip(self.labelnames, key))
            lines.append(f"{self.name}{_label_str(self.labelnames, key)} "
                         f"{_fmt(self.value(**labels))}\n")
        return "".join(lines)


DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

# Per-FAMILY bucket boundaries, keyed by metric-name prefix (longest match
# wins). One serving tier wants sub-ms latency buckets, a batch tier wants
# multi-second ones: a single hardcoded ladder fits neither. Families are
# registered at configure time (`set_family_buckets`), consulted only when
# a histogram is created WITHOUT explicit buckets; an existing histogram
# never reshapes (cumulative counts cannot be re-binned).
_FAMILY_BUCKETS: Dict[str, Tuple[float, ...]] = {}


def set_family_buckets(prefix: str, buckets: Sequence[float]) -> None:
    """Declare default bucket boundaries for every histogram whose name
    starts with `prefix` (configure-time; see ServeConfig.latency_buckets_ms
    for the serving wiring)."""
    bs = tuple(sorted(float(b) for b in buckets))
    if not bs:
        raise ValueError("a bucket family needs at least one finite bound")
    _FAMILY_BUCKETS[prefix] = bs


def family_buckets(name: str,
                   default: Sequence[float] = DEFAULT_BUCKETS) -> Tuple[float, ...]:
    """Resolve the bucket ladder for `name`: longest registered family
    prefix, else `default`."""
    best = ""
    for prefix in _FAMILY_BUCKETS:
        if name.startswith(prefix) and len(prefix) > len(best):
            best = prefix
    return _FAMILY_BUCKETS[best] if best else tuple(default)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus convention: each `le` bucket
    counts every observation <= its bound; `+Inf` == `_count`). Buckets
    resolve per family when not given explicitly (`family_buckets`)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help)
        if buckets is None:
            buckets = family_buckets(name)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one finite bucket")
        self._counts = [0] * (len(self.buckets) + 1)  # + the +Inf bucket
        self._sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if v <= b:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (Prometheus
        `histogram_quantile` semantics): find the bucket the q-th
        observation falls in, linearly interpolate inside it. NaN when
        empty; the top bucket clamps to its lower bound (the +Inf
        bucket has no upper edge to interpolate toward)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts)
        total = sum(counts)
        if total == 0:
            return float("nan")
        rank = q * total
        cum = 0
        for i, b in enumerate(self.buckets):
            prev = cum
            cum += counts[i]
            if cum >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                if counts[i] == 0:
                    return b
                return lo + (b - lo) * (rank - prev) / counts[i]
        return self.buckets[-1]

    def render(self) -> str:
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
        labels = [_fmt(b) for b in self.buckets] + ["+Inf"]
        lines = [self.header()]
        cum = 0
        for i, label in enumerate(labels):
            cum += counts[i]
            lines.append(f'{self.name}_bucket{{le="{label}"}} {cum}\n')
        lines.append(f"{self.name}_sum {_fmt(total_sum)}\n")
        lines.append(f"{self.name}_count {cum}\n")
        return "".join(lines)


class Registry:
    """Named metric store; `counter`/`gauge`/`histogram` are get-or-create
    (a re-request returns the SAME object, so every surface that reads a
    name reads the same numbers)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def scrape(self, prefix: str = "") -> Dict[str, float]:
        """Flat numeric snapshot of every metric whose name starts with
        `prefix`, the same numbers `/metrics` renders. Counters/gauges emit one entry per label
        combination, keyed Prometheus-style
        (``name{label="v"}``; unlabeled series key on the bare name);
        histograms emit ``name_sum`` and ``name_count``.  Callback gauges
        are evaluated live, outside the registry lock."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)
                       if n.startswith(prefix)]
        out: Dict[str, float] = {}
        for m in metrics:
            if isinstance(m, Histogram):
                out[f"{m.name}_sum"] = m.sum
                out[f"{m.name}_count"] = float(m.count)
            else:
                for labels, v in m.samples():
                    key = m.name + _label_str(
                        m.labelnames, tuple(labels[n] for n in m.labelnames))
                    out[key] = float(v)
        return out

    def render(self) -> str:
        """Prometheus text exposition v0.0.4 of every registered metric."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        return "".join(m.render() for m in metrics)


_DEFAULT = Registry()


def get_registry() -> Registry:
    """The process-default registry."""
    return _DEFAULT
