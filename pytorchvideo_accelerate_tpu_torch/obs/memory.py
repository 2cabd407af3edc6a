"""Device-memory ledger: per-component byte accounting of the card's
memory (the port's copy of the JAX package's `obs/memory.py`).

The allocation sites (the trainer's state: parameters, BN running
averages, optimizer state, EMA; the device prefetch ring; the serving
engine's resident weights) register their actual tensor bytes here, and the
ledger cross-checks the attributed sum live against the CUDA caching
allocator (`torch.cuda.memory_stats`: `allocated_bytes.all.current` is the
JAX backend's `bytes_in_use`, `allocated_bytes.all.peak` its
`peak_bytes_in_use`; the card's total memory is `bytes_limit`). On the CPU
there is no such reading and the ledger never fakes one: `source` stays
"estimate".

`unattributed_bytes = bytes_in_use - sum(components)` is published
explicitly, so a growing residual is a visible accounting gap, not a hidden
leak. A failed reading on the card raises: the ledger never turns a fault
into an "estimate".

Exported surface, the JAX package's names and help strings:

- gauges `pva_hbm_bytes{component=}` (and the explicit ``unattributed``
  component), `pva_hbm_bytes_in_use`, `pva_hbm_peak_bytes`,
  `pva_hbm_attributed_frac`, `pva_hbm_drift_frac{component=}`;
- a watermark warning into the flight ring when `bytes_in_use` crosses
  `WATERMARK_FRAC` of `bytes_limit` (edge-triggered);
- `source()`, "measured" or "estimate", and `measured_bytes(component)`
  for admission paths (`ModelBudget`): ledger bytes on the card, None on
  the CPU, where the caller falls back to its declared figure.

Declared estimates: an allocation site may pass the figure it would have
used before the ledger existed (`register(..., declared=)`, as the
streaming engine does for its ring pools); `drift()` and the gauge
`pva_hbm_drift_frac{component=}` then publish |measured - declared| /
declared, so an estimate that lies is a metric.

Arming: the module-level `register()` / `release()` hooks at the
allocation sites are one module-global read and a `None` check while
disarmed. `configure()` arms the process-default ledger; tests construct
private instances. Stdlib only at import time (torch is imported where a
reading or a byte count needs it).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from pytorchvideo_accelerate_tpu_torch.utils.sync import make_lock, shared_state

# The armed process-default ledger or None: the disarmed hot path at every
# allocation site is one load and a None check.
_DEFAULT: Optional["MemoryLedger"] = None

# the fraction of `bytes_limit` past which `bytes_in_use` warns
WATERMARK_FRAC = 0.92


def default_device_stats(device=None) -> Optional[Dict[str, int]]:
    """The caching allocator's reading of `device` (a CUDA device; None:
    the current card) in the JAX backend's keys, or None off the card: a
    CPU device, or no CUDA."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device)
                               .total_memory)}


def tree_nbytes(tree) -> int:
    """Total bytes over the tensors (and arrays) of `tree`: dicts, lists,
    tuples, a module (its parameters and buffers) or a TrainState (its
    model, its optimizer's per-param state and its EMA copy)."""
    return sum(_nbytes(leaf) for leaf in _walk_leaves(tree))


def _nbytes(leaf) -> int:
    numel = getattr(leaf, "numel", None)
    if callable(numel) and hasattr(leaf, "element_size"):
        return int(numel()) * int(leaf.element_size())
    return int(getattr(leaf, "nbytes", 0))


def _walk_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk_leaves(v)
    elif hasattr(tree, "parameters") and hasattr(tree, "buffers"):  # a module
        yield from tree.parameters()
        yield from tree.buffers()
    elif hasattr(tree, "model") and hasattr(tree, "optimizer"):  # TrainState
        yield from _walk_leaves(tree.model)
        yield from _walk_leaves(list(tree.optimizer.opt.state.values()))
        yield from _walk_leaves(tree.ema or {})
    else:
        yield tree


@shared_state("_bytes", "_declared", "_peak_attributed", "_over_watermark")
class MemoryLedger:
    """Per-component device-byte accounting with a live backend
    cross-check. Thread-safe: allocation sites (the prefetch worker, the
    serving engine) race scrape ticks. `device` is the card whose
    allocator `default_device_stats` reads (None: the current one)."""

    def __init__(self, registry=None, recorder=None, *,
                 drift_tol: float = 0.25,
                 stats_fn: Optional[Callable[[], Optional[Dict[str, int]]]]
                 = None, device=None):
        from pytorchvideo_accelerate_tpu_torch.obs.registry import get_registry

        self._lock = make_lock("obs.MemoryLedger._lock")
        self._bytes: Dict[str, int] = {}
        self._declared: Dict[str, int] = {}
        self._peak_attributed = 0
        self._over_watermark = False  # edge trigger for the watermark warn
        self.drift_tol = float(drift_tol)
        self.registry = registry if registry is not None else get_registry()
        self.recorder = recorder
        self._stats_fn = stats_fn if stats_fn is not None \
            else (lambda: default_device_stats(device))
        self._g_bytes = self.registry.gauge(
            "pva_hbm_bytes", "attributed device bytes per component "
            "(component=unattributed is the residual vs bytes_in_use)",
            labelnames=("component",))
        self._g_drift = self.registry.gauge(
            "pva_hbm_drift_frac", "relative declared-vs-measured drift "
            "per component (0 when the estimate is honest)",
            labelnames=("component",))
        self._g_in_use = self.registry.gauge(
            "pva_hbm_bytes_in_use", "backend bytes_in_use (0 = backend "
            "exposes no memory_stats; see pva_hbm_attributed_frac)")
        self._g_peak = self.registry.gauge(
            "pva_hbm_peak_bytes", "backend peak_bytes_in_use, or the peak "
            "attributed sum when the backend exposes no memory_stats")
        self._g_frac = self.registry.gauge(
            "pva_hbm_attributed_frac",
            "attributed / bytes_in_use (1.0 when no backend stats: the "
            "ledger is then the only accounting there is)")
        # live reads: the scrape sees current stats without a tick cycle
        self._g_in_use.set_function(lambda: (self.device_stats() or {})
                                    .get("bytes_in_use", 0))
        self._g_peak.set_function(lambda: self.peak_bytes())
        self._g_frac.set_function(lambda: self.attributed_frac())
        self._g_bytes.set_function(lambda: self.unattributed_bytes(),
                                   component="unattributed")

    # --- accounting ---------------------------------------------------------

    def register(self, component: str, nbytes: int,
                 declared: Optional[int] = None) -> None:
        """Add `nbytes` of live device allocation to `component`;
        `declared` is the estimate the caller would have used without the
        ledger (it drives the drift gauge)."""
        n = int(nbytes)
        with self._lock:
            self._bytes[component] = self._bytes.get(component, 0) + n
            if declared is not None:
                self._declared[component] = (
                    self._declared.get(component, 0) + int(declared))
            total = sum(self._bytes.values())
            if total > self._peak_attributed:
                self._peak_attributed = total
            cur = self._bytes[component]
            dec = self._declared.get(component)
        self._g_bytes.set(cur, component=component)
        if dec:
            self._g_drift.set(abs(cur - dec) / dec, component=component)
        self._check_watermark()

    def release(self, component: str, nbytes: Optional[int] = None,
                declared: Optional[int] = None) -> None:
        """Return bytes to the pool; `nbytes=None` clears the component.
        Clamped at zero — a double release is an accounting bug, not a
        negative gauge."""
        with self._lock:
            if nbytes is None:
                self._bytes.pop(component, None)
                self._declared.pop(component, None)
                cur, dec = 0, None
            else:
                cur = max(0, self._bytes.get(component, 0) - int(nbytes))
                self._bytes[component] = cur
                if declared is not None:
                    dec = max(0, self._declared.get(component, 0)
                              - int(declared))
                    self._declared[component] = dec
                else:
                    dec = self._declared.get(component)
        self._g_bytes.set(cur, component=component)
        if dec:
            self._g_drift.set(abs(cur - dec) / dec, component=component)

    def component_bytes(self, component: str) -> int:
        with self._lock:
            return self._bytes.get(component, 0)

    def attributed_bytes(self) -> int:
        with self._lock:
            return sum(self._bytes.values())

    # --- backend cross-check ------------------------------------------------

    def device_stats(self) -> Optional[Dict[str, int]]:
        """The backend reading, None off the card; a failed reading on
        the card raises."""
        return self._stats_fn()

    def source(self) -> str:
        """"measured" when the backend exposes memory_stats, else
        "estimate": the label every figure of ledger bytes carries (never
        fake device bytes on a CPU host)."""
        return "measured" if self.device_stats() is not None else "estimate"

    def measured_bytes(self, component: str) -> Optional[int]:
        """Ledger bytes of `component` where this host reads the card;
        None on the CPU (admission then falls back to the caller's
        declared figure)."""
        if self.device_stats() is None:
            return None
        return self.component_bytes(component)

    def peak_bytes(self) -> int:
        stats = self.device_stats()
        if stats is not None and "peak_bytes_in_use" in stats:
            return stats["peak_bytes_in_use"]
        with self._lock:
            return self._peak_attributed

    def unattributed_bytes(self) -> int:
        stats = self.device_stats()
        if stats is None:
            return 0
        return max(0, stats.get("bytes_in_use", 0) - self.attributed_bytes())

    def attributed_frac(self) -> float:
        stats = self.device_stats()
        if stats is None or not stats.get("bytes_in_use"):
            return 1.0
        return min(1.0, self.attributed_bytes() / stats["bytes_in_use"])

    def _check_watermark(self) -> None:
        stats = self.device_stats()
        limit = (stats or {}).get("bytes_limit")
        if not limit:
            return
        over = stats.get("bytes_in_use", 0) >= WATERMARK_FRAC * limit
        with self._lock:
            fire = over and not self._over_watermark
            self._over_watermark = over
        if fire and self.recorder is not None:
            self.recorder.warn(
                "hbm watermark crossed",
                bytes_in_use=stats.get("bytes_in_use", 0),
                bytes_limit=limit, watermark_frac=WATERMARK_FRAC)

    # --- snapshots ----------------------------------------------------------

    def drift(self) -> Dict[str, float]:
        """component -> |measured - declared| / declared, for components
        that declared an estimate."""
        with self._lock:
            return {c: abs(self._bytes.get(c, 0) - d) / d
                    for c, d in self._declared.items() if d}

    def snapshot(self) -> Dict:
        """Per-component bytes, the residual, the drift offenders and the
        provenance label."""
        stats = self.device_stats()
        with self._lock:
            components = dict(self._bytes)
            peak_att = self._peak_attributed
        drift = self.drift()
        out = {
            "source": "measured" if stats is not None else "estimate",
            "components": components,
            "attributed_bytes": sum(components.values()),
            "unattributed_bytes": self.unattributed_bytes(),
            "attributed_frac": self.attributed_frac(),
            "peak_bytes": (stats or {}).get("peak_bytes_in_use", peak_att),
            "drift": drift,
            "drift_over_tol": sorted(c for c, d in drift.items()
                                     if d > self.drift_tol),
        }
        if stats is not None:
            out["bytes_in_use"] = stats.get("bytes_in_use", 0)
            if "bytes_limit" in stats:
                out["bytes_limit"] = stats["bytes_limit"]
        return out


# --- module-level arming ----------------------------------------------------

def get_ledger() -> Optional[MemoryLedger]:
    return _DEFAULT


def configure(enabled: bool = True, **kwargs) -> Optional[MemoryLedger]:
    """Arm (or disarm, with enabled=False) the process-default ledger.
    kwargs pass through to `MemoryLedger` (`device`, `registry`,
    `recorder`; tests inject `stats_fn`)."""
    global _DEFAULT
    _DEFAULT = MemoryLedger(**kwargs) if enabled else None
    return _DEFAULT


def register(component: str, nbytes: int,
             declared: Optional[int] = None) -> None:
    """Allocation-site hook; disarmed this is one global read and return."""
    led = _DEFAULT
    if led is None:
        return
    led.register(component, nbytes, declared=declared)


def release(component: str, nbytes: Optional[int] = None,
            declared: Optional[int] = None) -> None:
    led = _DEFAULT
    if led is None:
        return
    led.release(component, nbytes, declared=declared)
