"""Multi-model serving on one pool under a shared device budget (the
port's copy of the JAX package's `fleet/control/multimodel.py`).

One fleet, several model families (say `x3d_s` and `videomae_t`): each replica declares the family it serves (`replica.model`), the
router narrows candidates per request (`submit(..., model=)`) and labels
traffic per family (`pva_fleet_model_*{pool=,model=}`), and THIS module
adds the two things routing alone cannot give:

- **a shared budget** (`ModelBudget`): the device-memory footprint is
  a per-chip resource the families compete for. Each family registers
  its declared footprint; when the sum crosses the budget, the
  LOWEST-PRIORITY over-budget family — registration order is priority
  order, latest-registered evicts first — is marked over-budget and its
  NEW work is shed at the fleet door (503 + Retry-After, labeled
  `pva_fleet_budget_shed_total{model=}`). The POOL never degrades: the
  in-budget families keep serving untouched, which is the whole point —
  budget pressure from model B must read as "B sheds", never "everyone's
  p99 doubles".
- **per-family observability** (`MultiModelFleet.model_snapshot`):
  the per-model `fleet_snapshot` slice plus the family's declared
  footprint/ladder, and `snapshot_labels`-style flattening for trackers.

Per-model bucket ladders: each family registers its own latency bucket
boundaries (`latency_buckets_ms`) — `stats_for()` mints a `ServingStats`
carrying that ladder for the family's replicas, so a sub-second x3d tier
and a multi-second videomae tier each get histogram resolution where
their traffic actually lands (the `set_family_buckets` lesson,
obs/registry.py, applied per model family).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence

from pytorchvideo_accelerate_tpu_torch import obs
from pytorchvideo_accelerate_tpu_torch.obs import memory as obs_memory
from pytorchvideo_accelerate_tpu_torch.serving.batcher import QueueFullError
from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats

logger = logging.getLogger("pva_tpu_torch")


class ModelBudget:
    """Shared device-memory budget across model families (MB).

    On the card, where the ledger reads the caching allocator, each
    family's footprint is the MEASURED MemoryLedger bytes of its
    ``model_weights:<model>`` (and ``engine_compiled:<model>``, which the
    port's engines do not register: their kernels hold no per-bucket
    executables) components; the declared `footprint_mb` then only sets
    the priority slot and is the CPU/test fallback. A family that under-declares
    cannot lie its way under the budget where the ledger can see it.
    """

    # ledger components that make up one family's device footprint
    _COMPONENTS = ("model_weights:{m}", "engine_compiled:{m}")

    def __init__(self, budget_mb: float):
        self.budget_mb = float(budget_mb)
        self._lock = threading.Lock()
        self._footprints: Dict[str, float] = {}  # insertion order = priority

    def register(self, model: str, footprint_mb: float) -> None:
        """Declare (or update) a family's footprint; re-registration keeps
        the original priority slot."""
        with self._lock:
            self._footprints[str(model)] = float(footprint_mb)

    def release(self, model: str) -> None:
        with self._lock:
            self._footprints.pop(str(model), None)

    def footprint_mb(self, model: str) -> float:
        """One family's effective footprint: measured ledger bytes where
        the device exposes them, the declared estimate elsewhere."""
        with self._lock:
            declared = self._footprints.get(str(model), 0.0)
        led = obs_memory.get_ledger()
        if led is not None:
            measured = [led.measured_bytes(c.format(m=model))
                        for c in self._COMPONENTS]
            # nonzero: a zero-byte "measurement" means the family never
            # registered an engine here — that's the declared fallback,
            # not a free admission
            if any(measured):
                return sum(b or 0 for b in measured) / 1e6
        return declared

    def footprint_source(self, model: str) -> str:
        """"measured" when `footprint_mb` reads the ledger, "declared"
        otherwise (CPU hosts / disarmed ledger / unregistered family)."""
        led = obs_memory.get_ledger()
        if led is not None and any(
                led.measured_bytes(c.format(m=model))
                for c in self._COMPONENTS):
            return "measured"
        return "declared"

    def usage_mb(self) -> float:
        with self._lock:
            models = list(self._footprints)
        return sum(self.footprint_mb(m) for m in models)

    def over_budget(self) -> List[str]:
        """Families whose admission must shed, lowest priority first.
        Walking registration order, the first families that FIT keep
        serving; everything past the point the budget is exhausted sheds.
        The earliest-registered family always fits (a budget smaller than
        every family would otherwise shed the whole pool — the exact
        failure mode this module exists to prevent)."""
        with self._lock:
            models = list(self._footprints)
        used = 0.0
        shed: List[str] = []
        for i, model in enumerate(models):
            used += self.footprint_mb(model)
            if i > 0 and used > self.budget_mb:
                shed.append(model)
        return shed


class MultiModelFleet:
    """Budget-aware per-family front over a `Router`.

    Speaks the router's `submit` surface with a REQUIRED model key; the
    over-budget check runs before dispatch, so a shed family's request
    never consumes router retries or replica queue slots."""

    def __init__(self, router, budget: ModelBudget,
                 retry_after_s: float = 1.0):
        self.router = router
        self.budget = budget
        self.retry_after_s = float(retry_after_s)
        self._ladders: Dict[str, Optional[tuple]] = {}
        self._c_budget_shed = router.registry.counter(
            "pva_fleet_budget_shed_total",
            "requests shed because the model family is over the shared "
            "compiled-cache/HBM budget, by pool and model",
            labelnames=("pool", "model"))

    def register_model(self, model: str, footprint_mb: float,
                       latency_buckets_ms: Optional[Sequence[float]] = None,
                       ) -> None:
        self.budget.register(model, footprint_mb)
        self._ladders[str(model)] = (
            tuple(float(b) for b in latency_buckets_ms)
            if latency_buckets_ms else None)
        over = self.budget.over_budget()
        logger.info("fleet: model %s registered (%.0f MB; budget %.0f/%.0f "
                    "MB used%s)", model, footprint_mb,
                    self.budget.usage_mb(), self.budget.budget_mb,
                    f"; shedding {over}" if over else "")
        obs.get_recorder().record(
            "fleet", "model-registered", model=str(model),
            footprint_mb=float(footprint_mb),
            over_budget=",".join(over))

    def stats_for(self, model: str) -> ServingStats:
        """A `ServingStats` carrying the family's own latency ladder (ms
        boundaries -> seconds), for this family's replicas."""
        ladder = self._ladders.get(str(model))
        return ServingStats(
            latency_buckets=[b / 1e3 for b in ladder] if ladder else None)

    def models(self) -> List[str]:
        """Families with at least one pooled replica, registration-stable."""
        seen: List[str] = []
        for r in list(self.router.pool.replicas):
            m = getattr(r, "model", None)
            if m is not None and m not in seen:
                seen.append(m)
        return seen

    def submit(self, clip, *, model: str, **kwargs):
        if model in self.budget.over_budget():
            # the budget-aware shed: THIS family yields, the pool doesn't
            self._c_budget_shed.inc(pool=self.router.pool.name,
                                    model=str(model))
            raise QueueFullError(
                f"model {model!r} over the shared budget "
                f"({self.budget.usage_mb():.0f}/"
                f"{self.budget.budget_mb:.0f} MB); retry later",
                retry_after_s=self.retry_after_s)
        return self.router.submit(clip, model=model, **kwargs)

    def model_snapshot(self, model: str) -> Dict[str, float]:
        snap = self.router.fleet_snapshot(model=model)
        snap["budget_shed"] = self._c_budget_shed.value(
            pool=self.router.pool.name, model=str(model))
        snap["footprint_mb"] = self.budget.footprint_mb(str(model))
        return snap

    def snapshot_labels(self) -> Dict[str, float]:
        """Flat tracker-facing view: every family's snapshot, keys
        prefixed ``<model>/`` (the ServingStats.snapshot_labels idiom)."""
        out: Dict[str, float] = {
            "budget_mb": self.budget.budget_mb,
            "budget_used_mb": self.budget.usage_mb(),
            "models_served": float(len(self.models())),
        }
        for model in self.models():
            for k, v in self.model_snapshot(model).items():
                out[f"{model}/{k}"] = v
        return out
