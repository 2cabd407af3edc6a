"""Fleet intelligence: the control loops over the serving tier (the port's
copy of the JAX package's `fleet/control/`).

fleet/ gave the serving tier sensors (per-replica registry labels,
pooled percentiles, traces) and actuators (`spawn_serving_process`,
blue/green hot-swap, admission drain, session re-home); this package
closes the loops:

- `signals.SignalReader` — one registry-fed `ControlSignals` snapshot
  per control tick (the same numbers `/metrics` serves); with a shared
  `obs.history.MetricsHistory` attached it also serves the smoothed
  (EWMA) series off the retained ring;
- `autoscaler.Autoscaler` — damped SLO-driven pool resizing: spawn on
  backlog/p99 pressure, drain -> re-home -> reap on idle, dead-member
  replacement without double-counting;
- `multimodel.ModelBudget` / `multimodel.MultiModelFleet` — several
  model families on one pool under a shared device-memory budget;
  the over-budget family sheds, the pool never degrades (budgets consume
  MEASURED MemoryLedger bytes on device, declared footprints elsewhere);
- `canary.CanaryController` — fractional blue/green rollout with
  direction-aware comparison (perfdiff vocabulary) evaluated PER model
  family on multi-model pools (a regression in one family strikes that
  family instead of diluting into a pool average), exemplar-linked
  evidence, and escalation-ladder auto-rollback.
"""

from pytorchvideo_accelerate_tpu_torch.fleet.control.autoscaler import (  # noqa: F401,E501
    Autoscaler,
)
from pytorchvideo_accelerate_tpu_torch.fleet.control.canary import (  # noqa: F401
    CanaryController,
)
from pytorchvideo_accelerate_tpu_torch.fleet.control.multimodel import (  # noqa: F401,E501
    ModelBudget,
    MultiModelFleet,
)
from pytorchvideo_accelerate_tpu_torch.fleet.control.signals import (  # noqa: F401
    ControlSignals,
    SignalReader,
)
