"""The serving fleet (the port's copy of the JAX package's `fleet/`): the
tier that turns N single-endpoint replicas into one endpoint.

- `scheduler.Scheduler`: the continuous-batching EDF front of ONE replica
  (per-request deadlines, `realtime`/`batch` classes, shed before a
  deadline miss);
- `pool.ReplicaPool`: N replicas (in-process `LocalReplica` schedulers, or
  `HttpReplica` processes) with health-gated membership;
- `router.Router`: affinity-then-least-outstanding routing, replica-shed
  failover, route-around on replica death (in-flight requests
  re-dispatched), per-replica registry labels, fleet-merged stats;
- `hotswap.hot_swap`: zero-downtime blue/green checkpoint swap with a
  pre-warm and a measured `swap_blackout_ms`;
- `loadgen.LoadGen`, `loadgen.StreamLoadGen` and `pva-torch-loadgen`: the
  open-loop load harness (Poisson arrivals of requests or of streams);
- `control/`: the loops over all of the above (`Autoscaler`,
  `ModelBudget`/`MultiModelFleet`, `CanaryController`).

The router speaks the `Scheduler`'s interface, so an `InferenceServer`
fronts a fleet unchanged.
"""

from pytorchvideo_accelerate_tpu_torch.fleet.control import (  # noqa: F401
    Autoscaler,
    CanaryController,
    ControlSignals,
    ModelBudget,
    MultiModelFleet,
    SignalReader,
)
from pytorchvideo_accelerate_tpu_torch.fleet.hotswap import (  # noqa: F401
    hot_swap,
    swap_replica,
)
from pytorchvideo_accelerate_tpu_torch.fleet.loadgen import (  # noqa: F401
    LoadGen,
    StreamLoadGen,
    heavy_tail_clip_factory,
)
from pytorchvideo_accelerate_tpu_torch.fleet.pool import (  # noqa: F401
    HttpReplica,
    LocalReplica,
    ReplicaDeadError,
    ReplicaPool,
    spawn_serving_process,
)
from pytorchvideo_accelerate_tpu_torch.fleet.router import Router  # noqa: F401
from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import (  # noqa: F401
    BATCH,
    REALTIME,
    Scheduler,
    ShedError,
)
