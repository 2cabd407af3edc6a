"""The port's telemetry layer (its copy of the JAX package's `obs/`):
spans, the flight recorder, the metric registry, the device-memory ledger,
the metrics history, the burn-rate alerts, the hang watchdog, distributed
tracing (`obs.trace`: `configure_tracing`, the capture/attach handoff
helpers, the per-process trace ring) and the on-demand profiler
(`obs.profiler`).

Stdlib only at import time. The process-default singletons
(`get_collector`/`get_recorder`/`get_registry`) are the shared path;
tests construct private instances. `configure()` is the one switch:
`obs.enabled=false` turns every span into a shared no-op and detaches the
recorder. Tracing and the profiler are armed apart, and disarmed each
costs one global read per hook.
"""

from __future__ import annotations

from pytorchvideo_accelerate_tpu_torch.obs import alerts  # noqa: F401
from pytorchvideo_accelerate_tpu_torch.obs import history  # noqa: F401
from pytorchvideo_accelerate_tpu_torch.obs import memory  # noqa: F401
from pytorchvideo_accelerate_tpu_torch.obs import profiler  # noqa: F401
from pytorchvideo_accelerate_tpu_torch.obs import trace  # noqa: F401
from pytorchvideo_accelerate_tpu_torch.obs.alerts import (  # noqa: F401
    AlertEngine,
    AlertRule,
)
from pytorchvideo_accelerate_tpu_torch.obs.flight_recorder import (  # noqa: F401
    FlightRecorder,
    get_recorder,
)
from pytorchvideo_accelerate_tpu_torch.obs.history import MetricsHistory  # noqa: F401
from pytorchvideo_accelerate_tpu_torch.obs.memory import MemoryLedger  # noqa: F401
from pytorchvideo_accelerate_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
)
from pytorchvideo_accelerate_tpu_torch.obs.spans import (  # noqa: F401
    BACKGROUND as BACKGROUND_SPANS,
    SpanCollector,
    current_stacks,
    get_collector,
    observe,
    span,
)
from pytorchvideo_accelerate_tpu_torch.obs.watchdog import Watchdog  # noqa: F401

# default wiring: completed spans feed the flight-recorder ring
get_collector().recorder = get_recorder()


def configure(enabled: bool = None, capacity: int = None) -> SpanCollector:
    """Turn the process-default telemetry on or off and/or resize the
    flight ring (the Trainer and the server call this from `cfg.obs`)."""
    collector = get_collector()
    recorder = get_recorder()
    if capacity is not None:
        recorder.set_capacity(capacity)
    if enabled is not None:
        collector.enabled = bool(enabled)
        collector.recorder = recorder if enabled else None
    return collector
