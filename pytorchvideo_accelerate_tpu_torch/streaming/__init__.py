"""Incremental streaming inference (the port's counterpart of the JAX
package's `streaming/`).

A session owns a device-resident rolling window ring inside an
`InferenceEngine`'s device; each advance ships only the new frames to the
device, writes them into the ring in place and scores the cached window, so
a live stream scored at stride s stops paying the T/s-fold decode,
host-to-device and patch-embed cost of one-shot clip classification.

- `streaming/session.py`: the session table: ids, ring-slot leases, TTL
  and budget admission (`SessionTable`);
- `streaming/engine.py`: `StreamingEngine`: ring pools, the per-(geometry,
  stride, bucket) establish and advance steps, the hot-swap state carry
  (`carry_state_from`) and the parity oracles.

The scheduler's session launches and `/stream` live in fleet/scheduler.py
and serving/server.py.
"""

from pytorchvideo_accelerate_tpu_torch.streaming.engine import (  # noqa: F401
    StreamingEngine,
)
from pytorchvideo_accelerate_tpu_torch.streaming.session import (  # noqa: F401
    SessionAdmissionError,
    SessionError,
    SessionTable,
    SessionUnknownError,
)
