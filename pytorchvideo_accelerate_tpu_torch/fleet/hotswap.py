"""Zero-downtime checkpoint hot swap: blue/green per replica (the port's
copy of the JAX package's `fleet/hotswap.py`).

A new checkpoint lands (a nightly fine-tune, a rollback); the replicas pick
it up without dropping a request or serving one answer of mixed weights.
Per replica (fleet-wide it runs replica by replica, so the router keeps the
rest of the fleet serving):

1. **green build**: restore the artifact into a FRESH `InferenceEngine` on
   the replica's own device (`InferenceEngine.from_artifact`), sharing the
   replica's `ServingStats` so the latency window survives the swap;
2. **pre-warm**: run the green engine at EVERY batch geometry the blue one
   has served (`compiled_keys`), so the cutover never turns the first
   requests into first-call stalls (kernel builds, cuDNN's algorithm
   pick); a streaming green also runs every stream step blue serves
   (`prepare_carry_from`);
3. **drain-then-swap**: `Scheduler.swap_engine` installs green BETWEEN
   launches: it waits on the launch lock for the launch in flight, so no
   launch (and no future) ever sees mixed weights. The time it waits is the
   measured `swap_blackout_ms`: with the pre-warm done, at most one
   launch's service time (plus a streaming engine's state carry).

Bucket ladders must match (the same `serve.max_batch_size`): a swap that
would change them is refused, since queued padding plans assume stable
buckets; that change is a restart.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np

from pytorchvideo_accelerate_tpu_torch import obs
from pytorchvideo_accelerate_tpu_torch.obs import trace

logger = logging.getLogger("pva_tpu_torch")


def prewarm_like(green, blue) -> int:
    """Run `green` at every batch geometry `blue` has served; returns the
    number of keys run. Runs while blue is still serving, on the caller's
    thread. A streaming green also runs every stream step blue serves and
    the whole-pool re-derives (`prepare_carry_from`); the session-state
    carry itself happens later, inside `Scheduler.swap_engine` under the
    launch lock, because blue keeps launching all through the pre-warm."""
    n = 0
    for key in blue.compiled_keys:
        batch = {name: np.zeros(shape, green.input_dtype)
                 for name, shape in key}
        green.predict(batch)
        n += 1
    if hasattr(green, "prepare_carry_from") and hasattr(blue, "table"):
        with trace.span("session_carry_prewarm",
                        sessions=len(blue.table.sessions())):
            n += green.prepare_carry_from(blue)
        logger.info("hot-swap: stream steps pre-warmed; live sessions move "
                    "at cutover under the launch lock")
    return n


def swap_replica(replica, green, *, prewarm: bool = True) -> float:
    """Blue/green cutover of ONE replica; returns the blackout in seconds."""
    blue = replica.scheduler.current_engine()
    if prewarm:
        n = prewarm_like(green, blue)
        logger.info("hot-swap %s: pre-warmed %d keys", replica.name, n)
    return replica.scheduler.swap_engine(green)


def hot_swap(replicas: List, artifact: str, *,
             max_batch_size: Optional[int] = None,
             prewarm: bool = True) -> Dict[str, float]:
    """Swap every replica of `replicas` onto the checkpoint at `artifact`,
    one at a time (the rest of the fleet keeps serving). Each green lands on
    its blue's device, with its blue's quantization. Returns
    ``{"swap_blackout_ms": worst case, "swap_total_s": wall,
    "per_replica_ms": {...}}``."""
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine

    t0 = time.perf_counter()
    per: Dict[str, float] = {}
    for replica in replicas:
        blue = replica.scheduler.current_engine()
        # the serving tier's quantization survives the swap: an int8 blue
        # cuts over to an int8 green even from an fp artifact
        streaming_blue = getattr(blue, "supports_sessions", False)
        inner_blue = blue.engine if streaming_blue else blue
        green = InferenceEngine.from_artifact(
            artifact, device=inner_blue.device,
            max_batch_size=(max_batch_size if max_batch_size is not None
                            else blue.buckets[-1]),
            stats=replica.stats,
            quantization=getattr(inner_blue, "quantization", None))
        if streaming_blue:
            # a streaming replica cuts over to a streaming green with the
            # same session surface and trunk mode; the carry re-derives
            # every weight-derived ring under the green weights
            from pytorchvideo_accelerate_tpu_torch.streaming.engine import (
                StreamingEngine,
            )

            green = StreamingEngine(
                green,
                session_budget_mb=blue.session_budget_bytes / 1e6,
                session_ttl_s=blue.table.ttl_s,
                retry_after_s=blue.table.retry_after_s,
                name=blue.name,
                trunk=getattr(blue, "trunk", "full"),
                attn_window=getattr(blue, "attn_window", 0))
        blackout = swap_replica(replica, green, prewarm=prewarm)
        per[replica.name] = round(blackout * 1e3, 3)
        logger.info("hot-swap %s: cutover blackout %.2f ms",
                    replica.name, blackout * 1e3)
    out = {
        "swap_blackout_ms": max(per.values()) if per else 0.0,
        "swap_total_s": round(time.perf_counter() - t0, 3),
        "per_replica_ms": per,
    }
    obs.get_recorder().record("fleet", "hot-swap-complete", **{
        k: v for k, v in out.items() if k != "per_replica_ms"})
    return out
