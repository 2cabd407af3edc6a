"""StubEngine: the host-side `InferenceEngine` double (the port's copy of
the JAX package's `serving/stub.py`, without the streaming stub).

Tests of the serving control plane (batcher, scheduler, HTTP front, stats)
need the engine surface without a model: bucket geometry, `bucket_for`,
`predict`, the identity attributes `/healthz` reads (`device` is the CPU),
and `release_memory` (it holds no device memory: a no-op).
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch


class StubEngine:
    """Bucket geometry + a host-side forward; `tag` fills column 1 of the
    logits so callers can tell which engine answered, and `forward_s` makes
    service time measurable (deadline sheds, queue buildup)."""

    model_name = "stub"
    input_dtype = "float32"
    device = torch.device("cpu")

    def __init__(self, tag: float = 0.0, forward_s: float = 0.001,
                 buckets: Tuple[int, ...] = (2, 4), num_classes: int = 4):
        self.tag = float(tag)
        self.forward_s = float(forward_s)
        self.buckets = tuple(buckets)
        self.num_classes = int(num_classes)
        self.compiled_keys: tuple = ()

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest bucket {self.buckets[-1]}")

    def predict(self, batch) -> np.ndarray:
        if self.forward_s > 0:
            time.sleep(self.forward_s)
        rows = next(iter(v for k, v in batch.items() if k != "mask"))
        n = rows.shape[0]
        out = np.zeros((n, self.num_classes), np.float32)
        if self.num_classes > 1:
            out[:, 1] = self.tag
        return out

    def release_memory(self) -> None:
        """Nothing registered in the memory ledger: nothing to return."""
