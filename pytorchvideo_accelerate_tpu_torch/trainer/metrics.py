"""Host-side metric accumulators (counterpart of the JAX package's
`trainer/metrics.py`).

The steps return device scalars; `update` keeps them pending and the host
reads them all at once when a result is asked for, not once per step, so
the loop never waits on a step's result before launching the next.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


def _fetch(values: list) -> list:
    """Read a list of 0-d tensors of one device (or dicts of them) to
    Python floats with one device sync."""
    flat = [t for v in values
            for t in (v.values() if isinstance(v, dict) else [v])]
    if not flat:
        return []
    host = iter(torch.stack([t.float().reshape(()) for t in flat]).tolist())
    return [{k: next(host) for k in v} if isinstance(v, dict) else next(host)
            for v in values]


@dataclass
class SumMetrics:
    """Accumulates {loss_sum, correct, correct5, count} dicts from eval
    steps."""

    loss_sum: float = 0.0
    correct: float = 0.0
    correct5: float = 0.0
    count: float = 0.0
    pending: list = field(default_factory=list)

    def update(self, step_out: dict) -> None:
        self.pending.append(step_out)

    def _drain(self) -> None:
        if self.pending:
            for out in _fetch(self.pending):
                self.loss_sum += out["loss_sum"]
                self.correct += out["correct"]
                self.correct5 += out["correct5"]
                self.count += out["count"]
            self.pending = []

    def accuracy(self) -> float:
        self._drain()
        return self.correct / max(self.count, 1.0)

    def accuracy_top5(self) -> float:
        self._drain()
        return self.correct5 / max(self.count, 1.0)

    def mean_loss(self) -> float:
        self._drain()
        return self.loss_sum / max(self.count, 1.0)


@dataclass
class MeanLoss:
    """Running epoch-mean train loss; `update` keeps the device scalar
    pending until `mean()`."""

    total: float = 0.0
    n: int = 0
    pending: list = field(default_factory=list)

    def update(self, loss) -> None:
        self.pending.append(loss)

    def _drain(self) -> None:
        if self.pending:
            for v in _fetch(self.pending):
                self.total += v
                self.n += 1
            self.pending = []

    def mean(self) -> float:
        self._drain()
        return self.total / max(self.n, 1)
