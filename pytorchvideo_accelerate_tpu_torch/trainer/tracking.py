"""Experiment tracking (the port's copy of the JAX package's
`trainer/tracking.py`): a small `Tracker` protocol, the jsonl, TensorBoard
and wandb writers, `"all"` resolving to every one that imports, the
retrying fan-out `TrackerHub`, and the one-step-late `DeferredStepLogger`.

`JsonlTracker` writes the JAX package's lines, so one parser reads either
package's file. TensorBoard goes through `torch.utils.tensorboard` (it needs
the `tensorboard` package) and wandb through `wandb`; a machine without
them tracks to jsonl alone under `"all"`. The JAX hub's fault point waits
for the port of `reliability/faults.py` (ROADMAP.md).
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from pytorchvideo_accelerate_tpu_torch.reliability.retry import retry_call

logger = logging.getLogger(__name__)


class Tracker:
    name = "base"

    def start(self, run_name: str, config: dict) -> None:  # pragma: no cover
        raise NotImplementedError

    def log(self, values: Dict[str, float], step: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def finish(self) -> None:
        pass


class JsonlTracker(Tracker):
    """One JSON line per call at `<logging_dir>/<run_name>.jsonl`: a
    `start` line with the config, `{"step": N, ...values}` per log, an
    `end` line."""

    name = "jsonl"

    def __init__(self, logging_dir: str):
        self.logging_dir = logging_dir
        self._fh = None

    def start(self, run_name: str, config: dict) -> None:
        os.makedirs(self.logging_dir, exist_ok=True)
        path = os.path.join(self.logging_dir, f"{run_name}.jsonl")
        self._fh = open(path, "a")
        self._fh.write(json.dumps({"event": "start", "run": run_name,
                                   "time": time.time(), "config": config},
                                  default=str) + "\n")
        self._fh.flush()

    def log(self, values: Dict[str, float], step: int) -> None:
        if self._fh:
            self._fh.write(json.dumps(
                {"step": int(step), **{k: float(v) for k, v in values.items()}})
                + "\n")
            self._fh.flush()

    def finish(self) -> None:
        if self._fh:
            self._fh.write(json.dumps({"event": "end", "time": time.time()})
                           + "\n")
            self._fh.close()
            self._fh = None


class TensorBoardTracker(Tracker):
    """Scalars through `torch.utils.tensorboard.SummaryWriter` under
    `<logging_dir>/<run_name>`, the config as text at step 0."""

    name = "tensorboard"

    def __init__(self, logging_dir: str):
        self.logging_dir = logging_dir
        self._writer = None

    def start(self, run_name: str, config: dict) -> None:
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(os.path.join(self.logging_dir, run_name))
        self._writer.add_text("config", json.dumps(config, default=str), 0)

    def log(self, values: Dict[str, float], step: int) -> None:
        if self._writer:
            for k, v in values.items():
                self._writer.add_scalar(k, float(v), int(step))
            self._writer.flush()

    def finish(self) -> None:
        if self._writer:
            self._writer.close()
            self._writer = None


class WandbTracker(Tracker):
    name = "wandb"

    def __init__(self, logging_dir: str):
        self.logging_dir = logging_dir
        self._run = None

    def start(self, run_name: str, config: dict) -> None:
        import wandb

        self._run = wandb.init(name=run_name, config=config,
                               dir=self.logging_dir)

    def log(self, values: Dict[str, float], step: int) -> None:
        if self._run:
            self._run.log(values, step=int(step))

    def finish(self) -> None:
        if self._run:
            self._run.finish()
            self._run = None


_TRACKERS = {"jsonl": JsonlTracker, "tensorboard": TensorBoardTracker,
             "wandb": WandbTracker}
# the package each tracker needs (torch.utils.tensorboard imports
# `tensorboard`); looked up, not imported: importing tensorboard can pull in
# TensorFlow. A broken install fails in start(), and the hub disables it.
_NEEDS = {"tensorboard": "tensorboard", "wandb": "wandb"}


def _available(name: str) -> bool:
    return name not in _NEEDS or importlib.util.find_spec(_NEEDS[name]) is not None


def resolve_trackers(spec: str, logging_dir: str) -> List[Tracker]:
    """`"all"` -> every tracker that imports (accelerate's `log_with="all"`);
    else a comma list of names, each skipped with a log line when it does
    not import or is unknown (as the JAX package does)."""
    names = (list(_TRACKERS) if spec == "all"
             else [s.strip() for s in spec.split(",") if s.strip()])
    out: List[Tracker] = []
    for n in names:
        if n not in _TRACKERS or not _available(n):
            logger.info("tracker %s unavailable; skipping", n)
            continue
        out.append(_TRACKERS[n](logging_dir))
    return out


class TrackerHub:
    """Fan-out over the resolved trackers. A raising tracker gets `retries`
    attempts in all (`retry_call`, short backoff: tracker outages are
    usually brief) and is then disabled; the others keep logging. A logging
    failure never kills a training step. The disable rebinds
    `self.trackers` under a lock, so a fan-out running on another thread
    keeps iterating its own copy."""

    def __init__(self, spec: str, logging_dir: str, retries: int = 2):
        self._lock = threading.Lock()
        self.trackers = resolve_trackers(spec, logging_dir)
        self.retries = max(int(retries), 1)

    def _fanout(self, op: str, fn: Callable[[Tracker], None]) -> None:
        with self._lock:
            trackers = list(self.trackers)
        for t in trackers:
            try:
                retry_call(lambda t=t: fn(t), attempts=self.retries,
                           retry_on=(Exception,), base_delay_s=0.02,
                           deadline_s=2.0)
            except Exception as e:  # noqa: BLE001 - any tracker bug qualifies
                logger.warning(
                    "tracker %r raised in %s (%s: %s) after %d attempt(s); "
                    "disabling it: a logging failure must never kill a "
                    "training step", t.name, op, type(e).__name__, e,
                    self.retries)
                with self._lock:
                    self.trackers = [x for x in self.trackers if x is not t]

    def start(self, run_name: str, config: dict) -> None:
        self._fanout("start", lambda t: t.start(run_name, config))

    def log(self, values: Dict[str, float], step: int) -> None:
        self._fanout("log", lambda t: t.log(values, step))

    def finish(self) -> None:
        self._fanout("finish", lambda t: t.finish())


class DeferredStepLogger:
    """Metric logging one step late, off the dispatch path.

    Reading a step's device scalars right after dispatching it would block
    the host on that step before the next one is queued. `defer()` stashes
    them; `flush()`, called after the next step has been dispatched, reads
    them as floats (that step has all but retired, and the one just queued
    keeps the card busy) and hands them to the hub and to `on_flush`. At
    most one log is pending: a second `defer()` flushes the first, never
    drops it. `hub` may be None (only `on_flush` sees the floats)."""

    def __init__(self, hub: Optional[TrackerHub],
                 on_flush: Optional[Callable[[Dict[str, float], int], None]] = None):
        self.hub = hub
        self.on_flush = on_flush
        self._pending: Optional[tuple] = None

    def defer(self, values: Dict[str, object], step: int) -> None:
        if self._pending is not None:
            self.flush()
        self._pending = (values, step)

    def flush(self) -> None:
        """Read and log the stashed metrics, if any."""
        if self._pending is None:
            return
        values, step = self._pending
        self._pending = None
        floats = {k: float(v) for k, v in values.items()}
        if self.on_flush is not None:
            self.on_flush(floats, step)
        if self.hub is not None:
            self.hub.log(floats, step=step)
