"""Process-based clip workers over native shm rings (the port's copy of the
JAX package's `native/shm_loader.py`).

The thread transport (`data/pipeline.py`) suffices while decode and the
transforms release the interpreter lock; transforms that hold it serialise
there. This pool forks workers that write decoded, transformed samples
straight into shared memory:

- ONE RING PER WORKER, created fresh per epoch: worker w produces epoch
  positions w, w+W, ... in order into its own ring, and the consumer pops
  position p from ring p%W, so samples arrive in order by construction, the
  memory is bounded by the rings, and a slow worker holds back only itself;
- samples cross as zero-copy views and are copied once, into the batch
  (`ringbuf.gather_copy`, outside the interpreter lock);
- a worker's exception comes back in-band as an "__error__" sample carrying
  its traceback, so the consumer raises the real message at once; a worker
  that dies without one (SIGKILL) is reported within about a second;
- an early exit of `map_epoch` (a closed generator, an exception) shuts the
  rings down and reaps the workers.

Three fork hazards the JAX package does not meet, handled in each child
before its first sample (`_child_init`):
- torch's OpenMP pool: after the parent ran a parallel region, a forked
  child can hang in its first one (`F.interpolate` in the transforms), so a
  child runs torch on one thread (`torch.set_num_threads(1)`, as torch's
  own DataLoader workers do);
- CUDA: a child touches no CUDA; a source that does raises torch's "Cannot
  re-initialize CUDA in forked subprocess", which comes back in-band;
- locks: the parent forks while other threads run (the device prefetcher,
  the watchdog, the checkpoint writer, gloo's); a lock one of them held at
  the fork would stay held in the child forever. The child replaces the
  locks of the process-default telemetry objects (span collector, flight
  recorder, metric registry), of the armed fault plan and of the source's
  own objects (the meta cache, the quarantine) with fresh ones. As in the
  JAX package, what a child counts or quarantines stays in the child.
SIGTERM takes its default action in a child and SIGINT is ignored (the
parent tears the pool down), so a child never runs the parent's signal
hooks, and it leaves through `os._exit`, never the parent's exit handlers.
"""

from __future__ import annotations

import os
import signal
import threading
import traceback
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from pytorchvideo_accelerate_tpu_torch.native.ringbuf import (
    ShmRing,
    pack_sample,
    sample_nbytes,
    unpack_sample,
)

ERROR_KEY = "__error__"
# lock type -> its factory
_LOCKS = {type(threading.Lock()): threading.Lock,
          type(threading.RLock()): threading.RLock}


def _fresh_locks(obj, depth: int = 2, seen=None) -> None:
    """Replace every lock attribute of `obj` (and of the port's objects it
    holds, `depth` levels down) with a new, released lock of the same kind."""
    seen = set() if seen is None else seen
    if id(obj) in seen or not hasattr(obj, "__dict__"):
        return
    seen.add(id(obj))
    for name, value in list(vars(obj).items()):
        if type(value) in _LOCKS:
            setattr(obj, name, _LOCKS[type(value)]())
        elif depth > 0 and type(value).__module__.startswith(
                "pytorchvideo_accelerate_tpu_torch"):
            _fresh_locks(value, depth - 1, seen)


def _child_init(source) -> None:
    """A forked worker's preparation before its first sample (module
    docstring: the three fork hazards)."""
    import torch

    from pytorchvideo_accelerate_tpu_torch import obs
    from pytorchvideo_accelerate_tpu_torch.reliability import faults

    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    torch.set_num_threads(1)
    registry = obs.get_registry()
    for target in (obs.get_collector(), obs.get_recorder(), registry,
                   faults.current_plan(), source):
        if target is not None:
            _fresh_locks(target)
    for metric in list(vars(registry).get("_metrics", {}).values()):
        _fresh_locks(metric)


class ShmWorkerPool:
    """Decode workers in forked processes, samples through per-worker rings."""

    def __init__(self, source, num_workers: int = 4, slots_per_worker: int = 0,
                 slot_bytes: int = 0, probe_epoch: int = 0,
                 timeout_ms: int = 60_000):
        self.source = source
        self.num_workers = max(1, num_workers)
        self.timeout_ms = timeout_ms
        if not slot_bytes:
            probe = source.get(0, probe_epoch)
            # headroom for per-sample shape jitter + header
            slot_bytes = int(sample_nbytes(probe) * 1.25) + 1024
        self.slot_bytes = slot_bytes
        self.slots_per_worker = slots_per_worker or 4
        self._rings: List[ShmRing] = []
        self._pids: List[int] = []
        self.forks = 0  # workers forked over the pool's life

    # --- worker body ------------------------------------------------------

    def _worker(self, wid: int, indices: np.ndarray, epoch: int) -> None:
        ring = self._rings[wid]
        try:
            _child_init(self.source)
            for pos in range(wid, len(indices), self.num_workers):
                sample = self.source.get(int(indices[pos]), epoch)
                slot = ring.acquire(self.timeout_ms)
                if slot < 0:  # shutdown or stuck consumer
                    return
                n = pack_sample(sample, ring.slot_view(slot))
                ring.commit(slot, n, tag=pos)
        except BaseException:  # noqa: BLE001 - delivered in-band, then os._exit
            # the consumer raises with this traceback
            msg = traceback.format_exc().encode()[-4096:]
            slot = ring.acquire(2000)
            if slot >= 0:
                err = {ERROR_KEY: np.frombuffer(msg, np.uint8)}
                n = pack_sample(err, ring.slot_view(slot))
                ring.commit(slot, n, tag=0)
        finally:
            os._exit(0)

    def _spawn(self, indices: np.ndarray, epoch: int) -> None:
        self._rings = [ShmRing(self.slots_per_worker, self.slot_bytes)
                       for _ in range(self.num_workers)]
        self._pids = []
        for w in range(self.num_workers):
            pid = os.fork()
            if pid == 0:
                self._worker(w, indices, epoch)  # never returns
            self._pids.append(pid)
            self.forks += 1

    def _teardown(self) -> None:
        for ring in self._rings:
            ring.shutdown()  # wakes any worker blocked in acquire()
        for pid in self._pids:
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
        self._pids = []
        self._rings = []

    # --- consumer ---------------------------------------------------------

    def map_epoch(self, indices: Sequence[int], epoch: int,
                  start: int = 0) -> Iterator[Tuple[Dict[str, np.ndarray], "callable"]]:
        """Yield (sample, done) for positions start..len(indices)-1 IN ORDER.

        `sample` holds zero-copy views into a ring slot; call `done()` after
        copying it out (releases the slot). Rings + workers live for this
        call only; early generator exit tears them down promptly.
        """
        indices = np.asarray(indices[start:])
        self._spawn(indices, epoch)
        dead: Dict[int, int] = {}  # wid -> waitpid status
        try:
            for pos in range(len(indices)):
                wid = pos % self.num_workers
                ring = self._rings[wid]
                # short pops with a liveness check between them: a
                # SIGKILLed worker is reported within ~1 s (with its wait
                # status) instead of after the whole consumer timeout
                deadline_ms = self.timeout_ms
                slot = -1
                while deadline_ms > 0:
                    step_ms = min(deadline_ms, 1000)
                    slot, nbytes, tag = ring.pop(step_ms)
                    if slot >= 0:
                        break
                    deadline_ms -= step_ms
                    if wid not in dead:
                        pid_done, status = os.waitpid(self._pids[wid],
                                                      os.WNOHANG)
                        if pid_done:
                            dead[wid] = status
                    if wid in dead:
                        raise RuntimeError(
                            f"shm pool: worker {wid} (pid {self._pids[wid]}) "
                            f"died (wait status {dead[wid]}) before producing "
                            f"position {pos}")
                if slot < 0:
                    raise TimeoutError(
                        f"shm pool: no sample for position {pos} from worker "
                        f"{wid} (status {slot})")
                sample = unpack_sample(ring.slot_view(slot)[:nbytes])
                if ERROR_KEY in sample:
                    raise RuntimeError(
                        "shm worker failed:\n"
                        + bytes(sample[ERROR_KEY]).decode(errors="replace"))
                if tag != pos:  # protocol violation: should be impossible
                    raise RuntimeError(f"shm pool: expected pos {pos}, got {tag}")
                yield sample, (lambda r=ring, s=slot: r.release(s))
        finally:
            self._teardown()

    def close(self) -> None:
        for pid in self._pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        self._teardown()
