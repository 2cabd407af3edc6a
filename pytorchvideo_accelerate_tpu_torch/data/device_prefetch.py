"""Device-side batch prefetch: overlap the host-to-device copy with compute
(counterpart of the JAX package's `data/device_prefetch.py`).

A `DevicePrefetcher` sits between the host `ClipLoader` and the step loop. A
background thread advances `ClipLoader.epoch_items()`, copies each batch
into pinned host memory and from there to the card with `non_blocking`
copies on a side stream, records an event after them, and holds at most
`depth` batches that way. The consumer makes the current stream wait on
that event (a device-side wait: the host does not block), so the copy of
batch N+1 runs while the card computes batch N. On the CPU the batches are
only converted to tensors.

Contracts (the JAX package's):
- exact batch order: one producer, a FIFO queue;
- `loader.state` is assigned when the trainer takes a batch, so a
  checkpoint records the consumed position;
- at most `depth` batches are placed and not yet consumed;
- early `break`, an exception, or closing the generator stops the worker
  and closes the loader's generator; worker exceptions re-raise in the
  consumer;
- the time the consumer waits for the next batch accumulates in `wait_s`
  (`pop_wait()` drains it), the trainer's `input_wait_frac`.

`depth=0` places each batch inline and synchronously (the A/B baseline).
Under data parallelism `device` is the rank's own card (`cuda:<index>`),
and every copy, stream and event lands there.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from pytorchvideo_accelerate_tpu_torch.data.pipeline import ClipLoader

_POLL_S = 0.05  # stop-flag poll cadence for blocking waits
_JOIN_TIMEOUT_S = 10.0


def _as_tensor(v) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))


class DevicePrefetcher:
    """Bounded background host-to-device pipeline over one `ClipLoader`."""

    def __init__(self, loader: ClipLoader, device: torch.device,
                 depth: int = 2):
        if depth < 0:
            raise ValueError(f"device prefetch depth must be >= 0, got {depth}")
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.wait_s = 0.0  # consumer time blocked on the next device batch
        self._stream = None

    def pop_wait(self) -> float:
        """Accumulated input-wait seconds since the last call."""
        w, self.wait_s = self.wait_s, 0.0
        return w

    def _place(self, batch: dict):
        """(device batch, event or None). On the card: pinned host copy,
        then a non_blocking copy on the side stream, then an event."""
        tensors = {k: _as_tensor(v) for k, v in batch.items()}
        if self.device.type != "cuda":
            return {k: v.to(self.device) for k, v in tensors.items()}, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        # the producer thread's current card is not the trainer's: a rank's
        # batches go to its own card
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            placed = {k: v.pin_memory().to(self.device, non_blocking=True)
                      for k, v in tensors.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _take(self, placed: dict, event) -> dict:
        """Consumer side: the current stream waits for the copies, and the
        allocator learns the tensors are used there."""
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for v in placed.values():
                v.record_stream(current)
        return placed

    def epoch(self, epoch: Optional[int] = None,
              from_start: bool = False) -> Iterator[dict]:
        """Yield device batches for one epoch, `depth` ahead; `loader.state`
        tracks the consumed position as the plain host iteration would."""
        if self.depth == 0:
            yield from self._epoch_sync(epoch, from_start)
            return
        q: "queue.Queue[tuple]" = queue.Queue()
        stop = threading.Event()
        slots = threading.Semaphore(self.depth)
        items = self.loader.epoch_items(epoch, from_start)
        worker = threading.Thread(target=self._worker,
                                  args=(items, q, stop, slots),
                                  name="device-prefetch", daemon=True)
        worker.start()
        try:
            while True:
                t0 = time.perf_counter()
                kind, payload, state = q.get()
                self.wait_s += time.perf_counter() - t0
                if kind == "batch":
                    slots.release()
                    self.loader.state = state
                    yield self._take(*payload)
                elif kind == "state":  # epoch rollover marker
                    self.loader.state = state
                elif kind == "error":
                    raise payload
                else:  # "done"
                    return
        finally:
            stop.set()
            worker.join(timeout=_JOIN_TIMEOUT_S)
            while True:  # drop queued batches so their memory frees
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def _epoch_sync(self, epoch: Optional[int],
                    from_start: bool) -> Iterator[dict]:
        for batch, state in self.loader.epoch_items(epoch, from_start):
            if batch is None:
                self.loader.state = state
                continue
            t0 = time.perf_counter()
            placed = self._take(*self._place(batch))
            self.wait_s += time.perf_counter() - t0
            self.loader.state = state
            yield placed

    def _worker(self, items: Iterator[tuple], q: "queue.Queue[tuple]",
                stop: threading.Event, slots: threading.Semaphore) -> None:
        """Producer: advance the loader, place, enqueue. Closing `items`
        from this thread (the only one that ran it) cancels the loader's
        pending work."""
        try:
            for batch, state in items:
                if batch is None:  # exhaustion marker: no slot, no copy
                    q.put(("state", None, state))
                    continue
                while not stop.is_set():
                    if slots.acquire(timeout=_POLL_S):
                        break
                else:
                    return  # consumer gone
                q.put(("batch", self._place(batch), state))
        except BaseException as e:  # noqa: BLE001 - must cross the thread
            q.put(("error", e, None))
        else:
            q.put(("done", None, None))
        finally:
            items.close()
