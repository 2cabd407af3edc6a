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

Telemetry (obs/): the consumer's wait is also the `wait_name` span
("input_wait" for training, "eval_input_wait" for eval, which nests inside
the "eval" span and so counts as background), the worker's placement the
`h2d_name` span ("h2d" / "eval_h2d"); the memory ledger accounts the placed
batches not yet consumed as component `prefetch_ring:<wait_name>`
(registered when placed, released when the consumer takes them, cleared
when the epoch's generator closes). With a `watchdog` (obs/watchdog.py)
the worker sends `heartbeat(watchdog_name)` for each batch it takes from
the loader (the inline path: for each batch it places) and clears the
component when its epoch ends: an idle prefetcher is no stall. Each
placement is the `prefetch.h2d` fault point (reliability/faults.py): a
``delay`` is a starved host link, a ``raise`` crosses the queue and
re-raises in the consumer like a real placement failure.

Tracing (obs/trace.py): the worker's placements run under the consumer's
trace context, so their `h2d` spans join its trace: the one captured when
the epoch starts (the JAX package's handoff) or, once the consumer hands
one in with `set_trace_context` (the Trainer does at each traced step), the
latest handed in: a placement joins the step that runs while it is made.

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

from pytorchvideo_accelerate_tpu_torch import obs
from pytorchvideo_accelerate_tpu_torch.data.pipeline import ClipLoader
from pytorchvideo_accelerate_tpu_torch.obs import memory as obs_memory
from pytorchvideo_accelerate_tpu_torch.obs import trace
from pytorchvideo_accelerate_tpu_torch.reliability.faults import fault_point

_POLL_S = 0.05  # stop-flag poll cadence for blocking waits
_JOIN_TIMEOUT_S = 10.0


def _as_tensor(v) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))


class DevicePrefetcher:
    """Bounded background host-to-device pipeline over one `ClipLoader`."""

    def __init__(self, loader: ClipLoader, device: torch.device,
                 depth: int = 2, wait_name: str = "input_wait",
                 h2d_name: str = "h2d", watchdog=None,
                 watchdog_name: str = "prefetch"):
        if depth < 0:
            raise ValueError(f"device prefetch depth must be >= 0, got {depth}")
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.wait_s = 0.0  # consumer time blocked on the next device batch
        self.wait_name = wait_name
        self.h2d_name = h2d_name
        self.watchdog = watchdog
        self.watchdog_name = watchdog_name
        self._mem_component = f"prefetch_ring:{wait_name}"
        self._stream = None
        self._trace_ctx = None  # the consumer's latest handed-in context

    def set_trace_context(self, ctx) -> None:
        """The trace context the worker's next placements join (None: the
        one captured when the epoch started)."""
        self._trace_ctx = ctx

    def pop_wait(self) -> float:
        """Accumulated input-wait seconds since the last call."""
        w, self.wait_s = self.wait_s, 0.0
        return w

    def _place(self, batch: dict):
        """(device batch, event or None). On the card: pinned host copy,
        then a non_blocking copy on the side stream, then an event."""
        fault_point("prefetch.h2d")
        with obs.span(self.h2d_name):
            return self._copy(batch)

    def _copy(self, batch: dict):
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
        # the consumer's context when the epoch starts (None when tracing
        # is disarmed or nothing is traced here)
        self._trace_ctx = None
        worker = threading.Thread(target=self._worker,
                                  args=(items, q, stop, slots, trace.capture()),
                                  name="device-prefetch", daemon=True)
        worker.start()
        try:
            while True:
                t0 = time.perf_counter()
                kind, payload, state = q.get()
                dt = time.perf_counter() - t0
                self.wait_s += dt
                obs.observe(self.wait_name, dt)
                if kind == "batch":
                    slots.release()
                    # the step loop owns the batch from here
                    obs_memory.release(self._mem_component,
                                       obs_memory.tree_nbytes(payload[0]))
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
            # a worker that out-raced the drain leaves no phantom bytes
            obs_memory.release(self._mem_component)

    def _epoch_sync(self, epoch: Optional[int],
                    from_start: bool) -> Iterator[dict]:
        try:
            for batch, state in self.loader.epoch_items(epoch, from_start):
                if batch is None:
                    self.loader.state = state
                    continue
                t0 = time.perf_counter()
                placed = self._take(*self._place(batch))
                dt = time.perf_counter() - t0
                self.wait_s += dt
                obs.observe(self.wait_name, dt)
                if self.watchdog is not None:
                    self.watchdog.heartbeat(self.watchdog_name)
                self.loader.state = state
                yield placed
        finally:
            # a finished epoch is idle, not stalled
            if self.watchdog is not None:
                self.watchdog.clear(self.watchdog_name)

    def _worker(self, items: Iterator[tuple], q: "queue.Queue[tuple]",
                stop: threading.Event, slots: threading.Semaphore,
                ctx=None) -> None:
        """Producer: advance the loader, place, enqueue. `ctx` is the
        consumer's trace context at the epoch's start. Closing `items` from
        this thread (the only one that ran it) cancels the loader's pending
        work."""
        try:
            for batch, state in items:
                if self.watchdog is not None:
                    self.watchdog.heartbeat(self.watchdog_name)
                if batch is None:  # exhaustion marker: no slot, no copy
                    q.put(("state", None, state))
                    continue
                while not stop.is_set():
                    if slots.acquire(timeout=_POLL_S):
                        break
                else:
                    return  # consumer gone
                with trace.attach(self._trace_ctx or ctx):
                    placed = self._place(batch)
                # the ledger: the bytes of the batch resident in the ring
                obs_memory.register(self._mem_component,
                                    obs_memory.tree_nbytes(placed[0]))
                q.put(("batch", placed, state))
        except BaseException as e:  # noqa: BLE001 - must cross the thread
            q.put(("error", e, None))
        else:
            q.put(("done", None, None))
        finally:
            # a finished or closed worker is idle, not stalled
            if self.watchdog is not None:
                self.watchdog.clear(self.watchdog_name)
            items.close()
