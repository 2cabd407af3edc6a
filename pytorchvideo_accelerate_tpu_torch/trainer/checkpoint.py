"""Training checkpoints and inference artifacts (counterpart of the JAX
package's `trainer/checkpoint.py`).

Inference artifacts (`export_inference` / `load_inference`) use the JAX
package's `pva-tpu-inference-v1` format, so each side reads the other's: a
directory of
  weights.npz  flat {params/..., batch_stats/...} numpy arrays in the flax
               layout (models/convert.py maps them to the port's state_dict)
  meta.json    format tag, step, ema_resolved, quantization, num_classes,
               model name and the resolved TrainConfig dict
Both files land atomically (`reliability/atomic.py`: tmp file in the same
directory, fsync, os.replace), retried on OSError, so a reader never finds
a truncated artifact. The artifact is the crossing point between the two
packages. `export_inference(..., quantization="int8")` bakes an int8
artifact (serving/quantize.py; `meta.quantization` records it): every
eligible weight becomes the flax kernel's `q8` / `q8_scale` leaves, the
JAX package's int8 layout, and `load_inference` returns such a weight as
its quant leaf, from either package's artifact.

Training checkpoints (`Checkpointer`) use the port's own format: one
directory per optimizer step, `<dir>/<step>/` holding
  state.pt    `torch.save` of `TrainState.state_dict()`: step, the model's
              state_dict (params + BN running averages), the optimizer's
              (e.g. SGD momentum buffers), the EMA copy or None
  extra.json  kind (step|epoch|final|preempt), epoch, the loader's
              LoaderState, num_classes and model name
written into a temporary directory and renamed into place with
`os.replace`; a save that fails with OSError is tried again from a clean
temporary directory, `retries` attempts in all
(`reliability.ckpt_retries`), the guard's last-known-good ring included.

Asynchronous saves (`use_async`, the default; `checkpoint.async_checkpoint`
in the Trainer): the calling thread takes the state dict (the gathers over
the fsdp and tensor groups are collectives and stay there) and queues its
copy to host memory (pinned buffers, `non_blocking` copies on the current
stream, then an event: the step that follows is queued behind the copies,
so it cannot change what they read); one writer thread waits for the
event, then runs `torch.save`, `extra.json`, `os.replace`, the retries and
the retention. `wait()` fences: it returns once every queued write has
landed, raises the first failed write's error (a failed write is never
swallowed) and holds the rank barrier. A save fences the one before it,
and so do a restore, a delete and a listing (`all_steps`,
`latest_step`); `close()` fences and stops the writer. A rank that leaves
on an exception fences with `barrier=False`: its writes land and a failed
one raises, without the barrier that its peers, stuck elsewhere, would
never reach. Each of these host waits is a watched section of the hang
check (parallel/hangcheck.py): `ckpt_save step=N` (the gathers and the
dispatch), `ckpt_wait` (a fence with a save pending; its barrier is named
`checkpoint_save`), `ckpt_close` (its barrier `checkpoint_close`) and
`ckpt_restore step=N` (its barrier `checkpoint_restore`).
A process killed during a write leaves only its temporary directory
(`.tmp-<step>-<pid>`, never listed as a step): `latest_step()` stays the
last complete one. `use_async=False` writes on the calling thread and
returns after the barrier (the preemption grace path's save).

In a data-parallel job (`parallel/`) every rank holds the same state:
rank 0 writes and prunes, then every rank meets at a barrier (in `wait()`),
so no rank reads or lists the directory before the write has landed; a
restore starts with a barrier too, and every rank then loads the same
file. On
the model axis every rank first gathers the full state over its model
group (`TrainState.state_dict`), so rank 0 writes the full tree, and a
restore keeps each rank's shards of it: a checkpoint resumes at any
(data, model) layout.
A JAX orbax checkpoint is not read by the port (orbax is a JAX
dependency); carry weights across with an inference artifact, or a JAX
TrainState with `models/convert.py`.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorchvideo_accelerate_tpu_torch.config import ReliabilityConfig
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    jax_tree_from_state_dict,
    state_dict_from_jax,
)
from pytorchvideo_accelerate_tpu_torch.parallel.distributed import (
    is_main_process,
    sync_global_devices,
)
from pytorchvideo_accelerate_tpu_torch.parallel.hangcheck import collective_section
from pytorchvideo_accelerate_tpu_torch.reliability.atomic import (
    atomic_write,
    atomic_write_json,
)
from pytorchvideo_accelerate_tpu_torch.reliability.retry import retry_call
from pytorchvideo_accelerate_tpu_torch.serving.quantize import (
    QUANT_MODES,
    quantize_tree,
)

INFERENCE_FORMAT = "pva-tpu-inference-v1"
_WEIGHTS_FILE = "weights.npz"
_META_FILE = "meta.json"


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=str)


def export_inference(path: str, model, config=None,
                     meta: Optional[dict] = None, step: int = 0,
                     params: Optional[Dict[str, torch.Tensor]] = None,
                     quantization: str = "off",
                     state: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Write `model`'s weights (parameters and BN running stats) as a
    serving artifact the JAX package's engine and the port's both load.
    `params` (the EMA copy, when training keeps one) replaces the model's
    parameters: the artifact is then EMA-resolved, the weights evaluation
    scores. `quantization="int8"` bakes the eligible weights as int8 with
    per-output-channel scales. `state` replaces `model.state_dict()` (the
    full weights gathered from a split model)."""
    if quantization not in QUANT_MODES:
        raise ValueError(
            f"export quantization must be one of {QUANT_MODES}, got "
            f"{quantization!r}")
    state = dict(model.state_dict() if state is None else state)
    if params is not None:
        state.update(params)
    if quantization == "int8":
        state, _ = quantize_tree(state)
    tree = jax_tree_from_state_dict(state)
    info = {
        "format": INFERENCE_FORMAT,
        "step": int(step),
        "ema_resolved": params is not None,
        "quantization": quantization,
        **(meta or {}),
    }
    if config is not None:
        info["config"] = config.to_dict()
    os.makedirs(path, exist_ok=True)
    retry_call(lambda: atomic_write(
        os.path.join(path, _WEIGHTS_FILE),
        lambda tmp: np.savez(tmp, **flatten_tree(tree))))
    retry_call(lambda: atomic_write_json(os.path.join(path, _META_FILE), info))
    return path


def load_inference(path: str) -> Tuple[dict, dict]:
    """Load an inference artifact -> (state_dict as numpy, meta); an int8
    weight comes as its quant leaf {"q8", "q8_scale"}."""
    meta_path = os.path.join(path, _META_FILE)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"{path} is not an inference artifact (no {_META_FILE}); a full "
            "training checkpoint dir cannot be served directly")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != INFERENCE_FORMAT:
        raise ValueError(
            f"unknown inference artifact format {meta.get('format')!r} in "
            f"{path} (expected {INFERENCE_FORMAT})")
    if (meta.get("quantization") or "off") not in QUANT_MODES:
        raise ValueError(
            f"artifact {path} has unknown quantization "
            f"{meta['quantization']!r} (expected one of {QUANT_MODES})")
    with np.load(os.path.join(path, _WEIGHTS_FILE)) as data:
        flat = {k: data[k] for k in data.files}
    return state_dict_from_jax(flat), meta


_STATE_FILE = "state.pt"
_EXTRA_FILE = "extra.json"


def _to_host(tree, pinned: bool):
    """`tree` (dicts, lists, tuples, tensors, plain values) with every
    tensor copied to host memory, and the CUDA event after the copies (None
    when nothing was on the card). `pinned`: card tensors go to pinned
    buffers by `non_blocking` copies on the current stream (complete once
    the event has) and host tensors are cloned; else card tensors are
    copied with a sync and host tensors kept as they are."""
    devices = set()

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        if not torch.is_tensor(x):
            return x
        x = x.detach()
        if not x.is_cuda:
            return x.clone() if pinned else x
        if not pinned:
            return x.cpu()
        devices.add(x.device)
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        return out

    host = copy(tree)
    event = None
    if devices:
        (device,) = devices
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return host, event


class Checkpointer:
    """Step-indexed training checkpoints under `directory` (format in the
    module docstring). `max_to_keep > 0` keeps only the newest that many.
    `reliability` (a `ReliabilityConfig`, its defaults when None) is the
    retry policy of a save: `ckpt_retries` total attempts, backoff shaped
    by `retry_{base_delay,max_delay,deadline}_s`. `use_async`: writes on
    the writer thread, fenced by `wait()` (the module docstring).
    `write_log` holds the last 64 saves' times on rank 0: `fence_s` (the
    wait for the save before it), `dispatch_s` (the rest of `save()` on the
    calling thread), `write_s` (from the dispatch until the files
    landed)."""

    def __init__(self, directory: str, max_to_keep: int = 0,
                 reliability: Optional[ReliabilityConfig] = None,
                 use_async: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(int(max_to_keep), 0)
        self.reliability = reliability or ReliabilityConfig()
        self.use_async = bool(use_async)
        self.write_log: deque = deque(maxlen=64)
        self._jobs: Optional[queue.Queue] = None  # made at the first async save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._unfenced = False  # a save not yet fenced (alike on every rank)

    def all_steps(self) -> List[int]:
        """The steps on disk, once the writes in flight have landed."""
        self.wait()
        return self._listed_steps()

    def _listed_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, _EXTRA_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, extra: Optional[dict] = None) -> None:
        """Write `state` (a TrainState) at `step`; a step already on disk is
        left as it is. An OSError retries the whole write. Every rank
        fences the save before it, then takes the (gathered) state; rank 0
        copies it to host memory and writes it: on the writer thread when
        asynchronous (every rank returns at once; `wait()` holds the
        barrier), else here (every rank returns after the write, at the
        barrier)."""
        t_fence = time.perf_counter()
        self.wait()
        t0 = time.perf_counter()
        with collective_section("ckpt_save", step=int(step)):
            full = state.state_dict()
            self._unfenced = True
            if is_main_process():
                host, event = _to_host(full, pinned=self.use_async)
                del full
                log = {"step": int(step), "fence_s": t0 - t_fence}
                job = (int(step), host, extra, event, t0, log)
                if self.use_async:
                    self._queue().put(job)
                else:
                    try:
                        self._run(job)
                    except BaseException:
                        self._unfenced = False  # raised here: nothing to fence
                        raise
                log["dispatch_s"] = time.perf_counter() - t0
        if not self.use_async:
            self.wait()

    def _queue(self) -> queue.Queue:
        if self._jobs is None:
            self._jobs = queue.Queue()
            self._writer = threading.Thread(target=self._drain, args=(self._jobs,),
                                            name="pva-ckpt-writer", daemon=True)
            self._writer.start()
        return self._jobs

    def _drain(self, jobs: queue.Queue) -> None:
        """The writer thread: one job at a time, until the None job. A
        written job's host copy is dropped before the next wait, so its
        pinned buffers go back to the allocator's cache for the next save."""
        while True:
            job = jobs.get()
            try:
                if job is None:
                    return
                self._run(job)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                if self._error is None:
                    self._error = e
            finally:
                job = None
                jobs.task_done()

    def _run(self, job) -> None:
        step, host, extra, event, t0, log = job
        if event is not None:
            event.synchronize()  # the host copies have landed
        self._write(step, host, extra)
        log["write_s"] = time.perf_counter() - t0
        self.write_log.append(log)

    def wait(self, barrier: bool = True, name: str = "checkpoint_save") -> None:
        """Fence: return once every queued write has landed, raising the
        first failed write's error, then meet the other ranks at the
        barrier `name` (`barrier=False`: this rank only). A no-op, without
        a barrier, when no save is pending (alike on every rank)."""
        if not self._unfenced:
            return
        self._unfenced = False
        with collective_section("ckpt_wait"):
            if self._jobs is not None:
                self._jobs.join()
            err, self._error = self._error, None
            if err is not None:
                raise err
            if barrier:
                sync_global_devices(name)

    def close(self, barrier: bool = True) -> None:
        """Fence (`wait(barrier)`, its barrier `checkpoint_close`), then
        stop the writer thread."""
        try:
            with collective_section("ckpt_close"):
                self.wait(barrier, name="checkpoint_close")
        finally:
            if self._jobs is not None:
                self._jobs.put(None)
                self._writer.join()
                self._jobs = self._writer = None

    def _write(self, step: int, full: dict, extra: Optional[dict]) -> None:
        step = int(step)
        final = os.path.join(self.directory, str(step))

        def save_once():
            # a failed attempt may have committed before it raised
            if os.path.exists(final):
                return
            os.makedirs(self.directory, exist_ok=True)
            tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            try:
                torch.save(full, os.path.join(tmp, _STATE_FILE))
                _write_json(os.path.join(tmp, _EXTRA_FILE), extra or {})
                os.replace(tmp, final)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)

        r = self.reliability
        retry_call(save_once, attempts=max(int(r.ckpt_retries), 1),
                   retry_on=(OSError,), base_delay_s=r.retry_base_delay_s,
                   max_delay_s=r.retry_max_delay_s,
                   deadline_s=r.retry_deadline_s)
        if self.max_to_keep:
            for old in self._listed_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def delete(self, step: int) -> None:
        """Remove checkpoint `step` (a guard ring revisiting a step index
        after a rollback replaces it) once the writes in flight have landed;
        rank 0 removes it."""
        self.wait()
        if is_main_process():
            shutil.rmtree(os.path.join(self.directory, str(int(step))),
                      ignore_errors=True)

    def restore(self, state, step: Optional[int] = None) -> Tuple[dict, int]:
        """Load checkpoint `step` (default: the latest) into `state` in
        place, once the writes in flight have landed; returns `(extra,
        step)`."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found in {self.directory}")
        with collective_section("ckpt_restore", step=int(step)):
            sync_global_devices("checkpoint_restore")
            d = os.path.join(self.directory, str(int(step)))
            device = next(state.model.parameters()).device
            saved = torch.load(os.path.join(d, _STATE_FILE), map_location=device,
                               weights_only=True)
            state.load_state_dict(saved)
        with open(os.path.join(d, _EXTRA_FILE)) as f:
            extra = json.load(f)
        return extra, int(step)


def resolve_resume_path(resume: str, output_dir: str) -> Optional[str]:
    """Map `--resume_from_checkpoint` onto a checkpoint directory: "" ->
    None; "auto" -> output_dir; an explicit path -> that path, or its parent
    when it names a step directory (`<dir>/<step>`, or the reference's
    `step_<i>` / `epoch_<i>`)."""
    if not resume:
        return None
    if resume == "auto":
        return output_dir
    resume = resume.rstrip("/")
    base = os.path.basename(resume)
    if base.isdigit():
        return os.path.dirname(resume)
    for prefix in ("step_", "epoch_"):
        if base.startswith(prefix) and base[len(prefix):].isdigit():
            return os.path.dirname(resume)
    return resume
