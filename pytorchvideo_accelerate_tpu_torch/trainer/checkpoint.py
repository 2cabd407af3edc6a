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
In a data-parallel job (`parallel/`) every rank holds the same state:
rank 0 writes and prunes, then every rank meets at a barrier, so no rank
reads or lists the directory before the write has landed; a restore
starts with a barrier too, and every rank then loads the same file. On
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
import shutil
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


class Checkpointer:
    """Step-indexed training checkpoints under `directory` (format in the
    module docstring). `max_to_keep > 0` keeps only the newest that many.
    `reliability` (a `ReliabilityConfig`, its defaults when None) is the
    retry policy of a save: `ckpt_retries` total attempts, backoff shaped
    by `retry_{base_delay,max_delay,deadline}_s`."""

    def __init__(self, directory: str, max_to_keep: int = 0,
                 reliability: Optional[ReliabilityConfig] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(int(max_to_keep), 0)
        self.reliability = reliability or ReliabilityConfig()

    def all_steps(self) -> List[int]:
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
        takes the (gathered) state, rank 0 writes it; every rank returns
        after the write, at a barrier."""
        full = state.state_dict()
        if is_main_process():
            self._write(step, full, extra)
        sync_global_devices("checkpoint_save")

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
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def delete(self, step: int) -> None:
        """Remove checkpoint `step` (a guard ring revisiting a step index
        after a rollback replaces it); rank 0 only, the save after it
        fences."""
        if is_main_process():
            shutil.rmtree(os.path.join(self.directory, str(int(step))),
                      ignore_errors=True)

    def restore(self, state, step: Optional[int] = None) -> Tuple[dict, int]:
        """Load checkpoint `step` (default: the latest) into `state` in
        place; returns `(extra, step)`."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found in {self.directory}")
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
