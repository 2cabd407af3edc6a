"""Inference artifacts: `export_inference` / `load_inference` (a subset of
the JAX package's `trainer/checkpoint.py`; training checkpoints are the next
slice).

The format is the JAX package's `pva-tpu-inference-v1`, so each side reads
the other's artifacts: a directory of
  weights.npz  flat {params/..., batch_stats/...} numpy arrays in the flax
               layout (models/convert.py maps them to the port's state_dict)
  meta.json    format tag, step, ema_resolved, quantization, num_classes,
               model name and the resolved TrainConfig dict
Both files land atomically (tmp file in the same directory, fsync,
os.replace), so a reader never finds a truncated artifact.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    jax_tree_from_state_dict,
    state_dict_from_jax,
)

INFERENCE_FORMAT = "pva-tpu-inference-v1"
_WEIGHTS_FILE = "weights.npz"
_META_FILE = "meta.json"


def _atomic_write(path: str, write_fn) -> None:
    d, base = os.path.split(path)
    root, ext = os.path.splitext(base)
    tmp = os.path.join(d, f".{root}.tmp-{os.getpid()}{ext}")
    try:
        write_fn(tmp)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=str)


def export_inference(path: str, model, config=None,
                     meta: Optional[dict] = None, step: int = 0) -> str:
    """Write `model`'s weights (parameters and BN running stats) as a
    serving artifact the JAX package's engine and the port's both load."""
    tree = jax_tree_from_state_dict(model.state_dict())
    info = {
        "format": INFERENCE_FORMAT,
        "step": int(step),
        "ema_resolved": False,
        "quantization": "off",
        **(meta or {}),
    }
    if config is not None:
        info["config"] = config.to_dict()
    os.makedirs(path, exist_ok=True)
    _atomic_write(os.path.join(path, _WEIGHTS_FILE),
                  lambda tmp: np.savez(tmp, **flatten_tree(tree)))
    _atomic_write(os.path.join(path, _META_FILE),
                  lambda tmp: _write_json(tmp, info))
    return path


def load_inference(path: str) -> Tuple[dict, dict]:
    """Load an inference artifact -> (state_dict as numpy, meta)."""
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
    if (meta.get("quantization") or "off") != "off":
        raise NotImplementedError(
            f"artifact {path} is quantized ({meta['quantization']}); "
            "serving/quantize.py is not ported yet (ROADMAP.md)")
    with np.load(os.path.join(path, _WEIGHTS_FILE)) as data:
        flat = {k: data[k] for k in data.files}
    return state_dict_from_jax(flat), meta
