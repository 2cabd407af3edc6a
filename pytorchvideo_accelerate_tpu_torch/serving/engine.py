"""The inference engine: weights pinned on one device + bucketed forwards.

Counterpart of the JAX package's `serving/engine.py`, single-device
(`shards` = 1). It restores an `export_inference` artifact, pins the weights
on `device` once, and runs batched forwards under `torch.inference_mode()`.

Buckets: the batcher pads every launch up to the nearest bucket (a doubling
ladder up to `max_batch_size`), so the device sees a handful of batch shapes;
`predict` refuses any other batch size. Padded rows ride a mask and are
stripped by the batcher before responses resolve.

The forward is `device_normalize_batch` -> `multiview_logits` over the
eval weights, the op sequence of the eval step, so serving top-1 matches
evaluation.

Quantization (`quantization="int8"`, serving/quantize.py): the engine
holds int8 weights with f32 per-output-channel scales, and each quantized
module dequantizes its weight when it runs (`q * scale` in f32, one
downcast to the compute dtype), so no full-precision copy of the model
stays resident and the weight reaches the same kernels. `from_artifact`
resolves the mode as the JAX engine does: an explicit argument, then the
artifact's baked `meta.quantization`, then its embedded
`serve.quantization`; a baked int8 artifact always serves int8.

Device: the engine runs on the CUDA card unless the caller passes
`device="cpu"`; on a host without CUDA it raises instead of falling back.

Memory ledger (obs/memory.py, armed by the server with `obs.enabled`):
the resident weights (parameters and buffers as they sit on the device,
int8 weights at their int8 size) register as component
`model_weights:<model name>`; `release_memory()` (the server's close)
returns them.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pytorchvideo_accelerate_tpu_torch.obs import memory as obs_memory
from pytorchvideo_accelerate_tpu_torch.precision import (
    f32_island,
    policy_compute_dtype,
)
from pytorchvideo_accelerate_tpu_torch.serving.quantize import (
    QUANT_MODES,
    is_quant_leaf,
    quant_bytes,
    quantize_module,
    quantize_tree,
    quantized_leaf_count,
)
from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
    device_normalize_batch,
    model_inputs,
    multiview_logits,
)

logger = logging.getLogger("pva_tpu_torch")

# the batch-dict clip leaves (batcher.py and server.py import this one)
CLIP_KEYS = ("video", "slow", "fast")


def resolve_device(device=None) -> torch.device:
    """`device` as given, else the CUDA card; raises when none is there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the PyTorch port runs on the GPU unless asked "
            "for the CPU (--cpu, or device='cpu' on the Python API)")
    return torch.device("cuda")


def clip_key(clips: Dict[str, Any]) -> tuple:
    """Geometry key for a clip dict: ((name, shape), ...) sorted by name —
    the unit of batch grouping (batcher) and of the engine's seen-shapes."""
    return tuple((k, tuple(np.shape(clips[k]))) for k in sorted(clips))


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def compute_buckets(max_batch_size: int, shards: int) -> Tuple[int, ...]:
    """Padding targets: shard-aligned sizes on a doubling ladder up to
    max_batch_size (each rung the smallest shard multiple >= a power-of-two
    target; duplicate rungs collapse)."""
    shards = max(int(shards), 1)
    top = _round_up(max(max_batch_size, 1), shards)
    buckets = []
    target = 1
    while True:
        b = _round_up(target, shards)
        if b >= top:
            break
        if not buckets or b != buckets[-1]:
            buckets.append(b)
        target *= 2
    buckets.append(top)
    return tuple(buckets)


class InferenceEngine:
    """Batched forwards over weights pinned on one device.

    `predict` takes a host batch dict (clip leaves (B, T, H, W, C) or
    (B, V, T, H, W, C), optional "mask") and returns f32 logits
    (B, num_classes) for every row, padded ones included; the batcher never
    resolves a padded row into a response. `quantization="int8"` quantizes
    a full-precision `state_dict` (or the model's own weights) on the fly;
    a `state_dict` that already holds quant leaves (an int8 artifact) is
    used as it is. `compute_dtype` is the dtype the weights dequantize to
    (default bf16)."""

    def __init__(self, model: torch.nn.Module,
                 state_dict: Optional[Dict[str, Any]] = None, *,
                 num_classes: int, max_batch_size: int = 8,
                 device_normalize=None, input_dtype: str = "float32",
                 model_name: str = "", stats=None, device=None,
                 quantization: str = "off",
                 compute_dtype: Optional[torch.dtype] = None):
        if quantization not in QUANT_MODES:
            raise ValueError(
                f"serve.quantization must be one of {QUANT_MODES}, got "
                f"{quantization!r}")
        self.device = resolve_device(device)
        self.quantization = quantization
        if state_dict is None and quantization == "int8":
            state_dict = model.state_dict()
        qstate: Dict[str, Any] = {}
        if state_dict is not None:
            if quantization == "int8" and not quantized_leaf_count(state_dict):
                # on the fly: the arithmetic of a baked artifact
                state_dict, n = quantize_tree(state_dict)
                logger.info("engine: quantized %d weight leaves to int8 (%s)",
                            n, quant_bytes(state_dict))
            qstate = {k: v for k, v in state_dict.items() if is_quant_leaf(v)}
            if qstate and quantization != "int8":
                raise ValueError(
                    "state_dict holds int8 weights; serve it with "
                    "quantization='int8'")
            missing, unexpected = model.load_state_dict(
                {k: torch.as_tensor(np.asarray(v))
                 for k, v in state_dict.items() if k not in qstate},
                strict=False)
            if unexpected or set(missing) != set(qstate):
                raise RuntimeError(
                    f"state_dict does not match the model: missing "
                    f"{sorted(set(missing) - set(qstate))}, unexpected "
                    f"{sorted(unexpected)}")
        if qstate:
            # before the move: only int8 weights and scales reach the card
            quantize_module(model, qstate,
                            compute_dtype if compute_dtype is not None
                            else torch.bfloat16)
        # pin the weights on the device once; every forward reuses them
        self.model = model.eval().to(self.device)
        self.num_classes = int(num_classes)
        self.model_name = model_name
        self.input_dtype = input_dtype
        self.stats = stats
        self._device_normalize = device_normalize
        self.shards = 1
        self.buckets = compute_buckets(max_batch_size, self.shards)
        # the (name, shape) keys of every batch geometry run, in first-run
        # order (a dict as an ordered set): `compiled_keys`
        self._seen: Dict[tuple, None] = {}
        self._lock = threading.Lock()
        # the ledger: the weights as resident on the device
        self._mem_component = f"model_weights:{model_name or 'engine'}"
        self._weight_bytes = obs_memory.tree_nbytes(self.model)
        obs_memory.register(self._mem_component, self._weight_bytes)
        # set by from_artifact: the training run's resolved TrainConfig
        self.artifact_config = None

    def release_memory(self) -> None:
        """Return this engine's ledger component (the retire hook; an
        engine dropped without it leaves its bytes attributed)."""
        obs_memory.release(self._mem_component)

    @classmethod
    def from_artifact(cls, path: str, device=None, *,
                      max_batch_size: Optional[int] = None,
                      stats=None,
                      quantization: Optional[str] = None) -> "InferenceEngine":
        """Restore an `export_inference` artifact (either package's) into a
        ready engine: rebuild the model from the artifact's config, load its
        weights, pin them on `device`. `quantization`: an explicit mode,
        else the artifact's baked one, else its `serve.quantization`."""
        from pytorchvideo_accelerate_tpu_torch.config import (
            TrainConfig,
            config_from_dict,
        )
        from pytorchvideo_accelerate_tpu_torch.models import create_model
        from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import (
            load_inference,
        )

        device = resolve_device(device)
        state_dict, meta = load_inference(path)
        cfg = (config_from_dict(meta["config"]) if meta.get("config")
               else TrainConfig())
        art_q = meta.get("quantization") or "off"
        eff_q = (quantization if quantization is not None
                 else (art_q if art_q != "off" else cfg.serve.quantization))
        if art_q == "int8" and eff_q == "off":
            logger.warning(
                "artifact %s is baked int8; the fp weights no longer "
                "exist: serving int8 despite quantization='off'", path)
            eff_q = "int8"
        num_classes = int(meta.get("num_classes") or cfg.model.num_classes)
        if not num_classes:
            raise ValueError(
                f"artifact {path} carries no num_classes (meta.json) and its "
                "config has none — cannot size the classifier head")
        cfg.model.num_classes = num_classes
        model = create_model(cfg.model, cfg.mixed_precision, data_cfg=cfg.data)
        # u8-trained runs ship raw uint8 clips and normalize on the device
        u8 = cfg.data.host_cast == "u8"
        engine = cls(
            model, state_dict, num_classes=num_classes,
            max_batch_size=(max_batch_size if max_batch_size is not None
                            else cfg.serve.max_batch_size),
            device_normalize=(cfg.data.mean, cfg.data.std) if u8 else None,
            input_dtype="uint8" if u8 else "float32",
            model_name=meta.get("model") or cfg.model.name,
            stats=stats, device=device, quantization=eff_q,
            compute_dtype=policy_compute_dtype(cfg.mixed_precision))
        engine.artifact_config = cfg
        return engine

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding `n` rows."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest bucket {self.buckets[-1]} "
            f"(serve.max_batch_size)")

    def predict(self, batch: Dict[str, Any]) -> np.ndarray:
        """f32 logits (B, num_classes) for a host batch whose B is one of
        `self.buckets`. Non-clip keys ("mask", "label") are ignored."""
        clips = {k: np.asarray(batch[k]) for k in CLIP_KEYS if k in batch}
        if not clips:
            raise ValueError("batch has neither 'video' nor 'slow'/'fast'")
        n = next(iter(clips.values())).shape[0]
        if n not in self.buckets:
            raise ValueError(
                f"batch size {n} is not a bucket {self.buckets}; pad to "
                "bucket_for(n) first")
        key = clip_key(clips)
        with torch.inference_mode():
            placed = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                      for k, v in clips.items()}
            placed = device_normalize_batch(placed, self._device_normalize)
            logits = multiview_logits(self.model, model_inputs(placed))
            out = f32_island(logits).cpu().numpy()
        with self._lock:
            first = key not in self._seen
            self._seen[key] = None
        if first and self.stats is not None:
            # a new geometry: its first forward pays cuDNN's algorithm pick
            self.stats.observe_compile()
        return out

    @property
    def compiled_keys(self) -> tuple:
        """Every batch geometry `predict` has run, as ((name, (B, ...)),
        ...) keys in first-run order: the JAX engine's compiled-bucket keys,
        which `fleet/hotswap.prewarm_like` runs on a green engine before
        cutover so its first requests pay no first-call cost."""
        with self._lock:
            return tuple(self._seen)

    def warmup(self, sample_clip: Dict[str, np.ndarray]) -> None:
        """Run every bucket once for one request geometry so first requests
        pay no first-call cost: `sample_clip` is ONE request's clip dict."""
        for b in self.buckets:
            batch = {k: np.broadcast_to(v, (b,) + tuple(np.shape(v))).copy()
                     for k, v in sample_clip.items()}
            self.predict(batch)
