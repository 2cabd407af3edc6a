"""int8 weight quantization for the serving tier (`serve.quantization`;
the port's copy of the JAX package's `serving/quantize.py`, without the
streaming K/V ring's `quantize_kv`).

Weight-only: int8 weights with a per-OUTPUT-channel absmax scale, activations
in the compute dtype. A port state_dict key names a flax kernel with the
output axis first (OIDHW conv weights, (out, in) Linear weights, (C, 1, kt,
kh, kw) depthwise ones; models/convert.py), so the scale runs over dim 0 and
the absmax over every other dim. The arithmetic is the JAX package's, in
f32 numpy: `scale = absmax / 127` (a zero scale becomes 1), `q = rint(w /
scale)` clipped to [-127, 127]. A weight quantized here and the same weight
quantized by the JAX package are byte-equal, int8 and scale, once the int8
array is laid out like the other (`models/convert.py` carries the `q8` /
`q8_scale` leaves across).

Eligible: `weight` leaves with ndim >= 2 and at least `MIN_QUANT_SIZE`
elements (conv and Linear kernels). BN and LayerNorm weights, biases,
running statistics, `pos_embed` and `mask_token` stay in full precision.

In an engine (`quantize_module`) the int8 weight and its f32 scale are what
the module holds; a parametrization dequantizes at each use: `q * scale` in
f32 and one downcast to the compute dtype. So the dequantized copy of a
weight lives only while the module that reads it runs, and the weight
reaches the fused kernels through the same wrappers as a full-precision
one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from pytorchvideo_accelerate_tpu_torch.precision import end_island, f32_island

Q_KEY = "q8"
SCALE_KEY = "q8_scale"
QUANT_MODES = ("off", "int8")

# leaves below this many elements stay fp: biases and norm vectors are noise
# in the byte budget and carry outsized accuracy weight
MIN_QUANT_SIZE = 1024


def is_quant_leaf(x: Any) -> bool:
    """True for the {"q8": ..., "q8_scale": ...} marker dicts."""
    return isinstance(x, Mapping) and set(x.keys()) == {Q_KEY, SCALE_KEY}


def _numpy(w) -> np.ndarray:
    return w.detach().cpu().numpy() if torch.is_tensor(w) else np.asarray(w)


def _eligible(name: str, arr) -> bool:
    shape = tuple(np.shape(arr)) if not torch.is_tensor(arr) else tuple(arr.shape)
    return (name.rpartition(".")[2] == "weight" and len(shape) >= 2
            and int(np.prod(shape)) >= MIN_QUANT_SIZE)


def quantize_array(w) -> Dict[str, np.ndarray]:
    """Per-output-channel (dim 0) absmax int8 quantization of one weight."""
    w32 = _numpy(w).astype(np.float32)
    absmax = np.max(np.abs(w32), axis=tuple(range(1, w32.ndim)))
    scale = (absmax / 127.0).astype(np.float32)
    # an all-zero channel must not divide by zero; its q rows are zero
    safe = np.where(scale > 0, scale, 1.0).astype(np.float32)
    per_row = safe.reshape((-1,) + (1,) * (w32.ndim - 1))
    q = np.clip(np.rint(w32 / per_row), -127, 127).astype(np.int8)
    return {Q_KEY: q, SCALE_KEY: safe}


def quantize_tree(state: Mapping[str, Any]) -> Tuple[dict, int]:
    """A state_dict (tensors or arrays) -> (the same keys with every
    eligible weight replaced by its quant leaf, #leaves quantized). Leaves
    already quantized pass through unchanged (idempotent)."""
    out, n = {}, 0
    for name, v in state.items():
        if not is_quant_leaf(v) and _eligible(name, v):
            v = quantize_array(v)
            n += 1
        out[name] = v
    return out, n


def dequantize_array(q: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """`q * scale` per output channel in f32, one downcast to `dtype`."""
    per_row = scale.view((-1,) + (1,) * (q.dim() - 1))
    return end_island(f32_island(q) * per_row, dtype)


def dequantize_tree(state: Mapping[str, Any], dtype: torch.dtype) -> dict:
    """Every quant leaf of `state` dequantized to a `dtype` tensor; the
    other leaves as tensors, unchanged."""
    out = {}
    for name, v in state.items():
        if is_quant_leaf(v):
            v = dequantize_array(torch.as_tensor(v[Q_KEY]),
                                 torch.as_tensor(v[SCALE_KEY]), dtype)
        out[name] = torch.as_tensor(v)
    return out


def quantized_leaf_count(state: Mapping[str, Any]) -> int:
    return sum(1 for v in state.values() if is_quant_leaf(v))


def quant_bytes(state: Mapping[str, Any]) -> Dict[str, int]:
    """{quantized, fp} payload bytes: int8 weights + f32 scales, and every
    other leaf."""
    q = fp = 0
    for v in state.values():
        if is_quant_leaf(v):
            q += int(np.size(v[Q_KEY])) + 4 * int(np.size(v[SCALE_KEY]))
        elif torch.is_tensor(v):
            fp += v.numel() * v.element_size()
        else:
            fp += int(np.asarray(v).nbytes)
    return {"quantized": q, "fp": fp}


class _Dequant(nn.Module):
    """The parametrization of a quantized weight: the module holds the int8
    tensor, and each read of `module.weight` returns `q * scale` in f32,
    downcast once to `dtype` (and cast to `out_dtype` for a consumer that
    computes in another dtype: an f32 head reads the bf16-rounded weight in
    f32, as flax promotes a bf16 kernel in an f32 Dense)."""

    def __init__(self, scale: torch.Tensor, dtype: torch.dtype,
                 out_dtype: torch.dtype):
        super().__init__()
        self.register_buffer("scale", scale)
        self.dtype = dtype
        self.out_dtype = out_dtype

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return dequantize_array(q, self.scale, self.dtype).to(self.out_dtype)


def quantize_module(model: nn.Module, qstate: Mapping[str, Any],
                    dtype: torch.dtype) -> int:
    """Replace the weight of every module named by a quant leaf of `qstate`
    (state_dict key `<path>.weight`) by its int8 tensor and scale, read
    through a `_Dequant` parametrization in `dtype`. A plain `nn.Linear` is
    a classifier head whose forward runs in f32: its weight is read in its
    own dtype after the downcast. Returns the number of weights replaced."""
    n = 0
    for name, v in qstate.items():
        if not is_quant_leaf(v):
            continue
        path, _, leaf = name.rpartition(".")
        module = model.get_submodule(path)
        old = getattr(module, leaf)
        out_dtype = old.dtype if type(module) is nn.Linear else dtype
        q = torch.as_tensor(np.ascontiguousarray(v[Q_KEY])).to(old.device)
        if tuple(q.shape) != tuple(old.shape):
            raise ValueError(f"quantized {name} has shape {tuple(q.shape)}, "
                             f"the model's is {tuple(old.shape)}")
        scale = torch.as_tensor(np.asarray(v[SCALE_KEY], np.float32)).to(old.device)
        delattr(module, leaf)
        setattr(module, leaf, nn.Parameter(q, requires_grad=False))
        parametrize.register_parametrization(
            module, leaf, _Dequant(scale, dtype, out_dtype), unsafe=True)
        n += 1
    return n
