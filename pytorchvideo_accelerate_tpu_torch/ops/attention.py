"""Attention backends (counterpart of the JAX package's `ops/attention.py`).

The transformer models (MViT, VideoMAE) call one entry point,
`dot_product_attention(q, k, v, backend, mask=None)`, so the attention
implementation is a deployment choice (`--model.attention`), not a model
choice:

- "dense": `dense_attention`, plain PyTorch: f32 logits from the f32
  operands, softmax in f32, probabilities cast to q's dtype, then P V. The
  port never calls `F.scaled_dot_product_attention`.
- "pallas": `flash_attention` (ops/flash_attention.py), the hand kernels on
  the card; the name is kept so configs cross with the JAX package.
- "ring" / "ulysses": context-parallel attention over several devices;
  not ported (the multi-GPU item of ROADMAP.md), they raise.

Shapes: q (B, Nq, H, D), k/v (B, Nk, H, D) -> (B, Nq, H, D).

`mask`: optional bool broadcastable to (B, H, Nq, Nk), True = attend (the
causal/windowed VideoMAE trunks, built by `temporal_band_mask`). Dense
only: the flash kernels have no masked lowering and refuse a mask rather
than drop it.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorchvideo_accelerate_tpu_torch.ops.flash_attention import flash_attention
from pytorchvideo_accelerate_tpu_torch.precision import f32_island

ATTENTION_BACKENDS = ("dense", "pallas", "ring", "ulysses")
_MULTI_DEVICE = ("ring", "ulysses")


def dense_attention(q, k, v, scale: Optional[float] = None, mask=None):
    """Reference attention: f32 logits, f32 softmax, probabilities in q's
    dtype; `mask` True = attend (masked logits take -1e30)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", f32_island(q), f32_island(k)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), -1e30, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def banded_time_mask(q_idx, k_idx, window: int):
    """Query slot qi may attend key slot kj iff 0 <= qi - kj < window:
    (..., Nq) and (..., Nk) int tensors -> (..., Nq, Nk) bool."""
    delta = q_idx[..., :, None] - k_idx[..., None, :]
    return (delta >= 0) & (delta < window)


def temporal_band_mask(t: int, hw: int, window: int, device=None):
    """(t*hw, t*hw) bool mask of a full-clip trunk: token i at temporal
    slot i // hw attends token j iff slot(j) is within the trailing
    `window` slots of slot(i), its own included. `window >= t` is plain
    temporal causality; space is never masked."""
    slots = torch.arange(t, dtype=torch.int32, device=device)
    band = banded_time_mask(slots, slots, window)
    return band.repeat_interleave(hw, dim=0).repeat_interleave(hw, dim=1)


def check_backend(backend: str) -> None:
    """Raise for a backend the port cannot run."""
    if backend in _MULTI_DEVICE:
        raise NotImplementedError(
            f"attention backend {backend!r} (context-parallel, several "
            "devices) is not ported to PyTorch yet (the multi-GPU item of "
            "ROADMAP.md); use dense or pallas")
    if backend not in ATTENTION_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected one "
                         f"of {ATTENTION_BACKENDS}")


def dot_product_attention(q, k, v, backend: str = "dense", mask=None):
    """Route to an attention implementation (see the module docstring)."""
    if backend == "dense":
        return dense_attention(q, k, v, mask=mask)
    if mask is not None:
        raise NotImplementedError(
            f"attention backend {backend!r} has no masked lowering; "
            "causal/windowed trunks need backend='dense' (model.attention)")
    check_backend(backend)
    return flash_attention(q, k, v)
