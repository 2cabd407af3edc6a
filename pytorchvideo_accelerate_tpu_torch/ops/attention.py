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
- "ring" / "ulysses": context-parallel attention over the train mesh's
  model axis or the library mesh's context axis
  (`parallel/ring_attention.py`, `parallel/ulysses.py`, through
  `cp_attention` over `distributed.context_group()`): the token axis split
  over the context group's ranks inside attention (on a rank's local
  heads where tensor parallelism split them), the full result on every
  rank after it. Without a context axis they run on one rank (one ring
  block; Ulysses's local flash attention).

Shapes: q (B, Nq, H, D), k/v (B, Nk, H, D) -> (B, Nq, H, D).

`mask`: optional bool broadcastable to (B, H, Nq, Nk), True = attend (the
causal/windowed VideoMAE trunks, built by `temporal_band_mask`). Dense
only: the flash kernels and the context-parallel backends have no masked
lowering and refuse a mask rather than drop it.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorchvideo_accelerate_tpu_torch.ops.flash_attention import flash_attention
from pytorchvideo_accelerate_tpu_torch.parallel.distributed import context_group
from pytorchvideo_accelerate_tpu_torch.parallel.ring_attention import (
    cp_attention,
    ring_attention,
)
from pytorchvideo_accelerate_tpu_torch.parallel.ulysses import ulysses_attention
from pytorchvideo_accelerate_tpu_torch.precision import f32_island

ATTENTION_BACKENDS = ("dense", "pallas", "ring", "ulysses")


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
    """Raise for an unknown backend."""
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
    if backend == "ring":
        return cp_attention(q, k, v, ring_attention, context_group())
    if backend == "ulysses":
        return cp_attention(q, k, v, ulysses_attention, context_group())
    return flash_attention(q, k, v)
