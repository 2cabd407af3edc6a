"""The precision policy seam: every deliberate f32 island goes through here.

Counterpart of the JAX package's `precision.py`. Models compute in bf16 by
policy, parameters stay f32, and a few sites are designed to run in f32
anyway (classifier heads, norm affines, kernel accumulators and epilogues).
Those casts go through `f32_island` / `end_island`, so each one states that
the excursion is deliberate.
"""

from __future__ import annotations

import torch

ISLAND_DTYPE = torch.float32


def f32_island(x: torch.Tensor) -> torch.Tensor:
    """Cast `x` to float32 at a designed f32 island."""
    return x.to(ISLAND_DTYPE)


def end_island(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Close an f32 island: cast back to the compute dtype at the designed
    boundary (the single store of a fused epilogue or accumulator)."""
    return x.to(dtype)


def policy_compute_dtype(mixed_precision: str) -> torch.dtype:
    """Model compute dtype for a TrainConfig.mixed_precision string: bf16
    for "bf16"/"fp16" (fp16 maps to bf16, no loss scaling), f32 otherwise."""
    return torch.bfloat16 if mixed_precision in ("bf16", "fp16") else torch.float32
