"""Batch plumbing shared by evaluation and serving (a subset of the JAX
package's `trainer/steps.py`; the train step is the next slice).

Batch convention: dict with "video" (single-pathway) or "slow"/"fast"
(SlowFast packing), each clip NDHWC.
"""

from __future__ import annotations

from typing import Callable

import torch

from pytorchvideo_accelerate_tpu_torch.precision import f32_island


def model_inputs(batch: dict):
    """Map a batch dict to the model's input convention."""
    if "slow" in batch:
        return (batch["slow"], batch["fast"])
    return batch["video"]


def device_normalize_batch(batch: dict, norm) -> dict:
    """Normalize uint8 clips on the device: the host ships raw uint8 (4x less
    host->device transfer than f32) and this applies the `x/255` + mean/std
    affine in f32. No-op when `norm` is None or a clip is already floating
    point."""
    if norm is None:
        return batch
    mean, std = norm

    def f(x):
        if x.dtype != torch.uint8:
            return x
        mean32 = torch.tensor(mean, dtype=torch.float32, device=x.device)
        std32 = torch.tensor(std, dtype=torch.float32, device=x.device)
        return f32_island(x) * (1.0 / (255.0 * std32)) + (-mean32 / std32)

    out = dict(batch)
    for k in ("video", "slow", "fast"):
        if k in out:
            out[k] = f(out[k])
    return out


def fold_views(inputs):
    """Fold the per-video view axis into the batch dim: (B, V, T, H, W, C)
    leaves become (B*V, T, H, W, C); rank-5 inputs pass through. Returns
    `(inputs, num_views)`, for one tensor or the (slow, fast) tuple."""
    first = inputs[0] if isinstance(inputs, tuple) else inputs
    num_views = first.shape[1] if first.dim() == 6 else 1
    if num_views > 1:
        fold = lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])  # noqa: E731
        inputs = (tuple(fold(x) for x in inputs)
                  if isinstance(inputs, tuple) else fold(inputs))
    return inputs, num_views


def multiview_logits(forward: Callable, inputs):
    """Fold views into the batch, run one forward, then average the logits
    over views in f32 before any argmax (the eval protocol the serving
    engine shares)."""
    inputs, num_views = fold_views(inputs)
    logits = forward(inputs)
    if num_views > 1:
        logits = f32_island(logits).reshape(
            -1, num_views, logits.shape[-1]).mean(dim=1)
    return logits
