"""Classification heads (counterpart of the JAX package's `models/heads.py`).

`ResBasicHead` is pytorchvideo's `create_res_basic_head`: optional global
average pool -> dropout -> linear projection. The projection runs in f32
whatever the compute dtype, so logits stay clean under bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import (
    SeededDropout,
    global_avg_pool,
)
from pytorchvideo_accelerate_tpu_torch.precision import f32_island


class ResBasicHead(nn.Module):
    """Global-avg-pool (optional) -> dropout -> linear `proj` (f32).

    `pool=False` is the SlowFast head, whose caller concatenates already
    pooled pathway features. Dropout is `SeededDropout` (train mode only,
    reseeded by the trainer)."""

    def __init__(self, in_features: int, num_classes: int,
                 dropout_rate: float = 0.5, pool: bool = True):
        super().__init__()
        self.pool = pool
        self.dropout = SeededDropout(dropout_rate)
        self.proj = nn.Linear(in_features, num_classes)

    def reset_parameters_like_jax(self, generator: torch.Generator) -> None:
        """normal(0.01) kernel and zero bias (pytorchvideo's head
        convention): initial logits stay small, so initial CE ~ ln(classes)."""
        with torch.no_grad():
            nn.init.normal_(self.proj.weight, 0.0, 0.01, generator=generator)
            self.proj.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool and x.dim() == 5:
            x = global_avg_pool(x)
        return self.proj(f32_island(self.dropout(x)))
