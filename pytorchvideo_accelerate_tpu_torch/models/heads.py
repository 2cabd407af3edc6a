"""Classification heads (counterpart of the JAX package's `models/heads.py`).

`ResBasicHead` is pytorchvideo's `create_res_basic_head`: optional global
average pool -> dropout -> linear projection. The projection runs in f32
whatever the compute dtype, so logits stay clean under bf16.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import global_avg_pool
from pytorchvideo_accelerate_tpu_torch.precision import f32_island


class ResBasicHead(nn.Module):
    """Global-avg-pool (optional) -> dropout -> linear `proj` (f32).

    `pool=False` is the SlowFast head, whose caller concatenates already
    pooled pathway features. Dropout (train mode only) draws its mask from
    an explicit generator seeded by `reseed` (the trainer reseeds it from
    (seed, step) every optimizer step, as the JAX package derives its
    dropout key), with flax's semantics: keep with probability 1 - rate and
    scale the kept values by 1 / (1 - rate)."""

    def __init__(self, in_features: int, num_classes: int,
                 dropout_rate: float = 0.5, pool: bool = True):
        super().__init__()
        self.pool = pool
        self.dropout_rate = dropout_rate
        self.proj = nn.Linear(in_features, num_classes)
        self.reseed(0)

    def reseed(self, seed: int) -> None:
        self._seed = int(seed)
        self._generators: Dict[torch.device, torch.Generator] = {}

    def _generator(self, device: torch.device) -> torch.Generator:
        g = self._generators.get(device)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed(self._seed)
            self._generators[device] = g
        return g

    def dropout(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.dropout_rate == 0.0:
            return x
        keep = 1.0 - self.dropout_rate
        mask = torch.rand(x.shape, generator=self._generator(x.device),
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

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
