"""Slow-R50: single-pathway 3D ResNet (counterpart of the JAX package's
`models/resnet3d.py`; also builds `tiny3d` and `c2d_r50`).

- stem: 1x7x7 conv stride (1,2,2) -> 64ch, BN, ReLU, 1x3x3 maxpool s(1,2,2)
- res2..res5: bottleneck depths (3,4,6,3), outputs (256,512,1024,2048),
  temporal kernels (1,1,3,3); spatial stride 2 at each stage entry but res2
- head: global avg pool -> dropout -> linear

Input: (B, T, H, W, 3) NDHWC, normalized frames.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import (
    ConvBNAct,
    ResStage,
    max_pool_3d,
    to_channels_last,
)
from pytorchvideo_accelerate_tpu_torch.models.heads import ResBasicHead


class SlowR50(nn.Module):
    def __init__(self, num_classes: int, depths: Tuple[int, ...] = (3, 4, 6, 3),
                 stem_features: int = 64,
                 temporal_kernels: Tuple[int, ...] = (1, 1, 3, 3),
                 stage1_temporal_pool: bool = False,
                 dropout_rate: float = 0.5, fused: str = "off",
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depths = tuple(depths)
        # c2d_r50: the (2,1,1) temporal max-pool pytorchvideo inserts after res2
        self.stage1_temporal_pool = stage1_temporal_pool
        self.stem = ConvBNAct(3, stem_features, (1, 7, 7), stride=(1, 2, 2),
                              dtype=dtype)
        inner, out, cin = stem_features, stem_features * 4, stem_features
        for i, depth in enumerate(self.depths):
            self.add_module(f"res{i + 2}", ResStage(
                depth, cin, inner, out, temporal_kernels[i],
                1 if i == 0 else 2, fused, dtype))
            cin, inner, out = out, inner * 2, out * 2
        self.head = ResBasicHead(cin, num_classes, dropout_rate)

    @staticmethod
    def backbone_param_filter(path: Tuple[str, ...]) -> bool:
        """True for backbone (non-head) params, the ones
        `--model.freeze_backbone` freezes."""
        return path[0] != "head"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(to_channels_last(x.to(self.dtype)))
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        for i in range(len(self.depths)):
            x = getattr(self, f"res{i + 2}")(x)
            if i == 0 and self.stage1_temporal_pool:
                x = F.max_pool3d(x, (2, 1, 1), (2, 1, 1))
        return self.head(x)
