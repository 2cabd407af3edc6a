"""SlowFast networks (R50/R101), counterpart of the JAX package's
`models/slowfast.py` (Feichtenhofer et al. 2019, pytorchvideo's constants):

- two pathways: Slow (T/alpha frames, C channels) and Fast (T frames, C/8
  channels, temporal convs throughout)
- lateral fast->slow fusion after stem, res2, res3, res4: a (7,1,1) conv with
  stride (alpha,1,1) to 2x fast channels, concatenated onto the slow feature
- head: per-pathway global average pool, concat (2048+256=2304) -> dropout ->
  linear

Input: `(slow, fast)`, slow (B, T/alpha, H, W, 3), fast (B, T, H, W, 3), NDHWC.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import (
    ConvBNAct,
    ResStage,
    global_avg_pool,
    max_pool_3d,
    to_channels_last,
)
from pytorchvideo_accelerate_tpu_torch.models.heads import ResBasicHead


class FuseFastToSlow(nn.Module):
    """Time-strided (7,1,1) conv lateral, stride (alpha,1,1), 2x fast ch."""

    def __init__(self, fast_features: int, alpha: int, fusion_ratio: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.conv_f2s = ConvBNAct(fast_features, fast_features * fusion_ratio,
                                  (7, 1, 1), stride=(alpha, 1, 1), dtype=dtype)

    def forward(self, slow, fast):
        lateral = self.conv_f2s(fast)
        return torch.cat([slow, lateral], dim=1), fast


class SlowFast(nn.Module):
    def __init__(self, num_classes: int, depths: Tuple[int, ...] = (3, 4, 6, 3),
                 alpha: int = 4, beta_inv: int = 8, fusion_ratio: int = 2,
                 stem_features: int = 64,
                 slow_temporal_kernels: Tuple[int, ...] = (1, 1, 3, 3),
                 dropout_rate: float = 0.5, fused: str = "off",
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depths = tuple(depths)
        self.alpha = alpha  # the streaming engine's slow-ring rate
        fast_stem = stem_features // beta_inv  # 8 for r50
        self.slow_stem = ConvBNAct(3, stem_features, (1, 7, 7),
                                   stride=(1, 2, 2), dtype=dtype)
        self.fast_stem = ConvBNAct(3, fast_stem, (5, 7, 7), stride=(1, 2, 2),
                                   dtype=dtype)
        self.fuse_stem = FuseFastToSlow(fast_stem, alpha, fusion_ratio, dtype)
        slow_in = stem_features + fast_stem * fusion_ratio
        fast_in = fast_stem
        slow_inner, fast_inner = stem_features, fast_stem
        for i, depth in enumerate(self.depths):
            stride = 1 if i == 0 else 2
            self.add_module(f"slow_res{i + 2}", ResStage(
                depth, slow_in, slow_inner, slow_inner * 4,
                slow_temporal_kernels[i], stride, fused, dtype))
            # fast pathway: temporal convs everywhere
            self.add_module(f"fast_res{i + 2}", ResStage(
                depth, fast_in, fast_inner, fast_inner * 4, 3, stride, fused,
                dtype))
            slow_in, fast_in = slow_inner * 4, fast_inner * 4
            if i < len(self.depths) - 1:  # no fusion after res5
                self.add_module(f"fuse_res{i + 2}", FuseFastToSlow(
                    fast_inner * 4, alpha, fusion_ratio, dtype))
                slow_in += fast_inner * 4 * fusion_ratio
            slow_inner *= 2
            fast_inner *= 2
        self.head = ResBasicHead(slow_in + fast_in, num_classes, dropout_rate,
                                 pool=False)

    @staticmethod
    def backbone_param_filter(path: Tuple[str, ...]) -> bool:
        """True for backbone (non-head) params, the ones
        `--model.freeze_backbone` freezes."""
        return path[0] != "head"

    def forward(self, pathways) -> torch.Tensor:
        slow, fast = pathways
        slow = self.slow_stem(to_channels_last(slow.to(self.dtype)))
        fast = self.fast_stem(to_channels_last(fast.to(self.dtype)))
        slow = max_pool_3d(slow, (1, 3, 3), (1, 2, 2))
        fast = max_pool_3d(fast, (1, 3, 3), (1, 2, 2))
        slow, fast = self.fuse_stem(slow, fast)
        for i in range(len(self.depths)):
            slow = getattr(self, f"slow_res{i + 2}")(slow)
            fast = getattr(self, f"fast_res{i + 2}")(fast)
            if i < len(self.depths) - 1:
                slow, fast = getattr(self, f"fuse_res{i + 2}")(slow, fast)
        # pool per pathway, then concat: 2048 + 256 = 2304 for r50
        pooled = torch.cat([global_avg_pool(slow), global_avg_pool(fast)],
                           dim=-1)
        return self.head(pooled)
