"""R(2+1)D-50, counterpart of the JAX package's `models/r2plus1d.py` (Tran
et al. 2018, "A Closer Look at Spatiotemporal Convolutions for Action
Recognition", pytorchvideo's `create_r2plus1d`; hub `r2plus1d_r50`,
Kinetics-400 16x4):

- stem: (1,7,7) conv stride (1,2,2) + BN + ReLU, never fused, no max pool
- res2..res5: bottleneck depths (3,4,6,3), outputs (256,512,1024,2048);
  each block is (1,1,1) `conv_a` -> (1,3,3) spatial `conv_b_s` (carrying
  the spatial stride) -> (3,1,1) temporal `conv_b_t` (carrying the temporal
  stride) -> (1,1,1) `conv_c` with no activation, with a (1,1,1) `branch1`
  carrying both strides on a width or stride change; spatial stride 2 at
  every stage entry (res2 included), temporal stride 2 at the res4 and res5
  entries (16x224^2 -> 4x7x7)
- head: global average pool -> dropout -> linear

Both factors keep `features_inner` channels (no parameter-matching
mid-width): 28.1M parameters with 400 classes. The flax names are kept
(`conv_b_s` is the spatial factor; pytorchvideo swaps the two names, which
matters only to a hub converter). With `fused != "off"` every stride-1
ConvBNAct site takes a fused kernel: `conv_a` and `conv_c` the pointwise
one, the stride-1 `conv_b_s` and `conv_b_t` the odd-tap conv one; the stem,
the strided factors and every `branch1` stay unfused (cuDNN).
state_dict keys follow the flax paths: `res2_block0.conv_b_s.conv.weight`,
`res5_block2.conv_c.norm.running_mean`, ...

Input: (B, T, H, W, 3) NDHWC, normalized frames.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import (
    ConvBNAct,
    to_channels_last,
)
from pytorchvideo_accelerate_tpu_torch.models.heads import ResBasicHead


class Bottleneck2Plus1D(nn.Module):
    """(1,1,1) conv_a -> (1,3,3) conv_b_s -> (3,1,1) conv_b_t -> (1,1,1)
    conv_c, projection shortcut on a width or stride change."""

    def __init__(self, in_features: int, features_inner: int,
                 features_out: int, temporal_stride: int = 1,
                 spatial_stride: int = 1, fused: str = "off",
                 dtype=torch.float32):
        super().__init__()
        ts, ss = temporal_stride, spatial_stride
        self.conv_a = ConvBNAct(in_features, features_inner, (1, 1, 1),
                                fused=fused, dtype=dtype)
        self.conv_b_s = ConvBNAct(features_inner, features_inner, (1, 3, 3),
                                  stride=(1, ss, ss), fused=fused, dtype=dtype)
        self.conv_b_t = ConvBNAct(features_inner, features_inner, (3, 1, 1),
                                  stride=(ts, 1, 1), fused=fused, dtype=dtype)
        self.conv_c = ConvBNAct(features_inner, features_out, (1, 1, 1),
                                act=None, fused=fused, dtype=dtype)
        self.branch1 = None
        if in_features != features_out or ss != 1 or ts != 1:
            self.branch1 = ConvBNAct(in_features, features_out, (1, 1, 1),
                                     stride=(ts, ss, ss), act=None,
                                     fused=fused, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_c(self.conv_b_t(self.conv_b_s(self.conv_a(x))))
        residual = x if self.branch1 is None else self.branch1(x)
        return torch.relu(residual + y)


class R2Plus1D(nn.Module):
    def __init__(self, num_classes: int,
                 depths: Tuple[int, ...] = (3, 4, 6, 3),
                 stem_features: int = 64,
                 spatial_strides: Tuple[int, ...] = (2, 2, 2, 2),
                 temporal_strides: Tuple[int, ...] = (1, 1, 2, 2),
                 dropout_rate: float = 0.5, fused: str = "off",
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.blocks = []
        self.stem = ConvBNAct(3, stem_features, (1, 7, 7), stride=(1, 2, 2),
                              dtype=dtype)
        cin, inner, out = stem_features, stem_features, stem_features * 4
        for s, depth in enumerate(depths):
            for i in range(depth):
                name = f"res{s + 2}_block{i}"
                self.add_module(name, Bottleneck2Plus1D(
                    cin, inner, out,
                    temporal_strides[s] if i == 0 else 1,
                    spatial_strides[s] if i == 0 else 1, fused, dtype))
                self.blocks.append(name)
                cin = out
            inner, out = inner * 2, out * 2
        self.head = ResBasicHead(cin, num_classes, dropout_rate)

    @staticmethod
    def backbone_param_filter(path: Tuple[str, ...]) -> bool:
        """True for backbone (non-head) params, the ones
        `--model.freeze_backbone` freezes."""
        return path[0] != "head"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(to_channels_last(x.to(self.dtype)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.head(x)
