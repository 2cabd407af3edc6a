"""X3D networks (XS/S/M/L), counterpart of the JAX package's `models/x3d.py`
(Feichtenhofer 2020, "X3D", with pytorchvideo's constants):

- stem: (1,3,3) conv stride (1,2,2) `stem_xy` (no BN), then the (5,1,1)
  depthwise temporal conv `stem_t` + BN `stem_norm` + ReLU, 24 channels
- 4 stages of inverted bottlenecks, depths (3,5,11,7) (X3D-L (5,10,25,15)):
  (1,1,1) expand x2.25 `conv_a` -> (3,3,3) depthwise `conv_b` + BN
  `norm_b` (+ squeeze-excite `se` on every other block) + swish -> (1,1,1)
  project `conv_c`; spatial stride 2 at each stage entry
- conv5: (1,1,1) to 432 + BN + ReLU, global average pool, (1,1,1)
  `head_conv` to 2048 + ReLU, dropout, linear `proj` in f32

With `fused != "off"` the (1,1,1) ConvBNAct sites take the pointwise kernel
and every stride-1 depthwise site (`conv_b` of the non-entry blocks,
`stem_t`) takes `fused_depthwise_bn_act`: its epilogue stops at the affine
("identity") where SE follows (SE reads the normalised pre-activation),
else it fuses swish ("silu"); `stem_t` fuses relu. Strided stage entries
keep the unfused depthwise conv of `depthwise_impl`. The parameters are the
same either way; state_dict keys are the flax paths (`res2_block0.conv_b.
weight`, `res2_block0.norm_b.running_mean`, `stem_t.weight`, ...).

Input: (B, T, H, W, 3) NDHWC, normalized frames.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import (
    BNAffine,
    ConvBNAct,
    SeededDropout,
    fused_site,
    global_avg_pool,
    to_channels_last,
)
from pytorchvideo_accelerate_tpu_torch.ops.depthwise import DepthwiseConv3D
from pytorchvideo_accelerate_tpu_torch.ops.fused import fused_depthwise_bn_act
from pytorchvideo_accelerate_tpu_torch.precision import f32_island


def _round_width(width: int, multiplier: float, min_depth: int = 8,
                 divisor: int = 8) -> int:
    """Channel rounding (the paper's appendix; pytorchvideo round_width)."""
    if not multiplier:
        return width
    width *= multiplier
    new_width = max(min_depth, int(width + divisor / 2) // divisor * divisor)
    if new_width < 0.9 * width:
        new_width += divisor
    return int(new_width)


class SqueezeExcite(nn.Module):
    """SE over the (T,H,W)-pooled features, ratio 1/16: (1,1,1) `fc1` with
    bias, ReLU, (1,1,1) `fc2` with bias, sigmoid gate."""

    def __init__(self, channels: int, ratio: float = 0.0625,
                 dtype=torch.float32):
        super().__init__()
        se_ch = _round_width(channels, ratio, min_depth=8, divisor=8)
        self.dtype = dtype
        self.fc1 = nn.Conv3d(channels, se_ch, 1, bias=True)
        self.fc2 = nn.Conv3d(se_ch, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        s = torch.relu(F.conv3d(s, self.fc1.weight.to(d), self.fc1.bias.to(d)))
        s = F.conv3d(s, self.fc2.weight.to(d), self.fc2.bias.to(d))
        return x * torch.sigmoid(s)


class X3DBlock(nn.Module):
    """Inverted bottleneck: expand -> depthwise 3x3x3 (+SE, swish) ->
    project, with a (1,1,1) `branch1` shortcut on a stride or width change
    whose BN exists only on a width change (pytorchvideo's
    create_x3d_res_block: the hub checkpoints' stage-1 block 0, 24->24 with
    stride 2, has a branch1 conv and no branch1 norm)."""

    def __init__(self, in_features: int, features_out: int,
                 features_inner: int, spatial_stride: int = 1,
                 use_se: bool = False, depthwise_impl: str = "conv",
                 fused: str = "off", dtype=torch.float32):
        super().__init__()
        s = spatial_stride
        self.dtype = dtype
        self.fused = fused
        self.fuse_b = fused != "off" and s == 1
        self.conv_a = ConvBNAct(in_features, features_inner, (1, 1, 1),
                                fused=fused, dtype=dtype)
        self.conv_b = DepthwiseConv3D(features_inner, (3, 3, 3),
                                      stride=(1, s, s), impl=depthwise_impl,
                                      dtype=dtype)
        self.norm_b = BNAffine(features_inner)
        self.se = SqueezeExcite(features_inner, dtype=dtype) if use_se else None
        self.conv_c = ConvBNAct(features_inner, features_out, (1, 1, 1),
                                act=None, fused=fused, dtype=dtype)
        self.branch1 = None
        if in_features != features_out or s != 1:
            self.branch1 = ConvBNAct(in_features, features_out, (1, 1, 1),
                                     stride=(1, s, s), act=None,
                                     use_bn=in_features != features_out,
                                     dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_a(x)
        if self.fuse_b:
            # SE reads the normalised pre-activation, so with SE the fused
            # epilogue stops at the affine; without it swish fuses in too
            y = fused_site(fused_depthwise_bn_act, y, self.conv_b.weight,
                           self.norm_b,
                           "identity" if self.se is not None else "silu",
                           self.fused, self.dtype, self.training)
            if self.se is not None:
                y = F.silu(self.se(y))
        else:
            y = self.norm_b(self.conv_b(y))
            if self.se is not None:
                y = self.se(y)
            y = F.silu(y)
        y = self.conv_c(y)
        residual = x if self.branch1 is None else self.branch1(x)
        return torch.relu(residual + y)


class X3D(nn.Module):
    def __init__(self, num_classes: int,
                 depths: Tuple[int, ...] = (3, 5, 11, 7),
                 stem_features: int = 24,
                 stage_features: Tuple[int, ...] = (24, 48, 96, 192),
                 expansion: float = 2.25, head_features: int = 2048,
                 dropout_rate: float = 0.5, depthwise_impl: str = "conv",
                 fused: str = "off", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fused = fused
        self.stem_xy = nn.Conv3d(3, stem_features, (1, 3, 3), (1, 2, 2),
                                 padding=(0, 1, 1), bias=False)
        self.stem_t = DepthwiseConv3D(stem_features, (5, 1, 1),
                                      impl=depthwise_impl, dtype=dtype)
        self.stem_norm = BNAffine(stem_features)
        self.blocks = []
        cin = stem_features
        for stage_idx, depth in enumerate(depths):
            f_out = stage_features[stage_idx]
            f_inner = int(round(f_out * expansion))
            for i in range(depth):
                name = f"res{stage_idx + 2}_block{i}"
                self.add_module(name, X3DBlock(
                    cin, f_out, f_inner, spatial_stride=2 if i == 0 else 1,
                    use_se=i % 2 == 0,  # SE every other block (paper §3)
                    depthwise_impl=depthwise_impl, fused=fused, dtype=dtype))
                self.blocks.append(name)
                cin = f_out
        f5 = int(round(stage_features[-1] * expansion))
        self.conv5 = ConvBNAct(cin, f5, (1, 1, 1), fused=fused, dtype=dtype)
        self.head_conv = nn.Conv3d(f5, head_features, 1, bias=False)
        self.dropout = SeededDropout(dropout_rate)
        self.proj = nn.Linear(head_features, num_classes)

    @staticmethod
    def backbone_param_filter(path: Tuple[str, ...]) -> bool:
        """True for backbone params, the ones `--model.freeze_backbone`
        freezes (everything but `head_conv` and `proj`)."""
        return path[0] not in ("proj", "head_conv")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        x = to_channels_last(x.to(d))
        x = F.conv3d(x, self.stem_xy.weight.to(d), None, self.stem_xy.stride,
                     self.stem_xy.padding)
        if self.fused != "off":
            x = fused_site(fused_depthwise_bn_act, x, self.stem_t.weight,
                           self.stem_norm, "relu", self.fused, d,
                           self.training)
        else:
            x = torch.relu(self.stem_norm(self.stem_t(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        # conv5 -> BN -> relu -> global pool -> head_conv -> relu (the
        # 2048-d projection runs on pooled features, pytorchvideo's order)
        x = global_avg_pool(self.conv5(x))[:, :, None, None, None]
        x = torch.relu(F.conv3d(x, self.head_conv.weight.to(d)))
        x = self.dropout(x.flatten(1))
        return self.proj(f32_island(x))
