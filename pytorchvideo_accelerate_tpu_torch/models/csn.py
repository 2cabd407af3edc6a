"""ir-CSN-101, counterpart of the JAX package's `models/csn.py` (Tran et al.
2019, "Channel-Separated Convolutional Networks", pytorchvideo's
`create_csn`; hub `csn_r101`, Kinetics-400 32x2):

- stem: (3,7,7) conv stride (1,2,2) + BN + ReLU, (1,3,3) max pool stride
  (1,2,2)
- res2..res5: bottleneck depths (3,4,23,3), outputs (256,512,1024,2048);
  each block is (1,1,1) `conv_a` -> (3,3,3) DEPTHWISE `conv_b` (+ BN +
  ReLU) -> (1,1,1) `conv_c`, with a (1,1,1) `branch1` on a width or stride
  change; both the temporal and the spatial stride 2 ride the res3-res5
  entries (32x224^2 -> 4x7x7)
- head: global average pool -> dropout -> linear

With `fused != "off"` the (1,1,1) ConvBNAct sites take the pointwise kernel
and every stride-1 `conv_b` takes `fused_depthwise_bn_act` (relu epilogue);
strided stage entries keep the unfused depthwise conv of `depthwise_impl`.
state_dict keys follow the flax paths: `res2.block0.conv_b.conv.weight`,
`res2.block0.conv_b.norm.running_mean`, ...

Input: (B, T, H, W, 3) NDHWC, normalized frames.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import (
    BNAffine,
    ConvBNAct,
    fused_site,
    max_pool_3d,
    to_channels_last,
)
from pytorchvideo_accelerate_tpu_torch.models.heads import ResBasicHead
from pytorchvideo_accelerate_tpu_torch.ops.depthwise import DepthwiseConv3D
from pytorchvideo_accelerate_tpu_torch.ops.fused import fused_depthwise_bn_act


class _DepthwiseConvBN(nn.Module):
    """Depthwise (3,3,3) conv + BN + ReLU at `<name>.{conv,norm}`; stride-1
    sites go through the fused depthwise kernel when `fused != "off"`."""

    def __init__(self, features: int, stride: Tuple[int, int, int],
                 depthwise_impl: str = "conv", fused: str = "off",
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fused = fused
        self.fuse = fused != "off" and tuple(stride) == (1, 1, 1)
        self.conv = DepthwiseConv3D(features, (3, 3, 3), stride=stride,
                                    impl=depthwise_impl, dtype=dtype)
        self.norm = BNAffine(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fuse:
            return fused_site(fused_depthwise_bn_act, x, self.conv.weight,
                              self.norm, "relu", self.fused, self.dtype,
                              self.training)
        return torch.relu(self.norm(self.conv(x)))


class CSNBottleneck(nn.Module):
    """(1,1,1) conv_a -> depthwise (3,3,3) conv_b (carrying the strides) ->
    (1,1,1) conv_c, projection shortcut on a width or stride change."""

    def __init__(self, in_features: int, features_inner: int,
                 features_out: int, temporal_stride: int = 1,
                 spatial_stride: int = 1, depthwise_impl: str = "conv",
                 fused: str = "off", dtype=torch.float32):
        super().__init__()
        stride = (temporal_stride, spatial_stride, spatial_stride)
        self.conv_a = ConvBNAct(in_features, features_inner, (1, 1, 1),
                                fused=fused, dtype=dtype)
        self.conv_b = _DepthwiseConvBN(features_inner, stride, depthwise_impl,
                                       fused, dtype)
        self.conv_c = ConvBNAct(features_inner, features_out, (1, 1, 1),
                                act=None, fused=fused, dtype=dtype)
        self.branch1 = None
        if in_features != features_out or stride != (1, 1, 1):
            self.branch1 = ConvBNAct(in_features, features_out, (1, 1, 1),
                                     stride=stride, act=None, fused=fused,
                                     dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_c(self.conv_b(self.conv_a(x)))
        residual = x if self.branch1 is None else self.branch1(x)
        return torch.relu(residual + y)


class CSNStage(nn.Module):
    """A stack of CSN bottlenecks (`block0`, `block1`, ...); block 0 carries
    both strides."""

    def __init__(self, depth: int, in_features: int, features_inner: int,
                 features_out: int, temporal_stride: int = 1,
                 spatial_stride: int = 1, depthwise_impl: str = "conv",
                 fused: str = "off", dtype=torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", CSNBottleneck(
                in_features if i == 0 else features_out, features_inner,
                features_out, temporal_stride if i == 0 else 1,
                spatial_stride if i == 0 else 1, depthwise_impl, fused, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return x


class CSN(nn.Module):
    def __init__(self, num_classes: int,
                 depths: Tuple[int, ...] = (3, 4, 23, 3),
                 stem_features: int = 64,
                 spatial_strides: Tuple[int, ...] = (1, 2, 2, 2),
                 temporal_strides: Tuple[int, ...] = (1, 2, 2, 2),
                 dropout_rate: float = 0.5, depthwise_impl: str = "conv",
                 fused: str = "off", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depths = tuple(depths)
        self.stem = ConvBNAct(3, stem_features, (3, 7, 7), stride=(1, 2, 2),
                              dtype=dtype)
        cin, inner, out = stem_features, stem_features, stem_features * 4
        for i, depth in enumerate(self.depths):
            self.add_module(f"res{i + 2}", CSNStage(
                depth, cin, inner, out, temporal_strides[i],
                spatial_strides[i], depthwise_impl, fused, dtype))
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
        return self.head(x)
