"""Shared building blocks for 3D-CNN video backbones.

Counterpart of the JAX package's `models/common.py`. Layout: activations are
NCDHW tensors in `torch.channels_last_3d` memory, which is NDHWC underneath,
so the fused kernels get their NDHWC view with a zero-copy `permute`, and
cuDNN, pooling and BN take the same tensor. Submodules are named after the
flax tree (`slow_res2.block0.conv_a.conv.weight`, `...norm.running_mean`), so
every state_dict key is the flax path with a leaf rename (models/convert.py).

This slice serves: the modules run in eval mode only. Training (batch
statistics, running-average updates, the backward kernels) is the next slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorchvideo_accelerate_tpu_torch.ops.fused import (
    FUSED_ACTS,
    apply_act,
    fused_conv3d_bn_act,
)
from pytorchvideo_accelerate_tpu_torch.precision import end_island, f32_island

# the fused-kernel lowering knob threaded from ModelConfig.fused_kernels:
# "off" = the unfused conv -> BN -> act graph; "auto" = CUDA kernels for CUDA
# tensors, plain PyTorch for CPU tensors; "pallas"/"xla" force one lowering
FUSED_MODES = ("off", "auto", "pallas", "xla")


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            "the PyTorch port serves only (eval mode); training is the next "
            "slice of the port (ROADMAP.md)")


class BNAffine(nn.Module):
    """Owns exactly the BatchNorm state (`weight`/`bias` parameters,
    `running_mean`/`running_var` buffers, the flax scale/bias/mean/var) and
    resolves it into the per-channel (mul, add) affine in f32, the form the
    fused kernels fold into their weights and epilogue."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return mul, self.bias - self.running_mean * mul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode BatchNorm over NCDHW x, computed in f32 and cast back."""
        _eval_only(self)
        shape = (1, -1, 1, 1, 1)
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        y = (f32_island(x) - self.running_mean.view(shape)) * mul.view(shape)
        return end_island(y + self.bias.view(shape), x.dtype)


class ConvBNAct(nn.Module):
    """conv3d -> BN -> activation. Stride-1 BN sites without a conv bias,
    groups or an unknown activation go through the fused lowering when
    `fused != "off"`; the parameters are the same either way."""

    def __init__(self, in_features: int, features: int,
                 kernel: Sequence[int], stride: Sequence[int] = (1, 1, 1),
                 groups: int = 1, use_bias: bool = False, use_bn: bool = True,
                 act: Optional[str] = "relu", dtype=torch.float32,
                 bn_eps: float = 1e-5, fused: str = "off"):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.groups = groups
        self.act = act or "identity"
        self.dtype = dtype
        self.fused = fused
        self.conv = nn.Conv3d(in_features, features, self.kernel, self.stride,
                              padding=[k // 2 for k in self.kernel],
                              groups=groups, bias=use_bias)
        self.norm = BNAffine(features, bn_eps) if use_bn else None
        self.fuse = (fused != "off" and use_bn and not use_bias
                     and groups == 1 and self.stride == (1, 1, 1)
                     and self.act in FUSED_ACTS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        x = x.to(self.dtype)
        w = self.conv.weight.to(self.dtype)
        if self.fuse:
            mul, add = self.norm.affine()
            # NCDHW channels_last_3d -> its NDHWC view (no copy), DHWIO weight
            y = fused_conv3d_bn_act(
                x.permute(0, 2, 3, 4, 1).contiguous(), w.permute(2, 3, 4, 1, 0),
                mul, add, act=self.act, mode=self.fused)
            return y.permute(0, 4, 1, 2, 3)
        bias = None if self.conv.bias is None else self.conv.bias.to(self.dtype)
        x = F.conv3d(x, w, bias, self.stride, self.conv.padding, 1, self.groups)
        if self.norm is not None:
            x = self.norm(x)
        return apply_act(x, self.act)


class Bottleneck3D(nn.Module):
    """ResNet bottleneck: (kt,1,1) conv_a, (1,3,3) conv_b carrying the
    spatial stride, (1,1,1) conv_c, and a (1,1,1) branch1 projection when
    the width or the stride changes."""

    def __init__(self, in_features: int, features_inner: int,
                 features_out: int, temporal_kernel: int = 1,
                 spatial_stride: int = 1, fused: str = "off",
                 dtype=torch.float32):
        super().__init__()
        s = spatial_stride
        self.conv_a = ConvBNAct(in_features, features_inner,
                                (temporal_kernel, 1, 1), fused=fused,
                                dtype=dtype)
        self.conv_b = ConvBNAct(features_inner, features_inner, (1, 3, 3),
                                stride=(1, s, s), fused=fused, dtype=dtype)
        self.conv_c = ConvBNAct(features_inner, features_out, (1, 1, 1),
                                act=None, fused=fused, dtype=dtype)
        self.branch1 = None
        if in_features != features_out or s != 1:
            self.branch1 = ConvBNAct(in_features, features_out, (1, 1, 1),
                                     stride=(1, s, s), act=None, fused=fused,
                                     dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_c(self.conv_b(self.conv_a(x)))
        residual = x if self.branch1 is None else self.branch1(x)
        return torch.relu(residual + y)


class ResStage(nn.Module):
    """A stack of bottleneck blocks (`block0`, `block1`, ...); the first
    carries the spatial stride."""

    def __init__(self, depth: int, in_features: int, features_inner: int,
                 features_out: int, temporal_kernel: int = 1,
                 spatial_stride: int = 2, fused: str = "off",
                 dtype=torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", Bottleneck3D(
                in_features if i == 0 else features_out, features_inner,
                features_out, temporal_kernel,
                spatial_stride if i == 0 else 1, fused, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return x


def max_pool_3d(x: torch.Tensor, window: Sequence[int],
                strides: Sequence[int]) -> torch.Tensor:
    """3D max pool with per-dim padding k//2 (the flax SAME-style pads)."""
    return F.max_pool3d(x, tuple(window), tuple(strides),
                        padding=[k // 2 for k in window])


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over (T, H, W) of NCDHW x."""
    return x.mean(dim=(2, 3, 4))


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """NDHWC clip -> NCDHW view in channels_last_3d memory (no copy for a
    contiguous NDHWC tensor)."""
    return x.permute(0, 4, 1, 2, 3)
