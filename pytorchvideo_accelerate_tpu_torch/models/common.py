"""Shared building blocks for the video backbones.

Counterpart of the JAX package's `models/common.py`. Layout: activations are
NCDHW tensors in `torch.channels_last_3d` memory, which is NDHWC underneath,
so the fused kernels get their NDHWC view with a zero-copy `permute`, and
cuDNN, pooling and BN take the same tensor. Submodules are named after the
flax tree (`slow_res2.block0.conv_a.conv.weight`, `...norm.running_mean`), so
every state_dict key is the flax path with a leaf rename (models/convert.py).

Train mode (`module.train()`) normalises with batch statistics and updates
the BN running averages with flax semantics; eval mode uses the running
averages. `init_like_jax` (models/__init__.py) draws the weights the way
the JAX package initialises them. `SeededDropout` is the dropout of every
head: its mask comes from an explicit generator that the trainer reseeds;
`DropPath` (the transformers' stochastic depth) is one too.

The transformer families (models/mvit.py, models/videomae.py) build on
`LayerNorm` and `Dense`, flax's `nn.LayerNorm` (epsilon 1e-6, statistics
in f32) and `nn.Dense(dtype=...)` with torch parameters (`weight`/`bias`
for flax's `scale`/`kernel` and `bias`). Their blocks take `remat`
(`--model.remat`): `remat_call` runs a block under activation
checkpointing, as `nn.remat` wraps the JAX package's blocks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


class BNAffine(nn.Module):
    """Owns exactly the BatchNorm state (`weight`/`bias` parameters,
    `running_mean`/`running_var` buffers, the flax scale/bias/mean/var) and
    resolves it into the per-channel (mul, add) affine in f32, the form the
    fused kernels fold into their weights and epilogue.

    Running averages follow flax's nn.BatchNorm, not torch's: momentum 0.9
    (ra <- 0.9 ra + 0.1 batch) over the BIASED batch variance, which is why
    `F.batch_norm(training=True)` (unbiased running var) cannot update them.
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def update_running_averages(self, batch_mean: torch.Tensor,
                                batch_var: torch.Tensor) -> None:
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(batch_mean.detach(), alpha=1 - m)
            self.running_var.mul_(m).add_(batch_var.detach(), alpha=1 - m)

    def affine(self, batch_mean: Optional[torch.Tensor] = None,
               batch_var: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mul, add) from the running averages, or, given the batch
        statistics (train mode), from those, after folding them into the
        running averages."""
        if batch_mean is None:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = batch_mean, batch_var
            self.update_running_averages(mean, var)
        mul = self.weight * torch.rsqrt(var + self.eps)
        return mul, self.bias - mean * mul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """BatchNorm over NCDHW x in f32, cast back to x's dtype, in flax's
        form (x - mean) * (scale * rsqrt(var + eps)) + bias: batch statistics
        in train mode, running averages in eval mode."""
        x32 = f32_island(x)
        if self.training:
            mean, var = batch_norm_stats(x32, dims=(0, 2, 3, 4))
            self.update_running_averages(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1, 1)
        mul = self.weight * torch.rsqrt(var + self.eps)
        y = (x32 - mean.view(shape)) * mul.view(shape)
        return end_island(y + self.bias.view(shape), x.dtype)


def batch_norm_stats(raw32: torch.Tensor, dims=None):
    """Per-channel batch (mean, var) of f32 `raw32`, the fast-variance form
    flax's nn.BatchNorm uses: E[x^2] - E[x]^2 clamped at 0 (biased). `dims`
    defaults to every axis but the last (NDHWC)."""
    if dims is None:
        dims = tuple(range(raw32.dim() - 1))
    mean = raw32.mean(dim=dims)
    var = torch.clamp_min((raw32 * raw32).mean(dim=dims) - mean * mean, 0.0)
    return mean, var


def fused_train_norm_act(raw: torch.Tensor, bn: BNAffine, act: str,
                         dtype) -> torch.Tensor:
    """Training-mode tail of a fused conv site: batch statistics of the raw
    NDHWC conv output (in its compute dtype, cast to f32), the running-average
    update through `bn`, then affine + activation as one f32 island. The
    gradient flows through the statistics."""
    raw32 = f32_island(raw)
    mul, add = bn.affine(*batch_norm_stats(raw32))
    return end_island(apply_act(raw32 * mul + add, act), dtype)


class SeededDropout(nn.Module):
    """Dropout in train mode with flax's semantics (keep with probability
    1 - rate, scale the kept values by 1 / (1 - rate)), its mask drawn from
    an explicit generator per device seeded by `reseed` (the trainer reseeds
    every head's dropout from (seed, step) each optimizer step, as the JAX
    package derives its dropout key). Identity in eval mode or at rate 0."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self._generator(x.device),
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(SeededDropout):
    """Stochastic depth with the JAX package's `_drop_path` semantics: in
    train mode each sample's branch is kept with probability 1 - rate and
    scaled by 1 / (1 - rate), one draw per sample; identity in eval mode or
    at rate 0. Its generator is reseeded like every `SeededDropout`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=self._generator(x.device),
                          device=x.device) < keep
        return x * mask.to(x.dtype) / keep


class _DropMaskStates:
    """The recompute of a checkpointed block must redraw the drop masks
    of its forward, but `checkpoint`'s `preserve_rng_state` restores only
    torch's default generators, and every `SeededDropout` draws from its
    own. The forward context saves their states; the recompute context
    rewinds them to those states and, on its way out, puts back the
    states it found (the post-forward ones)."""

    def __init__(self, generators: List[torch.Generator]):
        self.generators = generators
        self.before: List[torch.Tensor] = []

    @contextlib.contextmanager
    def forward(self):
        self.before = [g.get_state() for g in self.generators]
        yield

    @contextlib.contextmanager
    def recompute(self):
        found = [g.get_state() for g in self.generators]
        for g, state in zip(self.generators, self.before):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(self.generators, found):
                g.set_state(state)


def check_remat_block(block: nn.Module) -> None:
    """A checkpointed block's forward runs twice per training step: a
    `BNAffine` inside would fold its batch statistics into the running
    averages twice."""
    bad = [n for n, m in block.named_modules() if isinstance(m, BNAffine)]
    if bad:
        raise ValueError(f"remat of a block holding BatchNorm {bad}: the "
                         "recompute would update its running averages twice")


def remat_call(block: nn.Module, fn: Callable, x: torch.Tensor, *args):
    """`fn(x, *args)` (the body of `block`) under activation checkpointing
    (`torch.utils.checkpoint`, non-reentrant): only the block's inputs are
    kept, and the backward runs the forward again. The generators of the
    block's active `SeededDropout`s are rewound for that recompute, so it
    draws the forward's masks. Without autograd, a plain call."""
    if not torch.is_grad_enabled():
        return fn(x, *args)
    gens = [m._generator(x.device) for m in block.modules()
            if isinstance(m, SeededDropout) and m.training and m.rate > 0]
    states = _DropMaskStates(gens)
    return checkpoint(fn, x, *args, use_reentrant=False,
                      context_fn=lambda: (states.forward(), states.recompute()))


class LayerNorm(nn.Module):
    """flax's `nn.LayerNorm` over the last dim: statistics in f32 (the fast
    variance E[x^2] - E[x]^2 clamped at 0), epsilon 1e-6 (torch's default
    is 1e-5), (x - mean) * (rsqrt(var + eps) * scale) + bias in f32, cast
    to `dtype`. `weight`/`bias` are the flax `scale`/`bias`."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = f32_island(x)
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(-1, keepdim=True) - mean * mean,
                              0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return end_island(y, self.dtype)


class Dense(nn.Linear):
    """flax's `nn.Dense(dtype=...)`: input, kernel and bias cast to `dtype`,
    one matmul in that dtype."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32):
        super().__init__(in_features, features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


def fused_site(fused_op, x: torch.Tensor, w: torch.Tensor, bn: BNAffine,
               act: str, mode: str, dtype, training: bool) -> torch.Tensor:
    """One fused conv -> BN -> act site over the port's NCDHW activation
    `x`: `fused_op` (`fused_conv3d_bn_act` or `fused_depthwise_bn_act`) on
    its NDHWC view with the OIDHW weight `w` as DHWIO. Eval mode folds the
    running-average affine into the kernel; train mode runs the conv pass
    alone and lets batch statistics, affine and act ride its raw output as
    one f32 tail (`fused_train_norm_act`, autodiff through the stats)."""
    x, w = x.to(dtype), w.to(dtype)
    # NCDHW channels_last_3d -> its NDHWC view (no copy), OIDHW -> DHWIO
    xl, wl = x.permute(0, 2, 3, 4, 1).contiguous(), w.permute(2, 3, 4, 1, 0)
    n = wl.shape[-1]
    if training:
        raw = fused_op(xl, wl, torch.ones(n, device=x.device),
                       torch.zeros(n, device=x.device), act="identity",
                       mode=mode)
        y = fused_train_norm_act(raw, bn, act, dtype)
    else:
        mul, add = bn.affine()
        y = fused_op(xl, wl, mul, add, act=act, mode=mode)
    return y.permute(0, 4, 1, 2, 3)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's `lecun_normal()`: a normal truncated at two standard deviations,
    scaled to variance 1/fan_in (fan_in = Cin * taps for an OIDHW conv
    weight, in_features for a Linear one)."""
    fan_in = weight[0].numel()
    # std of the untruncated normal whose +-2 sigma truncation has unit
    # variance (flax's variance_scaling constant)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


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
        if self.fuse:
            return fused_site(fused_conv3d_bn_act, x, self.conv.weight,
                              self.norm, self.act, self.fused, self.dtype,
                              self.training)
        x = x.to(self.dtype)
        w = self.conv.weight.to(self.dtype)
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
