"""Depthwise 3D convolution with a selectable lowering.

The counterpart of the JAX package's `ops/depthwise.py` and
`ops/pallas_depthwise.py`. X3D's every `conv_b` and `stem_t`, and CSN's every
`conv_b`, are depthwise; `--model.depthwise_impl` picks how they run:

- "conv": `F.conv3d(groups=C)`, the library's grouped conv (cuDNN on the
  card), as the JAX package leaves this lowering to XLA;
- "shift": `depthwise_conv3d_shift`, the tap decomposition in f32 (the plain
  version, any stride);
- "pallas": `Depthwise3dS1`, stride 1 with odd taps: on a CUDA tensor the
  hand kernel `csrc/depthwise3d.cu` (`pva_depthwise3d_s1`), on a CPU tensor
  the plain version inside the same autograd Function. Strided or even-tap
  calls take the grouped conv, as the JAX module does (the kernel hard-codes
  odd SAME geometry). The name is kept so configs cross with the JAX
  package.

`Depthwise3dS1` is the counterpart of `pallas_depthwise3d_s1`'s custom VJP:
dx through the same kernel against the tap-flipped taps on the incoming
gradient (the stride-1 transpose is the same stencil), dk as f32 per-tap
reductions cast to the taps' dtype. Its launches count in the fused ops'
`LAUNCHES` under "depthwise3d_s1" and "depthwise3d_s1.bwd_dx".

`DepthwiseConv3D` owns its weight as an `nn.Conv3d` of `groups=C` at its own
scope, `(C, 1, kt, kh, kw)`, so `<path>/kernel` of the flax tree,
`(kt, kh, kw, 1, C)`, maps to `<path>.weight` under the converter's usual
transpose, and `init_like_jax` draws it lecun-normal with fan-in = taps.
Activations are the port's NCDHW views of channels_last_3d memory; the
shift and kernel lowerings take the NDHWC view without a copy.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from pytorchvideo_accelerate_tpu_torch.ops.fused import (
    _dw_cuda,
    depthwise_tap_grads_f32,
    depthwise_taps_f32,
)
from pytorchvideo_accelerate_tpu_torch.precision import end_island, f32_island

DEPTHWISE_IMPLS = ("conv", "shift", "pallas")


def depthwise_conv3d_shift(x, kernel, stride: Sequence[int] = (1, 1, 1),
                           padding: Sequence[int] = None):
    """Shift-and-accumulate depthwise conv: x (B,T,H,W,C) NDHWC, kernel
    (kt,kh,kw,1,C), padding k//2 per dim by default; the taps summed in f32,
    the result cast to x's dtype."""
    return end_island(depthwise_taps_f32(x, kernel, tuple(stride), padding),
                      x.dtype)


def _s1_apply(x, k, kernel: bool, count: str = "depthwise3d_s1"):
    if kernel:
        return _dw_cuda(x, k, None, "identity", count)
    return depthwise_conv3d_shift(x, k)


class Depthwise3dS1(torch.autograd.Function):
    """Depthwise conv3d, stride 1, SAME (k//2) padding, no bias: x
    (B,T,H,W,C), k (kt,kh,kw,1,C) odd taps, f32 accumulation, result in x's
    dtype. `kernel` launches the CUDA kernel, else the plain version. The
    backward mirrors `_bwd` of pallas_depthwise.py: dx by the same kernel on
    the gradient against the tap-flipped taps (no f32 dz step), dk by f32
    reductions cast to k's dtype."""

    @staticmethod
    def forward(ctx, x, k, kernel: bool):
        ctx.kernel = kernel
        ctx.save_for_backward(x, k)
        return _s1_apply(x, k, kernel)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, k = ctx.saved_tensors
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = _s1_apply(dy.to(x.dtype).contiguous(), k.flip(0, 1, 2),
                           ctx.kernel, "depthwise3d_s1.bwd_dx")
        if ctx.needs_input_grad[1]:
            dk = end_island(depthwise_tap_grads_f32(x, f32_island(dy),
                                                    k.shape[:3]), k.dtype)
        return dx, dk, None


class DepthwiseConv3D(nn.Conv3d):
    """Depthwise conv3d (k//2 padding, no bias) with lowering `impl`
    (conv | shift | pallas) over the port's NCDHW activations, computing in
    `dtype`; the weight is the `nn.Conv3d(groups=C)` parameter."""

    def __init__(self, features: int, kernel_size: Sequence[int],
                 stride: Sequence[int] = (1, 1, 1), impl: str = "conv",
                 dtype=torch.float32):
        if impl not in DEPTHWISE_IMPLS:
            raise ValueError(
                f"depthwise impl must be conv|shift|pallas, got {impl!r}")
        super().__init__(features, features, tuple(kernel_size), tuple(stride),
                         padding=[k // 2 for k in kernel_size],
                         groups=features, bias=False)
        self.impl = impl
        self.dtype = dtype

    def forward(self, x: torch.Tensor, channels: slice = None) -> torch.Tensor:
        """`channels`: run on that slice of the weight's channels only (x
        holds just those), as a split MViT attention pools its heads."""
        w = self.weight if channels is None else self.weight[channels]
        x, w = x.to(self.dtype), w.to(self.dtype)
        s1_odd = (self.stride == (1, 1, 1)
                  and all(k % 2 for k in self.kernel_size))
        if self.impl == "conv" or (self.impl == "pallas" and not s1_odd):
            return F.conv3d(x, w, None, self.stride, self.padding, 1,
                            w.shape[0])
        xl, kl = x.permute(0, 2, 3, 4, 1), w.permute(2, 3, 4, 1, 0)
        if self.impl == "shift":
            y = depthwise_conv3d_shift(xl, kl, self.stride)
        else:
            y = Depthwise3dS1.apply(xl.contiguous(), kl, xl.is_cuda)
        return y.permute(0, 4, 1, 2, 3)
