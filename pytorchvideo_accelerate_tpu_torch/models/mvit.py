"""MViT, multiscale vision transformers for video: counterpart of the JAX
package's `models/mvit.py` (Fan et al. 2021, pytorchvideo's MViT-B/16x4
constants):

- patch embed: (3,7,7) conv stride (2,4,4), 96 dims, plus a learned
  `pos_embed` (1, T', H', W', 96) sized to the clip (`input_grid`)
- 16 blocks; the dim doubles in the MLP of the block before each stage start
  (1, 3, 14): 96 -> 192 -> 384 -> 768, heads 1 -> 2 -> 4 -> 8, head_dim 96
- pooling attention: Q pooled by (1,2,2) at stage starts, K/V pooled in
  every block by a stride starting at (1,8,8) and halving spatially per
  stage; a pool is a (3,3,3) depthwise conv (`DepthwiseConv3D`, impl
  `depthwise_impl`) then a LayerNorm over head_dim shared by the heads;
  residual Q pooling (attn + pooled q)
- MLP ratio 4 with erf GELU, drop path on a linear schedule, no CLS token:
  the head mean-pools the final grid, then dropout and an f32 Linear.

Tokens stay in their (B, T, H, W, C) grid between blocks. Attention runs
through `ops/attention.py` `dot_product_attention` with `attention_backend`
dense|pallas; under `depthwise_impl pallas` the stride-1 K/V pools of the
last stage take the `depthwise3d_s1` kernel, the strided pools the grouped
conv (cuDNN), as the JAX package leaves them to XLA. Submodules carry the
flax names, so a state_dict key is the flax path (`block0.attn.qkv.weight`,
`block14.attn.pool_k.pool.weight`, `pos_embed`).

`remat` checkpoints every block (`models/common.py remat_call`, the JAX
package's `nn.remat(MViTBlock)`). On the model axis
(`parallel/tensor_parallel.py apply_model_axis`) an attention whose heads
divide it runs its local heads (`split_heads`): `qkv` column-parallel and
head-aligned, the pools on the local heads' channels of their shared
weights, `proj` row-parallel; `mlp_fc1` / `mlp_fc2` split as a
column / row pair and `skip_proj` stays replicated. `--model.attention
ring|ulysses` splits the attention's tokens over the same axis instead.
`set_pipeline(plan)` streams a uniform trunk (no stage starts, no drop
path, dense or pallas attention: `pipeline_cut_check`, the JAX refusals)
through the stage pipeline in training (`parallel/pipeline.py`);
full-width MViT-B is multiscale and refuses. `forward(x, from_stem=True)`
is the streaming stem seam (streaming/engine.py's stem ring): `x` is the
pre-positional stem token grid (B, T', H', W', embed_dim), the patch embed
is skipped and `pos_embed` is added in window order. Not ported:
block-boundary sharding (`shard_mesh`).

Input: (B, T, H, W, 3) NDHWC, normalized frames.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import (
    Dense,
    DropPath,
    LayerNorm,
    SeededDropout,
    check_remat_block,
    remat_call,
)
from pytorchvideo_accelerate_tpu_torch.ops.attention import dot_product_attention
from pytorchvideo_accelerate_tpu_torch.ops.depthwise import DepthwiseConv3D
from pytorchvideo_accelerate_tpu_torch.parallel.pipeline import (
    PipelinePlan,
    apply_pipelined_blocks,
    is_active,
    stage_cuts,
)
from pytorchvideo_accelerate_tpu_torch.precision import f32_island

ONE = (1, 1, 1)


class PoolHeads(nn.Module):
    """(3,3,3) depthwise conv pooling of a per-head token grid, then a
    LayerNorm over each head's slice with one shared (head_dim,) parameter
    (pytorchvideo's `LayerNorm(head_dim)`). Identity at unit stride unless
    `always` (the K/V pools of every block)."""

    def __init__(self, channels: int, stride: Sequence[int], head_dim: int,
                 always: bool = False, depthwise_impl: str = "conv",
                 dtype=torch.float32):
        super().__init__()
        self.stride = tuple(stride)
        self.active = self.stride != ONE or always
        self.head_dim = head_dim
        if self.active:
            self.pool = DepthwiseConv3D(channels, (3, 3, 3), self.stride,
                                        impl=depthwise_impl, dtype=dtype)
            self.norm = LayerNorm(head_dim, dtype=dtype)

    def forward(self, x: torch.Tensor, channels: slice = None) -> torch.Tensor:
        """`channels`: the slice of the pool's channels that x holds (a
        split attention's local heads)."""
        if not self.active:
            return x
        x = self.pool(x.permute(0, 4, 1, 2, 3), channels).permute(0, 2, 3, 4, 1)
        shape = x.shape
        x = self.norm(x.reshape(*shape[:-1], shape[-1] // self.head_dim,
                                self.head_dim))
        return x.reshape(shape)


class MultiScaleAttention(nn.Module):
    """Pooling attention over a (B, T, H, W, C) grid: qkv projection, per
    head pools of q, k and v, attention, + pooled q, output projection."""

    def __init__(self, dim: int, num_heads: int, q_stride=ONE, kv_stride=ONE,
                 attention_backend: str = "dense", depthwise_impl: str = "conv",
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.backend = attention_backend
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.pool_q = PoolHeads(dim, q_stride, self.head_dim,
                                depthwise_impl=depthwise_impl, dtype=dtype)
        self.pool_k = PoolHeads(dim, kv_stride, self.head_dim, always=True,
                                depthwise_impl=depthwise_impl, dtype=dtype)
        self.pool_v = PoolHeads(dim, kv_stride, self.head_dim, always=True,
                                depthwise_impl=depthwise_impl, dtype=dtype)
        self.proj = Dense(dim, dim, dtype)
        self.local_heads, self.local_dim, self.channels = num_heads, dim, None

    def split_heads(self, count: int, index: int) -> None:
        """Run heads [index H / count, (index + 1) H / count) only (the
        model axis's `qkv` and `proj` shards hold them)."""
        self.local_heads = self.num_heads // count
        self.local_dim = self.dim // count
        self.channels = slice(index * self.local_dim, (index + 1) * self.local_dim)

    def partial_pools(self):
        """The pools whose shared weights this rank uses in part."""
        if self.channels is None:
            return []
        return [n for n in ("pool_q", "pool_k", "pool_v")
                if getattr(self, n).active]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, ch = x.shape[0], self.channels
        q, k, v = self.qkv(x).split(self.local_dim, dim=-1)
        q, k, v = self.pool_q(q, ch), self.pool_k(k, ch), self.pool_v(v, ch)
        grid = q.shape[1:4]

        def tokens(t):
            return t.reshape(b, -1, self.local_heads, self.head_dim)

        attn = dot_product_attention(tokens(q), tokens(k), tokens(v),
                                     backend=self.backend)
        # residual Q pooling (paper §3.1, the improved MViTv2 form)
        attn = attn.reshape(b, *grid, self.local_dim) + q
        return self.proj(attn)


class MViTBlock(nn.Module):
    """pytorchvideo's MultiScaleBlock (dim_mul_in_att=False): attention at
    the input dim, the channel change to `dim_out` in the MLP, the residual
    projected from norm2(x) (`skip_proj`) when the dim changes, the skip
    max-pooled to the q-pooled grid (kernel stride+1, padding kernel//2).
    `remat`: the block runs under activation checkpointing."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_stride=ONE,
                 kv_stride=ONE, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 attention_backend: str = "dense", depthwise_impl: str = "conv",
                 dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.q_stride = tuple(q_stride)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = MultiScaleAttention(dim, num_heads, q_stride, kv_stride,
                                        attention_backend, depthwise_impl, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim_out, dtype)
        self.skip_proj = Dense(dim, dim_out, dtype) if dim_out != dim else None
        self.drop_path = DropPath(drop_path)
        if remat:
            check_remat_block(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat:
            return remat_call(self, self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        y = self.attn(self.norm1(x))
        if self.q_stride != ONE:
            kernel = tuple(s + 1 if s > 1 else s for s in self.q_stride)
            shortcut = F.max_pool3d(shortcut.permute(0, 4, 1, 2, 3), kernel,
                                    self.q_stride, [k // 2 for k in kernel]
                                    ).permute(0, 2, 3, 4, 1)
        x = shortcut + self.drop_path(y)
        y = self.norm2(x)
        mlp = self.mlp_fc2(F.gelu(self.mlp_fc1(y)))
        if self.skip_proj is not None:
            x = self.skip_proj(y)
        return x + self.drop_path(mlp)


def patch_grid(input_grid: Sequence[int], kernel: Sequence[int],
               stride: Sequence[int]) -> Tuple[int, int, int]:
    """(T', H', W') of the patch embed conv (padding k//2) over (T, H, W)."""
    return tuple((n + 2 * (k // 2) - k) // s + 1
                 for n, k, s in zip(input_grid, kernel, stride))


class MViT(nn.Module):
    """MViT-B/16x4 by default. `input_grid` is the clip's (T, H, W), which
    sizes `pos_embed` (the flax module sizes it from its first input)."""

    def __init__(self, num_classes: int, input_grid: Sequence[int] = (16, 224, 224),
                 depth: int = 16, embed_dim: int = 96, num_heads: int = 1,
                 stage_starts: Sequence[int] = (1, 3, 14),
                 patch_kernel: Sequence[int] = (3, 7, 7),
                 patch_stride: Sequence[int] = (2, 4, 4),
                 initial_kv_stride: Sequence[int] = (1, 8, 8),
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.2,
                 dropout_rate: float = 0.5, attention_backend: str = "dense",
                 depthwise_impl: str = "conv", dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        self.stage_starts = tuple(stage_starts)
        self.drop_path_rate = drop_path_rate
        self.attention_backend = attention_backend
        self.pipeline: Optional[PipelinePlan] = None
        self.patch_embed = nn.Conv3d(3, embed_dim, tuple(patch_kernel),
                                     tuple(patch_stride),
                                     padding=[k // 2 for k in patch_kernel])
        grid = patch_grid(input_grid, patch_kernel, patch_stride)
        self.pos_embed = nn.Parameter(torch.zeros(1, *grid, embed_dim))
        # pytorchvideo's schedule: the dim doubles in the MLP of the block
        # BEFORE a stage start; the stage start then runs attention at the
        # doubled dim with doubled heads, (1,2,2) q pooling and a kv stride
        # halved spatially (head_dim stays constant)
        dim, heads = embed_dim, num_heads
        kv_stride = list(initial_kv_stride)
        for i in range(depth):
            if i in stage_starts:
                heads *= 2
                q_stride = (1, 2, 2)
                kv_stride = [max(s // 2, 1) if j > 0 else s
                             for j, s in enumerate(kv_stride)]
            else:
                q_stride = ONE
            dim_out = dim * 2 if (i + 1) in stage_starts else dim
            self.add_module(f"block{i}", MViTBlock(
                dim, dim_out, heads, q_stride, tuple(kv_stride), mlp_ratio,
                drop_path_rate * i / max(depth - 1, 1), attention_backend,
                depthwise_impl, dtype, remat))
            dim = dim_out
        self.norm = LayerNorm(dim, dtype=dtype)
        self.dropout = SeededDropout(dropout_rate)
        self.head = nn.Linear(dim, num_classes)

    @staticmethod
    def backbone_param_filter(path: Tuple[str, ...]) -> bool:
        """True for backbone params (everything but the head)."""
        return path[0] != "head"

    def pipeline_cut_check(self, stages: int) -> None:
        """Raise ValueError naming the first obstruction to cutting this
        trunk into `stages` equal stages (the JAX package's texts)."""
        stage_cuts(self.depth, stages)
        if self.stage_starts:
            raise ValueError(
                "mvit pipeline_stages>1 needs a homogeneous block stack, "
                f"but stage_starts={self.stage_starts} double dims/"
                "heads and q-pool the token grid at those blocks — the "
                "per-stage param trees and activation shapes differ, so "
                "no equal stage cut exists. Pipeline the videomae trunk, "
                "or configure a uniform MViT (stage_starts=()); see "
                "docs/PARALLELISM.md § pipeline")
        if self.drop_path_rate > 0:
            raise ValueError(
                "mvit pipeline_stages>1 needs rng-free, per-block-"
                f"identical blocks; drop_path_rate={self.drop_path_rate} "
                "gives every block its own stochastic-depth rate (and an "
                "rng stream) — set model.dropout/drop_path off to "
                "pipeline this trunk")
        if self.attention_backend in ("ring", "ulysses"):
            raise ValueError(
                "mvit pipeline_stages>1 does not compose with the "
                f"context-parallel attention backend "
                f"{self.attention_backend!r}: the pipelined region keeps "
                "MViT's (B,T,H,W,C) token grid un-sharded — use dense/"
                "pallas attention, or pipeline the videomae trunk where "
                "CP composes on the library mesh")

    def set_pipeline(self, plan: Optional[PipelinePlan]) -> None:
        """Pipeline the trunk under `plan` (checked by `pipeline_cut_check`
        first; None: the plain loop)."""
        if is_active(plan):
            self.pipeline_cut_check(plan.stages)
        self.pipeline = plan

    def pipelined_blocks(self):
        return [f"block{i}" for i in range(self.depth)] if is_active(self.pipeline) else []

    def forward(self, x: torch.Tensor, from_stem: bool = False) -> torch.Tensor:
        """`from_stem`: `x` is already the patch embed's output grid (B, T',
        H', W', embed_dim), before `pos_embed`."""
        d = self.dtype
        if from_stem:
            x = x.to(d)
        else:
            x = F.conv3d(x.to(d).permute(0, 4, 1, 2, 3), self.patch_embed.weight.to(d),
                         self.patch_embed.bias.to(d), self.patch_embed.stride,
                         self.patch_embed.padding)
            x = x.permute(0, 2, 3, 4, 1)
        if x.shape[1:4] != self.pos_embed.shape[1:4]:
            raise ValueError(
                f"clip grid {tuple(x.shape[1:4])} after the patch embed does not "
                f"match pos_embed {tuple(self.pos_embed.shape[1:4])} (the "
                "model was built for another num_frames / crop_size)")
        x = x + self.pos_embed.to(d)
        x = apply_pipelined_blocks([getattr(self, f"block{i}") for i in range(self.depth)],
                                   x, self.pipeline)
        x = self.norm(x).mean(dim=(1, 2, 3))
        return self.head(f32_island(self.dropout(x)))
