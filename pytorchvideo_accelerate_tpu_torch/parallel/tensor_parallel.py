"""Megatron tensor parallelism over the train mesh's model axis (the
port's counterpart of the JAX package's GSPMD rules in
`parallel/sharding.py`, which do not translate: here the layers and their
collectives are explicit).

- `ColumnDense`: a `Dense` holding this rank's output features (its rows
  of the torch weight and of the bias); its input goes through
  `copy_to_model`, whose backward sums the input's gradient over the model
  group.
- `RowDense`: a `Dense` holding this rank's input features (columns of
  the weight); the partial products are summed over the model group
  (`reduce_from_model`) and the full bias is added once, after the sum.
- `ModelAxis`: how a run spends the axis (`layout`, the JAX trainer's
  decision): tensor-parallel (MViT and VideoMAE: `tp`), context-parallel
  (`--model.attention ring|ulysses`: `cp`, the attention's token axis
  split over the same ranks, parameters replicated) or replicated (the conv
  families).
- `apply_model_axis(model, axis)`: the full-width model, built from the
  seed on every rank, cut to this rank's shards in place by
  `parallel/sharding.py shard_plan`: each split `qkv`/`proj`/`mlp_fc1`/
  `mlp_fc2` becomes a `ColumnDense`/`RowDense` holding its slice, and each
  split attention runs its local heads. The plan rides on the model
  (`model.model_axis`) for the checkpoint's gather and the step.

Replicated leaves that a split attention uses only in part (MViT's
`pool_q/k/v` conv taps and norm, shared by all heads, of which each rank
pools its local heads) get a partial gradient on each rank;
`partial_params` names them, and the step sums their gradients over the
model group.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import Dense
from pytorchvideo_accelerate_tpu_torch.parallel.collectives import (
    copy_to_model,
    reduce_from_model,
)
from pytorchvideo_accelerate_tpu_torch.parallel.distributed import model_group
from pytorchvideo_accelerate_tpu_torch.parallel.sharding import (
    Plan,
    family_uses_tp,
    shard_plan,
    shard_tensor,
)

CP_BACKENDS = ("ring", "ulysses")


@dataclass
class ModelAxis:
    """The model axis of one rank: its size `count`, this rank's `index`,
    and what the axis carries: `tp` (heads and MLP widths) or `cp` (the
    attention's tokens); neither is replication. `plan` is filled by
    `apply_model_axis`."""

    count: int = 1
    index: int = 0
    tp: bool = False
    cp: bool = False
    plan: Plan = field(default_factory=dict)

    @property
    def mode(self) -> str:
        return ("context-parallel" if self.cp else "tensor-parallel"
                if self.tp else "replicated")


def layout(model_name: str, attention: str, count: int,
           index: int = 0) -> ModelAxis:
    """The JAX trainer's decision (`trainer/loop.py`): the context-parallel
    lane spends the model axis when `attention` is ring or ulysses;
    otherwise the transformer families split heads and MLP widths over it
    and the rest replicate."""
    cp = attention in CP_BACKENDS
    tp = family_uses_tp(model_name) and not cp
    return ModelAxis(count=count, index=index, tp=tp and count > 1, cp=cp)


class ColumnDense(Dense):
    """Column-parallel `Dense`: this rank's output features."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return F.linear(copy_to_model(x.to(d), model_group()),
                        self.weight.to(d), self.bias.to(d))


class RowDense(Dense):
    """Row-parallel `Dense`: this rank's input features; the bias is added
    once, after the sum over the model group."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = reduce_from_model(F.linear(x.to(d), self.weight.to(d)), model_group())
        return y + self.bias.to(d)


def attention_heads(model: nn.Module) -> Dict[str, int]:
    """{module name: head count} of every attention module (one holding a
    `qkv` projection), the key prefix `shard_plan` takes."""
    return {name: m.num_heads for name, m in model.named_modules()
            if hasattr(m, "num_heads") and isinstance(getattr(m, "qkv", None), nn.Linear)}


def _swap(model: nn.Module, name: str, cls, plan: Plan, axis: ModelAxis) -> None:
    parent_name, _, attr = name.rpartition(".")
    parent = model.get_submodule(parent_name) if parent_name else model
    old = getattr(parent, attr)
    w = plan[f"{name}.weight"]
    weight = shard_tensor(old.weight.data, axis.index, axis.count, *w)
    bias = old.bias.data
    if f"{name}.bias" in plan:
        bias = shard_tensor(bias, axis.index, axis.count, *plan[f"{name}.bias"])
    new = cls(weight.shape[1], weight.shape[0], old.dtype)
    with torch.no_grad():
        new.weight.copy_(weight)
        new.bias.copy_(bias)
    setattr(parent, attr, new.to(old.weight.device))


def apply_model_axis(model: nn.Module, axis: ModelAxis) -> nn.Module:
    """Cut the full-width `model` to this rank's shards in place (a no-op
    unless `axis.tp` and `axis.count > 1`) and attach `axis` as
    `model.model_axis`. Returns the model."""
    if axis.tp and axis.count > 1:
        heads = attention_heads(model)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        axis.plan = shard_plan(shapes, axis.count, heads)
        modules = sorted({k.rsplit(".", 1)[0] for k in axis.plan})
        for name in modules:
            last = name.rsplit(".", 1)[-1]
            _swap(model, name, ColumnDense if last in ("qkv", "mlp_fc1") else RowDense,
                  axis.plan, axis)
        for name in heads:
            if f"{name}.qkv.weight" in axis.plan:
                model.get_submodule(name).split_heads(axis.count, axis.index)
    model.model_axis = axis
    return model


def model_axis_of(model: nn.Module) -> ModelAxis:
    """The model's `ModelAxis` (a replicated one of size 1 when none was
    applied)."""
    return getattr(model, "model_axis", None) or ModelAxis()


def partial_params(model: nn.Module) -> List[str]:
    """Names of the replicated parameters whose gradient each rank holds in
    part (the pools of each split MViT attention): the step sums them over
    the model group."""
    out = []
    for name, m in model.named_modules():
        for pool in getattr(m, "partial_pools", lambda: [])():
            out += [f"{name}.{pool}.{n}" for n, _ in
                    m.get_submodule(pool).named_parameters()]
    return out


def sharded_params(model: nn.Module) -> List[str]:
    """Names of the parameters that hold one rank's shard."""
    return [k for k in model_axis_of(model).plan
            if k in dict(model.named_parameters())]
