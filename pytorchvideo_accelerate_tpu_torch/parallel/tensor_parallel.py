"""Megatron tensor parallelism over the train mesh's model axis, or the
library mesh's tensor axis (the port's counterpart of the JAX package's
GSPMD rules in `parallel/sharding.py`, which do not translate: here the
layers and their collectives are explicit).

- `ColumnDense`: a `Dense` holding this rank's output features (its rows
  of the torch weight and of the bias); its input goes through
  `copy_to_model`, whose backward sums the input's gradient over the
  tensor group (`distributed.tensor_group()`: the model group on the
  (data, model) grid).
- `RowDense`: a `Dense` holding this rank's input features (columns of
  the weight); the partial products are summed over the tensor group
  (`reduce_from_model`) and the full bias is added once, after the sum.
- `ModelAxis`: how a run lays the model out (`layout`, the JAX trainer's
  decision). On the (data, model) grid the one model axis is spent on
  tensor parallelism (MViT and VideoMAE: `tp`), on context parallelism
  (`--model.attention ring|ulysses`: `cp`, the attention's token axis
  split over the same ranks, parameters replicated), on pipeline stages
  (`pipeline`, `parallel/pipeline.py`: parameters replicated) or on
  nothing (the conv families replicate). On the library mesh TP (or the
  stages) runs over `tensor` and CP over `context`, both at once, and
  `fsdp_plan` shards the big leaves over `fsdp` (`parallel/fsdp.py`).
- `apply_model_axis(model, axis)`: the full-width model, built from the
  seed on every rank, cut to this rank's shards in place by
  `parallel/sharding.py shard_plan`: each split `qkv`/`proj`/`mlp_fc1`/
  `mlp_fc2` becomes a `ColumnDense`/`RowDense` holding its slice, and each
  split attention runs its local heads; then each leaf of the fsdp plan
  (the JAX rule on the full shapes) keeps its fsdp chunk. The layout rides
  on the model (`model.model_axis`) for the checkpoint's gather and the
  step.

Replicated leaves that a split attention uses only in part (MViT's
`pool_q/k/v` conv taps and norm, shared by all heads, of which each rank
pools its local heads) get a partial gradient on each rank;
`partial_params` names them, and the step sums their gradients over the
model group.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import Dense
from pytorchvideo_accelerate_tpu_torch.parallel.collectives import (
    copy_to_model,
    reduce_from_model,
)
from pytorchvideo_accelerate_tpu_torch.parallel.distributed import tensor_group
from pytorchvideo_accelerate_tpu_torch.parallel.fsdp import apply_fsdp
from pytorchvideo_accelerate_tpu_torch.parallel.pipeline import (
    PipelinePlan,
    is_active,
    staged_params,
)
from pytorchvideo_accelerate_tpu_torch.parallel.sharding import (
    FSDP,
    TP,
    FsdpPlan,
    Plan,
    family_uses_tp,
    fsdp_plan,
    shard_plan,
    shard_tensor,
)

CP_BACKENDS = ("ring", "ulysses")


@dataclass
class ModelAxis:
    """The layout of one rank's model. The tensor-parallel split: its
    size `count` (the model axis, or the library mesh's tensor axis) and
    this rank's `index`; `tp` (heads and MLP widths split) and `cp` (the
    attention's tokens split over the context group). On the (data, model)
    grid the one axis carries one of them; neither is replication.
    `library`: the 4-axis mesh, where TP and CP have axes of their own,
    and `fsdp_count` / `fsdp_index` the fsdp axis, whose rule shards the
    leaves of at least `fsdp_min_size` elements. `plan` and `fsdp_plan`
    are filled by `apply_model_axis`."""

    count: int = 1
    index: int = 0
    tp: bool = False
    cp: bool = False
    plan: Plan = field(default_factory=dict)
    library: bool = False
    fsdp_count: int = 1
    fsdp_index: int = 0
    fsdp_min_size: int = 2**16
    fsdp_plan: FsdpPlan = field(default_factory=dict)
    pipeline: Optional[PipelinePlan] = None

    @property
    def mode(self) -> str:
        """What the model-parallel axis carries (the JAX trainer's word):
        on the library mesh context parallelism has its own axis."""
        if self.pipeline is not None:
            return (f"pipelined ({self.pipeline.stages} stages, "
                    f"{self.pipeline.microbatches} microbatches)")
        if self.cp and not self.library:
            return "context-parallel"
        return "tensor-parallel" if self.tp else "replicated"


def layout(model_name: str, attention: str, count: int, index: int = 0, *,
           library: bool = False, fsdp_count: int = 1, fsdp_index: int = 0,
           fsdp_min_size: int = 2**16,
           pipeline: Optional[PipelinePlan] = None) -> ModelAxis:
    """The JAX trainer's decision (`trainer/loop.py`): on the (data,
    model) grid the context-parallel lane spends the model axis when
    `attention` is ring or ulysses; otherwise the transformer families
    split heads and MLP widths over it and the rest replicate. On the
    library mesh (`library`) the transformer families split over the
    tensor axis (`count`) whatever the attention, ring and ulysses run
    over the context axis, and the fsdp axis shards the leaves of at least
    `fsdp_min_size` elements (the JAX package's `min_size`). An active
    `pipeline` spends the axis on stages (`parallel/pipeline.py`): no
    tensor parallelism."""
    cp = attention in CP_BACKENDS
    pipelined = is_active(pipeline)
    tp = family_uses_tp(model_name) and (library or not cp) and not pipelined
    return ModelAxis(count=count, index=index, tp=tp and count > 1, cp=cp,
                     library=library, fsdp_count=fsdp_count,
                     fsdp_index=fsdp_index, fsdp_min_size=fsdp_min_size,
                     pipeline=pipeline if pipelined else None)


class ColumnDense(Dense):
    """Column-parallel `Dense`: this rank's output features."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return F.linear(copy_to_model(x.to(d), tensor_group()),
                        self.weight.to(d), self.bias.to(d))


class RowDense(Dense):
    """Row-parallel `Dense`: this rank's input features; the bias is added
    once, after the sum over the tensor group."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = reduce_from_model(F.linear(x.to(d), self.weight.to(d)), tensor_group())
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
    unless `axis.tp` and `axis.count > 1`, or `axis.fsdp_count > 1`) and
    attach `axis` as `model.model_axis`. Returns the model."""
    if axis.fsdp_count > 1:
        # the JAX rule on the full shapes, before the tensor cut; the BN
        # statistics (per channel, under 2^16 in every model) stay whole
        shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
        axis.fsdp_plan = fsdp_plan(shapes, axis.fsdp_count,
                                   axis.count if axis.tp else 1,
                                   axis.fsdp_min_size)
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
    apply_fsdp(model, axis)
    model.model_axis = axis
    return model


def model_axis_of(model: nn.Module) -> ModelAxis:
    """The model's `ModelAxis` (a replicated one of size 1 when none was
    applied)."""
    return getattr(model, "model_axis", None) or ModelAxis()


def partial_params(model: nn.Module) -> List[str]:
    """Names of the replicated parameters whose gradient each rank holds in
    part: the pools of each split MViT attention, and the blocks of a
    pipelined trunk, each of which only its owner stage runs
    (`parallel/pipeline.py staged_params`). The step sums them over the
    tensor group (the stage group)."""
    out = staged_params(model)
    for name, m in model.named_modules():
        for pool in getattr(m, "partial_pools", lambda: [])():
            out += [f"{name}.{pool}.{n}" for n, _ in
                    m.get_submodule(pool).named_parameters()]
    return out


def param_kinds(model: nn.Module) -> Dict[str, int]:
    """{name: `TP` | `FSDP` bits} of every parameter (0: replicated)."""
    axis = model_axis_of(model)
    return {n: (TP if n in axis.plan else 0) | (FSDP if n in axis.fsdp_plan else 0)
            for n, _ in model.named_parameters()}
