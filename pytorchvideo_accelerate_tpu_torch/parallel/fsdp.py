"""Fully sharded data parallelism over the library mesh's fsdp axis (the
ZeRO-3 layout that the JAX package gets from its `fsdp_spec` annotations,
which XLA lowers to gathers and reduce-scatters; here they are explicit).

`apply_fsdp(model, axis)` keeps, of each leaf that `axis.fsdp_plan` names
(`parallel/sharding.py fsdp_plan`, the JAX rule), this rank's contiguous
chunk of its fsdp dim: the `nn.Parameter` the optimizer sees, the EMA copy
and the optimizer's moments all have the chunk's shape, and the full value
exists only while a module runs:

- each owner's parent (the module whose forward reads the leaf: a
  `ConvBNAct` reads `conv.weight` itself, a block calls its `Dense`; a
  leaf of the root is its own) gets a pre-forward hook that gathers the
  full leaf over the fsdp group (`collectives.fsdp_gather`) and sets it on
  the owner's instance `__dict__`, where attribute lookup finds it before
  `nn.Module` looks in `_parameters`, and a post-forward hook (also on an
  exception) that drops it again. The forward sees the full weight (the
  fused BN fold folds the gathered weight, `ColumnDense` / `RowDense` get
  their full tensor-parallel shard); `state_dict()`, `parameters()` and
  `torch.func.functional_call` (the EMA's eval) see the chunk.
- autograd keeps the gathered weight that a backward needs and frees it
  after that backward; the gather's backward reduce-scatters the gradient
  (a sum over the fsdp group) into the chunk's `.grad`, so no full copy
  outlives a step.
- under activation checkpointing (`models/common.py remat_call`) the
  recompute gathers again: modules inside the block gather through their
  hooks as in the forward, and `regathered(block)` sets the leaves whose
  hook sits on the block itself, whose pre-forward does not run again.

A gathered leaf whose owner is also its unit's parent is set once per
forward of that unit; a hook finding the leaf already set (by
`regathered`) leaves it to whoever set it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

from torch import nn

from pytorchvideo_accelerate_tpu_torch.parallel.collectives import fsdp_gather
from pytorchvideo_accelerate_tpu_torch.parallel.distributed import fsdp_group
from pytorchvideo_accelerate_tpu_torch.parallel.sharding import shard_tensor

# (owner module, parameter name, fsdp dim) of each sharded leaf of a unit
Leaf = Tuple[nn.Module, str, int]
# gathers done since the last reset (forward and recompute)
GATHERS = [0]


def _gather_into(leaves: List[Leaf]) -> List[Leaf]:
    """Set the full value of each leaf not already set; returns those set."""
    group, done = fsdp_group(), []
    for owner, name, dim in leaves:
        if name in owner.__dict__:
            continue
        GATHERS[0] += 1
        owner.__dict__[name] = fsdp_gather(owner._parameters[name], dim, group)
        done.append((owner, name, dim))
    return done


def _drop(leaves: List[Leaf]) -> None:
    for owner, name, _ in leaves:
        owner.__dict__.pop(name, None)


def _unit_of(model: nn.Module, key: str) -> Tuple[nn.Module, nn.Module, str]:
    """(unit, owner, parameter name) of state-dict key `key`."""
    module, _, name = key.rpartition(".")
    owner = model.get_submodule(module) if module else model
    parent = module.rpartition(".")[0]
    unit = model.get_submodule(parent) if (module and parent) else model
    return unit, owner, name


def apply_fsdp(model: nn.Module, axis) -> nn.Module:
    """Cut each leaf of `axis.fsdp_plan` to this rank's chunk
    (`axis.fsdp_index` of `axis.fsdp_count`) in place and hook the units
    that gather them (the module docstring). A no-op without a plan."""
    if not axis.fsdp_plan:
        return model
    units: Dict[nn.Module, List[Leaf]] = {}
    for key, dim in axis.fsdp_plan.items():
        unit, owner, name = _unit_of(model, key)
        param = owner._parameters[name]
        chunk = shard_tensor(param.data, axis.fsdp_index, axis.fsdp_count, dim, 1)
        owner._parameters[name] = nn.Parameter(chunk, requires_grad=param.requires_grad)
        units.setdefault(unit, []).append((owner, name, dim))
    for unit, leaves in units.items():
        unit._fsdp_leaves = leaves
        unit._fsdp_set = []
        unit.register_forward_pre_hook(_pre_forward)
        unit.register_forward_hook(_post_forward, always_call=True)
    return model


def _pre_forward(unit: nn.Module, args) -> None:
    unit._fsdp_set.append(_gather_into(unit._fsdp_leaves))


def _post_forward(unit: nn.Module, args, output) -> None:
    if unit._fsdp_set:
        _drop(unit._fsdp_set.pop())


@contextlib.contextmanager
def regathered(block: nn.Module):
    """The leaves whose hook sits on `block` itself set for the duration
    (a checkpointed block's recompute runs its body without its
    pre-forward); a no-op for a block without any."""
    leaves = getattr(block, "_fsdp_leaves", None)
    if not leaves:
        yield
        return
    done = _gather_into(leaves)
    try:
        yield
    finally:
        _drop(done)
