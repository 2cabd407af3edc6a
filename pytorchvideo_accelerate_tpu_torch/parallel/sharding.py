"""Which parameters the model axis and the fsdp axis split, and the split
itself (the port's copy of the tensor-parallel and fsdp rules of the JAX
package's `parallel/sharding.py`).

`_TP_COLUMN`, `_TP_ROW`, `_TP_FAMILIES`, `family_uses_tp` and `tp_dim` are
the JAX package's rules, run on the flax path and kernel layout that
`models/convert.py` maps each of the port's keys to (`flax_names`): the
column-parallel `qkv` / `mlp_fc1` shard their output features and bias,
the row-parallel `proj` / `mlp_fc2` their input features, and every other
leaf is replicated.

`shard_plan` turns them into the port's layout, one entry per split key,
`(torch dim, parts)`:

- the dim is `tp_dim`'s flax dim through the converter's transpose (a
  torch Linear weight is (out, in), a flax kernel (in, out));
- `qkv` splits head-aligned (`parts` 3): rank m keeps heads [m H / tp,
  (m + 1) H / tp) of each of q, k and v, where `tp_dim` would cut the 3 dim
  output columns contiguously (GSPMD then reshards behind the scenes);
  the block's `proj` keeps the matching input rows;
- a block's attention splits only where its heads divide the model axis
  and `tp_dim` names both its `qkv` and its `proj` (VideoMAE's decoder
  `proj`, `dec_block*`, is not one of the projections `tp_dim` shards), and
  an MLP only as the pair `mlp_fc1` / `mlp_fc2`; otherwise the pair stays
  replicated, and every rank computes it alike.

`shard_state_dict` cuts a full state dict to one rank's shards and
`gather_state_dict` puts the shards of a model group back together, bit
for bit: checkpoints always hold the full tree.

The fsdp axis of the library mesh (`fsdp_spec`, `param_dims`: the JAX
package's `fsdp_spec` and `param_sharding`): a leaf of at least `min_size`
(2^16) elements shards its largest dim that the fsdp axis divides (a stable
sort: the first of equal dims), and a leaf that `tp_dim` splits takes the
largest other divisible dim. The rule runs on the flax shape of each leaf,
as the JAX one does (a conv kernel's (T, H, W, I, O) with I == O picks I),
and `_torch_dim` maps the chosen dim onto the torch tensor. `fsdp_plan`
gives {key: torch dim} of a full model's state dict; a rank holds the
contiguous `index`-th of `count` equal chunks of that dim (the block a
JAX device at that fsdp index holds), cut after the tensor-parallel shard
(`local_state_dict`), gathered before it (`full_state_dict`).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from pytorchvideo_accelerate_tpu_torch.models.convert import flax_key

# --- the JAX package's rules ------------------------------------------------

_TP_COLUMN = frozenset({"qkv", "mlp_fc1"})
_TP_ROW = frozenset({"proj", "mlp_fc2"})

# the families whose blocks carry the qkv/proj/mlp names the rules key on;
# every conv family replicates over the model axis
_TP_FAMILIES = ("mvit", "videomae")


def family_uses_tp(model_name: str) -> bool:
    """Does this model family spend the `model` axis on Megatron TP?"""
    return model_name.startswith(_TP_FAMILIES)


def tp_dim(names: tuple, shape: tuple, tensor_size: int) -> Optional[int]:
    """Which dim (if any) of this flax param (path `names`, flax `shape`)
    shards over the model axis of size `tensor_size`."""
    if tensor_size <= 1 or len(names) < 2 or len(shape) < 1:
        return None
    module, leaf = names[-2], names[-1]
    # "proj" is also the name of classifier heads and CubeEmbed's
    # patchifying conv: only the attention out-projection inside a
    # transformer block is row-parallel
    if module == "proj" and not (
        len(names) >= 3
        and (names[-3] == "attn" or re.match(r"block\d+$", names[-3]))
    ):
        return None
    if module in _TP_COLUMN:
        if leaf == "kernel" and shape[-1] % tensor_size == 0:
            return len(shape) - 1
        if leaf == "bias" and shape[0] % tensor_size == 0:
            return 0
    if (module in _TP_ROW and leaf == "kernel" and len(shape) >= 2
            and shape[0] % tensor_size == 0):
        return 0
    return None


# --- the port's layout --------------------------------------------------------

_PAIR = {"qkv": "proj", "proj": "qkv", "mlp_fc1": "mlp_fc2", "mlp_fc2": "mlp_fc1"}
Plan = Dict[str, Tuple[int, int]]


def flax_names(key: str, shape: tuple) -> Tuple[tuple, tuple]:
    """(flax path under `params`, flax shape) of the port's state_dict key
    `key` holding a tensor of `shape`."""
    names = tuple(flax_key(key, len(shape)).split("/")[1:])
    if names[-1] == "kernel" and len(shape) == 2:  # (out, in) -> (in, out)
        return names, tuple(reversed(shape))
    if names[-1] == "kernel" and len(shape) == 5:  # OIDHW -> DHWIO
        return names, tuple(shape[i] for i in (2, 3, 4, 1, 0))
    return names, tuple(shape)


# a conv kernel's flax dim (T, H, W, I, O) -> its torch dim (O, I, T, H, W)
_CONV_DIM = (2, 3, 4, 1, 0)


def _torch_dim(flax_dim: int, ndim: int, kernel: bool = True) -> int:
    """A leaf's flax dim as the torch tensor's: a Dense kernel (in, out)
    is the torch weight (out, in), a conv kernel DHWIO is OIDHW, any other
    leaf (`kernel` False: a bias, a scale, a position table) keeps its
    layout (`flax_names`)."""
    if kernel and ndim == 2:
        return ndim - 1 - flax_dim
    if kernel and ndim == 5:
        return _CONV_DIM[flax_dim]
    return flax_dim


def fsdp_spec(shape: tuple, fsdp_size: int, min_size: int = 2**16) -> Optional[int]:
    """The dim (if any) of a leaf of `shape` that shards over `fsdp`: the
    largest that `fsdp_size` divides, for a leaf of at least `min_size`
    elements (the JAX package's `fsdp_spec`, as a dim)."""
    shape = tuple(shape)
    if fsdp_size <= 1 or np.prod(shape, dtype=np.int64) < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % fsdp_size == 0:
            return d
    return None


def param_dims(names: tuple, shape: tuple, tensor_size: int, fsdp_size: int,
               min_size: int = 2**16) -> Tuple[Optional[int], Optional[int]]:
    """(tensor dim, fsdp dim) of a flax leaf (the JAX package's
    `param_sharding` rule): the TP dim over `tensor`, and fsdp on the
    largest other divisible dim of a big enough leaf; `fsdp_spec` when the
    leaf is not tensor-split (`tensor_size` 1: the conv families, or
    context parallelism on the train mesh)."""
    shape = tuple(shape)
    d = tp_dim(names, shape, tensor_size)
    if d is None:
        return None, fsdp_spec(shape, fsdp_size, min_size)
    if fsdp_size > 1 and np.prod(shape, dtype=np.int64) >= min_size:
        for other in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if other != d and shape[other] % fsdp_size == 0:
                return d, other
    return d, None


FsdpPlan = Dict[str, int]
TP, FSDP = 1, 2  # a parameter's layout bits (`tensor_parallel.param_kinds`)


def fsdp_plan(shapes: Mapping[str, tuple], fsdp_size: int, tensor_size: int = 1,
              min_size: int = 2**16) -> FsdpPlan:
    """{key: torch dim} of the keys of a full model's state dict (`shapes`)
    that the fsdp axis of size `fsdp_size` splits; `tensor_size`: the
    tensor axis the rule composes with (1 when the layout does not split
    tensors)."""
    if fsdp_size <= 1:
        return {}
    plan: FsdpPlan = {}
    for key, shape in shapes.items():
        names, fshape = flax_names(key, tuple(shape))
        _, f = param_dims(names, fshape, tensor_size, fsdp_size, min_size)
        if f is not None:
            plan[key] = _torch_dim(f, len(shape), names[-1] == "kernel")
    return plan


def shard_plan(shapes: Mapping[str, tuple], count: int,
               heads: Mapping[str, int]) -> Plan:
    """{key: (torch dim, parts)} of the keys the model axis of size `count`
    splits (see the module docstring). `shapes`: the full model's state_dict
    shapes; `heads`: each attention module's key prefix (the parent of its
    `qkv`) -> its head count."""
    if count <= 1:
        return {}
    raw = {}
    for key, shape in shapes.items():
        if key.rsplit(".", 1)[-1] not in ("weight", "bias") or not shape:
            continue
        names, fshape = flax_names(key, tuple(shape))
        d = tp_dim(names, fshape, count)
        if d is not None:
            raw[key] = _torch_dim(d, len(shape))
    plan: Plan = {}
    for key, dim in raw.items():
        module = key.rsplit(".", 1)[0]
        parent, _, name = module.rpartition(".")
        prefix = f"{parent}." if parent else ""
        if f"{prefix}{_PAIR[name]}.weight" not in raw or f"{module}.weight" not in raw:
            continue
        if name in ("qkv", "proj") and (parent not in heads or heads[parent] % count):
            continue
        plan[key] = (dim, 3 if name == "qkv" else 1)
    return plan


def shard_tensor(x: torch.Tensor, index: int, count: int, dim: int,
                 parts: int) -> torch.Tensor:
    """Rank `index`'s shard of the full `x`: its 1/count of each of `parts`
    equal parts of dim `dim`, concatenated (a copy)."""
    chunks = x.chunk(parts, dim=dim)
    return torch.cat([c.chunk(count, dim=dim)[index] for c in chunks],
                     dim=dim).clone()


def join_shards(shards, dim: int, parts: int) -> torch.Tensor:
    """Inverse of `shard_tensor` over every rank's shard, rank order."""
    cut = [s.chunk(parts, dim=dim) for s in shards]
    return torch.cat([c[p] for p in range(parts) for c in cut], dim=dim)


def shard_state_dict(sd: Mapping[str, torch.Tensor], model_index: int,
                     model_count: int, plan: Plan) -> dict:
    """The shards of rank `model_index` of `model_count` of a full state
    dict: every key of `plan` cut, every other key as it is."""
    return {k: (shard_tensor(v, model_index, model_count, *plan[k])
                if k in plan else v) for k, v in sd.items()}


def gather_state_dict(sd: Mapping[str, torch.Tensor], plan: Plan,
                      group) -> dict:
    """The full state dict from every rank's shards over the model group
    `group` (a collective: every rank of the group calls it with its own
    shards, the same keys in the same order); the keys outside `plan` as
    this rank holds them."""
    from pytorchvideo_accelerate_tpu_torch.parallel.collectives import gather_list

    return {k: (join_shards(gather_list(v, group), *plan[k])
                if k in plan else v) for k, v in sd.items()}


def shard_fsdp(sd: Mapping[str, torch.Tensor], index: int, count: int,
               plan: FsdpPlan) -> dict:
    """The fsdp shards of rank `index` of `count` (a copy of each keyed
    leaf's `index`-th contiguous chunk of its dim); other keys as they
    are."""
    return {k: (shard_tensor(v, index, count, plan[k], 1) if k in plan else v)
            for k, v in sd.items()}


def gather_fsdp(sd: Mapping[str, torch.Tensor], plan: FsdpPlan, group) -> dict:
    """The fsdp shards of every rank of `group` joined (a collective, as
    `gather_state_dict`)."""
    from pytorchvideo_accelerate_tpu_torch.parallel.collectives import gather_list

    return {k: (torch.cat(gather_list(v, group), plan[k]) if k in plan else v)
            for k, v in sd.items()}


def local_state_dict(sd: Mapping[str, torch.Tensor], axis) -> dict:
    """A full state dict cut to this rank's shards on `axis` (a
    `tensor_parallel.ModelAxis`): the tensor-parallel cut, then the fsdp
    one."""
    out = shard_state_dict(sd, axis.index, axis.count, axis.plan) if axis.plan else dict(sd)
    if axis.fsdp_plan:
        out = shard_fsdp(out, axis.fsdp_index, axis.fsdp_count, axis.fsdp_plan)
    return out


def full_state_dict(sd: Mapping[str, torch.Tensor], axis) -> dict:
    """The full state dict from this rank's shards on `axis` (a collective
    over the fsdp group, then the tensor group: every rank calls it with
    the same keys in the same order)."""
    from pytorchvideo_accelerate_tpu_torch.parallel.distributed import (
        fsdp_group,
        tensor_group,
    )

    out = dict(sd)
    if axis.fsdp_plan:
        out = gather_fsdp(out, axis.fsdp_plan, fsdp_group())
    if axis.plan:
        out = gather_state_dict(out, axis.plan, tensor_group())
    return out
