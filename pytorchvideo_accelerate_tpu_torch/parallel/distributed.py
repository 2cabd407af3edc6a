"""The process group (counterpart of the JAX package's
`parallel/distributed.py`).

One process per card, torch's idiom: the launcher (`launch.py`) starts N
processes with the `PVA_*` env contract, and `initialize_distributed` joins
them into one `torch.distributed` group over
`tcp://<coordinator_address>`: NCCL on the card, gloo on the CPU
(`--cpu`). A caller may name the backend itself (`backend="gloo"` puts two
ranks on one card); a failing NCCL init fails the run, it never falls
back. Each rank trains on card `rank % torch.cuda.device_count()`.

The train mesh: after `initialize_distributed`, `initialize_mesh(model)`
lays the ranks out on the (data, model) grid, rank r at (r // model,
r % model) (the row-major order of the JAX package's device grid on the
CPU), and makes one data group per model index (the ranks that hold the
same shard of the model, over which gradients are averaged) and one model
group per data index (the ranks that share a slice of the global batch,
over which heads, MLP widths or tokens are split). `data_index()`,
`data_count()`, `model_index()`, `model_count()`, `data_group()` and
`model_group()` read it; at model 1 (or with no group) they are the
rank, the world size, 0, 1, the default group and None, so a
data-parallel job runs as before.

The library mesh (`--mesh.fsdp/tensor/context`, the JAX package's
`make_mesh`): `initialize_library_mesh(fsdp, tensor, context)` lays the
ranks on the 4-axis (data, fsdp, tensor, context) grid, rank r at the
row-major coordinates of r (`library_ranks`), and makes five kinds of
group, each with its index and count:

- batch: the ranks that share (tensor, context), i.e. data x fsdp: the
  shards of every global batch (the loader's shard index
  `data_index * fsdp + fsdp_index`), over which sync BatchNorm, the loss
  and eval sum;
- fsdp: the ranks that share (data, tensor, context), over which the
  fsdp-sharded parameters are gathered and their gradients
  reduce-scattered (`parallel/fsdp.py`);
- data: the ranks that share (fsdp, tensor, context), over which the
  fsdp shards' gradients are averaged;
- tensor: the ranks that share (data, fsdp, context), over which
  Megatron tensor parallelism splits heads and MLP widths;
- context: the ranks that share (data, fsdp, tensor), over which ring or
  Ulysses attention splits the tokens.

On the (data, model) grid the same functions read that layout: the batch
group is the data group, the fsdp group none, and the tensor and context
groups are both the model group (a run spends the model axis on one of
them). `model_count()` / `model_index()` on the library mesh are those of
the tensor x context ranks that share a batch slice (`tensor * context`,
`tensor_index * context + context_index`); it makes no group of them.

Host-side agreement (barriers, the resume step, the preemption flag,
desync fingerprints) runs over `host_group()`: the group itself under
gloo, a gloo group beside it under NCCL, so that a host collective moves
CPU tensors and never waits for the card's queue.

With no group every helper here is the single-process answer (rank 0 of
1, barriers and desync checks are no-ops), so code that calls them runs
unchanged without a launcher.
"""

from __future__ import annotations

import atexit
import datetime
import itertools
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_INITIALIZED = False
_HOST_GROUP = None
# the train mesh: model-axis size, this rank's data and model groups
_MODEL_COUNT = 1
_DATA_GROUP = None
_MODEL_GROUP = None
# the library mesh: its (data, fsdp, tensor, context) shape and this rank's
# group of each kind
_LIBRARY: Optional[Tuple[int, int, int, int]] = None
_GROUPS: Dict[str, object] = {}


def initialize_distributed(coordinator_address: str = "",
                           num_processes: int = 0, process_id: int = -1, *,
                           cpu: bool = False, backend: Optional[str] = None,
                           timeout_s: Optional[float] = None) -> bool:
    """Join the process group if the job names one; True when a group is
    up afterwards.

    Resolution order, the JAX package's: the arguments (from TrainConfig),
    then `PVA_COORDINATOR_ADDRESS` / `PVA_NUM_PROCESSES` / `PVA_PROCESS_ID`
    (the launcher's env contract), else a single process and a no-op.
    Idempotent: nothing happens after a first call that joined a group, or
    when the caller has set one up itself (`torch.distributed`'s own
    `init_process_group`). `backend`: "nccl" on the card and "gloo" with
    `cpu` unless given; `timeout_s` bounds every collective of the group
    (torch's default otherwise)."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        return dist.is_initialized()
    coordinator_address = coordinator_address or os.environ.get(
        "PVA_COORDINATOR_ADDRESS", "")
    num_processes = num_processes or int(os.environ.get("PVA_NUM_PROCESSES", "0"))
    env_pid = os.environ.get("PVA_PROCESS_ID", "")
    if process_id < 0 and env_pid:
        process_id = int(env_pid)
    if num_processes <= 1:
        return False
    if not coordinator_address:
        raise ValueError(
            f"num_processes={num_processes} needs a coordinator address to "
            "meet at: start the job with `python -m "
            "pytorchvideo_accelerate_tpu_torch.launch`, or set "
            "--coordinator_address / PVA_COORDINATOR_ADDRESS on every process")
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id must be in [0, {num_processes}) when a coordinator "
            f"is configured; got {process_id}. Set PVA_PROCESS_ID or "
            f"--process_id on every host.")
    backend = backend or ("gloo" if cpu else "nccl")
    if not cpu:
        torch.cuda.set_device(local_device_index(process_id))
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kwargs)
    _INITIALIZED = True
    atexit.register(_destroy)
    main_print(f"distributed: {num_processes} processes over {backend} "
               f"(coordinator {coordinator_address})", flush=True)
    return True


def _destroy() -> None:
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
    reset_mesh()


def mesh_ranks(data: int, model: int) -> tuple:
    """(data groups, model groups) of a (data, model) grid as lists of
    global ranks: data group m holds ranks m, model + m, 2 model + m, ...;
    model group d holds ranks d * model ... d * model + model - 1."""
    return ([[d * model + m for d in range(data)] for m in range(model)],
            [[d * model + m for m in range(model)] for d in range(data)])


def initialize_mesh(model: int) -> None:
    """Lay the ranks out on the (world // model, model) train mesh and make
    its groups (`dist.new_group`, every rank the same calls in the same
    order, as torch requires). model 1 makes no group. Idempotent for the
    same size; another size replaces the layout (after a `reset_mesh`)."""
    global _MODEL_COUNT, _DATA_GROUP, _MODEL_GROUP
    world = process_count()
    if model < 1 or world % model:
        raise ValueError(f"mesh.model={model} does not divide device count "
                         f"{world}")
    if (_LIBRARY is None and model == _MODEL_COUNT
            and (model == 1 or _MODEL_GROUP is not None)):
        return
    reset_mesh()
    if model == 1:
        return
    rank = process_index()
    data_groups, model_groups = mesh_ranks(world // model, model)
    for ranks in data_groups:
        g = dist.new_group(ranks)
        if rank in ranks:
            _DATA_GROUP = g
    for ranks in model_groups:
        g = dist.new_group(ranks)
        if rank in ranks:
            _MODEL_GROUP = g
    _MODEL_COUNT = model


def library_ranks(shape: Tuple[int, int, int, int]) -> Dict[str, List[List[int]]]:
    """{kind: its groups as lists of global ranks} of the (data, fsdp,
    tensor, context) grid `shape`, rank r at the row-major coordinates of
    r; each kind (batch, fsdp, data, tensor, context) holds the ranks that
    differ only on its own axes (batch: data and fsdp; each other kind: its
    one axis)."""
    varying = {"batch": (0, 1), "fsdp": (1,), "data": (0,), "tensor": (2,),
               "context": (3,)}
    coords = list(itertools.product(*(range(n) for n in shape)))
    out = {}
    for kind, axes in varying.items():
        groups: Dict[tuple, List[int]] = {}
        for rank, c in enumerate(coords):
            key = tuple(v for i, v in enumerate(c) if i not in axes)
            groups.setdefault(key, []).append(rank)
        out[kind] = list(groups.values())
    return out


def library_coords(rank: int, shape: Tuple[int, int, int, int]) -> tuple:
    """(data, fsdp, tensor, context) index of `rank` on the grid `shape`."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def initialize_library_mesh(fsdp: int, tensor: int, context: int) -> None:
    """Lay the ranks out on the (world / (fsdp tensor context), fsdp,
    tensor, context) library mesh and make its groups (`dist.new_group`,
    every rank the same calls in the same order). A kind whose groups span
    the world is the default group; one of single ranks still makes them
    (a collective over it is its identity, never the default group's).
    Idempotent for the same shape."""
    global _LIBRARY, _GROUPS
    world = process_count()
    inner = fsdp * tensor * context
    if min(fsdp, tensor, context) < 1 or world % inner:
        raise ValueError(f"mesh axes fsdp*tensor*context={inner} does not "
                         f"divide device count {world}")
    shape = (world // inner, fsdp, tensor, context)
    if shape == _LIBRARY:
        return
    reset_mesh()
    rank = process_index()
    groups = {}
    for kind, lists in library_ranks(shape).items():
        if len(lists[0]) == world:
            groups[kind] = dist.group.WORLD
            continue
        for ranks in lists:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[kind] = g
    _LIBRARY, _GROUPS = shape, groups


def library_shape() -> Optional[Tuple[int, int, int, int]]:
    """The library mesh's (data, fsdp, tensor, context), None on the
    (data, model) grid."""
    return _LIBRARY


def reset_mesh() -> None:
    """Back to the data-parallel layout (model 1); the groups are left to
    the process group's teardown."""
    global _MODEL_COUNT, _DATA_GROUP, _MODEL_GROUP, _LIBRARY, _GROUPS
    _MODEL_COUNT, _DATA_GROUP, _MODEL_GROUP = 1, None, None
    _LIBRARY, _GROUPS = None, {}


def _coord(axis: int) -> int:
    return library_coords(process_index(), _LIBRARY)[axis]


def model_count() -> int:
    """Ranks on the model axis (1 without a mesh); on the library mesh the
    tensor x context ranks that share a batch slice."""
    if _LIBRARY is not None:
        return _LIBRARY[2] * _LIBRARY[3]
    return _MODEL_COUNT


def model_index() -> int:
    if _LIBRARY is not None:
        return _coord(2) * _LIBRARY[3] + _coord(3)
    return process_index() % _MODEL_COUNT


def data_count() -> int:
    """Ranks on the data axis: on the (data, model) grid the slices of
    every global batch."""
    if _LIBRARY is not None:
        return _LIBRARY[0]
    return process_count() // _MODEL_COUNT


def data_index() -> int:
    if _LIBRARY is not None:
        return _coord(0)
    return process_index() // _MODEL_COUNT


def data_group():
    """This rank's data group: the default group at model 1."""
    if _LIBRARY is not None:
        return _GROUPS["data"]
    if _MODEL_COUNT == 1:
        return dist.group.WORLD if is_distributed() else None
    return _DATA_GROUP


def model_group():
    """This rank's model group; None at model 1 and on the library mesh
    (whose tensor and context groups split it)."""
    return _MODEL_GROUP


def batch_count() -> int:
    """The shards of every global batch: data x fsdp (the data count on
    the (data, model) grid)."""
    if _LIBRARY is not None:
        return _LIBRARY[0] * _LIBRARY[1]
    return data_count()


def batch_index() -> int:
    """This rank's batch shard, data_index * fsdp + fsdp_index."""
    if _LIBRARY is not None:
        return _coord(0) * _LIBRARY[1] + _coord(1)
    return data_index()


def batch_group():
    """The ranks of the other batch shards of this rank's (tensor,
    context): the data group on the (data, model) grid."""
    if _LIBRARY is not None:
        return _GROUPS["batch"]
    return data_group()


def fsdp_count() -> int:
    return _LIBRARY[1] if _LIBRARY is not None else 1


def fsdp_index() -> int:
    return _coord(1) if _LIBRARY is not None else 0


def fsdp_group():
    """The ranks over which the fsdp shards are gathered; None off the
    library mesh."""
    return _GROUPS.get("fsdp")


def tensor_count() -> int:
    """Ranks Megatron tensor parallelism splits over: the model axis on
    the (data, model) grid."""
    return _LIBRARY[2] if _LIBRARY is not None else _MODEL_COUNT


def tensor_index() -> int:
    return _coord(2) if _LIBRARY is not None else model_index()


def tensor_group():
    if _LIBRARY is not None:
        return _GROUPS["tensor"]
    return _MODEL_GROUP


def context_count() -> int:
    """Ranks ring or Ulysses attention splits the tokens over: the model
    axis on the (data, model) grid."""
    return _LIBRARY[3] if _LIBRARY is not None else _MODEL_COUNT


def context_index() -> int:
    return _coord(3) if _LIBRARY is not None else model_index()


def context_group():
    if _LIBRARY is not None:
        return _GROUPS["context"]
    return _MODEL_GROUP


def group_ranks(group) -> list:
    """The global ranks of `group` in group-rank order (the world's for
    the default group or None)."""
    if group is None or group is dist.group.WORLD:
        return list(range(process_count()))
    return dist.get_process_group_ranks(group)


def host_group():
    """The group host collectives use: the default group under gloo, else a
    gloo group over the same ranks, made at the first call (which every
    rank reaches together, as it is itself a collective)."""
    global _HOST_GROUP
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    return _HOST_GROUP


def is_distributed() -> bool:
    """A process group is up (the trainer's data-parallel path, world size
    1 included)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main_process() -> bool:
    """The rank that writes checkpoints, logs and trackers."""
    return process_index() == 0


def main_print(*args, **kwargs) -> None:
    if is_main_process():
        print(*args, **kwargs)


def local_device_index(rank: Optional[int] = None) -> int:
    """This rank's card: `rank % torch.cuda.device_count()`."""
    rank = process_index() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def sync_global_devices(name: str = "barrier") -> None:
    """A barrier of every rank (checkpoint fences); a no-op without a
    group. `name` is for the reader of a hang's stack."""
    del name
    if is_distributed():
        dist.barrier(group=host_group())


def any_process(flag: bool) -> bool:
    """True on every rank when `flag` is true on any rank: one scalar
    all-reduce (max) over the host group. A decision that one rank makes
    alone (a preemption signal) is made by all this way, at the same
    step."""
    if not is_distributed():
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t.item())


def check_desync(fingerprint: float, name: str = "train_state") -> None:
    """Compare a float32 fingerprint (the parameters' global norm) across
    ranks and raise on disagreement: silent replica divergence. All-NaN
    agrees (the run diverged identically everywhere: a NaN problem, not a
    desync). A no-op with one process."""
    if process_count() == 1:
        return
    from pytorchvideo_accelerate_tpu_torch.parallel.collectives import (
        host_allgather,
    )

    vals = np.asarray(host_allgather(np.float32(fingerprint))).reshape(-1)
    agree = np.all((vals == vals[0]) | (np.isnan(vals) & np.isnan(vals[0])))
    if not agree:
        raise RuntimeError(
            f"cross-host desync on {name!r}: per-process fingerprints "
            f"{vals.tolist()}")
    if np.isnan(vals[0]):
        main_print(f"desync check on {name!r}: fingerprint is NaN on all "
                   "hosts (consistent, but the run has diverged)", flush=True)
