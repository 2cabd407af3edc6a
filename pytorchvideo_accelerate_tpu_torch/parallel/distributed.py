"""The process group (counterpart of the JAX package's
`parallel/distributed.py`).

One process per card, torch's idiom: the launcher (`launch.py`) starts N
processes with the `PVA_*` env contract, and `initialize_distributed` joins
them into one `torch.distributed` group over
`tcp://<coordinator_address>`: NCCL on the card, gloo on the CPU
(`--cpu`). A caller may name the backend itself (`backend="gloo"` puts two
ranks on one card); a failing NCCL init fails the run, it never falls
back. Each rank trains on card `rank % torch.cuda.device_count()`.

One rank grid serves both meshes of the JAX package: a tuple of named
axes and their sizes, rank r at the row-major coordinates of r
(`grid_ranks`), and one group of each kind for this rank, a kind being the
ranks that differ only on its axes: each axis, "batch" (the batch axes:
data, and fsdp on the library mesh) and "model" (every other axis).

- `initialize_mesh(model)` lays out the (data, model) train mesh, (world
  // model, model) (the row-major order of the JAX package's device grid
  on the CPU). model 1 lays out nothing: the data-parallel layout, every
  rank in the data and batch groups (the default group) and no model
  group.
- `initialize_library_mesh(fsdp, tensor, context)` lays out the 4-axis
  (data, fsdp, tensor, context) library mesh (the JAX package's
  `make_mesh`).

The accessors read the grid by role, as the JAX package reads a mesh
(`mesh.model_axis`, `mesh.cp_axis`): the tensor group (Megatron tensor
parallelism, and a pipeline's stages) is the group of the model-parallel
axis, `model` on the train mesh and `tensor` on the library mesh; the
context group (ring and Ulysses attention) that of the context-parallel
axis, `model` and `context`. On the train mesh both are the model group,
which a run spends on one of them. The batch group holds the shards of
every global batch (the loader's shard index `data_index * fsdp +
fsdp_index`), over which sync BatchNorm, the loss and eval sum; the fsdp
group the ranks over which fsdp-sharded parameters are gathered and their
gradients reduce-scattered (`parallel/fsdp.py`); the data group the ranks
over which a shard's gradients are averaged. `model_count()` /
`model_index()` are those of the model axes together (tensor x context on
the library mesh).

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

from pytorchvideo_accelerate_tpu_torch.parallel import mesh as pmesh
from pytorchvideo_accelerate_tpu_torch.parallel.hangcheck import collective_section
from pytorchvideo_accelerate_tpu_torch.parallel.mesh import LIBRARY_AXES, TRAIN_AXES

_INITIALIZED = False
_HOST_GROUP = None
# the one rank grid: its axes (the train mesh's or the library mesh's), their
# sizes (None: no grid laid out, the data-parallel layout) and this rank's
# group of each kind
_AXES: Tuple[str, ...] = TRAIN_AXES
_SHAPE: Optional[Tuple[int, ...]] = None
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
    (torch's default otherwise). A hang watchdog
    (`obs.watchdog_timeout_s`) dumps its evidence only if its timeout is
    shorter than this one: past `timeout_s` NCCL or gloo ends the rank."""
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


def grid_ranks(axes: Tuple[str, ...], shape: Tuple[int, ...]) -> Dict[str, List[List[int]]]:
    """{kind: its groups as lists of global ranks} of the grid of `axes`
    sized `shape`, rank r at the row-major coordinates of r. A kind holds
    the ranks that differ only on its own axes: one kind per axis, "batch"
    (the batch axes, `mesh.batch_axes`) and "model" (every other axis)."""
    batch = pmesh.batch_axes(axes)
    varying = {"batch": batch, **{a: (a,) for a in axes},
               "model": tuple(a for a in axes if a not in batch)}
    coords = list(itertools.product(*(range(n) for n in shape)))
    out = {}
    for kind, names in varying.items():
        pos = {axes.index(a) for a in names}
        groups: Dict[tuple, List[int]] = {}
        for rank, c in enumerate(coords):
            key = tuple(v for i, v in enumerate(c) if i not in pos)
            groups.setdefault(key, []).append(rank)
        out[kind] = list(groups.values())
    return out


def mesh_ranks(data: int, model: int) -> tuple:
    """(data groups, model groups) of a (data, model) grid as lists of
    global ranks: data group m holds ranks m, model + m, 2 model + m, ...;
    model group d holds ranks d * model ... d * model + model - 1."""
    kinds = grid_ranks(TRAIN_AXES, (data, model))
    return kinds["data"], kinds["model"]


def library_ranks(shape: Tuple[int, int, int, int]) -> Dict[str, List[List[int]]]:
    """`grid_ranks` of the (data, fsdp, tensor, context) grid `shape`:
    batch (data and fsdp), each axis, and model (tensor and context)."""
    return grid_ranks(LIBRARY_AXES, shape)


def library_coords(rank: int, shape: Tuple[int, ...]) -> tuple:
    """The row-major coordinates of `rank` on the grid `shape` ((data,
    fsdp, tensor, context) on the library mesh)."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _lay_out(axes: Tuple[str, ...], shape: Tuple[int, ...]) -> None:
    """Make the groups of the grid (`dist.new_group`, every rank the same
    calls in the same order, as torch requires). A kind whose groups span
    the world is the default group, one whose groups are those of a kind
    made before shares its groups, and one of single ranks still makes
    them (a collective over it is its identity, never the default group's).
    Idempotent for the same grid."""
    global _AXES, _SHAPE, _GROUPS
    if (axes, shape) == (_AXES, _SHAPE):
        return
    reset_mesh()
    world, rank = process_count(), process_index()
    groups, made = {}, {}
    for kind, lists in grid_ranks(axes, shape).items():
        key = tuple(map(tuple, lists))
        if key in made:
            groups[kind] = made[key]
            continue
        if len(lists[0]) == world:
            groups[kind] = dist.group.WORLD
        else:
            for ranks in lists:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[kind] = g
        made[key] = groups[kind]
    _AXES, _SHAPE, _GROUPS = axes, shape, groups


def initialize_mesh(model: int) -> None:
    """Lay the ranks out on the (world // model, model) train mesh. model 1
    makes no group (the data-parallel layout); another size replaces the
    layout."""
    world = process_count()
    if model < 1 or world % model:
        raise ValueError(f"mesh.model={model} does not divide device count "
                         f"{world}")
    if model == 1:
        reset_mesh()
        return
    _lay_out(TRAIN_AXES, (world // model, model))


def initialize_library_mesh(fsdp: int, tensor: int, context: int) -> None:
    """Lay the ranks out on the (world / (fsdp tensor context), fsdp,
    tensor, context) library mesh."""
    world = process_count()
    inner = fsdp * tensor * context
    if min(fsdp, tensor, context) < 1 or world % inner:
        raise ValueError(f"mesh axes fsdp*tensor*context={inner} does not "
                         f"divide device count {world}")
    _lay_out(LIBRARY_AXES, (world // inner, fsdp, tensor, context))


def library_shape() -> Optional[Tuple[int, int, int, int]]:
    """The library mesh's (data, fsdp, tensor, context), None on the
    (data, model) grid."""
    return _SHAPE if _AXES == LIBRARY_AXES else None


def reset_mesh() -> None:
    """Back to the data-parallel layout (model 1); the groups are left to
    the process group's teardown."""
    global _AXES, _SHAPE, _GROUPS
    _AXES, _SHAPE, _GROUPS = TRAIN_AXES, None, {}


def _sizes() -> Dict[str, int]:
    """{axis: size} of the grid; (world, 1) when none is laid out."""
    return dict(zip(_AXES, _SHAPE or (process_count(), 1)))


def _coords() -> Dict[str, int]:
    sizes = _sizes()
    return dict(zip(_AXES, library_coords(process_index(), tuple(sizes.values()))))


def _count(axes) -> int:
    sizes = _sizes()
    return int(np.prod([sizes.get(a, 1) for a in axes]))


def _index(axes) -> int:
    """This rank's row-major index over `axes` (0 over absent ones)."""
    sizes, coords, i = _sizes(), _coords(), 0
    for a in axes:
        i = i * sizes.get(a, 1) + coords.get(a, 0)
    return i


def _group(kind: str):
    """This rank's group of `kind`; with no grid laid out every rank shares
    the data and batch kinds (the default group) and no other."""
    if kind in _GROUPS:
        return _GROUPS[kind]
    if kind in ("data", "batch") and _SHAPE is None and is_distributed():
        return dist.group.WORLD
    return None


def _model_axes() -> tuple:
    return tuple(a for a in _AXES if a not in pmesh.batch_axes(_AXES))


def model_count() -> int:
    """Ranks on the model axis (1 without a mesh); on the library mesh the
    tensor x context ranks that share a batch slice."""
    return _count(_model_axes())


def model_index() -> int:
    return _index(_model_axes())


def model_group():
    """This rank's model group (the tensor x context ranks of its batch
    shard on the library mesh); None at model 1."""
    return _group("model")


def data_count() -> int:
    """Ranks on the data axis: on the (data, model) grid the slices of
    every global batch."""
    return _count(("data",))


def data_index() -> int:
    return _index(("data",))


def data_group():
    """This rank's data group: the default group at model 1."""
    return _group("data")


def batch_count() -> int:
    """The shards of every global batch: data x fsdp (the data count on
    the (data, model) grid)."""
    return _count(pmesh.batch_axes(_AXES))


def batch_index() -> int:
    """This rank's batch shard, data_index * fsdp + fsdp_index."""
    return _index(pmesh.batch_axes(_AXES))


def batch_group():
    """The ranks of the other batch shards of this rank's (tensor,
    context): the data group on the (data, model) grid."""
    return _group("batch")


def fsdp_count() -> int:
    return _count(("fsdp",))


def fsdp_index() -> int:
    return _index(("fsdp",))


def fsdp_group():
    """The ranks over which the fsdp shards are gathered; None off the
    library mesh."""
    return _group("fsdp")


def tensor_count() -> int:
    """Ranks Megatron tensor parallelism (or the pipeline's stages) splits
    over: the model axis on the (data, model) grid."""
    return _count((pmesh.model_axis(_AXES),))


def tensor_index() -> int:
    return _index((pmesh.model_axis(_AXES),))


def tensor_group():
    return _group(pmesh.model_axis(_AXES))


def context_count() -> int:
    """Ranks ring or Ulysses attention splits the tokens over: the model
    axis on the (data, model) grid."""
    return _count((pmesh.cp_axis(_AXES),))


def context_index() -> int:
    return _index((pmesh.cp_axis(_AXES),))


def context_group():
    return _group(pmesh.cp_axis(_AXES))


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
    group. Watched: a `barrier` section whose detail carries `name`
    (parallel/hangcheck.py)."""
    if is_distributed():
        with collective_section("barrier", name=name):
            dist.barrier(group=host_group())


def any_process(flag: bool) -> bool:
    """True on every rank when `flag` is true on any rank: one scalar
    all-reduce (max) over the host group, in an `any_process` section. A
    decision that one rank makes alone (a preemption signal) is made by
    all this way, at the same step."""
    if not is_distributed():
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    with collective_section("any_process"):
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

    with collective_section("desync_check", name=name):
        vals = np.asarray(host_allgather(np.float32(fingerprint))).reshape(-1)
    agree = np.all((vals == vals[0]) | (np.isnan(vals) & np.isnan(vals[0])))
    if not agree:
        raise RuntimeError(
            f"cross-host desync on {name!r}: per-process fingerprints "
            f"{vals.tolist()}")
    if np.isnan(vals[0]):
        main_print(f"desync check on {name!r}: fingerprint is NaN on all "
                   "hosts (consistent, but the run has diverged)", flush=True)
