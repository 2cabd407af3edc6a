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
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_INITIALIZED = False
_HOST_GROUP = None
# the train mesh: model-axis size, this rank's data and model groups
_MODEL_COUNT = 1
_DATA_GROUP = None
_MODEL_GROUP = None


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
    if model == _MODEL_COUNT and (model == 1 or _MODEL_GROUP is not None):
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


def reset_mesh() -> None:
    """Back to the data-parallel layout (model 1); the groups are left to
    the process group's teardown."""
    global _MODEL_COUNT, _DATA_GROUP, _MODEL_GROUP
    _MODEL_COUNT, _DATA_GROUP, _MODEL_GROUP = 1, None, None


def model_count() -> int:
    """Ranks on the model axis (1 without a mesh)."""
    return _MODEL_COUNT


def model_index() -> int:
    return process_index() % _MODEL_COUNT


def data_count() -> int:
    """Ranks on the data axis: the slices of every global batch."""
    return process_count() // _MODEL_COUNT


def data_index() -> int:
    return process_index() // _MODEL_COUNT


def data_group():
    """This rank's data group: the default group at model 1."""
    if _MODEL_COUNT == 1:
        return dist.group.WORLD if is_distributed() else None
    return _DATA_GROUP


def model_group():
    """This rank's model group; None at model 1."""
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
