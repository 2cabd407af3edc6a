"""The process group (counterpart of the JAX package's
`parallel/distributed.py`).

One process per card, torch's idiom: the launcher (`launch.py`) starts N
processes with the `PVA_*` env contract, and `initialize_distributed` joins
them into one `torch.distributed` group over
`tcp://<coordinator_address>`: NCCL on the card, gloo on the CPU
(`--cpu`). A caller may name the backend itself (`backend="gloo"` puts two
ranks on one card); a failing NCCL init fails the run, it never falls
back. Each rank trains on card `rank % torch.cuda.device_count()`.

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
