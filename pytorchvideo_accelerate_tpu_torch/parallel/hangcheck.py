"""Collective-hang attribution (the port's copy of the JAX package's
`parallel/hangcheck.py`).

A rank wedged in a collective looks like a slow input pipeline from the
outside: the process sits idle until the process group's timeout, or an
outer `timeout -k`, kills it blind. The watchdog (obs/watchdog.py) knows
that nothing progressed; this module tells it where. Every point where a
rank's host waits on the others wraps itself in `collective_section(op,
**info)`, an attributed `Watchdog.section` whose detail carries the op,
this rank's `host=i/n` and the info, so a stall dump reads

    [watchdog] collective wedged inside 'barrier host=1/2 name=checkpoint_close' for 10.1s

on each rank, before the kill. The sections: `host_allgather`,
`host_broadcast`, `host_reduce_sum` (parallel/collectives.py), `barrier`,
`any_process`, `desync_check` (parallel/distributed.py), `ckpt_save`,
`ckpt_wait`, `ckpt_close`, `ckpt_restore` (trainer/checkpoint.py),
`epoch_sync` and `step_dispatch` (trainer/loop.py; the latter covers the
step and the deferred metric read, where the host blocks on the card's
queue: under NCCL a collective only enqueues, so a section around
`all_reduce` alone would attribute nothing).

Disarmed (no watchdog installed, the default) a section costs three
module-global reads (the watchdog, the schedule recorder, the
`collective.sync` fault point) and yields. The `collective.sync` fault
point fires inside the section, after the watchdog has marked it open, so
an injected ``delay`` is a straggler to the detector; it is passed the
section's detail as its `path`, so a `FaultSpec(path_substr=...)` can pin
one collective. With a schedule recorder installed
(parallel/schedule_recorder.py) every section entry also records `(op,
info)` under this rank's label: `diff_schedules` then names the first
collective one rank issued and another did not.

Each rank is its own process with its own watchdog and recorder. The
watchdog's timeout should stay below the process group's own
(`distributed.initialize_distributed(timeout_s=)`), or NCCL's or gloo's
timeout kills the rank before the dump.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from pytorchvideo_accelerate_tpu_torch.reliability import faults

# the watchdog component every watched collective reports under
COMPONENT = "collective"

_watchdog = None
# installed and removed only through parallel/schedule_recorder.py
_recorder = None


def _set_schedule_recorder(recorder) -> None:
    global _recorder
    _recorder = recorder


def _schedule_recorder():
    return _recorder


def install_collective_watch(watchdog) -> None:
    """Route the watched collectives through `watchdog.section` (the
    Trainer installs its watchdog here)."""
    global _watchdog
    _watchdog = watchdog


def uninstall_collective_watch() -> None:
    global _watchdog
    _watchdog = None


def current_watchdog() -> Optional[object]:
    return _watchdog


def host_tag() -> str:
    """`host=i/n`: this rank of the process group (`host=0/1` without
    one), the one formatting of a rank's identity in every section."""
    from pytorchvideo_accelerate_tpu_torch.parallel.distributed import (
        process_count,
        process_index,
    )

    return f"host={process_index()}/{process_count()}"


def _info(info: dict) -> str:
    return "".join(f" {k}={v}" for k, v in info.items())


def section_detail(op: str, host_note: str = "", **info) -> str:
    """The watchdog's detail of `collective_section(op, host_note,
    **info)`: `"{op} {host_tag()}[ {host_note}] k=v ..."`."""
    note = f" {host_note}" if host_note else ""
    return f"{op} {host_tag()}{note}{_info(info)}"


@contextmanager
def collective_section(op: str, host_note: str = "", **info):
    """An attributed window around one point where this rank waits on the
    others (`section_detail` is its detail). `host_note` (the pipeline's
    `stage=s/P`) goes into the detail only, not the schedule, which must
    agree across ranks."""
    wd = _watchdog
    rec = _recorder
    if rec is not None:
        # at entry: the issue order is the schedule ranks must agree on
        rec.record(op, _info(info).strip())
    if wd is None:
        if faults._plan is not None:  # disarmed: no detail is formatted
            faults.fault_point("collective.sync",
                               path=section_detail(op, host_note, **info))
        yield
        return
    detail = section_detail(op, host_note, **info)
    with wd.section(COMPONENT, detail):
        faults.fault_point("collective.sync", path=detail)
        yield
