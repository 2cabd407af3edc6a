"""Collective-schedule recorder and cross-rank differ (the port's copy of
the JAX package's `parallel/schedule_recorder.py`).

The ranks of a group must issue the same ordered collectives; a rank that
skips one (behind a rank-0 branch, a per-rank file check, an exception
path) wedges the others with no evidence but the wedge. The hang watch
(parallel/hangcheck.py) attributes the wedge; this module records why:
with a recorder installed, every `collective_section` entry appends one
`(tick, op, detail)` record under the recorder's host label, and
`diff_schedules` compares the per-rank streams and reports the first
divergence with both ranks' trailing windows.

Each rank is a process of its own in the port, so each records under its
own `hangcheck.host_tag()` label (`CollectiveScheduleRecorder(host_tag())`);
a caller merges the ranks' `schedules()` (one dict entry a rank) and
diffs them. Disarmed (the default) a section pays one module-global read.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

# entries shown on each side of a first-divergence report
DEFAULT_WINDOW = 5


class CollectiveScheduleRecorder:
    """Ordered (tick, op, detail) records per host label."""

    def __init__(self, host: str = "host=0/1"):
        self._lock = threading.Lock()
        self._host = host
        self._schedules: Dict[str, List[Tuple[int, str, str]]] = {}

    # --- recording --------------------------------------------------------

    def record(self, op: str, detail: str = "") -> None:
        """Append one schedule point under the current host label."""
        with self._lock:
            sched = self._schedules.setdefault(self._host, [])
            sched.append((len(sched), str(op), str(detail)))

    @contextmanager
    def as_host(self, host: str):
        """Record the enclosed segment under another host label."""
        with self._lock:
            prev, self._host = self._host, str(host)
        try:
            yield self
        finally:
            with self._lock:
                self._host = prev

    # --- reading ----------------------------------------------------------

    def schedules(self) -> Dict[str, List[Tuple[int, str, str]]]:
        with self._lock:
            return {h: list(s) for h, s in self._schedules.items()}

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {h: len(s) for h, s in self._schedules.items()}

    def snapshot(self) -> dict:
        """Per-host record counts and each host's last entry."""
        with self._lock:
            return {
                "hosts": sorted(self._schedules),
                "counts": {h: len(s) for h, s in self._schedules.items()},
                "last": {h: list(s[-1]) for h, s in self._schedules.items()
                         if s},
            }


def install_schedule_recorder(recorder: CollectiveScheduleRecorder) -> None:
    """Route every `collective_section` entry to `recorder`."""
    from pytorchvideo_accelerate_tpu_torch.parallel import hangcheck

    hangcheck._set_schedule_recorder(recorder)


def uninstall_schedule_recorder() -> None:
    from pytorchvideo_accelerate_tpu_torch.parallel import hangcheck

    hangcheck._set_schedule_recorder(None)


def current_recorder() -> Optional[CollectiveScheduleRecorder]:
    from pytorchvideo_accelerate_tpu_torch.parallel import hangcheck

    return hangcheck._schedule_recorder()


def op_counts(schedule: List[Tuple[int, str, str]]) -> Dict[str, int]:
    """{op: entries} of one host's schedule."""
    out: Dict[str, int] = {}
    for _, op, _ in schedule:
        out[op] = out.get(op, 0) + 1
    return out


# --- cross-host differ ------------------------------------------------------

def diff_schedules(schedules: Dict[str, List[Tuple[int, str, str]]],
                   window: int = DEFAULT_WINDOW) -> dict:
    """Compare per-host ordered schedules; report the first divergence.

    The lexicographically first host is the reference. Returns::

        {"diverged": bool,
         "divergence_count": int,        # hosts that drifted from the ref
         "hosts": [...], "lengths": {host: n},
         "first_divergence": None | {
             "tick": int,                # first disagreeing position
             "hosts": {host: [tick, op, detail] | None},  # None = missing
             "window": {host: trailing entries up to the tick},
         }}

    A host whose schedule ends early diverges at its first missing tick
    (`hosts[h] is None`): the skipped-collective deadlock."""
    hosts = sorted(schedules)
    report: dict = {
        "diverged": False,
        "divergence_count": 0,
        "hosts": hosts,
        "lengths": {h: len(schedules[h]) for h in hosts},
        "first_divergence": None,
    }
    if len(hosts) < 2:
        return report
    ref_host, others = hosts[0], hosts[1:]
    ref = schedules[ref_host]
    diverged_hosts = set()
    first: Optional[dict] = None
    for h in others:
        sched = schedules[h]
        n = max(len(ref), len(sched))
        for i in range(n):
            a = ref[i] if i < len(ref) else None
            b = sched[i] if i < len(sched) else None
            # (op, detail): the tick is positional by construction
            if (a and a[1:]) == (b and b[1:]):
                continue
            diverged_hosts.add(h)
            if first is None or i < first["tick"]:
                first = {
                    "tick": i,
                    "hosts": {ref_host: list(a) if a else None,
                              h: list(b) if b else None},
                    "window": {
                        ref_host: [list(e) for e in ref[max(0, i - window):i + 1]],
                        h: [list(e) for e in sched[max(0, i - window):i + 1]],
                    },
                }
            break
    if diverged_hosts:
        report["diverged"] = True
        report["divergence_count"] = len(diverged_hosts)
        report["first_divergence"] = first
    return report


def publish_schedule_report(report: dict) -> None:
    """The `pva_spmd_schedule_divergence` gauge, and a flight-recorder
    event on any divergence."""
    from pytorchvideo_accelerate_tpu_torch import obs

    obs.get_registry().gauge(
        "pva_spmd_schedule_divergence",
        "hosts whose recorded collective schedule diverged from the "
        "reference in the last diff (0 == identical schedules)",
    ).set(float(report.get("divergence_count", 0)))
    if report.get("diverged"):
        first = report.get("first_divergence") or {}
        obs.get_recorder().record(
            "spmd", "schedule divergence",
            divergence_count=report.get("divergence_count", 0),
            tick=first.get("tick"),
            hosts={h: (e[1] if e else None)
                   for h, e in (first.get("hosts") or {}).items()})


def format_divergence(report: dict) -> str:
    """One readable paragraph per divergence report."""
    if not report.get("diverged"):
        return (f"schedules identical across {len(report.get('hosts', []))} "
                f"host(s): {report.get('lengths')}")
    first = report.get("first_divergence") or {}
    lines = [f"collective-schedule divergence across "
             f"{report.get('divergence_count')} host(s) at tick "
             f"{first.get('tick')}:"]
    for h, entry in sorted((first.get("hosts") or {}).items()):
        if entry is None:
            lines.append(f"  {h}: <no collective issued — schedule ended>")
        else:
            lines.append(f"  {h}: op={entry[1]!r} detail={entry[2]!r}")
    for h, win in sorted((first.get("window") or {}).items()):
        tail = ", ".join(f"{t}:{op}" for t, op, _ in win)
        lines.append(f"  {h} trailing window: [{tail}]")
    return "\n".join(lines)
