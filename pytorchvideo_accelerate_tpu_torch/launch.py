"""Local process launcher, the `accelerate launch` equivalent (counterpart of
the JAX package's `launch.py`).

Starts `--num_processes` Python processes, one per card, each with the
`PVA_*` env contract that `parallel/distributed.py` `initialize_distributed`
reads (PVA_COORDINATOR_ADDRESS, PVA_NUM_PROCESSES, PVA_PROCESS_ID); rank r
trains on card r % the card count. It picks a free coordinator port when
none is given, passes rank 0's output through and prefixes the other
ranks' lines, tears the whole group down when any rank fails (a dead peer
leaves the others blocked in a collective) and returns that rank's exit
code, under one deadline for the group (exit code 124 when it passes).
`--max_restarts N` relaunches a failed group up to N times (pair it with
`--resume_from_checkpoint auto`).

Usage:
    python -m pytorchvideo_accelerate_tpu_torch.launch --num_processes 2 -- \\
        --synthetic --model.name slowfast_r50 --batch_size 4 ...  # run.py
    python -m pytorchvideo_accelerate_tpu_torch.launch --num_processes 2 -- \\
        my_script.py --my-flag                                   # a script

`--batch_size` is per card: the global batch is batch_size x processes.
Add `--cpu` after `--` to run the group on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence


def find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _forward(stream, rank: int) -> None:
    for line in iter(stream.readline, b""):
        sys.stderr.buffer.write(f"[rank {rank}] ".encode() + line)
        sys.stderr.buffer.flush()
    stream.close()


def build_commands(num_processes: int, prog: List[str]) -> List[List[str]]:
    if prog and prog[0].endswith(".py"):
        base = [sys.executable, *prog]
    else:
        base = [sys.executable, "-m", "pytorchvideo_accelerate_tpu_torch.run", *prog]
    return [list(base) for _ in range(num_processes)]


def launch(num_processes: int, prog: List[str],
           coordinator_address: str = "", env_extra: Optional[dict] = None,
           timeout: Optional[float] = None, max_restarts: int = 0) -> int:
    """Run the process group; returns the first non-zero exit code or 0.
    On a failure the whole group is torn down and, up to `max_restarts`
    times, started again on a fresh port (unless one is pinned). `timeout`
    applies per attempt."""
    if num_processes < 1:
        raise ValueError(f"--num_processes must be >= 1, got {num_processes}")
    if max_restarts < 0:
        raise ValueError(f"--max_restarts must be >= 0, got {max_restarts}")
    rc = 0
    for attempt in range(max_restarts + 1):
        addr = coordinator_address or f"127.0.0.1:{find_free_port()}"
        rc = _run_group(num_processes, prog, addr, env_extra, timeout)
        # 130: the user asked to stop
        if rc in (0, 130) or attempt == max_restarts:
            return rc
        sys.stderr.write(f"[launch] group failed (rc {rc}); restart "
                         f"{attempt + 1}/{max_restarts}\n")
    return rc


def _run_group(num_processes: int, prog: List[str], coordinator_address: str,
               env_extra: Optional[dict], timeout: Optional[float]) -> int:
    """One attempt of the group."""
    procs: List[subprocess.Popen] = []
    threads: List[threading.Thread] = []
    for rank, cmd in enumerate(build_commands(num_processes, prog)):
        env = dict(os.environ)
        env.update(env_extra or {})
        env.update({"PVA_COORDINATOR_ADDRESS": coordinator_address,
                    "PVA_NUM_PROCESSES": str(num_processes),
                    "PVA_PROCESS_ID": str(rank)})
        if rank == 0:
            p = subprocess.Popen(cmd, env=env)
        else:
            p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            t = threading.Thread(target=_forward, args=(p.stdout, rank),
                                 daemon=True)
            t.start()
            threads.append(t)
        procs.append(p)

    rc = 0
    deadline = (time.monotonic() + timeout) if timeout else None
    try:
        # any child failing ends the group, under one deadline for all
        while True:
            codes = [p.poll() for p in procs]
            bad = next((c for c in codes if c), None)
            if bad is not None:
                rc = bad
                break
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                rc = 124
                break
            time.sleep(0.2)
    except KeyboardInterrupt:
        rc = rc or 130
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in threads:
            t.join(timeout=5)
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="pytorchvideo_accelerate_tpu_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--num_processes", type=int, default=1,
                    help="local processes to start, one per card")
    ap.add_argument("--coordinator_address", default="",
                    help="host:port the group meets at (default: 127.0.0.1 "
                         "with a free port)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="end the group after this many seconds (per attempt)")
    ap.add_argument("--max_restarts", type=int, default=0,
                    help="relaunch the whole group on failure up to N times "
                         "(pair with --resume_from_checkpoint auto)")
    ap.add_argument("prog", nargs=argparse.REMAINDER,
                    help="script.py + args, or args for the training module")
    args = ap.parse_args(argv)
    prog = args.prog
    if prog and prog[0] == "--":
        prog = prog[1:]
    return launch(args.num_processes, prog,
                  coordinator_address=args.coordinator_address,
                  timeout=args.timeout, max_restarts=args.max_restarts)


if __name__ == "__main__":
    sys.exit(main())
