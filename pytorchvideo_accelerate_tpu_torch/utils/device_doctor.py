"""Device reachability probe: the Trainer's `--device_init_timeout` guard
(the port's copy of `quick_probe` and `assert_device_reachable` of the JAX
package's `utils/device_doctor.py`).

A card whose driver or context creation wedges leaves a training job
sitting in its first CUDA call with no error. The guard asks a disposable
child process first: `torch.cuda.init()`, the device count, and one matmul
on the card, all within the deadline. The parent never touches the card
before the answer: a wedged init in the main process cannot be undone. A
child that finds no card, fails, or outlives the deadline (its whole
process group is killed) makes `assert_device_reachable` raise
RuntimeError with the child's stderr tail. The child's stderr goes to a
file, not a pipe, so its tail survives the kill.

The JAX module's PJRT-specific diagnosis (`diagnose`, the init-path
variants) and its `pva-tpu-doctor` CLI are not ported (ROADMAP.md A.7).
"""

from __future__ import annotations

import datetime
import os
import signal
import subprocess
import sys
import tempfile
import time

PROBE_CODE = (
    "import torch\n"
    "torch.cuda.init()\n"
    "n = torch.cuda.device_count()\n"
    "if n < 1:\n"
    "    raise SystemExit('torch.cuda.init() found no CUDA device')\n"
    "x = torch.ones(128, 128, device='cuda')\n"
    "(x @ x).sum().item()\n"
    "print('cuda', n, torch.cuda.get_device_name(0))\n")


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime("%FT%TZ")


def _attempt(code: str, env: dict, timeout_s: float, tail_bytes: int) -> dict:
    """Run `code` in a disposable child (its own process group, killed
    whole on timeout) with stderr to a fresh mkstemp file (two ranks probe
    at once), removed after reading; returns the attempt record: `ok`,
    `returncode`, `stdout` (its last 300 characters), `error` on a timeout,
    `elapsed_s`, `stderr_bytes`, `stderr_tail`."""
    fd, err_path = tempfile.mkstemp(prefix="pva_doctor_", suffix=".txt")
    os.close(fd)
    rec: dict = {"timeout_s": timeout_s}
    t0 = time.time()
    try:
        with open(err_path, "wb") as errf:
            p = subprocess.Popen([sys.executable, "-c", code], env=env,
                                 stdout=subprocess.PIPE, stderr=errf,
                                 text=True, start_new_session=True)
            try:
                out, _ = p.communicate(timeout=timeout_s)
                rec.update(ok=p.returncode == 0, returncode=p.returncode,
                           stdout=(out or "").strip()[-300:])
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except OSError:
                    pass
                p.wait()
                rec.update(ok=False, error="timeout (killed)")
        rec["elapsed_s"] = round(time.time() - t0, 1)
        with open(err_path, "rb") as f:
            data = f.read()
        rec["stderr_bytes"] = len(data)
        rec["stderr_tail"] = data[-tail_bytes:].decode("utf-8", "replace")
    finally:
        os.unlink(err_path)
    return rec


def quick_probe(timeout_s: float = 240) -> dict:
    """Initialise CUDA, count the cards and run one op on the first, in a
    disposable child with this process's environment; returns the attempt
    record (`ok`: the job may initialise the card itself)."""
    env = dict(os.environ)
    env["PYTHONUNBUFFERED"] = "1"
    rec = _attempt(PROBE_CODE, env, timeout_s, tail_bytes=1000)
    rec["ts"] = _utcnow()
    return rec


def assert_device_reachable(timeout_s: float, log=None) -> dict:
    """The Trainer's guard: the probe's record when the card answered in
    time, else RuntimeError with the child's error and stderr tail, never
    a training job that hangs in its first CUDA call."""
    log = log or (lambda msg: print(msg, file=sys.stderr))
    log(f"[device_doctor] probing device init ({timeout_s}s cap) ...")
    rec = quick_probe(timeout_s)
    if rec.get("ok"):
        log(f"[device_doctor] device ok in {rec['elapsed_s']}s: "
            f"{rec.get('stdout', '')}")
        return rec
    why = rec.get("error") or f"exit {rec.get('returncode')}"
    raise RuntimeError(
        f"CUDA device init did not complete within {timeout_s}s (probe: "
        f"{why}; stderr tail: {rec.get('stderr_tail', '')[-400:]!r}). Refusing to "
        "start a training job that would hang in its first CUDA call. Run "
        "on the CPU with --cpu, or raise or disable the guard with "
        "--device_init_timeout (0 disables).")
