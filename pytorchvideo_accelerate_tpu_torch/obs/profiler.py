"""On-demand profiler capture over `torch.profiler` (the port's copy of the
JAX package's `obs/profiler.py`).

Two triggers over one capture primitive:

- ``POST /profile?seconds=N`` on the server: a window on a live process,
  opened and closed on a background thread (409 while one runs: the
  profiler is a singleton resource);
- ``--obs.profile_steps A..B`` in the trainer: a run-relative step window
  (step 0 is this run's first step, so a resumed run profiles its warm
  steps).

A window records the CPU ops and, on the card, the CUDA activity
(`ProfilerCapture(cuda=True)`: CUPTI records every kernel of the process,
whichever thread launched it). The CPU ops are those of the thread that
opened the window: torch's profiler callbacks are thread-local (a window
opened on a background thread holds none of the scheduler thread's ops).
torch's profiler is also thread-affine: a window must stop on the thread
that started it, so `capture_for` runs both on its own thread. On the card
the window synchronises the device at its start and its stop, so it holds
the kernels launched inside it and no other.

Captures are published atomically under `output_dir`: the window's Chrome
trace (`trace.json`) is written into a dot-prefixed temporary directory,
which is `os.replace`d to its final name `profile_<tag>/` (rank r > 0:
`profile_<tag>.rank<r>/`) only once the trace is whole, so a crashed or
half-done capture is never mistaken for a complete one. The flight recorder
gets start and stop events; a capture torch refuses (another profiler
session running, no profiler) is a recorded warning and `start()` returns
False, never a crash.

Disarmed, the module-level hooks are one global read; torch is imported
inside the capture calls only.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Dict, Optional

from pytorchvideo_accelerate_tpu_torch.utils.sync import make_lock, shared_state

_DEFAULT: Optional["ProfilerCapture"] = None

TRACE_FILE = "trace.json"  # a window's Chrome trace, inside profile_<tag>/


def parse_steps(spec: str) -> Optional[tuple]:
    """"A..B" -> (A, B) run-relative step window; None for the empty
    spec. Raises ValueError on malformed/inverted windows (config-time
    validation, not a mid-run surprise)."""
    if not spec:
        return None
    parts = spec.split("..")
    if len(parts) != 2:
        raise ValueError(
            f"profile_steps must look like 'A..B', got {spec!r}")
    a, b = int(parts[0]), int(parts[1])
    if a < 0 or b <= a:
        raise ValueError(
            f"profile_steps window must satisfy 0 <= A < B, got {spec!r}")
    return a, b


@shared_state("_active_tag", "_tmp_dir", "_captures")
class ProfilerCapture:
    """One torch.profiler window at a time, atomically published."""

    def __init__(self, output_dir: str, recorder=None, cuda: bool = False,
                 rank: int = 0):
        self._lock = make_lock("obs.ProfilerCapture._lock")
        self.output_dir = output_dir
        self.recorder = recorder
        self.cuda = cuda
        self.suffix = f".rank{rank}" if rank else ""
        self._active_tag: Optional[str] = None
        self._tmp_dir: Optional[str] = None
        self._prof = None
        self._captures: int = 0
        self._thread = None

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._active_tag is not None

    def final_dir(self, tag: str) -> str:
        return os.path.join(self.output_dir, f"profile_{tag}{self.suffix}")

    def start(self, tag: Optional[str] = None) -> bool:
        """Open a window on the calling thread; False (not an exception)
        when one is already open or torch refuses."""
        tag = tag or time.strftime("%Y%m%d-%H%M%S")
        with self._lock:
            if self._active_tag is not None:
                return False
            tmp = os.path.join(self.output_dir,
                               f".profile_tmp_{tag}{self.suffix}")
            self._active_tag, self._tmp_dir = tag, tmp
        try:
            import torch
            import torch.autograd.profiler as autograd_profiler
            from torch.profiler import ProfilerActivity, profile

            if getattr(autograd_profiler, "_is_profiler_enabled", False):
                raise RuntimeError("another torch.profiler session is running")
            os.makedirs(tmp, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 - a refusal is recorded, never raised
            with self._lock:
                self._active_tag = self._tmp_dir = None
            shutil.rmtree(tmp, ignore_errors=True)
            if self.recorder is not None:
                self.recorder.warn("profiler capture refused",
                                   error=f"{type(e).__name__}: {e}")
            return False
        self._prof = prof
        if self.recorder is not None:
            self.recorder.record("profile", "start", tag=tag)
        return True

    def stop(self) -> Optional[str]:
        """Close the window (on the thread that opened it) and publish it
        atomically; returns the final directory, or None when nothing was
        open or publishing failed."""
        with self._lock:
            tag, tmp = self._active_tag, self._tmp_dir
            self._active_tag = self._tmp_dir = None
        prof, self._prof = self._prof, None
        if tag is None:
            return None
        final = self.final_dir(tag)
        try:
            import torch

            if self.cuda:
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(os.path.join(tmp, TRACE_FILE))
            # the capture only exists once this rename lands: readers
            # never see a partial trace directory
            if os.path.isdir(final):
                shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
        except Exception as e:  # noqa: BLE001 - a lost capture is recorded
            shutil.rmtree(tmp, ignore_errors=True)
            if self.recorder is not None:
                self.recorder.warn("profiler capture lost",
                                   tag=tag, error=f"{type(e).__name__}: {e}")
            return None
        with self._lock:
            self._captures += 1
        if self.recorder is not None:
            self.recorder.record("profile", "stop", tag=tag, dir=final)
        return final

    def capture_for(self, seconds: float,
                    tag: Optional[str] = None) -> Optional[str]:
        """The POST /profile shape: a window of `seconds` opened and closed
        on a background daemon thread. Returns the pending capture's tag,
        or None when a window is already open or torch refused."""
        tag = tag or time.strftime("%Y%m%d-%H%M%S")
        if self.busy:
            return None
        started = threading.Event()
        result = []

        def _worker():
            ok = self.start(tag=tag)
            result.append(ok)
            started.set()
            if ok:
                time.sleep(max(0.0, float(seconds)))
                self.stop()

        thread = threading.Thread(target=_worker, daemon=True,
                                  name="pva-profile-capture")
        thread.start()
        started.wait()
        if not result[0]:
            return None
        self._thread = thread
        return tag

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"busy": self._active_tag is not None,
                    "active_tag": self._active_tag,
                    "captures": self._captures,
                    "output_dir": self.output_dir}


def get_profiler() -> Optional[ProfilerCapture]:
    return _DEFAULT


def configure(enabled: bool = True,
              output_dir: Optional[str] = None,
              **kwargs) -> Optional[ProfilerCapture]:
    """Arm (or disarm) the process-default capture singleton."""
    global _DEFAULT
    if not enabled or output_dir is None:
        _DEFAULT = None
        return None
    _DEFAULT = ProfilerCapture(output_dir, **kwargs)
    return _DEFAULT
