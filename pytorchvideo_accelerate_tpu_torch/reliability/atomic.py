"""Atomic file writes: tmp file + fsync + os.replace (the port's copy of the
JAX package's `reliability/atomic.py`).

Every plain file the port writes itself (inference-export weights and
meta, the quarantine sidecar) goes through here, so a kill mid-save never
leaves a truncated file at the destination: readers see the old complete
content or the new complete content. The write is the `ckpt.write` fault
point (reliability/faults.py): a ``partial_write`` truncates the tmp file
and raises, and the destination stays as it was.
"""

from __future__ import annotations

import json
import os
from typing import Callable

from pytorchvideo_accelerate_tpu_torch.reliability.faults import fault_point


def _fsync_dir(path: str) -> None:
    """Durably commit the rename itself (POSIX: the directory entry)."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:  # pragma: no cover - non-POSIX / odd filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, write_fn: Callable[[str], None]) -> str:
    """Call `write_fn(tmp_path)` to produce the content, then fsync and
    `os.replace` onto `path`. The tmp file lives in the destination
    directory (same filesystem: the replace is a rename) and keeps the
    destination's extension (np.savez keys its behaviour on it). Any
    failure removes the tmp file and leaves `path` untouched."""
    d, base = os.path.split(path)
    root, ext = os.path.splitext(base)
    tmp = os.path.join(d, f".{root}.tmp-{os.getpid()}{ext}")
    try:
        write_fn(tmp)
        fault_point("ckpt.write", write_path=tmp)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        _fsync_dir(d)
    finally:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:  # pragma: no cover - cleanup is best-effort
            pass
    return path


def atomic_write_bytes(path: str, data: bytes) -> str:
    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(data)

    return atomic_write(path, write)


def atomic_write_json(path: str, obj) -> str:
    return atomic_write_bytes(
        path, json.dumps(obj, indent=1, default=str).encode())
