"""ctypes bindings of the native loader runtime (`native/csrc/pva_native.cpp`;
the port's copy of the JAX package's `native/`).

The shared library is built at first use, never at import, with the
system's `g++ -O3 -fPIC -shared -std=c++17 -pthread` (no other dependency,
about a second), into `ops/_build/` (listed in .gitignore) under a name that
carries a hash of the source and the flags: an edited source rebuilds, an
unchanged one loads what is there. The compiler writes a temporary file of
its own that `os.replace` moves into place, so several processes building
at once (pytest-xdist workers, data-parallel ranks) never load a half
written library. Where the build or the load fails, `load()` returns None
and logs one warning per process; the callers fall back (the loader to its
thread transport, `gather_copy` to numpy copies).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger("pva_tpu_torch")

SOURCE = Path(__file__).resolve().parent / "csrc" / "pva_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "ops" / "_build"
GXX = "g++"  # the compiler's path (tests point it at a missing one)
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None  # why the last load failed, once failed


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpva_native-{h.hexdigest()[:16]}.so"


def _build(dst: Path) -> None:
    """Compile the library to a temporary name, then move it into place."""
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_name(f".{dst.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([GXX, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, dst)
    finally:
        if tmp.exists():
            tmp.unlink()


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (built first if missing), or None where it cannot
    be built or loaded; a failure is final for the process."""
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            path = library_path()
            built = not path.exists()
            if built:
                _build(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                if built:
                    raise
                # a library built elsewhere (another C++ runtime): rebuild
                _build(path)
                lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            _load_error = (f"{type(e).__name__}: {e} "
                           f"{detail.decode(errors='replace')[-500:]}").strip()
            logger.warning("native loader library unavailable (%s); the "
                           "process transport falls back to threads",
                           _load_error)
            return None

        u64, u32, i32 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int
        p = ctypes.c_void_p
        lib.pva_rb_total_size.restype = u64
        lib.pva_rb_total_size.argtypes = [u32, u64]
        lib.pva_rb_init.restype = i32
        lib.pva_rb_init.argtypes = [p, u32, u64]
        lib.pva_rb_slot_ptr.restype = p
        lib.pva_rb_slot_ptr.argtypes = [p, u32]
        lib.pva_rb_slot_bytes.restype = u64
        lib.pva_rb_slot_bytes.argtypes = [p]
        lib.pva_rb_acquire.restype = i32
        lib.pva_rb_acquire.argtypes = [p, i32]
        lib.pva_rb_commit.restype = i32
        lib.pva_rb_commit.argtypes = [p, u32, u64, u64]
        lib.pva_rb_pop.restype = i32
        lib.pva_rb_pop.argtypes = [p, i32, ctypes.POINTER(u64), ctypes.POINTER(u64)]
        lib.pva_rb_release.restype = i32
        lib.pva_rb_release.argtypes = [p, u32]
        lib.pva_rb_shutdown.restype = None
        lib.pva_rb_shutdown.argtypes = [p]
        lib.pva_rb_ready_count.restype = u32
        lib.pva_rb_ready_count.argtypes = [p]
        lib.pva_gather_copy.restype = i32
        lib.pva_gather_copy.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(u64), ctypes.POINTER(u64), u32, u32,
        ]
        _lib = lib
        return _lib


def load_error() -> Optional[str]:
    """Why `load()` returned None in this process (None before a failure)."""
    return _load_error
