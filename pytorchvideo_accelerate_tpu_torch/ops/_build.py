"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each `csrc/<source>.cu` compiles with `nvcc` into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). Libraries land in `ops/_build/` (listed in .gitignore) under a name
that carries a hash of the sources and flags: an edited source rebuilds,
an unchanged one loads what is there. A failed build raises; nothing falls
back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the sources under csrc/, one library each
KERNELS = ("fused_pw_bn_act", "fused_conv_bn_act", "depthwise3d",
           "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> (source, C function, argtypes); see the extern "C" block of
# each source
_SIGNATURES = {
    # (x, w, bias, out, dims..., act, GEMM config id, stream)
    "fused_pw_bn_act": ("fused_pw_bn_act", "pva_fused_pw_bn_act",
                        [_P, _P, _P, _P] + [_I] * 5 + [_P]),
    "fused_conv_bn_act": ("fused_conv_bn_act", "pva_fused_conv_bn_act",
                          [_P, _P, _P, _P] + [_I] * 11 + [_P]),
    # (kernel: 0 pointwise, 1 conv; config; int[4] out): registers, local
    # bytes, dynamic shared memory, blocks per SM of one GEMM configuration
    "fused_pw_bn_act.attrs": ("fused_pw_bn_act", "pva_fused_gemm_attrs",
                              [_I, _I, _P]),
    "fused_conv_bn_act.attrs": ("fused_conv_bn_act", "pva_fused_gemm_attrs",
                                [_I, _I, _P]),
    # (x, k, [bias,] out, B T H W C kt kh kw, [act,] config, T chunk, stream)
    "fused_dw_bn_act": ("depthwise3d", "pva_fused_dw_bn_act",
                        [_P, _P, _P, _P] + [_I] * 11 + [_P]),
    "depthwise3d_s1": ("depthwise3d", "pva_depthwise3d_s1",
                       [_P, _P, _P] + [_I] * 10 + [_P]),
    # (config, kt, kh, kw, int[5] out): registers, local bytes, dynamic
    # shared memory, blocks per SM and compiled taps of the kernel such a
    # launch runs
    "depthwise3d.attrs": ("depthwise3d", "pva_depthwise3d_attrs",
                          [_I] * 4 + [_P]),
    # (pointers, B H Nq Nk D [splits], (b, n, h) strides of q k v [dO],
    # scale, stream)
    "flash_attention": ("flash_attention", "pva_flash_fwd",
                        [_P] * 5 + [_I] * 14 + [_F, _P]),
    "flash_attention.bwd_dq": ("flash_attention_bwd", "pva_flash_bwd_dq",
                               [_P] * 7 + [_I] * 17 + [_F, _P]),
    "flash_attention.bwd_dkv": ("flash_attention_bwd", "pva_flash_bwd_dkv",
                                [_P] * 9 + [_I] * 18 + [_F, _P]),
    # ([which: 0 dq, 1 dk/dv;] D; int[4] out): registers, local bytes,
    # dynamic shared memory, blocks per SM of one kernel
    "flash_attention.fwd_attrs": ("flash_attention", "pva_flash_fwd_attrs",
                                  [_I, _P]),
    "flash_attention.bwd_attrs": ("flash_attention_bwd", "pva_flash_bwd_attrs",
                                  [_I, _I, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build in this process
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put the CUDA toolkit on PATH); "
        "the fused kernels are compiled from ops/csrc at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every missing library, one `nvcc` per source, all started at
    once. Returns seconds per library built (0.0 for one already there)."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    seconds = {}
    t0 = time.perf_counter()
    for name in names:
        dst = library_path(name)
        if dst.exists():
            seconds[name] = 0.0
            continue
        tmp = dst.with_name(f".{dst.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst)
    failures = []
    for name, (proc, tmp, dst) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, dst)  # atomic: a concurrent loader never sees half
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>.cu`, built first if missing, with
    the argtypes of its entry points set."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path = library_path(source)
            if not path.exists():
                build([source])
            lib = ctypes.CDLL(str(path))
            for src, fn_name, argtypes in _SIGNATURES.values():
                if src == source:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _loaded[source] = lib
    return lib


def entry(name: str):
    """The C function of entry point `name` (argtypes set)."""
    source, fn_name, _ = _SIGNATURES[name]
    return getattr(load(source), fn_name)
