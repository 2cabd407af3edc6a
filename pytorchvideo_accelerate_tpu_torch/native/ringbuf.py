"""Python view of the native shm ring buffer and the sample (de)serialization
(the port's copy of the JAX package's `native/ringbuf.py`).

A slot carries one sample dict of fixed-shape arrays with a small binary
header (key table + dtype/shape), so workers in other processes write
decoded clips straight into shared pages: no pickling, no pipes. The slot
layout and the dtype code table are the JAX package's, so a slot written by
either package reads back the same in the other.

bf16 (code 6): the JAX package packs `ml_dtypes.bfloat16` arrays; the
port's transforms emit `torch.bfloat16` tensors (`output_dtype=
"bfloat16"`), which pack as their raw 16-bit words under the same code and
unpack as a `torch.bfloat16` view of the slot, without a copy. Other torch
tensors pack through their numpy view and unpack as numpy arrays.
"""

from __future__ import annotations

import ctypes
import mmap
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorchvideo_accelerate_tpu_torch import native

_DTYPES = [np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.uint8),
           np.dtype(np.float16), np.dtype(np.int64), np.dtype(np.bool_)]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}
BF16_CODE = 6  # the JAX package's ml_dtypes.bfloat16 entry


def _words(arr) -> Tuple[int, np.ndarray]:
    """(dtype code, numpy array of the payload) of one sample leaf."""
    if torch.is_tensor(arr):
        if arr.dtype == torch.bfloat16:
            return BF16_CODE, arr.contiguous().view(torch.int16).numpy()
        arr = arr.numpy()
    # NB: np.asarray, not ascontiguousarray: the latter promotes 0-d
    # scalars to (1,)
    arr = np.asarray(arr)
    return _DTYPE_CODE[arr.dtype], arr


def pack_sample(sample: Dict[str, np.ndarray], buf: memoryview) -> int:
    """Serialize a sample dict into `buf`; returns bytes written.

    Layout: u32 n_arrays, then per array: u16 keylen, key bytes, u8 dtype
    code, u8 ndim, u32 shape[ndim], u64 nbytes, payload (8-byte aligned).
    """
    off = 4
    n = 0
    for key, leaf in sample.items():
        code, arr = _words(leaf)
        kb = key.encode()
        struct.pack_into(f"<H{len(kb)}sBB", buf, off, len(kb), kb, code,
                         arr.ndim)
        off += 2 + len(kb) + 2
        struct.pack_into(f"<{arr.ndim}I", buf, off, *arr.shape)
        off += 4 * arr.ndim
        nbytes = arr.nbytes
        struct.pack_into("<Q", buf, off, nbytes)
        off += 8
        off = (off + 7) & ~7
        # one copy into shm
        np.frombuffer(buf, np.uint8, nbytes, off)[:] = arr.reshape(-1).view(np.uint8)
        off += nbytes
        n += 1
    struct.pack_into("<I", buf, 0, n)
    return off


def unpack_sample(buf: memoryview, copy: bool = False) -> Dict[str, np.ndarray]:
    """Deserialize; by default returns zero-copy views into the slot (valid
    until the slot is released: callers batch-copy before releasing)."""
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out = {}
    for _ in range(n):
        (klen,) = struct.unpack_from("<H", buf, off)
        key = bytes(buf[off + 2:off + 2 + klen]).decode()
        code, ndim = struct.unpack_from("<BB", buf, off + 2 + klen)
        off += 2 + klen + 2
        shape = struct.unpack_from(f"<{ndim}I", buf, off)
        off += 4 * ndim
        (nbytes,) = struct.unpack_from("<Q", buf, off)
        off += 8
        off = (off + 7) & ~7
        if code == BF16_CODE:
            words = np.frombuffer(buf, np.int16, nbytes // 2, off).reshape(shape)
            leaf = torch.from_numpy(words).view(torch.bfloat16)
            out[key] = leaf.clone() if copy else leaf
        else:
            dt = _DTYPES[code]
            arr = np.frombuffer(buf, dt, nbytes // dt.itemsize, off).reshape(shape)
            out[key] = arr.copy() if copy else arr
        off += nbytes
    return out


def sample_nbytes(sample: Dict[str, np.ndarray]) -> int:
    """Bytes `pack_sample` writes for `sample`, the alignment padding
    included."""
    total = 4
    for key, leaf in sample.items():
        _, arr = _words(leaf)
        total += 2 + len(key.encode()) + 2 + 4 * arr.ndim + 8 + 8
        total += arr.nbytes
    return total


class ShmRing:
    """A native ring buffer in an anonymous shared mmap (inherited by forked
    worker processes). The parent creates it before the fork; children
    reuse it."""

    def __init__(self, n_slots: int, slot_bytes: int):
        lib = native.load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self.lib = lib
        self.n_slots = n_slots
        total = lib.pva_rb_total_size(n_slots, slot_bytes)
        self.mm = mmap.mmap(-1, total)  # MAP_SHARED | MAP_ANONYMOUS
        self._base = ctypes.addressof(ctypes.c_char.from_buffer(self.mm))
        if lib.pva_rb_init(self._base, n_slots, slot_bytes) != 0:
            raise RuntimeError("pva_rb_init failed")
        self.slot_bytes = lib.pva_rb_slot_bytes(self._base)

    # --- producer side ----------------------------------------------------
    def acquire(self, timeout_ms: int = 10_000) -> int:
        return self.lib.pva_rb_acquire(self._base, timeout_ms)

    def commit(self, slot: int, nbytes: int, tag: int) -> None:
        self.lib.pva_rb_commit(self._base, slot, nbytes, tag)

    def put_sample(self, sample: Dict[str, np.ndarray], tag: int,
                   timeout_ms: int = 10_000) -> bool:
        slot = self.acquire(timeout_ms)
        if slot < 0:
            return False
        n = pack_sample(sample, self.slot_view(slot))
        self.commit(slot, n, tag)
        return True

    # --- consumer side ----------------------------------------------------
    def pop(self, timeout_ms: int = 10_000) -> Tuple[int, int, int]:
        nbytes = ctypes.c_uint64()
        tag = ctypes.c_uint64()
        slot = self.lib.pva_rb_pop(self._base, timeout_ms,
                                   ctypes.byref(nbytes), ctypes.byref(tag))
        return slot, nbytes.value, tag.value

    def release(self, slot: int) -> None:
        self.lib.pva_rb_release(self._base, slot)

    def slot_view(self, slot: int) -> memoryview:
        ptr = self.lib.pva_rb_slot_ptr(self._base, slot)
        off = ptr - self._base
        return memoryview(self.mm)[off:off + self.slot_bytes]

    def ready_count(self) -> int:
        return self.lib.pva_rb_ready_count(self._base)

    def shutdown(self) -> None:
        self.lib.pva_rb_shutdown(self._base)

    def close(self) -> None:
        self.shutdown()
        # mm stays mapped until gc so outstanding views stay valid


def gather_copy(dst: np.ndarray, parts: Sequence[np.ndarray],
                offsets: Optional[Sequence[int]] = None,
                n_threads: int = 4) -> None:
    """dst.flat bytes[off_i:] = parts[i]: a multithreaded memcpy outside the
    interpreter lock (batch assembly); numpy copies without the library."""
    lib = native.load()
    n = len(parts)
    if offsets is None:
        offsets, acc = [], 0
        for part in parts:
            offsets.append(acc)
            acc += part.nbytes
    if lib is None:
        view = dst.reshape(-1).view(np.uint8)
        for off, part in zip(offsets, parts):
            pb = np.ascontiguousarray(part).reshape(-1).view(np.uint8)
            view[off:off + part.nbytes] = pb
        return
    srcs = (ctypes.c_char_p * n)()
    offs = (ctypes.c_uint64 * n)(*offsets)
    sizes = (ctypes.c_uint64 * n)()
    keepalive: List[np.ndarray] = []
    for i, part in enumerate(parts):
        part = np.ascontiguousarray(part)
        keepalive.append(part)
        srcs[i] = ctypes.cast(part.ctypes.data, ctypes.c_char_p)
        sizes[i] = part.nbytes
    lib.pva_gather_copy(
        ctypes.cast(dst.ctypes.data, ctypes.c_char_p), srcs, offs, sizes,
        n, n_threads,
    )
