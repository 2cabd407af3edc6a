"""Collectives (counterpart of the JAX package's `parallel/collectives.py`).

Host collectives over the host group (`distributed.host_group()`, CPU
tensors over gloo): `host_allgather`,
`host_broadcast` (numeric leaves, and str/bytes leaves as a length then a
byte buffer) and `host_reduce_sum`. With one process they return what the
JAX package returns there: a leading axis of 1, numpy leaves. A pytree here
is nested dicts, lists and tuples.

The step's collectives, the counterpart of the JAX step's in-graph
`pmean`/`psum`: `all_reduce_mean_` (one flat all-reduce of many tensors,
the gradient's), `all_reduce_sum` (autograd-aware: its backward all-reduces
the gradient, as the sync BatchNorm's statistics need) and `exchange`
(the peer's copy of a tensor, for mixing against the global batch's flip).
Every one is an all-reduce or a broadcast, the two collectives gloo
carries for CUDA tensors. `shard_map`, `ppermute_ring` and `all_gather`
wait for ring and ulysses attention (ROADMAP.md A.1).
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pytorchvideo_accelerate_tpu_torch.parallel.distributed import (
    host_group,
    is_distributed,
    process_count,
    process_index,
)


def _flatten(x: Any) -> tuple:
    """(leaves, rebuild) of a pytree of dicts, lists and tuples."""
    if isinstance(x, dict):
        keys = list(x)
        parts = [_flatten(x[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                lambda it: {k: p[1](it) for k, p in zip(keys, parts)})
    if isinstance(x, (list, tuple)):
        parts = [_flatten(v) for v in x]
        kind = type(x)
        return ([leaf for p in parts for leaf in p[0]],
                lambda it: kind(p[1](it) for p in parts))
    return [x], lambda it: next(it)


def tree_map(fn: Callable, x: Any) -> Any:
    leaves, rebuild = _flatten(x)
    return rebuild(iter([fn(v) for v in leaves]))


def host_allgather(x: Any) -> Any:
    """Every process's value of each leaf, stacked on a new leading axis
    (process order), as numpy; for host-side logging and checks."""
    if process_count() == 1:
        return tree_map(lambda a: np.asarray(a)[None], x)
    def gather(a):
        t = torch.from_numpy(np.array(a))  # a copy; 0-d stays 0-d
        out = [torch.empty_like(t) for _ in range(process_count())]
        dist.all_gather(out, t, group=host_group())
        return np.stack([o.numpy() for o in out])

    return tree_map(gather, x)


def _broadcast_bytes(raw: bytes) -> bytes:
    """Process 0's bytes on every process: the length, then the buffer."""
    n = torch.tensor([len(raw)], dtype=torch.int64)
    dist.broadcast(n, src=0, group=host_group())
    buf = torch.zeros(int(n.item()), dtype=torch.uint8)
    if not len(buf):
        return b""
    if process_index() == 0:
        buf.copy_(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
    dist.broadcast(buf, src=0, group=host_group())
    return bytes(buf.numpy())


def host_broadcast(x: Any) -> Any:
    """Process 0's value on every process (the resume step, a run name:
    anything one process decides for all). Numeric leaves come back as
    numpy arrays on every process, single-process runs included; str and
    bytes leaves as str and bytes."""
    if process_count() == 1:
        return tree_map(lambda v: v if isinstance(v, (str, bytes))
                        else np.asarray(v), x)
    def bcast(v):
        if isinstance(v, (str, bytes)):
            raw = _broadcast_bytes(v.encode("utf-8") if isinstance(v, str) else bytes(v))
            return raw.decode("utf-8") if isinstance(v, str) else raw
        a = np.array(v)  # a copy; 0-d stays 0-d
        # the root's shape and dtype ride along: a peer may hold a
        # placeholder
        head = _broadcast_bytes(f"{a.dtype.str}|{','.join(map(str, a.shape))}".encode())
        dtype, shape = head.decode().split("|")
        shape = tuple(int(s) for s in shape.split(",") if s)
        if process_index() != 0:
            a = np.zeros(shape, np.dtype(dtype))
        raw = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
        dist.broadcast(raw, src=0, group=host_group())
        return raw.numpy().view(np.dtype(dtype)).reshape(shape)

    return tree_map(bcast, x)


def host_reduce_sum(x: Any) -> Any:
    """Each leaf summed across processes (host-side counters)."""
    return tree_map(lambda a: np.asarray(a.sum(axis=0)), host_allgather(x))


# --- the step's collectives ---------------------------------------------------


def _flat_groups(tensors: Sequence[torch.Tensor]) -> List[tuple]:
    """[(tensors of one (dtype, device)), ...] in first-seen order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return list(groups.values())


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """In place, each tensor <- its mean over the ranks: one all-reduce of
    one flat buffer per (dtype, device), the sum divided by the world size
    (the JAX step's single `pmean` of the gradient). Every rank gets the
    same bits."""
    if not is_distributed():
        return
    world = float(process_count())
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(world)
        torch._foreach_copy_(group, [v.view(t.shape) for v, t in
                                     zip(flat.split([t.numel() for t in group]), group)])


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """In place, each tensor <- rank `src`'s, one flat broadcast per
    (dtype, device) (replication of the parameters after init and after a
    restore)."""
    if not is_distributed():
        return
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=src)
        torch._foreach_copy_(group, [v.view(t.shape) for v, t in
                                     zip(flat.split([t.numel() for t in group]), group)])


class _AllReduceSum(torch.autograd.Function):
    """sum over ranks; its backward is the same all-reduce of the
    gradient (each rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable (identity without a
    group)."""
    if not is_distributed():
        return x
    return _AllReduceSum.apply(x)


def exchange(x: torch.Tensor, peer: int) -> torch.Tensor:
    """Rank `peer`'s `x` (same shape and dtype on every rank): one
    broadcast from each rank in turn, the tensor carried as raw bytes so
    any dtype crosses any backend. Rank r's own value with no group."""
    if not is_distributed() or process_count() == 1:
        return x
    raw = x.contiguous().view(torch.uint8) if x.dim() else x.reshape(1).view(torch.uint8)
    out = None
    for src in range(process_count()):
        buf = raw.clone() if src == process_index() else torch.empty_like(raw)
        dist.broadcast(buf, src=src)
        if src == peer:
            out = buf
    return out.view(x.dtype).reshape(x.shape)
