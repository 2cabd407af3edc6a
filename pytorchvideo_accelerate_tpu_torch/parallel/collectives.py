"""Collectives (counterpart of the JAX package's `parallel/collectives.py`).

Host collectives over the host group (`distributed.host_group()`, CPU
tensors over gloo): `host_allgather`,
`host_broadcast` (numeric leaves, and str/bytes leaves as a length then a
byte buffer) and `host_reduce_sum`. With one process they return what the
JAX package returns there: a leading axis of 1, numpy leaves. A pytree here
is nested dicts, lists and tuples. Each is one watched section of the hang
check (`parallel/hangcheck.py collective_section`), named after it.

The step's collectives, the counterpart of the JAX step's in-graph
`pmean`/`psum`: `all_reduce_mean_` (one flat all-reduce of many tensors,
the gradient's), `all_reduce_sum` (autograd-aware: its backward all-reduces
the gradient, as the sync BatchNorm's statistics need) and `exchange`
(the peer's copy of a tensor, for mixing against the global batch's flip).
Each takes `group=` (the default group when None): the trainer passes the
data group (`distributed.data_group()`), so a gradient is averaged over
the ranks that hold the same shard of the model.

The model axis's collectives (Megatron tensor parallelism and context
parallelism, the counterparts of the JAX package's `psum`, `ppermute` and
`all_to_all` inside `shard_map`), each an autograd Function over a model
group (`distributed.model_group()`; None, or a group of one, is the
identity): `copy_to_model` (forward identity, backward all-reduce),
`reduce_from_model` (forward all-reduce, backward identity),
`scatter_tokens` / `gather_tokens` (this rank's slice of the token axis,
and the all-gather back; each the other's backward), `ppermute_ring`
(send to the next rank, receive from the previous; the backward goes the
other way) and `all_to_all` (its backward the inverse all-to-all). Sums
run in float32 whatever the tensor's dtype.

The fsdp axis's collectives (`parallel/fsdp.py`): `fsdp_gather` (the
full leaf from every rank's contiguous chunk of one dim, all-gathered over
the fsdp group; its backward is `reduce_scatter`, the gradient summed over
the group and cut back to this rank's chunk) and `reduce_scatter` itself.
Every collective here takes `group=` on any of the mesh's groups
(`distributed.batch_group()`, `fsdp_group()`, `data_group()`,
`tensor_group()`, `context_group()`).

Transport. gloo carries only all-reduce and broadcast for CUDA tensors,
so on a gloo group the gather, the permute and the all-to-all are built
from one broadcast per rank of the group (the tensor as raw bytes, so
any dtype crosses), as `exchange` is; CPU and CUDA tensors take that same
code, and a reduce-scatter is the same broadcasts, then a local f32 sum in
group-rank order and this rank's slice. On an NCCL group they are
`all_gather_into_tensor`, `reduce_scatter_tensor`, `batch_isend_irecv` and
`all_to_all_single`.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pytorchvideo_accelerate_tpu_torch.parallel.distributed import (
    group_ranks,
    host_group,
    is_distributed,
    process_count,
    process_index,
)
from pytorchvideo_accelerate_tpu_torch.parallel.hangcheck import collective_section


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
    (process order), as numpy; for host-side logging and checks. Watched:
    a `host_allgather` section (parallel/hangcheck.py)."""
    with collective_section("host_allgather"):
        return _allgather(x)


def _allgather(x: Any) -> Any:
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
    bytes leaves as str and bytes. Watched: a `host_broadcast` section."""
    with collective_section("host_broadcast"):
        return _broadcast(x)


def _broadcast(x: Any) -> Any:
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
    """Each leaf summed across processes (host-side counters, eval sums).
    Watched: a `host_reduce_sum` section."""
    with collective_section("host_reduce_sum"):
        return tree_map(lambda a: np.asarray(a.sum(axis=0)), _allgather(x))


# --- the step's collectives ---------------------------------------------------


def _flat_groups(tensors: Sequence[torch.Tensor]) -> List[tuple]:
    """[(tensors of one (dtype, device)), ...] in first-seen order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return list(groups.values())


def _size(group) -> int:
    """Ranks in `group`; the default group when None (1 without one)."""
    if not is_distributed():
        return 1
    return dist.get_world_size(group)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """In place, each tensor <- its mean over the ranks of `group` (the
    default group when None): one all-reduce of one flat buffer per
    (dtype, device), the sum divided by the group's size (the JAX step's
    single `pmean` of the gradient). Every rank gets the same bits."""
    if not is_distributed():
        return
    n = float(_size(group))
    for tgroup in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in tgroup])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        torch._foreach_copy_(tgroup, [v.view(t.shape) for v, t in
                                      zip(flat.split([t.numel() for t in tgroup]), tgroup)])


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """In place, each tensor <- global rank `src`'s (a member of `group`,
    the default group when None), one flat broadcast per (dtype, device)
    (replication of the parameters after init and after a restore)."""
    if not is_distributed():
        return
    for tgroup in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in tgroup])
        dist.broadcast(flat, src=src, group=group)
        torch._foreach_copy_(tgroup, [v.view(t.shape) for v, t in
                                      zip(flat.split([t.numel() for t in tgroup]), tgroup)])


def _reduce32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, taken in float32, in x's dtype."""
    out = x.to(torch.float32, memory_format=torch.contiguous_format).clone()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """sum over ranks; its backward is the same all-reduce of the
    gradient (each rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group` (the default group when
    None), differentiable (identity without a process group)."""
    if not is_distributed():
        return x
    return _AllReduceSum.apply(x, group)


def exchange(x: torch.Tensor, peer: int, group=None) -> torch.Tensor:
    """Global rank `peer`'s `x` (a member of `group`, the default group when
    None; same shape and dtype on every rank): one broadcast from each rank
    of the group in turn, the tensor carried as raw bytes so any dtype
    crosses any backend. This rank's own value with no group."""
    if not is_distributed() or _size(group) == 1:
        return x
    out = None
    for src in group_ranks(group):
        buf = _broadcast_raw(x, src, group)
        if src == peer:
            out = buf
    return out


# --- the model axis -------------------------------------------------------------


def _active(group) -> bool:
    return group is not None and is_distributed() and dist.get_world_size(group) > 1


def _broadcast_raw(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Global rank `src`'s `x` (same shape and dtype everywhere) by one
    broadcast of its bytes."""
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    buf = raw.clone() if src == process_index() else torch.empty_like(raw)
    dist.broadcast(buf, src=src, group=group)
    return buf.view(x.dtype).reshape(x.shape)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `x` (same shape and dtype everywhere), group-rank
    order; [x] without a model axis."""
    if not _active(group):
        return [x]
    ranks = group_ranks(group)
    if _nccl(group):
        out = torch.empty((len(ranks),) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return list(out.unbind(0))
    return [_broadcast_raw(x, r, group) for r in ranks]


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in group-rank order."""
    return torch.cat(gather_list(x, group), dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous 1/n of `x` along `dim`."""
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size).contiguous()


def _permute(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """The `x` of group rank (i - shift) mod n on group rank i: each rank
    sends to its rank + shift."""
    ranks = group_ranks(group)
    n, i = len(ranks), dist.get_rank(group)
    src, dst = ranks[(i - shift) % n], ranks[(i + shift) % n]
    if _nccl(group):
        x = x.contiguous()
        out = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                       dist.P2POp(dist.irecv, out, src, group)])
        for r in reqs:
            r.wait()
        return out
    out = None
    for r in ranks:
        buf = _broadcast_raw(x, r, group)
        if r == src:
            out = buf
    return out


def _all_to_all(x: torch.Tensor, split: int, concat: int, group) -> torch.Tensor:
    """Tiled all-to-all: `x` cut in n chunks along `split`, chunk j sent to
    group rank j, the chunks received concatenated along `concat` in
    group-rank order (`lax.all_to_all(..., tiled=True)`)."""
    ranks = group_ranks(group)
    n, i = len(ranks), dist.get_rank(group)
    if _nccl(group):
        inp = torch.stack(x.chunk(n, dim=split)).contiguous()
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp, group=group)
        return torch.cat(list(out.unbind(0)), concat)
    parts = [_broadcast_raw(x, r, group).chunk(n, dim=split)[i] for r in ranks]
    return torch.cat(parts, concat)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _reduce32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice(x, 1, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, 1, ctx.group), None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, 1, group)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, 1, ctx.group), None


class _PermuteRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _permute(x, 1, group)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, -1, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.args = (split, concat, group)
        return _all_to_all(x, split, concat, group)

    @staticmethod
    def backward(ctx, grad):
        split, concat, group = ctx.args
        return _all_to_all(grad, concat, split, group), None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over `group` (the
    input of a column-parallel layer: each rank's local columns see all of
    `x`)."""
    return _CopyToModel.apply(x, group) if _active(group) else x


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` forward (a row-parallel layer's partial
    products); identity backward."""
    return _ReduceFromModel.apply(x, group) if _active(group) else x


def scatter_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's 1/n of the token axis (dim 1; it must divide);
    the backward all-gathers the slices' gradients."""
    return _ScatterTokens.apply(x, group) if _active(group) else x


def gather_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """The token slices of `group` concatenated along dim 1, rank order; the
    backward takes this rank's slice (every rank of the group computes the
    same thing after the gather, so a reduce-scatter would count each
    gradient n times)."""
    return _GatherTokens.apply(x, group) if _active(group) else x


def ppermute_ring(x: torch.Tensor, group) -> torch.Tensor:
    """The previous rank's `x` (group rank i - 1 mod n); this rank's goes to
    rank i + 1. The backward sends the gradient back the other way."""
    return _PermuteRing.apply(x, group) if _active(group) else x


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               group) -> torch.Tensor:
    """Tiled all-to-all over `group` (see `_all_to_all`); the backward is
    the inverse all-to-all."""
    if not _active(group):
        return x
    return _AllToAll.apply(x, split_axis, concat_axis, group)


# --- the fsdp axis ----------------------------------------------------------------


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous 1/n of dim `dim` of the sum of every rank's
    `x` over `group` (same shape and dtype everywhere), summed in float32;
    `x` itself without an active group."""
    if not _active(group):
        return x
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if _nccl(group):
        inp = torch.stack(x.to(torch.float32).chunk(n, dim=dim)).contiguous()
        out = torch.empty_like(inp[0])
        dist.reduce_scatter_tensor(out, inp, group=group)
        return out.to(x.dtype)
    total = None
    for r in group_ranks(group):
        part = _broadcast_raw(x, r, group).chunk(n, dim=dim)[i].to(torch.float32)
        total = part if total is None else total + part
    return total.to(x.dtype).contiguous()


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.args = (dim, group)
        return _all_gather(shard.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, grad):
        dim, group = ctx.args
        return reduce_scatter(grad.contiguous(), dim, group), None, None


def fsdp_gather(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The full leaf from every rank's chunk of dim `dim` (group-rank
    order); its backward reduce-scatters the gradient (a sum: the step
    divides by the fsdp count). The shard itself without an active group."""
    if not _active(group):
        return shard
    return _FsdpGather.apply(shard, dim, group)
