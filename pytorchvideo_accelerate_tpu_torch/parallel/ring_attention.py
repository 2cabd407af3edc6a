"""Ring attention: context-parallel attention over the train mesh's model
axis (counterpart of the JAX package's `parallel/ring_attention.py`).

Each rank of a model group holds 1/cp of the tokens of q, k and v; the K/V
blocks go round the ring (`ppermute_ring`: send to the next rank, receive
from the previous one) and each rank accumulates its queries' attention
with the online softmax of flash attention (`_online_block`, f32 running
max and sum), so the full score matrix never exists. Plain torch einsums,
like the JAX package's (plain XLA there, no Pallas kernel): each block
counts one in `RING_BLOCKS`.

Tokens that do not divide the axis are padded; the padded keys are masked,
and the mask multiplies the softmax numerator as well as the logits (a
block of padding only would otherwise add exp(0) = 1 per key). After s
hops a rank holds the block that started on rank (m - s) mod cp, which
places the mask. The running max is taken without a gradient: the result
does not depend on it.

`cp_attention(q, k, v, local_fn, group)` is the wrapper a model calls
(`make_cp_attention` in the JAX package): pad each of q, k, v to a multiple
of cp, take this rank's token slice (`scatter_tokens`), run `local_fn`
(`ring_attention` or `ulysses.ulysses_attention`), gather the slices back
(`gather_tokens`) and trim. Outside attention every rank of the group
computes the same full tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from pytorchvideo_accelerate_tpu_torch.parallel.collectives import (
    gather_tokens,
    ppermute_ring,
    scatter_tokens,
)
from pytorchvideo_accelerate_tpu_torch.precision import f32_island

NEG_INF = -1e30
# online-softmax blocks run since the last reset (plain torch, no kernel)
RING_BLOCKS = [0]


def _size_rank(group):
    import torch.distributed as dist

    if group is None or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _online_block(q, k, v, kmask, o, l, m, scale: float):
    """One accumulation block. q (B, Nq, H, D); k/v (B, Nk, H, D); kmask
    (Nk,) bool or None; o (B, Nq, H, D) f32; l/m (B, H, Nq) running sum and
    max."""
    RING_BLOCKS[0] += 1
    logits = torch.einsum("bqhd,bkhd->bhqk", f32_island(q), f32_island(k)) * scale
    if kmask is not None:
        logits = torch.where(kmask[None, None, None, :], logits,
                             torch.full((), NEG_INF, device=logits.device))
    m_new = torch.maximum(m, logits.detach().amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    if kmask is not None:
        p = p * kmask[None, None, None, :]
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, f32_island(v))
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return o_new, l_new, m_new


def ring_attention(q, k, v, group, scale: Optional[float] = None,
                   nk_valid: Optional[int] = None, nq_valid: Optional[int] = None):
    """Blockwise ring attention over the ranks of `group` (None: one rank):
    q/k/v are this rank's token shards (B, N_local, H, D). `nk_valid`: the
    global count of real keys; keys at a global position from it on are
    masked. `nq_valid` is unused (padded query rows are trimmed by the
    caller). Non-causal."""
    del nq_valid
    if scale is None:
        scale = q.shape[-1] ** -0.5
    steps, my = _size_rank(group)
    blk = k.shape[1]
    b, nq, h, d = q.shape
    o = torch.zeros((b, nq, h, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, nq), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, nq), NEG_INF, dtype=torch.float32, device=q.device)
    for s in range(steps):
        kmask = None
        if nk_valid is not None and nk_valid < steps * blk:
            src = (my - s) % steps
            kmask = (src * blk + torch.arange(blk, device=q.device)) < nk_valid
        o, l, m = _online_block(q, k, v, kmask, o, l, m, scale)
        if s < steps - 1:  # the last rotation would be dead work
            k, v = ppermute_ring(k, group), ppermute_ring(v, group)
    out = o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _pad_tokens(x, mult: int):
    pad = (-x.shape[1]) % mult
    return F.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def cp_attention(q, k, v, local_fn: Callable, group,
                 scale: Optional[float] = None):
    """Context-parallel attention of the full q (B, Nq, H, D), k/v (B, Nk,
    H, D), which every rank of `group` holds alike: pad, scatter the token
    axis, `local_fn(q, k, v, group, scale=, nk_valid=, nq_valid=)`, gather,
    trim. The result is the full (B, Nq, H, D) on every rank."""
    cp, _ = _size_rank(group)
    nq, nk = q.shape[1], k.shape[1]
    qp, kp, vp = _pad_tokens(q, cp), _pad_tokens(k, cp), _pad_tokens(v, cp)
    out = local_fn(scatter_tokens(qp, group), scatter_tokens(kp, group),
                   scatter_tokens(vp, group), group, scale=scale,
                   nk_valid=None if kp.shape[1] == nk else nk,
                   nq_valid=None if qp.shape[1] == nq else nq)
    return gather_tokens(out, group)[:, :nq]
