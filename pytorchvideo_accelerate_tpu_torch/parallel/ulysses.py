"""Ulysses attention: context parallelism by two all-to-alls (counterpart of
the JAX package's `parallel/ulysses.py`).

Each rank of a model group holds 1/cp of the tokens of q, k and v, all
heads. The first all-to-all swaps the split from tokens to heads, so each
rank attends H/cp heads over the whole sequence; the second swaps it back:

    (B, N/cp, H, D) -> (B, N, H/cp, D) -> attention -> (B, N/cp, H, D)

The local attention is the port's `flash_attention` (the hand kernels of
rows 5-7 on the card, their plain versions on the CPU), where the JAX
package runs XLA's fused attention with a key mask. The flash kernels
take no mask, and after the all-to-all the padding of a ragged sequence
sits at the end of the full sequence: the padded keys and queries are
trimmed before the call and the output padded back after it, which gives
the rows the mask gives. Where the heads do not divide the axis (MViT's
early stages) it falls back to ring attention.
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from pytorchvideo_accelerate_tpu_torch.ops.flash_attention import flash_attention
from pytorchvideo_accelerate_tpu_torch.parallel.collectives import all_to_all
from pytorchvideo_accelerate_tpu_torch.parallel.ring_attention import (
    _size_rank,
    ring_attention,
)


def ulysses_attention(q, k, v, group, scale: Optional[float] = None,
                      nk_valid: Optional[int] = None,
                      nq_valid: Optional[int] = None):
    """All-to-all attention over `group`: q/k/v this rank's token shards
    (B, N/cp, H, D); `nk_valid` / `nq_valid` the global counts of real keys
    and queries (None: all real). Ring attention when H % cp != 0."""
    cp, _ = _size_rank(group)
    if q.shape[2] % cp:
        return ring_attention(q, k, v, group, scale=scale, nk_valid=nk_valid)

    def to_heads(x):  # (B, N/cp, H, D) -> (B, N, H/cp, D)
        return all_to_all(x, 2, 1, group)

    qg, kg, vg = to_heads(q), to_heads(k), to_heads(v)
    nq = qg.shape[1] if nq_valid is None else nq_valid
    nk = kg.shape[1] if nk_valid is None else nk_valid
    out = flash_attention(qg[:, :nq], kg[:, :nk], vg[:, :nk], scale)
    if nq < qg.shape[1]:
        out = F.pad(out, (0, 0, 0, 0, 0, qg.shape[1] - nq))
    return all_to_all(out, 1, 2, group)  # back to (B, N/cp, H, D)
