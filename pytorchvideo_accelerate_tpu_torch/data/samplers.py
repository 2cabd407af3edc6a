"""Clip samplers: pick a [start, end) time window from a video (the port's
copy of the JAX package's `data/samplers.py`, numpy only).

- "random" (train): uniformly random start in [0, duration - clip_duration].
- "uniform" (val): `num_clips` evenly spaced windows per video (default 1),
  deterministic.

`substitute_indices` is the sampler half of the bad-sample quarantine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class ClipSpan:
    start: float  # seconds
    end: float


def random_clip(duration: float, clip_duration: float,
                rng: np.random.Generator) -> ClipSpan:
    if duration <= clip_duration:
        return ClipSpan(0.0, min(clip_duration, duration))
    start = float(rng.uniform(0.0, duration - clip_duration))
    return ClipSpan(start, start + clip_duration)


def uniform_clips(duration: float, clip_duration: float,
                  num_clips: int = 1) -> List[ClipSpan]:
    """`num_clips` evenly spaced windows; centers for the degenerate cases."""
    if duration <= clip_duration:
        return [ClipSpan(0.0, min(clip_duration, duration))] * num_clips
    if num_clips == 1:
        starts = [(duration - clip_duration) / 2.0]
    else:
        starts = np.linspace(0.0, duration - clip_duration, num_clips).tolist()
    return [ClipSpan(float(s), float(s) + clip_duration) for s in starts]


def substitute_indices(indices: np.ndarray, excluded, num_total: int,
                       seed: int, epoch: int) -> np.ndarray:
    """Remap quarantined sample indices onto clean ones, deterministically.

    A quarantined clip (`data/manifest.py Quarantine`) must never reach the
    decode pool, but dropping its index would change the epoch's batch
    count mid-run (steps_per_epoch feeds the LR schedule and the
    checkpointed loader position). So each excluded index is replaced by a
    clean index drawn from its own `(seed, 0xC1EA, epoch, index)` stream:
    reproducible across restarts and independent of how many other clips
    are quarantined. `excluded` is a set of sample indices, `num_total` the
    source length. Returns a copy; when every index is excluded, the
    original indices (nothing clean to substitute: the per-sample failure
    path then reports the real error)."""
    excluded = set(int(i) for i in excluded)
    if not excluded:
        return indices
    clean = np.array([i for i in range(num_total) if i not in excluded],
                     dtype=indices.dtype if indices.size else np.int64)
    if clean.size == 0:
        return indices
    out = indices.copy()
    for pos in np.nonzero(np.isin(indices, list(excluded)))[0]:
        rng = np.random.default_rng(
            (seed, 0xC1EA, epoch, int(indices[pos])))
        out[pos] = clean[int(rng.integers(0, clean.size))]
    return out
