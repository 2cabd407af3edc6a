"""Clip samplers: pick a [start, end) time window from a video (the port's
copy of the JAX package's `data/samplers.py`, numpy only).

- "random" (train): uniformly random start in [0, duration - clip_duration].
- "uniform" (val): `num_clips` evenly spaced windows per video (default 1),
  deterministic.
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
