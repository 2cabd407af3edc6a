"""Video decode through OpenCV (the port's copy of the JAX package's
`data/decode.py`).

cv2's `VideoCapture` releases the GIL, so a thread pool decodes in
parallel. Where cv2 cannot be imported, `probe` and `decode_span` raise
`NoVideoDecoderError`, which names the route that needs no codec: build a
frame cache where cv2 is (`python -m
pytorchvideo_accelerate_tpu_torch.data.cache build ...`) and train from it
with `--data.cache_dir`. It is an ImportError, not one of
`DECODE_ERRORS`, so no caller mistakes it for an unreadable file.

`decode_span` is the `decode.read` fault point (reliability/faults.py): an
injected fault is an OSError, so it takes the retry and quarantine path a
real unreadable file takes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from pytorchvideo_accelerate_tpu_torch.reliability.faults import fault_point

try:
    import cv2
except ImportError:  # pragma: no cover - a machine without OpenCV
    cv2 = None

# what "this video is unreadable" looks like from the decode layer, for
# every caller that degrades gracefully (clip substitution, the cache
# build's skip, the verify report); cv2.error subclasses Exception only
DECODE_ERRORS = ((IOError, OSError, ValueError, RuntimeError, cv2.error)
                 if cv2 is not None and hasattr(cv2, "error")
                 else (IOError, OSError, ValueError, RuntimeError))


class CorruptVideoError(IOError):
    """The decoder's verdict that the FILE is bad (the container does not
    open, no frame in a valid span), as opposed to an ambient OSError of
    flaky storage; an IOError, so it rides DECODE_ERRORS."""


class NoVideoDecoderError(ImportError):
    """cv2 cannot be imported on this machine, so no video file decodes."""


def require_decoder() -> None:
    """Raise `NoVideoDecoderError` naming the frame-cache route when cv2 is
    missing."""
    if cv2 is None:
        raise NoVideoDecoderError(
            "this machine has no cv2 (OpenCV), which decodes video files. "
            "Build a frame cache where cv2 is: python -m "
            "pytorchvideo_accelerate_tpu_torch.data.cache build --data_dir "
            "DATA_DIR/train --out CACHE/train (and the same for val), then "
            "train here with --data.cache_dir CACHE")


@dataclass
class VideoMeta:
    fps: float
    frame_count: int

    @property
    def duration(self) -> float:
        return self.frame_count / self.fps if self.fps > 0 else 0.0


def probe(path: str) -> VideoMeta:
    require_decoder()
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise CorruptVideoError(f"cannot open video: {path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        return VideoMeta(fps=float(fps), frame_count=frame_count)
    finally:
        cap.release()


def decode_span(path: str, start_sec: float, end_sec: float,
                max_frames: Optional[int] = None) -> np.ndarray:
    """Decode frames in [start_sec, end_sec) as (T, H, W, 3) RGB uint8.

    Seeks to the start frame, then reads sequentially. Raises
    CorruptVideoError on unreadable files; returns at least one frame for
    any readable video (a span past the end yields what exists)."""
    require_decoder()
    fault_point("decode.read", path=path)
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise CorruptVideoError(f"cannot open video: {path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        start_frame = max(int(round(start_sec * fps)), 0)
        end_frame = max(int(round(end_sec * fps)), start_frame + 1)
        if max_frames is not None:
            end_frame = min(end_frame, start_frame + max_frames)
        if start_frame > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
        frames = []
        for _ in range(end_frame - start_frame):
            ok, frame_bgr = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB))
        if not frames:
            raise CorruptVideoError(
                f"no frames decoded from {path} in [{start_sec:.2f}, {end_sec:.2f})s"
            )
        return np.stack(frames)
    finally:
        cap.release()
