"""Pre-decoded frame cache (the port's copy of the JAX package's
`data/cache.py`, the `build` side and the reader; its decode-vs-cache
bench is queued in ROADMAP.md).

An offline pass decodes every manifest video once into a flat uint8 frame
store plus a JSON index; training then serves any clip span as a memmap
slice, with no codec in the hot path. Building needs cv2; reading needs
only numpy, so a machine without cv2 trains on real clips from a cache
built elsewhere. The format is the JAX package's, so a cache built by
either package is read by both:

    index.json   {"fps": F, "short_side": S, "num_classes": N, "videos":
                  [{"path", "label", "offset", "frames", "height",
                  "width"}, ...]}
    data.bin     concatenated (T_i, H_i, W_i, 3) uint8 frame blocks

Videos keep their aspect ratio (short side scaled down to `short_side`),
so records vary in H and W; offsets are byte positions into data.bin.

CLI:
    python -m pytorchvideo_accelerate_tpu_torch.data.cache build \\
        --data_dir /data/kinetics/train --out /ssd/kinetics_cache/train \\
        [--list train.txt] [--fps 30] [--short_side 320] [--num_workers 8]
"""

from __future__ import annotations

import json
import logging
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

from pytorchvideo_accelerate_tpu_torch.data import decode as decode_mod
from pytorchvideo_accelerate_tpu_torch.data.manifest import (
    Manifest,
    from_list,
    scan_directory,
)
from pytorchvideo_accelerate_tpu_torch.data.pipeline import sample_views

logger = logging.getLogger(__name__)

INDEX_NAME = "index.json"
DATA_NAME = "data.bin"


def _scaled_size(h: int, w: int, short_side: int) -> tuple:
    if min(h, w) <= short_side:
        return h, w
    if h < w:
        return short_side, max(int(round(w * short_side / h)), 1)
    return max(int(round(h * short_side / w)), 1), short_side


def _decode_video(path: str, fps: float, short_side: int) -> np.ndarray:
    """Decode a whole video resampled to `fps` (nearest frame), short side
    scaled down to at most `short_side` (cv2 bilinear, as the JAX package
    resizes)."""
    meta = decode_mod.probe(path)
    frames = decode_mod.decode_span(path, 0.0, meta.duration)
    if abs(meta.fps - fps) > 1e-3 and meta.fps > 0:
        n_out = max(int(round(len(frames) * fps / meta.fps)), 1)
        idx = np.clip(
            np.round(np.arange(n_out) * meta.fps / fps).astype(np.int64),
            0, len(frames) - 1,
        )
        frames = frames[idx]
    h, w = frames.shape[1:3]
    sh, sw = _scaled_size(h, w, short_side)
    if (sh, sw) != (h, w):
        cv2 = decode_mod.cv2
        frames = np.stack(
            [cv2.resize(f, (sw, sh), interpolation=cv2.INTER_LINEAR)
             for f in frames]
        )
    return np.ascontiguousarray(frames)


def build_cache(data_dir: str, out_dir: str, fps: float = 30.0,
                short_side: int = 320, num_workers: int = 8,
                manifest: Optional[Manifest] = None) -> dict:
    """Offline transcode: manifest videos -> frame store. Returns the index.

    Decode runs in a thread pool with a bounded decode-ahead window;
    writes are sequential appends in manifest order, so the output is
    deterministic. An unreadable video is skipped (logged, left out of the
    index)."""
    decode_mod.require_decoder()
    manifest = manifest or scan_directory(data_dir)
    os.makedirs(out_dir, exist_ok=True)
    videos: List[dict] = []
    pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
    try:
        window = max(num_workers, 1) * 2
        pending = deque()
        for e in manifest.entries[:window]:
            pending.append((e, pool.submit(_decode_video, e.path, fps,
                                           short_side)))
        consumed = len(pending)
        offset = 0
        with open(os.path.join(out_dir, DATA_NAME), "wb") as f:
            while pending:
                entry, fut = pending.popleft()
                try:
                    frames = fut.result()
                except decode_mod.DECODE_ERRORS as e:
                    logger.warning("cache build: skipping unreadable %s "
                                   "(%s: %s)", entry.path, type(e).__name__, e)
                    frames = None
                if consumed < len(manifest.entries):
                    nxt = manifest.entries[consumed]
                    pending.append((nxt, pool.submit(_decode_video, nxt.path,
                                                     fps, short_side)))
                    consumed += 1
                if frames is None:
                    continue
                f.write(frames.tobytes())
                videos.append({
                    "path": entry.path,
                    "label": int(entry.label),
                    "offset": offset,
                    "frames": int(frames.shape[0]),
                    "height": int(frames.shape[1]),
                    "width": int(frames.shape[2]),
                })
                offset += frames.nbytes
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    index = {
        "fps": float(fps),
        "short_side": int(short_side),
        "num_classes": manifest.num_classes,
        "videos": videos,
    }
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump(index, f)
    return index


class FrameCache:
    """Memmap view over a built cache; `read(i, start_sec, end_sec)` returns
    (T, H, W, 3) uint8, the `decode_span` contract without the decode."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, INDEX_NAME)) as f:
            self.index = json.load(f)
        self.fps = float(self.index["fps"])
        self.num_classes = int(self.index.get("num_classes", 0))
        self.videos = self.index["videos"]
        self._data = np.memmap(os.path.join(cache_dir, DATA_NAME),
                               dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return len(self.videos)

    def duration(self, i: int) -> float:
        return self.videos[i]["frames"] / self.fps

    def label(self, i: int) -> int:
        return self.videos[i]["label"]

    def byte_range(self, i: int, start_sec: float, end_sec: float):
        """(lo, hi, shape) of a clip span inside data.bin: the span clamped
        to the video's frames, at least one frame."""
        v = self.videos[i]
        t, h, w = v["frames"], v["height"], v["width"]
        start = min(max(int(round(start_sec * self.fps)), 0), t - 1)
        end = min(max(int(round(end_sec * self.fps)), start + 1), t)
        stride = h * w * 3
        lo = v["offset"] + start * stride
        hi = v["offset"] + end * stride
        return lo, hi, (end - start, h, w, 3)

    def read(self, i: int, start_sec: float, end_sec: float) -> np.ndarray:
        lo, hi, shape = self.byte_range(i, start_sec, end_sec)
        return np.asarray(self._data[lo:hi]).reshape(shape)

    def close(self) -> None:
        """Release the memmap."""
        mm = getattr(self._data, "_mmap", None)
        self._data = None
        if mm is not None:
            mm.close()


class CachedClipSource:
    """A `ClipSource` over a FrameCache, with VideoClipSource's sampling
    (the `(seed, epoch, index)` stream, eval multi-view)."""

    def __init__(self, cache_dir: str, transform: Callable,
                 clip_duration: float, training: bool, seed: int = 42,
                 num_clips: int = 1):
        self.cache = FrameCache(cache_dir)
        self.transform = transform
        self.clip_duration = clip_duration
        self.training = training
        self.seed = seed
        self.num_clips = max(num_clips, 1) if not training else 1
        self.num_classes = self.cache.num_classes

    def __len__(self) -> int:
        return len(self.cache)

    def get(self, index: int, epoch: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, epoch, index))
        out = sample_views(
            lambda a, b: self.cache.read(index, a, b), self.transform,
            self.cache.duration(index), self.clip_duration, self.training,
            rng, self.num_clips,
        )
        out["label"] = np.int32(self.cache.label(index))
        return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="decode a manifest directory into a cache")
    b.add_argument("--data_dir", required=True)
    b.add_argument("--list", dest="list_file", default="",
                   help="build from a 'path label' list file instead of "
                        "scanning data_dir/{class}/ (manifest.from_list "
                        "format; relative paths resolve against data_dir)")
    b.add_argument("--out", required=True)
    b.add_argument("--fps", type=float, default=30.0)
    b.add_argument("--short_side", type=int, default=320)
    b.add_argument("--num_workers", type=int, default=8)
    args = ap.parse_args(argv)

    manifest = (from_list(args.list_file, root=args.data_dir)
                if args.list_file else None)
    index = build_cache(args.data_dir, args.out, fps=args.fps,
                        short_side=args.short_side,
                        num_workers=args.num_workers, manifest=manifest)
    total = sum(v["frames"] for v in index["videos"])
    size = os.path.getsize(os.path.join(args.out, DATA_NAME))
    print(f"cached {len(index['videos'])} videos, {total} frames, "
          f"{size / 1e9:.2f} GB -> {args.out}")
    return index


if __name__ == "__main__":
    main()
