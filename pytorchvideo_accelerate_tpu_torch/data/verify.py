"""Dataset doctor: audit a video tree before training on it (the port's
copy of the JAX package's `data/verify.py`).

How many files are unreadable, whether a class is empty or its videos are
shorter than the clip duration, and the duration spread the clip samplers
will see. Needs cv2 (`data/decode.py`).

CLI:
    python -m pytorchvideo_accelerate_tpu_torch.data.verify DATA_DIR/train \\
        [--list train.txt] [--clip_duration 2.13] [--num_workers 8] [--deep]

`--deep` decodes one frame from the middle of every file (catches
truncated payloads a header probe misses). Prints a JSON report; exit code
1 when any file is unreadable, 2 when a class is empty.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor

from pytorchvideo_accelerate_tpu_torch.data import decode as decode_mod
from pytorchvideo_accelerate_tpu_torch.data.manifest import (
    from_list,
    scan_directory,
)


def check_one(path: str, deep: bool) -> dict:
    """Probe (and under `deep`, decode a mid-file frame of) one video."""
    try:
        meta = decode_mod.probe(path)
        if meta.frame_count <= 0:
            return {"path": path, "ok": False,
                    "error": f"empty stream (frames={meta.frame_count})"}
        if meta.fps <= 0:
            return {"path": path, "ok": False,
                    "error": f"unreadable header (fps={meta.fps})"}
        if deep:
            mid = meta.duration / 2
            decode_mod.decode_span(path, mid, mid + 1.0 / meta.fps)
        return {"path": path, "ok": True, "fps": round(meta.fps, 3),
                "duration_s": round(meta.duration, 3)}
    except decode_mod.DECODE_ERRORS as e:
        return {"path": path, "ok": False,
                "error": f"{type(e).__name__}: {e}"}


def verify_tree(split_dir: str, clip_duration: float = 0.0,
                num_workers: int = 8, deep: bool = False,
                manifest=None) -> dict:
    """Audit every video under `split_dir` (or of `manifest`); returns the
    report dict."""
    decode_mod.require_decoder()
    manifest = manifest or scan_directory(split_dir)
    pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
    try:
        results = list(pool.map(lambda e: check_one(e.path, deep),
                                manifest.entries))
    finally:
        pool.shutdown(wait=False)

    bad = [r for r in results if not r["ok"]]
    ok = [r for r in results if r["ok"]]
    per_class = {name: 0 for name in manifest.class_names}
    short = []
    for entry, r in zip(manifest.entries, results):
        if r["ok"]:
            per_class[manifest.class_names[entry.label]] += 1
            if clip_duration and r["duration_s"] < clip_duration:
                short.append({"path": entry.path,
                              "duration_s": r["duration_s"]})
    empty_classes = sorted(n for n, c in per_class.items() if c == 0)
    durations = sorted(r["duration_s"] for r in ok)

    def pct(p):
        return durations[min(int(p * len(durations)), len(durations) - 1)]

    report = {
        "split_dir": split_dir,
        "num_videos": len(manifest),
        "num_classes": manifest.num_classes,
        "readable": len(ok),
        "unreadable": len(bad),
        "unreadable_files": [{"path": b["path"], "error": b["error"]}
                             for b in bad],
        "empty_classes": empty_classes,
        "deep": deep,
    }
    if durations:
        report["duration_s"] = {"min": durations[0], "p50": pct(0.5),
                                "p95": pct(0.95), "max": durations[-1]}
    if clip_duration:
        report["clip_duration"] = clip_duration
        # shorter-than-clip videos still train (the sampler clamps the span
        # and decode returns what exists), with repeated content
        report["shorter_than_clip"] = short
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("split_dir")
    ap.add_argument("--list", dest="list_file", default="",
                    help="audit a 'path label' list file instead of "
                         "scanning split_dir/{class}/ (from_list format; "
                         "relative paths resolve against split_dir)")
    ap.add_argument("--clip_duration", type=float, default=0.0,
                    help="flag videos shorter than this many seconds")
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--deep", action="store_true",
                    help="also decode one mid-file frame per video")
    args = ap.parse_args(argv)

    manifest = (from_list(args.list_file, root=args.split_dir)
                if args.list_file else None)
    report = verify_tree(args.split_dir, args.clip_duration,
                         args.num_workers, args.deep, manifest=manifest)
    print(json.dumps(report, indent=1))
    if report["unreadable"]:
        return 1
    if report["empty_classes"]:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
