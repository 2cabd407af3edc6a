"""Dataset manifest: a dir-per-class video index, or a path+label list file
(the port's copy of the JAX package's `data/manifest.py`; its bad-sample
`Quarantine` comes with the training guard, ROADMAP.md A.3).

The on-disk layout is the reference README's `data_dir/{train,val}/{class}/
*.mp4`. `from_list` reads the list format of pytorchvideo's
`LabeledVideoDataset.from_csv`: one `relative/path.mp4 <label>` per line,
space- or comma-separated.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mkv", ".webm", ".mov", ".m4v")


@dataclass(frozen=True)
class VideoEntry:
    path: str
    label: int
    label_name: str


@dataclass
class Manifest:
    entries: List[VideoEntry]
    class_names: List[str]  # sorted; index = label id

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def num_videos(self) -> int:
        return len(self.entries)

    def __len__(self) -> int:
        return len(self.entries)


def from_list(list_path: str, root: str = "") -> Manifest:
    """Read a `path label` list file (one video per line, space- or
    comma-separated, the label an integer id, the LAST field, so paths with
    spaces survive). Relative paths resolve against `root`. Class names are
    synthesized (`class_<id>`): list files carry none."""
    if not os.path.isfile(list_path):
        raise FileNotFoundError(f"manifest list file not found: {list_path}")
    entries: List[VideoEntry] = []
    max_label = -1
    with open(list_path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = (line.rsplit(",", 1) if "," in line
                     else line.rsplit(None, 1))
            if len(parts) != 2:
                raise ValueError(
                    f"{list_path}:{lineno}: expected 'path label', "
                    f"got {line!r}")
            path, label_s = parts[0].strip(), parts[1].strip()
            try:
                label = int(label_s)
            except ValueError:
                raise ValueError(
                    f"{list_path}:{lineno}: label must be an integer id, "
                    f"got {label_s!r} (dir-per-class trees carry names; "
                    "list files carry ids)") from None
            if label < 0:
                raise ValueError(
                    f"{list_path}:{lineno}: negative label {label}")
            if root and not os.path.isabs(path):
                path = os.path.join(root, path)
            max_label = max(max_label, label)
            entries.append(VideoEntry(path, label, f"class_{label}"))
    if not entries:
        raise ValueError(f"no entries in {list_path}")
    class_names = [f"class_{i}" for i in range(max_label + 1)]
    return Manifest(entries=entries, class_names=class_names)


def scan_directory(split_dir: str) -> Manifest:
    """Scan `split_dir/{class}/*` into a manifest. Class ids follow the
    sorted class-directory names, the same on every host."""
    if not os.path.isdir(split_dir):
        raise FileNotFoundError(f"dataset split directory not found: {split_dir}")
    class_names = sorted(
        d for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d)) and not d.startswith(".")
    )
    if not class_names:
        raise ValueError(f"no class directories under {split_dir}")
    entries: List[VideoEntry] = []
    for label, name in enumerate(class_names):
        cdir = os.path.join(split_dir, name)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(VIDEO_EXTENSIONS):
                entries.append(VideoEntry(os.path.join(cdir, fname), label, name))
    if not entries:
        raise ValueError(f"no video files under {split_dir}")
    return Manifest(entries=entries, class_names=class_names)
