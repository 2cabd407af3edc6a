"""Dataset manifest: a dir-per-class video index, or a path+label list file,
and the bad-sample `Quarantine` (the port's copy of the JAX package's
`data/manifest.py`).

The on-disk layout is the reference README's `data_dir/{train,val}/{class}/
*.mp4`. `from_list` reads the list format of pytorchvideo's
`LabeledVideoDataset.from_csv`: one `relative/path.mp4 <label>` per line,
space- or comma-separated.

`Quarantine` sidelines deterministically corrupt files: each clip has a
failure budget, and exhausting it moves the path into a JSON sidecar
(`<output_dir>/quarantine.json`, the JAX package's format, so either
package reads the other's) that the sampler excludes
(`samplers.substitute_indices`: epoch geometry unchanged). Each quarantine
ticks `pva_data_quarantined_total{site="decode"}` and leaves a warning in the
flight recorder.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from pytorchvideo_accelerate_tpu_torch.obs import get_recorder, get_registry
from pytorchvideo_accelerate_tpu_torch.reliability.atomic import atomic_write_json

logger = logging.getLogger(__name__)

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


class Quarantine:
    """Persisted per-clip failure budget and the quarantined-path sidecar.

    `record(path, error)` counts one decode failure against `path`; the
    `budget`-th quarantines it: the path lands in the sidecar (an atomic
    write, so a kill mid-update cannot corrupt the list), and every source
    and sampler consulting `contains()` / `paths()` skips the clip from then
    on, the next run included (the sidecar is read back at construction;
    an unreadable one starts fresh). Thread-safe: decode workers record
    concurrently. `budget=1` quarantines on the first failure."""

    def __init__(self, sidecar_path: str, budget: int = 3):
        self.sidecar_path = sidecar_path
        self.budget = max(int(budget), 1)
        self._lock = threading.Lock()
        self._failures: Dict[str, int] = {}
        self._quarantined: Dict[str, str] = {}  # path -> last error head
        if sidecar_path and os.path.exists(sidecar_path):
            try:
                with open(sidecar_path) as f:
                    data = json.load(f)
                self._quarantined = dict(data.get("quarantined", {}))
                self._failures = {k: int(v) for k, v in
                                  data.get("failures", {}).items()}
            except (OSError, ValueError, AttributeError, TypeError):
                # quarantine is an optimisation, never a reason to refuse
                # to train
                self._quarantined, self._failures = {}, {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._quarantined)

    def contains(self, path: str) -> bool:
        with self._lock:
            return path in self._quarantined

    def paths(self) -> set:
        with self._lock:
            return set(self._quarantined)

    def snapshot(self) -> dict:
        """Quarantined paths with their evidence, and the failure counts
        still under budget."""
        with self._lock:
            return {"budget": self.budget,
                    "quarantined": dict(self._quarantined),
                    "failures_under_budget": {
                        p: c for p, c in self._failures.items()
                        if p not in self._quarantined}}

    def record(self, path: str, error: Optional[BaseException] = None) -> bool:
        """Count one failure; True when this call newly quarantined the
        path."""
        head = f"{type(error).__name__}: {error}"[:200] if error else ""
        with self._lock:
            if path in self._quarantined:
                return False
            n = self._failures.get(path, 0) + 1
            self._failures[path] = n
            newly = n >= self.budget
            if newly:
                self._quarantined[path] = head
            # persisted under the lock: two records' writes landing out of
            # order would let the stale one win and lose a count
            self._persist({"budget": self.budget,
                           "failures": dict(self._failures),
                           "quarantined": dict(self._quarantined)})
        if newly:
            logger.warning("quarantined %s after %d failure(s) (%s)", path,
                           n, head)
            self._publish(path, head)
        return newly

    def _publish(self, path: str, head: str) -> None:
        get_registry().counter(
            "pva_data_quarantined_total",
            "clips quarantined after exhausting the failure budget, "
            "by site", labelnames=("site",)).inc(site="decode")
        get_recorder().warn("clip quarantined", path=path, error=head)

    def _persist(self, payload: dict) -> None:
        if not self.sidecar_path:
            return
        try:
            os.makedirs(os.path.dirname(self.sidecar_path) or ".", exist_ok=True)
            atomic_write_json(self.sidecar_path, payload)
        except OSError as e:  # the sideline must not kill decode
            logger.warning("quarantine sidecar %s not written (%s)",
                           self.sidecar_path, e)


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
