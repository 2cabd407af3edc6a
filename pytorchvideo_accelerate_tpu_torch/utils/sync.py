"""Creation point for the locks of the port's telemetry classes (the
port's copy of `make_lock` and `shared_state` from the JAX package's
`utils/sync.py`).

The JAX package routes every lock through one factory so that its dynamic
race sanitizer can wrap them; the port has no sanitizer, so `make_lock`
returns a plain `threading.Lock` and `shared_state` only records, as class
metadata, which instance attributes other threads touch. Keeping both
keeps the obs modules line for line with the JAX package's.

Stdlib only: the obs modules import this from worker threads.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


def make_lock(name: str = "lock"):
    """A mutex; `name` names the lock's class (one name per call site)."""
    del name
    return threading.Lock()


def shared_state(*fields: str, benign: Optional[Dict[str, str]] = None):
    """Class decorator: declare which instance attributes are cross-thread
    shared mutable state (`benign`: field -> why a race on it is
    accepted). Import-time metadata only."""

    def deco(cls: type) -> type:
        cls.__pva_shared_fields__ = frozenset(fields)
        cls.__pva_benign_fields__ = dict(benign or {})
        return cls

    return deco
