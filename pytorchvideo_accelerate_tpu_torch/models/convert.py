"""Weight bridge between the JAX package's variable tree and the port.

The port names its submodules after the flax tree, so a state_dict key is
the flax path joined with "." and a leaf renamed:

    params/<path>/kernel (5-D, DHWIO)  -> <path>.weight (OIDHW)
    params/<path>/kernel (2-D, in,out) -> <path>.weight (out, in)
    params/<path>/scale                -> <path>.weight   (BatchNorm)
    params/<path>/bias                 -> <path>.bias
    batch_stats/<path>/mean            -> <path>.running_mean
    batch_stats/<path>/var             -> <path>.running_var

Loading pytorchvideo hub checkpoints waits for the converter slice.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_INV = {v: k for k, v in _STATS.items()}


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested {"params": {...}, "batch_stats": {...}} -> {"params/a/b/kernel":
    leaf}; an already flat mapping passes through."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = v
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree.setdefault(parts[0], {})
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """JAX variable tree (nested, or flat "params/..." keys as in an
    inference artifact's weights.npz) -> the port's state_dict as numpy."""
    out = {}
    for key, arr in flatten_tree(tree).items():
        arr = np.asarray(arr)
        coll, *path, leaf = key.split("/")
        stem = ".".join(path)
        if coll == "batch_stats":
            if leaf not in _STATS:
                raise KeyError(f"unmapped batch_stats leaf {key!r}")
            out[f"{stem}.{_STATS[leaf]}"] = arr
        elif coll == "params":
            if leaf == "kernel" and arr.ndim == 5:      # DHWIO -> OIDHW
                out[f"{stem}.weight"] = np.ascontiguousarray(
                    arr.transpose(4, 3, 0, 1, 2))
            elif leaf == "kernel" and arr.ndim == 2:    # (in, out) -> (out, in)
                out[f"{stem}.weight"] = np.ascontiguousarray(arr.T)
            elif leaf == "scale":
                out[f"{stem}.weight"] = arr
            elif leaf == "bias":
                out[f"{stem}.bias"] = arr
            else:
                raise KeyError(f"unmapped params leaf {key!r}")
        else:
            raise KeyError(f"unknown collection in {key!r}")
    return out


def jax_tree_from_state_dict(state_dict: Mapping) -> dict:
    """Inverse of `state_dict_from_jax`: the port's state_dict (tensors or
    arrays) -> nested {"params": ..., "batch_stats": ...} numpy tree."""
    flat = {}
    for key, v in state_dict.items():
        arr = (v.detach().cpu().numpy() if hasattr(v, "detach")
               else np.asarray(v))
        stem, leaf = key.rsplit(".", 1)
        path = stem.replace(".", "/")
        if leaf in _STATS_INV:
            flat[f"batch_stats/{path}/{_STATS_INV[leaf]}"] = arr
        elif leaf == "weight" and arr.ndim == 5:        # OIDHW -> DHWIO
            flat[f"params/{path}/kernel"] = np.ascontiguousarray(
                arr.transpose(2, 3, 4, 1, 0))
        elif leaf == "weight" and arr.ndim == 2:
            flat[f"params/{path}/kernel"] = np.ascontiguousarray(arr.T)
        elif leaf == "weight" and arr.ndim == 1:
            flat[f"params/{path}/scale"] = arr
        elif leaf == "bias":
            flat[f"params/{path}/bias"] = arr
        else:
            raise KeyError(f"unmapped state_dict key {key!r}")
    return unflatten_tree(flat)
