"""Weight bridge between the JAX package's variable tree and the port.

The port names its submodules after the flax tree, so a state_dict key is
the flax path joined with "." and a leaf renamed:

    params/<path>/kernel (5-D, DHWIO)  -> <path>.weight (OIDHW)
    params/<path>/kernel (2-D, in,out) -> <path>.weight (out, in)
    params/<path>/scale                -> <path>.weight   (BatchNorm, LayerNorm)
    params/<path>/bias                 -> <path>.bias
    params/<path>/pos_embed            -> <path>.pos_embed (unchanged)
    params/<path>/mask_token           -> <path>.mask_token (unchanged)
    batch_stats/<path>/mean            -> <path>.running_mean
    batch_stats/<path>/var             -> <path>.running_var

`pos_embed` (MViT, (1, T, H, W, C)) and `mask_token` (VideoMAE
pretraining, (1, 1, dec_dim)) are free parameters of the model itself, so
at the top level their key is the bare name. The transformer trees carry
no batch_stats.

An int8 weight (serving/quantize.py) is the marker dict {"q8": int8,
"q8_scale": f32 (out,)} in both layouts: the flax kernel's leaves
`params/<path>/kernel/q8` and `.../q8_scale` (the JAX package's int8
artifact), the port's `<path>.weight` holding the same dict with the int8
array in the port's layout.

A JAX training state crosses too (`train_state_from_jax` and its inverse
`jax_train_state_from_port`): params and batch_stats as above, the optax
SGD momentum trace as each parameter's `momentum_buffer` (laid out like its
parameter), and the step counter.

Loading pytorchvideo hub checkpoints waits for the converter slice.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from pytorchvideo_accelerate_tpu_torch.serving.quantize import (
    Q_KEY,
    SCALE_KEY,
    is_quant_leaf,
)

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_INV = {v: k for k, v in _STATS.items()}
# free parameters, carried across with their name and layout unchanged
_FREE = ("pos_embed", "mask_token")


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
    quant: Dict[str, dict] = {}  # kernel stem -> its q8 / q8_scale leaves
    for key, arr in flatten_tree(tree).items():
        arr = np.asarray(arr)
        coll, *path, leaf = key.split("/")
        stem = ".".join(path)
        if coll == "params" and leaf in (Q_KEY, SCALE_KEY) and path[-1:] == ["kernel"]:
            quant.setdefault(".".join(path[:-1]), {})[leaf] = arr
        elif coll == "batch_stats":
            if leaf not in _STATS:
                raise KeyError(f"unmapped batch_stats leaf {key!r}")
            out[f"{stem}.{_STATS[leaf]}"] = arr
        elif coll == "params":
            name, v = _param_leaf_to_port(stem, leaf, arr)
            out[name] = v
        else:
            raise KeyError(f"unknown collection in {key!r}")
    for stem, leaves in quant.items():
        name, q = _param_leaf_to_port(stem, "kernel", leaves[Q_KEY])
        out[name] = {Q_KEY: q, SCALE_KEY: leaves[SCALE_KEY]}
    return out


def jax_tree_from_state_dict(state_dict: Mapping) -> dict:
    """Inverse of `state_dict_from_jax`: the port's state_dict (tensors or
    arrays) -> nested {"params": ..., "batch_stats": ...} numpy tree."""
    flat = {}
    for key, v in state_dict.items():
        *stem, leaf = key.split(".")
        path = "/".join(stem)
        if is_quant_leaf(v):
            flat[f"params/{path}/kernel/{Q_KEY}"] = _kernel_layout(
                np.asarray(v[Q_KEY]))
            flat[f"params/{path}/kernel/{SCALE_KEY}"] = np.asarray(v[SCALE_KEY])
            continue
        arr = (v.detach().cpu().numpy() if hasattr(v, "detach")
               else np.asarray(v))
        if leaf in _FREE:
            flat["/".join(["params"] + stem + [leaf])] = arr
        elif leaf in _STATS_INV:
            flat[f"batch_stats/{path}/{_STATS_INV[leaf]}"] = arr
        elif leaf == "weight" and arr.ndim in (2, 5):
            flat[f"params/{path}/kernel"] = _kernel_layout(arr)
        elif leaf == "weight" and arr.ndim == 1:
            flat[f"params/{path}/scale"] = arr
        elif leaf == "bias":
            flat[f"params/{path}/bias"] = arr
        else:
            raise KeyError(f"unmapped state_dict key {key!r}")
    return unflatten_tree(flat)


def _kernel_layout(arr: np.ndarray) -> np.ndarray:
    """A port conv or Linear weight in the flax kernel layout: OIDHW ->
    DHWIO, (out, in) -> (in, out)."""
    if arr.ndim == 5:
        return np.ascontiguousarray(arr.transpose(2, 3, 4, 1, 0))
    return np.ascontiguousarray(arr.T)


def _param_leaf_to_port(path: str, leaf: str, arr: np.ndarray):
    """(state_dict key, array) of one flax `params` leaf."""
    if leaf in _FREE:
        return f"{path}.{leaf}" if path else leaf, arr
    if leaf == "kernel" and arr.ndim == 5:      # DHWIO -> OIDHW
        return f"{path}.weight", np.ascontiguousarray(arr.transpose(4, 3, 0, 1, 2))
    if leaf == "kernel" and arr.ndim == 2:      # (in, out) -> (out, in)
        return f"{path}.weight", np.ascontiguousarray(arr.T)
    if leaf == "scale":
        return f"{path}.weight", arr
    if leaf == "bias":
        return f"{path}.bias", arr
    raise KeyError(f"unmapped params leaf {path}/{leaf}")


def train_state_from_jax(params: Mapping, batch_stats: Mapping, step: int,
                         momentum: Mapping = None) -> dict:
    """A JAX TrainState's pieces (numpy trees: params, batch_stats, and the
    optax SGD `trace` tree mirroring params) -> {"model": state_dict,
    "momentum": {param name: buffer}, "step": int}; `load_train_state`
    puts it into a port TrainState."""
    model = state_dict_from_jax({"params": params, "batch_stats": batch_stats})
    buffers = {}
    for key, arr in flatten_tree(momentum or {}).items():
        *path, leaf = key.split("/")
        name, v = _param_leaf_to_port(".".join(path), leaf, np.asarray(arr))
        buffers[name] = v
    return {"model": model, "momentum": buffers, "step": int(step)}


def load_train_state(state, converted: dict) -> None:
    """Load `train_state_from_jax`'s output into a port TrainState (SGD):
    weights, BN running averages, momentum buffers and the step."""
    import torch

    model = state.model
    device = next(model.parameters()).device
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in converted["model"].items()})
    named = dict(model.named_parameters())
    opt = state.optimizer.opt
    for name, buf in converted["momentum"].items():
        opt.state[named[name]]["momentum_buffer"] = torch.as_tensor(
            np.ascontiguousarray(buf)).to(device)
    state.step = int(converted["step"])


def jax_train_state_from_port(state) -> dict:
    """Inverse of `train_state_from_jax` + `load_train_state`: a port
    TrainState (SGD) -> {"params", "batch_stats", "momentum", "step"} numpy
    trees in the flax layout (momentum zeros where no buffer exists yet, as
    optax's trace starts)."""
    tree = jax_tree_from_state_dict(state.model.state_dict())
    opt = state.optimizer.opt
    buffers = {}
    for name, p in state.model.named_parameters():
        buf = opt.state.get(p, {}).get("momentum_buffer")
        buffers[name] = (buf if buf is not None else p.detach() * 0)
    momentum = jax_tree_from_state_dict(buffers)["params"]
    return {"params": tree["params"], "batch_stats": tree["batch_stats"],
            "momentum": momentum, "step": int(state.step)}
