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

Pretrained weights (the counterpart of the JAX package's converter, the
same maps and the same artifact): a pytorchvideo torch-hub checkpoint
(SlowFast, Slow, C2D, CSN, R(2+1)D, X3D, MViT) or a transformers VideoMAE
one is converted once, offline, into a flat `.npz` of flax paths
(`convert_state_dict`, `save_converted`; the `pva-torch-convert` CLI,
`main`), which either package loads; `load_pretrained` merges such an
artifact, or a `.pt/.pth/.bin/.safetensors` checkpoint converted on the
fly, into a port model. The route of a tensor is hub key -> flax path
(the JAX package's maps, ported here) -> port key (`_param_leaf_to_port`):
the OIDHW -> DHWIO -> OIDHW transposes cancel exactly. `.safetensors`
files are read by this module itself (`read_safetensors`: no
`safetensors` package), bf16 widened to f32 exactly.
`export_checkpoint_params` writes a port training checkpoint's params and
BN statistics (never the optimizer) as such an artifact: the MAE pretrain
-> fine-tune handoff.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Mapping, Optional, Tuple

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
        if is_quant_leaf(v):
            path = "/".join(key.split(".")[:-1])
            flat[f"params/{path}/kernel/{Q_KEY}"] = _kernel_layout(
                np.asarray(v[Q_KEY]))
            flat[f"params/{path}/kernel/{SCALE_KEY}"] = np.asarray(v[SCALE_KEY])
            continue
        arr = (v.detach().cpu().numpy() if hasattr(v, "detach")
               else np.asarray(v))
        name = flax_key(key, arr.ndim)
        flat[name] = _kernel_layout(arr) if name.endswith("/kernel") else arr
    return unflatten_tree(flat)


def flax_key(key: str, ndim: int) -> str:
    """The flat flax key ("params/a/b/kernel") of the port's state_dict key
    `key` holding a tensor of `ndim` dimensions."""
    *stem, leaf = key.split(".")
    path = "/".join(stem)
    if leaf in _FREE:
        return "/".join(["params"] + stem + [leaf])
    if leaf in _STATS_INV:
        return f"batch_stats/{path}/{_STATS_INV[leaf]}"
    if leaf == "weight" and ndim in (2, 5):
        return f"params/{path}/kernel"
    if leaf == "weight" and ndim == 1:
        return f"params/{path}/scale"
    if leaf == "bias":
        return f"params/{path}/bias"
    raise KeyError(f"unmapped state_dict key {key!r}")


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


# --- pytorchvideo / transformers hub checkpoints -> the flax tree ------------
#
# The JAX package's maps (its models/convert.py), numpy only. Layout rules:
# conv3d weight (O, I, kD, kH, kW) -> flax DHWIO kernel; linear weight
# (O, I) -> (I, O); BatchNorm weight/bias -> params .../norm/{scale,bias},
# running_mean/running_var -> batch_stats .../norm/{mean,var}. Names follow
# pytorchvideo's `create_resnet` / `create_slowfast` trees: `blocks.0` stem,
# `blocks.1-4` stages of `res_blocks` (branch1 projection + branch2
# conv_a/b/c bottleneck), the head `proj` at `blocks.5` (SlowFast:
# `blocks.6`); SlowFast wraps each level in `multipathway_blocks.{0,1}`
# (slow, fast) with the lateral `multipathway_fusion.conv_fast_to_slow`
# after stem/res2/res3/res4. tests/hub_manifests.py restates every hub
# checkpoint's keys and shapes independently of these maps.

Path = Tuple[str, ...]

_BRANCH2 = {"conv_a": "conv_a", "conv_b": "conv_b", "conv_c": "conv_c"}
_NORM2 = {"norm_a": "conv_a", "norm_b": "conv_b", "norm_c": "conv_c"}
_BN_PARAM = {"weight": "scale", "bias": "bias"}
_BN_STAT = _STATS_INV


def _map_block_member(rest: str) -> Optional[Tuple[str, Path]]:
    """Map the part of a torch key inside one res block / stem / fusion.

    Returns (collection, path-suffix) where collection is "params" or
    "batch_stats", or None for ignorable keys (num_batches_tracked)."""
    parts = rest.split(".")
    # stem / fusion level: conv.weight, norm.weight, ...
    if parts[0] == "conv" and parts[1] == "weight":
        return "params", ("conv", "kernel")
    if parts[0] == "norm":
        if parts[1] in _BN_PARAM:
            return "params", ("norm", _BN_PARAM[parts[1]])
        if parts[1] in _BN_STAT:
            return "batch_stats", ("norm", _BN_STAT[parts[1]])
        return None
    # res block level
    if parts[0] == "branch1_conv" and parts[1] == "weight":
        return "params", ("branch1", "conv", "kernel")
    if parts[0] == "branch1_norm":
        if parts[1] in _BN_PARAM:
            return "params", ("branch1", "norm", _BN_PARAM[parts[1]])
        if parts[1] in _BN_STAT:
            return "batch_stats", ("branch1", "norm", _BN_STAT[parts[1]])
        return None
    if parts[0] == "branch2":
        sub = parts[1]
        if sub in _BRANCH2 and parts[2] == "weight":
            return "params", (_BRANCH2[sub], "conv", "kernel")
        if sub in _NORM2:
            if parts[2] in _BN_PARAM:
                return "params", (_NORM2[sub], "norm", _BN_PARAM[parts[2]])
            if parts[2] in _BN_STAT:
                return "batch_stats", (_NORM2[sub], "norm", _BN_STAT[parts[2]])
    return None


def map_torch_key(key: str, model: str) -> Optional[Tuple[str, Path]]:
    """torch state_dict key -> ("params"|"batch_stats", flax path) or None."""
    if key.endswith("num_batches_tracked"):
        return None
    if model.startswith("x3d"):
        return map_x3d_key(key)
    if model.startswith("r2plus1d"):
        return map_r2plus1d_key(key)
    slowfast = model.startswith("slowfast")

    m = re.match(r"blocks\.(\d+)\.(.*)", key)
    if not m:
        return None
    idx, rest = int(m.group(1)), m.group(2)

    # head (blocks.5): proj linear
    pm = re.match(r"proj\.(weight|bias)", rest)
    if pm:
        return "params", ("head", "proj",
                          "kernel" if pm.group(1) == "weight" else "bias")

    if slowfast:
        m2 = re.match(r"multipathway_blocks\.([01])\.(.*)", rest)
        if m2:
            pathway = "slow" if m2.group(1) == "0" else "fast"
            inner = m2.group(2)
            if idx == 0:  # stem
                mapped = _map_block_member(inner)
                if mapped is None:
                    return None
                coll, suffix = mapped
                return coll, (f"{pathway}_stem",) + suffix
            m3 = re.match(r"res_blocks\.(\d+)\.(.*)", inner)
            if m3:
                mapped = _map_block_member(m3.group(2))
                if mapped is None:
                    return None
                coll, suffix = mapped
                return coll, (f"{pathway}_res{idx + 1}", f"block{m3.group(1)}") + suffix
            return None
        m2 = re.match(r"multipathway_fusion\.(.*)", rest)
        if m2:
            inner = m2.group(1)
            prefix = "fuse_stem" if idx == 0 else f"fuse_res{idx + 1}"
            fm = re.match(r"conv_fast_to_slow\.weight", inner)
            if fm:
                return "params", (prefix, "conv_f2s", "conv", "kernel")
            nm = re.match(r"norm\.(\w+)", inner)
            if nm:
                if nm.group(1) in _BN_PARAM:
                    return "params", (prefix, "conv_f2s", "norm", _BN_PARAM[nm.group(1)])
                if nm.group(1) in _BN_STAT:
                    return "batch_stats", (prefix, "conv_f2s", "norm", _BN_STAT[nm.group(1)])
            return None
        return None

    # single-pathway resnet (slow_r50 / x3d-style trees share the skeleton)
    if idx == 0:
        mapped = _map_block_member(rest)
        if mapped is None:
            return None
        coll, suffix = mapped
        return coll, ("stem",) + suffix
    m3 = re.match(r"res_blocks\.(\d+)\.(.*)", rest)
    if m3:
        mapped = _map_block_member(m3.group(2))
        if mapped is None:
            return None
        coll, suffix = mapped
        return coll, (f"res{idx + 1}", f"block{m3.group(1)}") + suffix
    return None


def torch_key_for(collection: str, path: Path, model: str) -> Optional[str]:
    """Inverse of `map_torch_key` — flax path -> torch key (used by tests as
    an independent spec and by weight export)."""
    if model.startswith("x3d"):
        return x3d_torch_key_for(collection, path)
    if model.startswith("r2plus1d"):
        return r2plus1d_torch_key_for(collection, path)
    slowfast = model.startswith("slowfast")
    head_block = 6 if slowfast else 5
    if path[0] == "head":
        return f"blocks.{head_block}.proj." + ("weight" if path[-1] == "kernel" else "bias")

    def member(suffix: Path, in_res_block: bool) -> Optional[str]:
        if suffix[0] == "conv":
            return "conv.weight"
        if suffix[0] == "norm":
            inv = {v: k for k, v in (_BN_PARAM if collection == "params"
                                     else _BN_STAT).items()}
            return f"norm.{inv[suffix[1]]}"
        if suffix[0] == "branch1":
            if suffix[1] == "conv":
                return "branch1_conv.weight"
            inv = {v: k for k, v in (_BN_PARAM if collection == "params"
                                     else _BN_STAT).items()}
            return f"branch1_norm.{inv[suffix[2]]}"
        if suffix[0] in ("conv_a", "conv_b", "conv_c"):
            letter = suffix[0][-1]
            if suffix[1] == "conv":
                return f"branch2.conv_{letter}.weight"
            inv = {v: k for k, v in (_BN_PARAM if collection == "params"
                                     else _BN_STAT).items()}
            return f"branch2.norm_{letter}.{inv[suffix[2]]}"
        return None

    if slowfast:
        m = re.match(r"(slow|fast)_(stem|res(\d))", path[0])
        if m:
            pw = 0 if m.group(1) == "slow" else 1
            if m.group(2) == "stem":
                inner = member(path[1:], False)
                return inner and f"blocks.0.multipathway_blocks.{pw}.{inner}"
            stage = int(m.group(3)) - 1
            blk = path[1].replace("block", "")
            inner = member(path[2:], True)
            return inner and (
                f"blocks.{stage}.multipathway_blocks.{pw}.res_blocks.{blk}.{inner}"
            )
        m = re.match(r"fuse_(stem|res(\d))", path[0])
        if m:
            idx = 0 if m.group(1) == "stem" else int(m.group(2)) - 1
            if path[2] == "conv":
                return f"blocks.{idx}.multipathway_fusion.conv_fast_to_slow.weight"
            inv = {v: k for k, v in (_BN_PARAM if collection == "params"
                                     else _BN_STAT).items()}
            return f"blocks.{idx}.multipathway_fusion.norm.{inv[path[3]]}"
        return None

    if path[0] == "stem":
        inner = member(path[1:], False)
        return inner and f"blocks.0.{inner}"
    m = re.match(r"res(\d)", path[0])
    if m:
        stage = int(m.group(1)) - 1
        blk = path[1].replace("block", "")
        inner = member(path[2:], True)
        return inner and f"blocks.{stage}.res_blocks.{blk}.{inner}"
    return None


# --- R(2+1)D (pytorchvideo create_r2plus1d tree) ----------------------------
#
# Same blocks.0 stem / blocks.1-4 res_blocks / blocks.5 head skeleton as
# slow_r50, except branch2.conv_b is a Conv2plus1d container with an inner
# norm: conv_b.conv_t (the 1x3x3 SPATIAL factor — same swapped slot naming
# as the X3D stem), conv_b.norm (+ inner ReLU, paramless), conv_b.conv_xy
# (the 3x1x1 temporal factor). branch2.norm_b then normalizes the temporal
# factor's output. Flax targets (models/r2plus1d.py Bottleneck2Plus1D):
# conv_b_s <- {conv_b.conv_t, conv_b.norm}, conv_b_t <- {conv_b.conv_xy,
# norm_b}. Full-depth key coverage in tests/hub_manifests.py.

_R2P1D_CONVB = {
    # torch member (incl. the branch2 level) -> (flax block member, is_norm)
    "branch2.conv_b.conv_t": ("conv_b_s", False),
    "branch2.conv_b.norm": ("conv_b_s", True),
    "branch2.conv_b.conv_xy": ("conv_b_t", False),
    "branch2.norm_b": ("conv_b_t", True),
}


def _map_r2p1d_block_member(rest: str) -> Optional[Tuple[str, Path]]:
    """Map inside one r2plus1d res block: Conv2plus1d members first, the
    shared stem/branch1/conv_a/conv_c skeleton via _map_block_member."""
    for tkey, (member, is_norm) in _R2P1D_CONVB.items():
        if rest.startswith(tkey + "."):
            leaf = rest[len(tkey) + 1:]
            if not is_norm:
                if leaf == "weight":
                    return "params", (member, "conv", "kernel")
                return None
            if leaf in _BN_PARAM:
                return "params", (member, "norm", _BN_PARAM[leaf])
            if leaf in _BN_STAT:
                return "batch_stats", (member, "norm", _BN_STAT[leaf])
            return None
    return _map_block_member(rest)


def map_r2plus1d_key(key: str) -> Optional[Tuple[str, Path]]:
    m = re.match(r"blocks\.(\d+)\.(.*)", key)
    if not m:
        return None
    idx, rest = int(m.group(1)), m.group(2)
    pm = re.match(r"proj\.(weight|bias)", rest)
    if pm:
        return "params", ("head", "proj",
                          "kernel" if pm.group(1) == "weight" else "bias")
    if idx == 0:
        mapped = _map_block_member(rest)
        if mapped is None:
            return None
        coll, suffix = mapped
        return coll, ("stem",) + suffix
    m3 = re.match(r"res_blocks\.(\d+)\.(.*)", rest)
    if m3:
        mapped = _map_r2p1d_block_member(m3.group(2))
        if mapped is None:
            return None
        coll, suffix = mapped
        return coll, (f"res{idx + 1}_block{m3.group(1)}",) + suffix
    return None


def r2plus1d_torch_key_for(collection: str, path: Path) -> Optional[str]:
    """Inverse of `map_r2plus1d_key` (independent spec for tests/export)."""
    inv_bn = {v: k for k, v in (_BN_PARAM if collection == "params"
                                else _BN_STAT).items()}
    if path[0] == "head":
        return "blocks.5.proj." + ("weight" if path[-1] == "kernel" else "bias")
    if path[0] == "stem":
        if path[1] == "conv":
            return "blocks.0.conv.weight"
        return f"blocks.0.norm.{inv_bn[path[2]]}"
    m = re.match(r"res(\d)_block(\d+)", path[0])
    if not m:
        return None
    prefix = f"blocks.{int(m.group(1)) - 1}.res_blocks.{m.group(2)}"
    member = path[1]
    if member == "branch1":
        if path[2] == "conv":
            return f"{prefix}.branch1_conv.weight"
        return f"{prefix}.branch1_norm.{inv_bn[path[3]]}"
    if member in ("conv_b_s", "conv_b_t"):
        for tkey, (fmember, is_norm) in _R2P1D_CONVB.items():
            if fmember == member and is_norm == (path[2] == "norm"):
                leaf = "weight" if path[2] == "conv" else inv_bn[path[3]]
                return f"{prefix}.{tkey}.{leaf}"
        return None
    if member in ("conv_a", "conv_c"):
        letter = member[-1]
        if path[2] == "conv":
            return f"{prefix}.branch2.conv_{letter}.weight"
        return f"{prefix}.branch2.norm_{letter}.{inv_bn[path[3]]}"
    return None


# --- X3D (pytorchvideo create_x3d tree) ------------------------------------
#
# Torch tree (pytorchvideo models/x3d.py):
# blocks.0 stem = Conv2plus1d where — a pytorchvideo quirk — the `conv_t`
# slot holds the 1xkxk *spatial* conv and `conv_xy` the kx1x1 depthwise
# temporal conv; blocks.1-4 stages of ResBlock(branch1_conv/branch1_norm,
# branch2=BottleneckBlock(conv_a/norm_a/conv_b/norm_b/conv_c/norm_c)) where
# norm_b is `Sequential(BN, SqueezeExcitation(fc1, fc2))` on SE blocks
# (keys norm_b.0.* / norm_b.1.fc{1,2}.*) and a plain BN otherwise; blocks.5
# head = ProjectedPool(pre_conv/pre_norm/post_conv) + proj linear.
# create_x3d_res_block quirk: branch1_conv exists on stride OR channel
# change but branch1_norm ONLY on channel change — stage-1 block 0 of the
# hub checkpoints (24->24, stride 2) is a bare shortcut conv (models/x3d.py
# mirrors this; full-depth key coverage in tests/hub_manifests.py).

_X3D_STEM = {"conv.conv_t": ("stem_xy", "kernel"),
             "conv.conv_xy": ("stem_t", "kernel")}


def _x3d_norm(prefix: Path, leaf: str) -> Optional[Tuple[str, Path]]:
    if leaf in _BN_PARAM:
        return "params", prefix + (_BN_PARAM[leaf],)
    if leaf in _BN_STAT:
        return "batch_stats", prefix + (_BN_STAT[leaf],)
    return None


def map_x3d_key(key: str) -> Optional[Tuple[str, Path]]:
    if key.endswith("num_batches_tracked"):
        return None
    m = re.match(r"blocks\.(\d+)\.(.*)", key)
    if not m:
        return None
    idx, rest = int(m.group(1)), m.group(2)

    if idx == 0:  # stem
        for torch_name, flax in _X3D_STEM.items():
            if rest == f"{torch_name}.weight":
                return "params", flax
        nm = re.match(r"norm\.(\w+)", rest)
        return _x3d_norm(("stem_norm",), nm.group(1)) if nm else None

    if idx == 5:  # head
        if rest == "pool.pre_conv.weight":
            return "params", ("conv5", "conv", "kernel")
        nm = re.match(r"pool\.pre_norm\.(\w+)", rest)
        if nm:
            return _x3d_norm(("conv5", "norm"), nm.group(1))
        if rest == "pool.post_conv.weight":
            return "params", ("head_conv", "kernel")
        pm = re.match(r"proj\.(weight|bias)", rest)
        if pm:
            return "params", ("proj",
                              "kernel" if pm.group(1) == "weight" else "bias")
        return None

    m3 = re.match(r"res_blocks\.(\d+)\.(.*)", rest)
    if not m3:
        return None
    block = (f"res{idx + 1}_block{m3.group(1)}",)
    inner = m3.group(2)
    if inner == "branch1_conv.weight":
        return "params", block + ("branch1", "conv", "kernel")
    nm = re.match(r"branch1_norm\.(\w+)", inner)
    if nm:
        return _x3d_norm(block + ("branch1", "norm"), nm.group(1))
    m4 = re.match(r"branch2\.(.*)", inner)
    if not m4:
        return None
    b2 = m4.group(1)
    for letter, tgt in (("a", ("conv_a", "conv")), ("c", ("conv_c", "conv"))):
        if b2 == f"conv_{letter}.weight":
            return "params", block + tgt + ("kernel",)
        nm = re.match(rf"norm_{letter}\.(\w+)", b2)
        if nm:
            return _x3d_norm(block + (tgt[0], "norm"), nm.group(1))
    if b2 == "conv_b.weight":
        return "params", block + ("conv_b", "kernel")
    # norm_b: plain BN, or Sequential(BN, SE) on SE blocks
    nm = re.match(r"norm_b\.(?:0\.)?(\w+)$", b2)
    if nm and (nm.group(1) in _BN_PARAM or nm.group(1) in _BN_STAT):
        return _x3d_norm(block + ("norm_b",), nm.group(1))
    sm = re.match(r"norm_b\.1\.(fc[12])\.(weight|bias)", b2)
    if sm:
        return "params", block + ("se", sm.group(1),
                                  "kernel" if sm.group(2) == "weight" else "bias")
    return None


def x3d_torch_key_for(collection: str, path: Path) -> Optional[str]:
    """Inverse of `map_x3d_key` (independent spec for tests + export)."""
    inv_bn = {v: k for k, v in (_BN_PARAM if collection == "params"
                                else _BN_STAT).items()}
    if path[0] == "stem_xy":
        return "blocks.0.conv.conv_t.weight"
    if path[0] == "stem_t":
        return "blocks.0.conv.conv_xy.weight"
    if path[0] == "stem_norm":
        return f"blocks.0.norm.{inv_bn[path[1]]}"
    if path[0] == "conv5":
        if path[1] == "conv":
            return "blocks.5.pool.pre_conv.weight"
        return f"blocks.5.pool.pre_norm.{inv_bn[path[2]]}"
    if path[0] == "head_conv":
        return "blocks.5.pool.post_conv.weight"
    if path[0] == "proj":
        return "blocks.5.proj." + ("weight" if path[1] == "kernel" else "bias")
    m = re.match(r"res(\d)_block(\d+)", path[0])
    if not m:
        return None
    prefix = f"blocks.{int(m.group(1)) - 1}.res_blocks.{m.group(2)}"
    rest = path[1:]
    if rest[0] == "branch1":
        if rest[1] == "conv":
            return f"{prefix}.branch1_conv.weight"
        return f"{prefix}.branch1_norm.{inv_bn[rest[2]]}"
    if rest[0] in ("conv_a", "conv_c"):
        letter = rest[0][-1]
        if rest[1] == "conv":
            return f"{prefix}.branch2.conv_{letter}.weight"
        return f"{prefix}.branch2.norm_{letter}.{inv_bn[rest[2]]}"
    if rest[0] == "conv_b":
        return f"{prefix}.branch2.conv_b.weight"
    if rest[0] == "norm_b":
        # SE blocks nest the BN at norm_b.0; either key converts back
        return f"{prefix}.branch2.norm_b.0.{inv_bn[rest[1]]}"
    if rest[0] == "se":
        return (f"{prefix}.branch2.norm_b.1.{rest[1]}."
                + ("weight" if rest[2] == "kernel" else "bias"))
    return None


# --- MViT (pytorchvideo create_multiscale_vision_transformers tree) ---------
#
# Torch tree (pytorchvideo models/vision_transformers.py + layers/attention.py):
# patch_embed.patch_model conv; cls_positional_encoding with *separable*
# pos embeds (pos_embed_spatial (1,HW,C) + pos_embed_temporal (1,T,C) +
# pos_embed_class); blocks.i = MultiScaleBlock(norm1, attn(qkv, pool_q/
# norm_q, pool_k/norm_k, pool_v/norm_v, proj), norm2, mlp.fc1/fc2, proj on
# dim-change blocks); final norm; head.proj. pool_q exists only at
# stage-start (q-stride) blocks, but pool_k/pool_v exist at EVERY block —
# the 3^3 pool_kvq_kernel applies globally once adaptive kv striding is
# configured, stride-1 last-stage blocks included (models/mvit.py;
# full-depth key coverage in tests/hub_manifests.py).
#
# Documented deviations of the MViT (models/mvit.py) from the torch tree and how
# conversion handles them:
# - joint pos embed (1,T,H,W,C), no CLS token: the separable tables ARE an
#   outer sum, so the joint table is synthesized exactly as
#   temporal[:,:,None,:] + spatial[:,None,hw,:]; pos_embed_class is dropped
#   (no CLS in this architecture — the head mean-pools).
# - per-head pooling as ONE depthwise conv over heads*head_dim channels:
#   torch applies the SAME (head_dim,1,3,3,3) depthwise kernel to every
#   head, so tiling it `heads` times across channels is exact. The pooling
#   LayerNorm keeps torch's (head_dim,) parameters verbatim — PoolHeads
#   normalizes each head's slice with the shared params (models/mvit.py), so the
#   converted function is exact, no tiling and no approximation.
# - the flax MViT follows torch's block schedule exactly (dim change in the
#   MLP before each stage start; see models/mvit.py MViTBlock), so qkv/proj/MLP/
#   skip-proj shapes line up at every block including stage transitions.

_MVIT_DIRECT = {
    "norm1": ("norm1", {"weight": "scale", "bias": "bias"}),
    "norm2": ("norm2", {"weight": "scale", "bias": "bias"}),
    "attn.qkv": ("attn/qkv", {"weight": "kernel", "bias": "bias"}),
    "attn.proj": ("attn/proj", {"weight": "kernel", "bias": "bias"}),
    "mlp.fc1": ("mlp_fc1", {"weight": "kernel", "bias": "bias"}),
    "mlp.fc2": ("mlp_fc2", {"weight": "kernel", "bias": "bias"}),
    "proj": ("skip_proj", {"weight": "kernel", "bias": "bias"}),
}
_MVIT_POOL = {"pool_q": "pool_q", "pool_k": "pool_k", "pool_v": "pool_v",
              "norm_q": "pool_q", "norm_k": "pool_k", "norm_v": "pool_v"}


def convert_mvit_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """MViT torch state_dict -> flax tree (cross-key: pos-embed synthesis and
    per-head tiling need more than one tensor, hence no per-key map fn)."""
    out: dict = {"params": {}, "batch_stats": {}, "skipped": []}

    # per-block head counts, from qkv dim / pool head_dim
    heads: Dict[int, int] = {}
    for key, value in sd.items():
        m = re.match(r"blocks\.(\d+)\.attn\.pool_[qkv]\.weight", key)
        if m:
            i = int(m.group(1))
            qkv = sd.get(f"blocks.{i}.attn.qkv.weight")
            if qkv is not None:
                heads[i] = max(np.shape(qkv)[0] // 3 // np.shape(value)[0], 1)

    spatial = sd.get("cls_positional_encoding.pos_embed_spatial")
    temporal = sd.get("cls_positional_encoding.pos_embed_temporal")
    if spatial is not None and temporal is not None:
        s, t = np.asarray(spatial), np.asarray(temporal)
        hw, c = s.shape[1], s.shape[2]
        h = int(round(float(np.sqrt(hw))))
        if h * h == hw:
            joint = (t[:, :, None, :] + s[:, None, :, :].reshape(1, 1, hw, c))
            joint = joint.reshape(1, t.shape[1], h, h, c)
            _set_path(out["params"], ("pos_embed",), joint.astype(np.float32))
        else:
            out["skipped"].append("cls_positional_encoding.pos_embed_spatial "
                                  "(non-square grid)")

    for key, value in sd.items():
        arr = np.asarray(value)
        if key.startswith("cls_positional_encoding."):
            if (key.endswith("pos_embed_class") or key.endswith("cls_token")
                    or spatial is not None):
                continue  # consumed above / no CLS token in this arch
            out["skipped"].append(key)
            continue
        if key == "patch_embed.patch_model.weight":
            _set_path(out["params"], ("patch_embed", "kernel"),
                      np.transpose(arr, (2, 3, 4, 1, 0)))
            continue
        if key == "patch_embed.patch_model.bias":
            _set_path(out["params"], ("patch_embed", "bias"), arr)
            continue
        if key in ("norm.weight", "norm.bias"):
            _set_path(out["params"],
                      ("norm", "scale" if key.endswith("weight") else "bias"), arr)
            continue
        m = re.match(r"head\.proj\.(weight|bias)", key)
        if m:
            _set_path(out["params"],
                      ("head", "kernel" if m.group(1) == "weight" else "bias"),
                      convert_tensor(("head", "kernel"), arr)
                      if m.group(1) == "weight" else arr)
            continue
        m = re.match(r"blocks\.(\d+)\.(.*)", key)
        if not m:
            out["skipped"].append(key)
            continue
        i, rest = int(m.group(1)), m.group(2)
        block = f"block{i}"
        pm = re.match(r"attn\.(pool_[qkv]|norm_[qkv])\.(\w+)", rest)
        if pm:
            name, leaf = pm.group(1), pm.group(2)
            n_heads = heads.get(i, 1)
            flax_pool = _MVIT_POOL[name]
            if name.startswith("pool") and leaf == "weight":
                # (head_dim,1,3,3,3) depthwise -> (3,3,3,1,heads*head_dim)
                k = np.transpose(arr, (2, 3, 4, 1, 0))
                _set_path(out["params"],
                          (block, "attn", flax_pool, "pool", "kernel"),
                          np.tile(k, (1, 1, 1, 1, n_heads)))
            elif name.startswith("norm") and leaf in ("weight", "bias"):
                _set_path(out["params"],
                          (block, "attn", flax_pool, "norm",
                           "scale" if leaf == "weight" else "bias"), arr)
            else:
                out["skipped"].append(key)
            continue
        for torch_name, (flax_name, leaf_map) in _MVIT_DIRECT.items():
            m2 = re.match(rf"{re.escape(torch_name)}\.(weight|bias)$", rest)
            if m2:
                leaf = leaf_map[m2.group(1)]
                path = (block,) + tuple(flax_name.split("/")) + (leaf,)
                _set_path(out["params"], path, convert_tensor(path, arr))
                break
        else:
            out["skipped"].append(key)
    return out


# --- VideoMAE (HF transformers VideoMAE* tree) ------------------------------
#
# Torch tree (transformers models/videomae/modeling_videomae.py):
# [videomae.]embeddings.patch_embeddings.projection Conv3d;
# [videomae.]encoder.layer.i = attention.attention.{query,key,value}.weight
# (bias=False) + separate q_bias/v_bias params (k bias is zero by
# construction), attention.output.dense, intermediate.dense, output.dense,
# layernorm_before/after; [videomae.]layernorm (only when
# use_mean_pooling=False); classification head = fc_norm + classifier;
# pretraining adds encoder_to_decoder (no bias), mask_token,
# decoder.decoder_layers.i (same layer tree), decoder.norm, decoder.head.
# Position embeddings are fixed sin-cos tensors (not in the state_dict) —
# videomae.sincos_pos_embed reproduces the exact table.
#
# The flax tree (models/videomae.py): encoder/patch_embed/proj,
# encoder/block{i}/{norm1,qkv,proj,norm2,mlp_fc1,mlp_fc2}, encoder/norm,
# fc_norm + head (classifier), enc_to_dec + mask_token + dec_block{i} +
# dec_norm + dec_pred (pretraining). The q/k/v linears fuse into one qkv
# kernel; the qkv bias is [q_bias, zeros, v_bias].

_HF_VIT_LAYER = {
    "layernorm_before": "norm1",
    "layernorm_after": "norm2",
    "attention.output.dense": "proj",
    "intermediate.dense": "mlp_fc1",
    "output.dense": "mlp_fc2",
}
_HF_VIDEOMAE_TOP = {
    "embeddings.patch_embeddings.projection.weight":
        ("encoder", "patch_embed", "proj", "kernel"),
    "embeddings.patch_embeddings.projection.bias":
        ("encoder", "patch_embed", "proj", "bias"),
    "layernorm.weight": ("encoder", "norm", "scale"),
    "layernorm.bias": ("encoder", "norm", "bias"),
    "fc_norm.weight": ("fc_norm", "scale"),
    "fc_norm.bias": ("fc_norm", "bias"),
    "classifier.weight": ("head", "kernel"),
    "classifier.bias": ("head", "bias"),
    "encoder_to_decoder.weight": ("enc_to_dec", "kernel"),
    "mask_token": ("mask_token",),
    "decoder.norm.weight": ("dec_norm", "scale"),
    "decoder.norm.bias": ("dec_norm", "bias"),
    "decoder.head.weight": ("dec_pred", "kernel"),
    "decoder.head.bias": ("dec_pred", "bias"),
}


def convert_videomae_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """HF VideoMAE{Model,ForVideoClassification,ForPreTraining} state_dict ->
    flax tree for videomae.py's models (cross-key: q/k/v fuse into one qkv)."""
    out: dict = {"params": {}, "batch_stats": {}, "skipped": []}
    plain = {}
    for k, v in sd.items():
        plain[k[len("videomae."):] if k.startswith("videomae.") else k] = \
            np.asarray(v)

    def layer_target(key):
        m = re.match(r"encoder\.layer\.(\d+)\.(.*)", key)
        if m:
            return ("encoder", f"block{m.group(1)}"), m.group(2)
        m = re.match(r"decoder\.decoder_layers\.(\d+)\.(.*)", key)
        if m:
            return (f"dec_block{m.group(1)}",), m.group(2)
        return None, None

    layers: Dict[Path, Dict[str, np.ndarray]] = {}
    for key, arr in plain.items():
        block, rest = layer_target(key)
        if block is not None:
            layers.setdefault(block, {})[rest] = arr
            continue
        if key in _HF_VIDEOMAE_TOP:
            path = _HF_VIDEOMAE_TOP[key]
            _set_path(out["params"], path, convert_tensor(path, arr))
        else:
            out["skipped"].append(key)

    # use_mean_pooling=False classifiers read the CLS-position token
    # (sequence_output[:, 0]) instead of mean-pool + fc_norm; our
    # VideoMAEClassifier can't represent that readout, so flag it loudly
    # rather than convert to a silently different function.
    if "classifier.weight" in plain and "fc_norm.weight" not in plain:
        out["skipped"].append(
            "(!) classifier without fc_norm (use_mean_pooling=False): "
            "token-0 readout is not representable by VideoMAEClassifier's "
            "mean-pool head — fc_norm stays fresh-initialized"
        )

    for block, members in layers.items():
        qw = members.pop("attention.attention.query.weight", None)
        kw = members.pop("attention.attention.key.weight", None)
        vw = members.pop("attention.attention.value.weight", None)
        if qw is not None and kw is not None and vw is not None:
            _set_path(out["params"], block + ("qkv", "kernel"),
                      np.concatenate([w.T for w in (qw, kw, vw)], axis=1))
        elif any(w is not None for w in (qw, kw, vw)):  # partial q/k/v: report,
            for name, w in (("query.weight", qw), ("key.weight", kw),
                            ("value.weight", vw)):  # don't silently drop
                if w is not None:
                    out["skipped"].append(
                        "/".join(block) + ".attention.attention." + name)
        qb = members.pop("attention.attention.q_bias", None)
        vb = members.pop("attention.attention.v_bias", None)
        if qb is not None and vb is not None:
            _set_path(out["params"], block + ("qkv", "bias"),
                      np.concatenate([qb, np.zeros_like(qb), vb]))
        elif any(b is not None for b in (qb, vb)):
            for name, b in (("q_bias", qb), ("v_bias", vb)):
                if b is not None:
                    out["skipped"].append(
                        "/".join(block) + ".attention.attention." + name)
        for rest, arr in members.items():
            for torch_name, flax_name in _HF_VIT_LAYER.items():
                m = re.match(rf"{re.escape(torch_name)}\.(weight|bias)$", rest)
                if m:
                    leaf = ("kernel" if m.group(1) == "weight" else "bias") \
                        if "dense" in torch_name else \
                        ("scale" if m.group(1) == "weight" else "bias")
                    path = block + (flax_name, leaf)
                    _set_path(out["params"], path, convert_tensor(path, arr))
                    break
            else:
                out["skipped"].append("/".join(block) + "." + rest)
    return out


def convert_tensor(path: Path, arr: np.ndarray) -> np.ndarray:
    """Apply the torch->flax layout transpose for one tensor."""
    if path[-1] == "kernel":
        if arr.ndim == 5:      # conv3d OIDHW -> DHWIO
            return np.transpose(arr, (2, 3, 4, 1, 0))
        if arr.ndim == 2:      # linear (O, I) -> (I, O)
            return np.transpose(arr, (1, 0))
    return arr


def export_tensor(path: Path, arr: np.ndarray) -> np.ndarray:
    """Inverse of `convert_tensor` (flax -> torch layout)."""
    if path[-1] == "kernel":
        if arr.ndim == 5:      # DHWIO -> OIDHW
            return np.transpose(arr, (4, 3, 0, 1, 2))
        if arr.ndim == 2:
            return np.transpose(arr, (1, 0))
    return arr


def _set_path(tree: dict, path: Path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


# --- checkpoint files ---------------------------------------------------------

_TORCH_FILES = (".pt", ".pth", ".bin", ".safetensors")
# safetensors dtype tags -> numpy (the format is little-endian); BF16 is
# widened to float32 apart
_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
                       "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1",
                       "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A `.safetensors` file -> {name: np.ndarray}, bf16 as float32 (exact:
    the bf16 bits are the high half of the float32's).

    The format: an 8-byte little-endian header length N, N bytes of JSON
    ({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
    "__metadata__"}), then the tensors' raw bytes, offsets relative to the
    end of the header."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its "
                         "header length)")
    (n,) = struct.unpack("<Q", blob[:8])
    if 8 + n > len(blob):
        raise ValueError(f"{path}: header length {n} runs past the end of "
                         f"the file ({len(blob)} bytes)")
    header = json.loads(blob[8:8 + n])
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(int(d) for d in info["shape"])
        tag = info["dtype"]
        if tag == "BF16":
            dtype = np.dtype("<u2")
        elif tag in _SAFETENSORS_DTYPES:
            dtype = np.dtype(_SAFETENSORS_DTYPES[tag])
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {tag}, which "
                             "this reader does not convert")
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= len(data) or end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"[{begin}, {end}) for {shape} {tag} in "
                             f"{len(data)} bytes of data")
        arr = np.frombuffer(data[begin:end], dtype=dtype).reshape(shape)
        if tag == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.astype(arr.dtype.newbyteorder("="), copy=True)
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a checkpoint file into {key: np.ndarray}: `.safetensors` by
    `read_safetensors`, `.pt/.pth/.bin` by `torch.load` (tensors only);
    the wrappers `model_state` and `state_dict` are unwrapped, bf16 becomes
    float32 (exact; the merge casts to the target dtype anyway)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state" in sd:
        sd = sd["model_state"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]

    def to_np(v):
        if v.dtype == torch.bfloat16:
            return v.detach().float().numpy()
        return v.numpy()

    return {k: to_np(v) for k, v in sd.items()}


def detect_model(sd: Dict) -> str:
    """Guess the model family from a torch state_dict's keys and shapes (when
    the caller names none)."""
    if any("multipathway" in k for k in sd):
        return "slowfast"
    if any(k.startswith("cls_positional_encoding") for k in sd):
        return "mvit_b"
    if any("patch_embeddings.projection" in k for k in sd):
        return "videomae_b"
    if "blocks.0.conv.conv_t.weight" in sd:
        return "x3d_s"
    if any(".conv_b.conv_t." in k for k in sd):
        return "r2plus1d_r50"
    # csn shares slow_r50's key names exactly; the depthwise conv_b shape
    # (inner, 1, 3, 3, 3) is the family signature
    k = "blocks.1.res_blocks.0.branch2.conv_b.weight"
    if k in sd:
        shape = np.shape(sd[k])
        if len(shape) == 5 and shape[1] == 1:
            return "csn_r101"
    # c2d also shares the key names; its signature is a kernel-1 temporal
    # conv_a where slow_r50 carries its (3,1,1) taps (res4 entry)
    k = "blocks.3.res_blocks.0.branch2.conv_a.weight"
    if k in sd:
        shape = np.shape(sd[k])
        if len(shape) == 5 and shape[2] == 1:
            return "c2d_r50"
    return "slow_r50"


def convert_state_dict(sd: Dict[str, np.ndarray], model: str) -> dict:
    """torch state_dict -> {"params": tree, "batch_stats": tree, "skipped":
    [keys no map recognised]} in the flax layout."""
    if model.startswith("mvit"):
        return convert_mvit_state_dict(sd)
    if model.startswith("videomae"):
        return convert_videomae_state_dict(sd)
    out: dict = {"params": {}, "batch_stats": {}, "skipped": []}
    for key, value in sd.items():
        arr = np.asarray(value)
        mapped = map_torch_key(key, model)
        if mapped is None:
            if not key.endswith("num_batches_tracked"):
                out["skipped"].append(key)
            continue
        coll, path = mapped
        _set_path(out[coll], path, convert_tensor(path, arr))
    return out


def save_converted(tree: dict, path: str) -> None:
    """Write {"params": ..., "batch_stats": ...} as the flat npz artifact
    (`params/...`, `batch_stats/...` flax paths) both packages load."""
    flat = {}
    for coll in ("params", "batch_stats"):
        flat.update({k: np.asarray(v) for k, v in
                     flatten_tree(tree.get(coll, {}), coll).items()})
    np.savez(path, **flat)


def load_converted(path: str) -> dict:
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})


def export_checkpoint_params(ckpt_dir: str, dst: str,
                             step: Optional[int] = None) -> int:
    """A port training checkpoint (trainer/checkpoint.py: `<ckpt_dir>/<step>/
    state.pt`; the latest step unless `step` is given) -> the npz artifact
    of its params and BN statistics, never the optimizer's state.

    The pretrain -> fine-tune handoff: export a `videomae_b_pretrain` run's
    checkpoint, then fine-tune `videomae_b` with `--model.pretrained
    --model.pretrained_path out.npz`: the shared `encoder` subtree loads
    name for name, the classifier head stays fresh. Returns the step."""
    import torch

    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import (
        _STATE_FILE,
        Checkpointer,
    )

    ckpt = Checkpointer(ckpt_dir)
    if step is None:
        step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    state_path = os.path.join(ckpt.directory, str(int(step)), _STATE_FILE)
    if not os.path.exists(state_path):
        raise FileNotFoundError(f"checkpoint step {step} has no state at "
                                f"{state_path}")
    saved = torch.load(state_path, map_location="cpu", weights_only=True)
    save_converted(jax_tree_from_state_dict(saved["model"]), dst)
    return int(step)


# --- the Trainer's entry point ----------------------------------------------

def _flax_shape(shape, name: str) -> tuple:
    """The flax shape of a port tensor of `shape` whose flax key is `name`."""
    shape = tuple(shape)
    if name.endswith("/kernel"):
        return shape[2:] + shape[1::-1] if len(shape) == 5 else shape[::-1]
    return shape


def load_pretrained(path: str, model, family: str = "") -> dict:
    """Merge a converted checkpoint into `model` (a port module) in place.

    A leaf of the model's state whose flax path is in the artifact with the
    same shape is loaded, cast to the target dtype; an absent one keeps its
    fresh value ("kept"); a present one of another shape too ("mismatched":
    expected only for a classification head swapped to another class
    count). A learned (1, T, H, W, C) `pos_embed` of another grid (a clip
    length or resolution other than the checkpoint's) is trilinear-resized
    to the model's ("interpolated"; `F.interpolate(align_corners=False)`,
    no antialiasing, as the JAX package's `jax.image.resize`). `path` is a
    converted `.npz`, or a `.pt/.pth/.bin/.safetensors` checkpoint converted
    on the fly as `family` (default: `detect_model`). Returns the report:
    {"loaded", "kept", "mismatched", "interpolated"} lists of flax paths."""
    import torch
    import torch.nn.functional as F

    if path.endswith(_TORCH_FILES):
        sd = load_torch_state_dict(path)
        source = convert_state_dict(sd, family or detect_model(sd))
    else:
        source = load_converted(path)

    state = model.state_dict()
    port_key = {}  # flat flax key -> the port's key
    target: dict = {"params": {}, "batch_stats": {}}
    for key, v in state.items():
        name = flax_key(key, v.ndim)
        port_key[name] = key
        _set_path(target, tuple(name.split("/")), _flax_shape(v.shape, name))

    report = {"loaded": [], "kept": [], "mismatched": [], "interpolated": []}
    updates = {}  # flat flax key -> its new value, flax layout

    def merge(target: dict, src: dict, prefix: Path) -> None:
        for k, shape in target.items():
            p = prefix + (k,)
            name = "/".join(p)
            if isinstance(shape, dict):
                if k in src and not isinstance(src[k], dict):
                    # a leaf where a subtree is expected: a stale or
                    # wrong-layout artifact, not a fresh head
                    report["mismatched"].append(name)
                    merge(shape, {}, p)
                else:
                    merge(shape, src.get(k, {}), p)
            elif (k in src and not isinstance(src[k], dict)
                  and tuple(np.shape(src[k])) == shape):
                updates[name] = np.asarray(src[k])
                report["loaded"].append(name)
            elif (k == "pos_embed" and k in src
                  and not isinstance(src[k], dict)
                  and np.ndim(src[k]) == 5 and len(shape) == 5
                  and np.shape(src[k])[-1] == shape[-1]):
                table = torch.from_numpy(np.asarray(src[k], np.float32))
                resized = F.interpolate(
                    table.permute(0, 4, 1, 2, 3), size=shape[1:4],
                    mode="trilinear", align_corners=False)
                updates[name] = resized.permute(0, 2, 3, 4, 1).numpy()
                report["interpolated"].append(
                    f"{name} {tuple(np.shape(src[k])[1:4])}->{shape[1:4]}")
            else:
                # a wrong shape, or a subtree where a leaf is expected
                (report["mismatched"] if k in src
                 else report["kept"]).append(name)

    for coll in ("params", "batch_stats"):
        merge(target[coll], source.get(coll, {}), (coll,))
    with torch.no_grad():
        for name, arr in updates.items():
            key = port_key[name]
            coll, *path, leaf = name.split("/")
            if coll == "params":
                arr = _param_leaf_to_port(".".join(path), leaf, arr)[1]
            state[key].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return report


def main(argv=None) -> None:
    """Convert weights to the npz artifact (`pva-torch-convert`).

    a torch-hub (or transformers VideoMAE) checkpoint:
        pva-torch-convert SRC.pth OUT.npz [--model slowfast_r50]
    a port training checkpoint directory (pretrain -> fine-tune handoff):
        pva-torch-convert OUTPUT_DIR/checkpoints OUT.npz [--step N]
    """
    import argparse

    ap = argparse.ArgumentParser(
        description=main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--model", default="",
                    help="model family (default: auto-detect from the keys)")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (checkpoint directories; default: "
                         "the latest)")
    args = ap.parse_args(argv)

    if os.path.isdir(args.src):
        step = export_checkpoint_params(args.src, args.dst, step=args.step)
        print(f"exported params of step {step} from {args.src} -> {args.dst}")
        return

    sd = load_torch_state_dict(args.src)
    model = args.model or detect_model(sd)
    tree = convert_state_dict(sd, model)
    n = len(flatten_tree(tree["params"])) + len(flatten_tree(tree["batch_stats"]))
    if n == 0:  # before touching dst: a good artifact there stays
        raise SystemExit(
            f"no tensors mapped for model {model!r} — wrong --model for this "
            f"checkpoint? skipped keys: {tree['skipped'][:8]}...")
    save_converted(tree, args.dst)
    print(f"wrote {n} tensors to {args.dst} (model {model}); "
          f"skipped: {tree['skipped']}")


if __name__ == "__main__":
    main()
