"""The train mesh's shape (counterpart of the JAX package's
`parallel/mesh.py`).

The port runs one process per card. Two layouts, as in the JAX package:

- the 2-D (data, model) train mesh: rank r at (r // model, r % model)
  (`distributed.initialize_mesh`). `data` slices every global batch;
  `model` is spent per run as the JAX trainer spends it
  (`parallel/tensor_parallel.py layout`: tensor-parallel heads and MLP
  widths, context-parallel tokens, pipeline stages
  (`parallel/pipeline.py`) or replication; its `cp_axis` and `model_axis`
  are this one axis). The defaults (`model` 1, `data` -1) are
  the reference's DDP layout.
- the 4-axis library mesh (data, fsdp, tensor, context), which any of
  `--mesh.fsdp/tensor/context` above 1 selects (the JAX package's
  `make_train_mesh` falls through to `make_mesh`): rank r at the row-major
  coordinates of r (`distributed.initialize_library_mesh`). The batch
  shards over data x fsdp, the parameters and optimizer state shard over
  fsdp (`parallel/fsdp.py`), Megatron TP (or the pipeline's stages) runs
  over `tensor` and ring / Ulysses over `context`, both at once.

A resolved shape is a tuple: (data, model) or (data, fsdp, tensor,
context); `batch_axes`, `model_axis`, `cp_axis` and `data_shard_count` read
the axes off it, as the JAX functions read them off a mesh (the first three
equally off the axis names, which is how `distributed.py`'s one rank grid
reads its roles). Both layouts are one grid of ranks there.
"""

from __future__ import annotations

from typing import Tuple

from pytorchvideo_accelerate_tpu_torch.config import MeshConfig

LIBRARY_AXES = ("data", "fsdp", "tensor", "context")
TRAIN_AXES = ("data", "model")


def resolve_mesh_shape(cfg: MeshConfig, n_devices: int) -> Tuple[int, int, int, int]:
    """Resolve -1 on the library mesh's data axis and validate
    divisibility (the JAX package's checks and messages)."""
    for name in ("fsdp", "tensor", "context"):
        if getattr(cfg, name) < 1:
            raise ValueError(f"mesh.{name} must be >= 1, got {getattr(cfg, name)}")
    if cfg.data != -1 and cfg.data < 1:
        raise ValueError(f"mesh.data must be >= 1 or -1 (infer), got {cfg.data}")
    explicit = cfg.fsdp * cfg.tensor * cfg.context
    data = cfg.data
    if data == -1:
        if n_devices % explicit != 0:
            raise ValueError(
                f"mesh axes fsdp*tensor*context={explicit} does not divide "
                f"device count {n_devices}")
        data = n_devices // explicit
    total = data * explicit
    if total != n_devices:
        raise ValueError(
            f"mesh shape ({data},{cfg.fsdp},{cfg.tensor},{cfg.context}) "
            f"needs {total} devices, have {n_devices}")
    return (data, cfg.fsdp, cfg.tensor, cfg.context)


def resolve_train_mesh_shape(cfg: MeshConfig, n_devices: int) -> Tuple[int, int]:
    """Resolve the 2-D (data, model) shape; -1 on `data` infers (the JAX
    package's checks and messages)."""
    if cfg.model < 1:
        raise ValueError(f"mesh.model must be >= 1, got {cfg.model}")
    if cfg.data != -1 and cfg.data < 1:
        raise ValueError(f"mesh.data must be >= 1 or -1 (infer), got {cfg.data}")
    data = cfg.data
    if data == -1:
        if n_devices % cfg.model != 0:
            raise ValueError(
                f"mesh.model={cfg.model} does not divide device count "
                f"{n_devices}")
        data = n_devices // cfg.model
    if data * cfg.model != n_devices:
        raise ValueError(
            f"train mesh shape ({data},{cfg.model}) needs "
            f"{data * cfg.model} devices, have {n_devices}")
    return data, cfg.model


def resolve_layout(cfg: MeshConfig, n_devices: int) -> tuple:
    """The trainer's mesh (JAX `make_train_mesh`): the library mesh's
    shape when a legacy fsdp/tensor/context axis is set, which `model` > 1
    cannot join; else the (data, model) shape."""
    if (cfg.fsdp, cfg.tensor, cfg.context) != (1, 1, 1):
        if cfg.model > 1:
            raise ValueError(
                "mesh.model is the 2-D train-mesh axis and cannot combine "
                "with the legacy fsdp/tensor/context axes — pick one layout")
        return resolve_mesh_shape(cfg, n_devices)
    return resolve_train_mesh_shape(cfg, n_devices)


def is_library(shape: tuple) -> bool:
    return len(shape) == len(LIBRARY_AXES)


def axis_names(shape: tuple) -> tuple:
    return LIBRARY_AXES if is_library(shape) else TRAIN_AXES


def batch_axes(shape: tuple) -> tuple:
    """The axes the global batch shards over: ("data", "fsdp") on the
    library mesh, ("data",) on the train mesh."""
    return ("data", "fsdp") if is_library(shape) else ("data",)


def model_axis(shape: tuple) -> str:
    """The model-parallel (TP) axis: "tensor" on the library mesh, "model"
    on the train mesh."""
    return "tensor" if is_library(shape) else "model"


def cp_axis(shape: tuple) -> str:
    """The axis context parallelism splits tokens over: "context" on the
    library mesh, "model" on the train mesh."""
    return "context" if is_library(shape) else "model"


def data_shard_count(shape: tuple) -> int:
    """The batch shards: the product of the batch axes."""
    sizes = dict(zip(axis_names(shape), shape))
    count = 1
    for a in batch_axes(shape):
        count *= sizes[a]
    return count


def mesh_line(shape: tuple, platform: str, mode: str) -> str:
    """The JAX trainer's mesh line: `mesh: {'data': D, 'model': M} over N
    <platform> devices, N process(es)` (the library mesh: `{'data': D,
    'fsdp': F, 'tensor': T, 'context': C}`), and `; model axis (M): <mode>`
    when the model-parallel axis is above 1."""
    sizes = dict(zip(axis_names(shape), shape))
    n = 1
    for v in shape:
        n *= v
    m = sizes[model_axis(shape)]
    return (f"mesh: {sizes} over {n} {platform} devices, {n} process(es)"
            + (f"; model axis ({m}): {mode}" if m > 1 else ""))
