"""The train mesh's shape (counterpart of the data axis of the JAX package's
`parallel/mesh.py`).

The port runs one process per card, so its mesh is (data, model) = (world
size, 1): each rank holds the whole model and a 1/world share of every
global batch (the reference's DDP layout, the JAX trainer's default
`mesh.data = -1`). A model axis above 1 and the legacy fsdp/tensor/context
axes are refused by the trainer (`trainer/loop.py` `refuse_unported`).
"""

from __future__ import annotations

from typing import Tuple

from pytorchvideo_accelerate_tpu_torch.config import MeshConfig


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

