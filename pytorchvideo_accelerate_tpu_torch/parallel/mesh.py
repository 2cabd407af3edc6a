"""The train mesh's shape (counterpart of the JAX package's
`parallel/mesh.py` train mesh).

The port runs one process per card on the 2-D (data, model) mesh: rank r
at (r // model, r % model) (`distributed.initialize_mesh`). `data` slices
every global batch; `model` is spent per run as the JAX trainer spends it
(`parallel/tensor_parallel.py layout`: tensor-parallel heads and MLP
widths, context-parallel tokens, or replication; its `cp_axis` and
`model_axis` are this one axis). The defaults (`model` 1, `data` -1) are
the reference's DDP layout. The legacy fsdp/tensor/context axes are
refused by the trainer (`trainer/loop.py` `refuse_unported`).
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



def mesh_line(shape: Tuple[int, int], platform: str, mode: str) -> str:
    """The JAX trainer's mesh line: `mesh: {'data': D, 'model': M} over N
    <platform> devices, N process(es)`, and `; model axis (M): <mode>`
    when M > 1."""
    data, model = shape
    n = data * model
    return (f"mesh: {{'data': {data}, 'model': {model}}} over {n} {platform} "
            f"devices, {n} process(es)"
            + (f"; model axis ({model}): {mode}" if model > 1 else ""))
