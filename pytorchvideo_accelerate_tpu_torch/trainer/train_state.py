"""The training state (counterpart of the JAX package's
`trainer/train_state.py`).

The JAX package keeps one immutable pytree; here the state is the live
objects: the step counter (optimizer steps taken), the model (parameters
and BN running averages), the optimizer (its per-param state, e.g. SGD
momentum buffers) and an optional EMA copy of the parameters
(`--optim.ema_decay > 0`, made from the parameters at creation). The step
functions update them in place.

On the model axis (tensor parallelism, `parallel/tensor_parallel.py`)
and the library mesh's fsdp axis (`parallel/fsdp.py`) the model, the
optimizer's per-param state and the EMA hold this rank's shards;
`state_dict()` gathers the full tree (over the fsdp group, then the tensor
group: a collective, every rank calls it) and `load_state_dict()` takes a
full tree and keeps this rank's shards, so a checkpoint is the same file at
every layout and resumes at any other. `eval_params()` is the EMA's
shards: evaluation runs them through the model, whose fsdp hooks gather
them like the live parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from pytorchvideo_accelerate_tpu_torch.parallel.sharding import (
    full_state_dict,
    local_state_dict,
)
from pytorchvideo_accelerate_tpu_torch.parallel.tensor_parallel import (
    ModelAxis,
    model_axis_of,
)
from pytorchvideo_accelerate_tpu_torch.trainer.optim import Optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Optimizer,
               ema_decay: float = 0.0) -> "TrainState":
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError(
                f"optim.ema_decay must be in [0, 1), got {ema_decay} (1.0 "
                "would freeze the EMA at the init weights while eval keeps "
                "scoring them)")
        ema = None
        if ema_decay > 0:
            ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        return cls(model=model, optimizer=optimizer, step=0, ema=ema)

    def eval_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The weights evaluation scores and export writes: the EMA when
        present (BN running averages stay the live ones; this rank's
        shards, which the model's fsdp hooks gather), else None (the
        model's own)."""
        return self.ema

    def _opt_plan(self, flat: dict, plan: dict) -> dict:
        """The entries of `plan` (keyed by parameter name) for the
        optimizer state's flat keys ("<param index>/<state key>"): each
        param-shaped tensor of a sharded param takes its param's."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        by_index = {i: (plan[names[id(p)]], p.dim())
                    for i, p in enumerate(self.optimizer.trained)
                    if names.get(id(p)) in plan}
        out = {}
        for key, v in flat.items():
            entry = by_index.get(int(key.split("/", 1)[0]))
            if entry is not None and torch.is_tensor(v) and v.dim() == entry[1]:
                out[key] = entry[0]
        return out

    def _opt_axis(self, flat: dict, axis: ModelAxis) -> ModelAxis:
        """`axis` with its plans keyed by the optimizer state's flat keys."""
        return ModelAxis(count=axis.count, index=axis.index,
                         plan=self._opt_plan(flat, axis.plan),
                         fsdp_count=axis.fsdp_count, fsdp_index=axis.fsdp_index,
                         fsdp_min_size=axis.fsdp_min_size,
                         fsdp_plan=self._opt_plan(flat, axis.fsdp_plan))

    def _map_opt(self, opt_sd: dict, axis: ModelAxis, fn) -> dict:
        """`opt_sd` with `fn(flat state, its axis)` applied to its
        per-param tensors."""
        flat = {f"{i}/{k}": v for i, st in opt_sd["state"].items()
                for k, v in st.items()}
        flat = fn(flat, self._opt_axis(flat, axis))
        state = {}
        for key, v in flat.items():
            i, k = key.split("/", 1)
            state.setdefault(int(i), {})[k] = v
        return {**opt_sd, "state": state}

    def state_dict(self) -> dict:
        """The full state (gathered over the fsdp and tensor groups when the
        model is split: every rank must call it)."""
        model, opt, ema = (self.model.state_dict(), self.optimizer.state_dict(),
                           self.ema)
        axis = model_axis_of(self.model)
        if axis.plan or axis.fsdp_plan:
            model = full_state_dict(model, axis)
            opt = self._map_opt(opt, axis, full_state_dict)
            if ema is not None:
                ema = full_state_dict(ema, axis)
        return {"step": int(self.step), "model": model, "optimizer": opt,
                "ema": ema}

    def load_state_dict(self, state: dict) -> None:
        """Load a full state (this rank keeps its shards of it)."""
        if (state.get("ema") is None) != (self.ema is None):
            raise ValueError(
                "checkpoint and run disagree on EMA (--optim.ema_decay): "
                "toggling it across a resume changes the state")
        model, opt, ema = state["model"], state["optimizer"], state.get("ema")
        axis = model_axis_of(self.model)
        if axis.plan or axis.fsdp_plan:
            model = local_state_dict(model, axis)
            ema = None if ema is None else local_state_dict(ema, axis)
            opt = self._map_opt(opt, axis, local_state_dict)
        self.model.load_state_dict(model)
        self.optimizer.load_state_dict(opt)
        if self.ema is not None:
            for k, v in ema.items():
                self.ema[k].copy_(v)
        self.step = int(state["step"])
