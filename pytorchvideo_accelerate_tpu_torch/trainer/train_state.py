"""The training state (counterpart of the JAX package's
`trainer/train_state.py`).

The JAX package keeps one immutable pytree; here the state is the live
objects: the step counter (optimizer steps taken), the model (parameters
and BN running averages), the optimizer (its per-param state, e.g. SGD
momentum buffers) and an optional EMA copy of the parameters
(`--optim.ema_decay > 0`, made from the parameters at creation). The step
functions update them in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

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
        present (BN running averages stay the live ones), else None (the
        model's own)."""
        return self.ema

    def state_dict(self) -> dict:
        return {"step": int(self.step),
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema": self.ema}

    def load_state_dict(self, state: dict) -> None:
        if (state.get("ema") is None) != (self.ema is None):
            raise ValueError(
                "checkpoint and run disagree on EMA (--optim.ema_decay): "
                "toggling it across a resume changes the state")
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            for k, v in state["ema"].items():
                self.ema[k].copy_(v)
        self.step = int(state["step"])
