"""Optimizer + LR schedule (counterpart of the JAX package's
`trainer/optim.py`, with optax's semantics).

- The LR schedule is a pure function of the optimizer step: linear warmup
  0 -> lr over `warmup_steps`, then `cosine_decay_schedule(lr, total -
  warmup, alpha 0)` (or constant). Update k uses schedule(k).
- SGD: coupled weight decay on every trained param, then momentum
  (optax `add_decayed_weights` + `sgd(momentum)`), which is
  `torch.optim.SGD(momentum, weight_decay, dampening=0)` with its lr set from
  the schedule before each `step()`.
- adamw: `torch.optim.AdamW` with optax's defaults (b1 0.9, b2 0.999, eps
  1e-8), `capturable` whenever the params are on the card: its step counts
  then live beside the params, where the guard's skip can select them
  without a host round trip, and every run takes the same update path.
- `grad_clip_norm > 0`: optax `clip_by_global_norm` before the optimizer.
- `freeze_backbone`: optax `multi_transform` gives the frozen params a zero
  update, no weight decay and no state, and the clip inside the trained
  branch takes its norm over the trained params only. Here the frozen
  params are left out of the torch optimizer, which does all of that.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Tuple

import torch

from pytorchvideo_accelerate_tpu_torch.config import OptimConfig


def build_lr_schedule(cfg: OptimConfig, total_steps: int) -> Callable[[int], float]:
    """Cosine annealing to 0 with optional linear warmup, or constant."""
    total_steps = max(int(total_steps), 1)
    lr, warmup = float(cfg.lr), int(cfg.warmup_steps)
    if cfg.schedule == "constant":
        def base(step):
            return lr
    elif cfg.schedule == "cosine":
        decay_steps = max(total_steps - warmup, 1)

        def base(step):
            count = min(max(step, 0), decay_steps)
            return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if warmup <= 0:
        return base

    def schedule(step: int) -> float:
        if step < warmup:
            return lr * min(max(step, 0), warmup) / warmup
        return base(step - warmup)

    return schedule


class Optimizer:
    """A torch optimizer over the trained params, its LR schedule and the
    optional global-norm clip, stepped as one optax update."""

    def __init__(self, opt: torch.optim.Optimizer,
                 schedule: Callable[[int], float], clip_norm: float,
                 trained: List[torch.nn.Parameter]):
        self.opt = opt
        self.schedule = schedule
        self.clip_norm = float(clip_norm)
        self.trained = trained

    def step(self, step: int) -> None:
        """Apply update number `step` (0-based) from the params' `.grad`."""
        lr = self.schedule(step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        if self.clip_norm > 0:
            grads = [p.grad for p in self.trained if p.grad is not None]
            norm = global_norm(grads)
            # optax: g if norm < max else g / norm * max
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        self.opt.step()

    def state_dict(self) -> dict:
        return self.opt.state_dict()

    def load_state_dict(self, state: dict) -> None:
        # torch takes the saved groups' `capturable`: put back the live one
        # (a checkpoint written on the CPU resumed on the card, or back).
        capturable = [g.get("capturable") for g in self.opt.param_groups]
        self.opt.load_state_dict(state)
        for group, cap in zip(self.opt.param_groups, capturable):
            if cap is None or group.get("capturable") == cap:
                continue
            group["capturable"] = cap
            for p in group["params"]:
                st = self.opt.state.get(p, {})
                if torch.is_tensor(st.get("step")):
                    st["step"] = st["step"].to(p.device if cap else "cpu")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element, in f32 (optax
    `global_norm`); a 0-d tensor on the tensors' device."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def build_optimizer(
    cfg: OptimConfig,
    total_steps: int,
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    backbone_filter: Optional[Callable] = None,
    freeze_backbone: bool = False,
) -> Optimizer:
    """SGD+momentum+wd+cosine by default; adamw for the transformer family.
    `backbone_filter(path) -> bool` (path = the param name split on ".")
    marks backbone params; with `freeze_backbone` those are not trained."""
    trained = [p for name, p in named_params
               if not (freeze_backbone and backbone_filter is not None
                       and backbone_filter(tuple(name.split("."))))]
    if cfg.optimizer == "sgd":
        opt = torch.optim.SGD(trained, lr=cfg.lr, momentum=cfg.momentum,
                              dampening=0.0, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(trained, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay,
                                capturable=any(p.is_cuda for p in trained))
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return Optimizer(opt, build_lr_schedule(cfg, total_steps),
                     cfg.grad_clip_norm, trained)
