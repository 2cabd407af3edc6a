"""Train and eval steps, and the batch plumbing they share with serving
(counterpart of the JAX package's `trainer/steps.py`).

PyTorch runs eagerly, so a "step" is a plain function over the live
`TrainState`: forward and backward per micro-batch, the summed gradients
divided by the accumulation count once per effective step, the optimizer
update, the EMA. Eval metrics are masked sums (`loss_sum`, `correct`,
`correct5`, `count`) the host adds across batches (trainer/metrics.py).
VideoMAE pretraining has its own pair (`make_pretrain_step`,
`make_pretrain_eval_step`) over the same update step.

Batch convention: dict with "video" (single-pathway) or "slow"/"fast"
(SlowFast packing), each clip NDHWC, "label" int, optional "mask" float32
(1.0 = real sample, 0.0 = padding). With gradient accumulation G > 1 every
leaf carries a leading (G, B, ...) micro-step axis.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from pytorchvideo_accelerate_tpu_torch.models.common import SeededDropout
from pytorchvideo_accelerate_tpu_torch.precision import f32_island
from pytorchvideo_accelerate_tpu_torch.trainer.optim import global_norm


def model_inputs(batch: dict):
    """Map a batch dict to the model's input convention."""
    if "slow" in batch:
        return (batch["slow"], batch["fast"])
    return batch["video"]


def device_normalize_batch(batch: dict, norm) -> dict:
    """Normalize uint8 clips on the device: the host ships raw uint8 (4x less
    host->device transfer than f32) and this applies the `x/255` + mean/std
    affine in f32. No-op when `norm` is None or a clip is already floating
    point."""
    if norm is None:
        return batch
    mean, std = norm

    def f(x):
        if x.dtype != torch.uint8:
            return x
        mean32 = torch.tensor(mean, dtype=torch.float32, device=x.device)
        std32 = torch.tensor(std, dtype=torch.float32, device=x.device)
        return f32_island(x) * (1.0 / (255.0 * std32)) + (-mean32 / std32)

    out = dict(batch)
    for k in ("video", "slow", "fast"):
        if k in out:
            out[k] = f(out[k])
    return out


def fold_views(inputs):
    """Fold the per-video view axis into the batch dim: (B, V, T, H, W, C)
    leaves become (B*V, T, H, W, C); rank-5 inputs pass through. Returns
    `(inputs, num_views)`, for one tensor or the (slow, fast) tuple."""
    first = inputs[0] if isinstance(inputs, tuple) else inputs
    num_views = first.shape[1] if first.dim() == 6 else 1
    if num_views > 1:
        fold = lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])  # noqa: E731
        inputs = (tuple(fold(x) for x in inputs)
                  if isinstance(inputs, tuple) else fold(inputs))
    return inputs, num_views


def multiview_logits(forward: Callable, inputs):
    """Fold views into the batch, run one forward, then average the logits
    over views in f32 before any argmax (the eval protocol the serving
    engine shares)."""
    inputs, num_views = fold_views(inputs)
    logits = forward(inputs)
    if num_views > 1:
        logits = f32_island(logits).reshape(
            -1, num_views, logits.shape[-1]).mean(dim=1)
    return logits


def _loss_and_metrics(logits, labels, mask, label_smoothing: float):
    """Masked mean softmax cross-entropy over f32 logits (labels smoothed to
    onehot * (1 - a) + a / K), and the masked top-1 hit count and count."""
    logits = f32_island(logits)
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    if label_smoothing > 0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    losses = -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    count = mask.sum()
    loss = (losses * mask).sum() / torch.clamp_min(count, 1.0)
    correct = ((logits.argmax(dim=-1) == labels) * mask).sum()
    return loss, correct, count


def _topk_correct(logits, labels, mask, k: int = 5):
    """Masked top-k hit count (Kinetics reports top-1 and top-5)."""
    k = min(k, logits.shape[-1])
    top = f32_island(logits).topk(k, dim=-1).indices
    hit = (top == labels[..., None].long()).any(dim=-1)
    return (hit * mask).sum()


def _mask_of(batch: dict) -> torch.Tensor:
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(batch["label"].shape, dtype=torch.float32,
                          device=batch["label"].device)
    return mask


def _make_update_step(model, optimizer, forward_loss: Callable,
                      accum_steps: int, ema_decay: float,
                      dropout_seed: Optional[int], with_accuracy: bool) -> Callable:
    """The optimizer step shared by the supervised and the MAE objective:
    `forward_loss(micro_batch, step, micro) -> (loss, correct, count)` per
    micro-batch in order, backward each, the summed grads divided by
    `accum_steps`, then the update (clip inside `optimizer.step`) and the
    EMA. Every `SeededDropout` of the model (head dropout, drop path) is
    reseeded at every step from (dropout_seed, step), each module on a
    stream of its own."""
    named = dict(model.named_parameters())
    params = [p for p in named.values() if p.requires_grad]
    dropouts = [m for m in model.modules() if isinstance(m, SeededDropout)]

    def step(state, batch: dict) -> dict:
        model.train()
        if dropout_seed is not None:
            base = dropout_seed * 1_000_003 + state.step
            for i, d in enumerate(dropouts):
                d.reseed((base + i * 0x9E3779B97F4A7C15) % 2 ** 63)
        for p in params:
            p.grad = None
        losses, corrects, counts = [], [], []
        for i in range(accum_steps):
            mb = batch if accum_steps == 1 else {k: v[i] for k, v in batch.items()}
            loss, correct, count = forward_loss(mb, state.step, i)
            loss.backward()
            losses.append(loss.detach())
            corrects.append(correct)
            counts.append(count)
        grads = [p.grad for p in params if p.grad is not None]
        if accum_steps > 1:
            torch._foreach_div_(grads, float(accum_steps))
        grad_norm = global_norm(grads)
        lr = optimizer.schedule(state.step)
        optimizer.step(state.step)
        if ema_decay > 0 and state.ema is not None:
            ema = list(state.ema.values())
            live = [named[k].detach() for k in state.ema]
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, live, alpha=1.0 - ema_decay)
        state.step += 1
        out = {"loss": torch.stack(losses).mean(), "grad_norm": grad_norm,
               "lr": lr}
        if with_accuracy:
            correct, count = torch.stack(corrects).sum(), torch.stack(counts).sum()
            out["accuracy"] = correct / torch.clamp_min(count, 1.0)
        return out

    return step


def make_train_step(model, optimizer, accum_steps: int = 1,
                    label_smoothing: float = 0.0, device_normalize=None,
                    ema_decay: float = 0.0,
                    dropout_seed: Optional[int] = None) -> Callable:
    """Build `step(state, batch) -> metrics`. One call is one optimizer
    step: forward + backward per micro-batch in order (the BN running
    averages thread through them), the summed grads divided by
    `accum_steps`, then the update and the EMA. `metrics`: "loss" (mean over
    micro-steps), "grad_norm" (global norm of the averaged grads, before
    clipping), "accuracy" (device scalars) and "lr" (the schedule at the
    step before the update, a float). `dropout_seed`: every `SeededDropout`
    of the model (each head's dropout) is reseeded from (seed, step) at
    every step."""

    def forward_loss(batch: dict, step: int, micro: int):
        batch = device_normalize_batch(batch, device_normalize)
        logits = model(model_inputs(batch))
        return _loss_and_metrics(logits, batch["label"], _mask_of(batch),
                                 label_smoothing)

    return _make_update_step(model, optimizer, forward_loss, accum_steps,
                             ema_decay, dropout_seed, with_accuracy=True)


def mask_generator(seed: int, step: int, micro: int) -> torch.Generator:
    """The tube-mask generator of one pretraining micro-step (CPU: the
    mask is drawn on the host, so a seed gives one mask on every device)."""
    return torch.Generator().manual_seed(
        (seed * 1_000_003 + step) * 1_009 + micro)


def make_pretrain_step(model, optimizer, accum_steps: int = 1,
                       ema_decay: float = 0.0, seed: int = 0) -> Callable:
    """Build the VideoMAE self-supervised step `step(state, batch) ->
    metrics` (JAX `make_pretrain_step`): no labels, the model returns its
    own reconstruction loss under a tube mask drawn from
    `mask_generator(seed, step, micro)`; the same accumulation, clip and
    EMA as `make_train_step`. `metrics`: "loss", "grad_norm", "lr"."""

    def forward_loss(batch: dict, step: int, micro: int):
        out = model(batch["video"], generator=mask_generator(seed, step, micro))
        zero = torch.zeros((), device=out["loss"].device)
        return out["loss"], zero, zero

    return _make_update_step(model, optimizer, forward_loss, accum_steps,
                             ema_decay, seed, with_accuracy=False)


def make_pretrain_eval_step(model) -> Callable:
    """Eval for MAE pretraining (JAX `make_pretrain_eval_step`): the
    reconstruction loss per clip under the deterministic mask (a generator
    seeded 0), summed over the batch mask so padded val-tail clips do not
    bias the mean; the same {loss_sum, correct, correct5, count} contract
    (accuracy reads 0). EMA weights when the state carries them."""

    def eval_step(state, batch: dict) -> dict:
        model.eval()
        with torch.no_grad():
            x = batch["video"]
            kwargs = {"generator": torch.Generator().manual_seed(0)}
            ema = state.eval_params()
            out = (model(x, **kwargs) if ema is None
                   else functional_call(model, ema, (x,), kwargs))
            err = (f32_island(out["pred"]) - f32_island(out["target"])) ** 2
            per_sample = err.mean(dim=tuple(range(1, err.dim())))
            mask = batch.get("mask")
            if mask is None:
                mask = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
            zero = torch.zeros((), device=x.device)
            return {"loss_sum": (per_sample * mask).sum(), "correct": zero,
                    "correct5": zero, "count": mask.sum()}

    return eval_step


def make_eval_step(model, label_smoothing: float = 0.0,
                   device_normalize=None) -> Callable:
    """Build `eval_step(state, batch) -> {loss_sum, correct, correct5,
    count}` (device scalars): the model in eval mode, the EMA weights when
    the state carries them (BN running averages stay the live ones), views
    folded into the batch and their logits averaged (`multiview_logits`)."""

    def eval_step(state, batch: dict) -> dict:
        model.eval()
        with torch.no_grad():
            batch = device_normalize_batch(batch, device_normalize)
            mask = _mask_of(batch)
            ema = state.eval_params()
            forward = model if ema is None else (
                lambda x: functional_call(model, ema, (x,)))
            logits = multiview_logits(forward, model_inputs(batch))
            loss, correct, count = _loss_and_metrics(
                logits, batch["label"], mask, label_smoothing)
            return {"loss_sum": loss * count, "correct": correct,
                    "correct5": _topk_correct(logits, batch["label"], mask),
                    "count": count}

    return eval_step
