"""Train and eval steps, and the batch plumbing they share with serving
(counterpart of the JAX package's `trainer/steps.py`).

PyTorch runs eagerly, so a "step" is a plain function over the live
`TrainState`: forward and backward per micro-batch, the summed gradients
divided by the accumulation count once per effective step, the optimizer
update, the EMA. Eval metrics are masked sums (`loss_sum`, `correct`,
`correct5`, `count`) the host adds across batches (trainer/metrics.py).
VideoMAE pretraining has its own pair (`make_pretrain_step`,
`make_pretrain_eval_step`) over the same update step.

Mixup and cutmix (`mixup_alpha`, `cutmix_alpha`) mix each clip with its
pair in the flipped batch through one per-pixel weight; the few scalars of
a micro-step's draw come from the host (`mix_draw`), the weight is built on
the device. `guard_skip` (reliability/guard.py TrainGuard) discards a step
whose loss or gradient norm is not finite: every state leaf keeps its old
value through `torch.where`, without a host round trip.

With a process group up (data parallelism, `parallel/`), each rank runs the
step on its share of the global batch and the step keeps the JAX step's
global view: the BatchNorm statistics are the global batch's
(models/common.py), the gradient is averaged over the ranks by one
all-reduce per optimizer step before its norm, the clip and the update,
the reported loss and accuracy are the global batch's (so the guard's skip
is decided alike on every rank), mixing pairs each clip with its partner
in the flipped global batch, and each rank's dropout mask is its rows of
the global batch's (models/common.py `batch_rand`).

On the model axis (`parallel/tensor_parallel.py`) "the ranks" above are
the batch group (the data group on the (data, model) grid; data x fsdp on
the library mesh), the ranks that hold the other shards of the global
batch: a tensor-sharded gradient is averaged over the batch group; a
replicated one, equal on the tensor and context ranks of a batch shard,
over the whole world (the same mean, and one reduction leaves every rank
the same bits even where a kernel's backward is not deterministic); the
pools of a split MViT attention, which each rank uses in part, are summed
over the tensor group as well (the world mean times the tensor count). An
fsdp chunk's gradient arrives summed over the fsdp group (the reduce-scatter
of `parallel/fsdp.py`'s gather); it is averaged over the data group and
divided by the fsdp count. The global norm sums the shards' squares over
their groups (trainer/optim.py).

Under an active pipeline plan (`parallel/pipeline.py`) the (G, B, ...)
micro axis is folded into one forward of G B rows (`fold_micro_axis`, the
JAX step's `_fold_micro_axis`): the stage schedule streams the plan's
microbatches, so the accumulation loop, which would fill and drain the
pipeline once a micro-step, goes; mixing and the MAE tube mask then draw
once per effective batch (micro-step 0's draw). The trunk blocks'
gradients, each non-zero only on its owner stage, are among the partial
ones above: summed over the stage group (the tensor group), and nothing
else is.

Batch convention: dict with "video" (single-pathway) or "slow"/"fast"
(SlowFast packing), each clip NDHWC, "label" int, optional "mask" float32
(1.0 = real sample, 0.0 = padding). With gradient accumulation G > 1 every
leaf carries a leading (G, B, ...) micro-step axis. `debug_asserts` (the
Trainer's `--debug_asserts`) holds each step's batch to that contract
before anything runs (`assert_batch_contract`, the JAX step's checks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from pytorchvideo_accelerate_tpu_torch.models.common import SeededDropout
from pytorchvideo_accelerate_tpu_torch.parallel.collectives import (
    all_reduce_mean_,
    exchange,
)
from pytorchvideo_accelerate_tpu_torch.parallel.distributed import (
    batch_count,
    batch_group,
    batch_index,
    data_count,
    data_group,
    fsdp_count,
    group_ranks,
    is_distributed,
    process_count,
    tensor_count,
)
from pytorchvideo_accelerate_tpu_torch.parallel.pipeline import is_active
from pytorchvideo_accelerate_tpu_torch.parallel.tensor_parallel import (
    FSDP,
    TP,
    param_kinds,
    partial_params,
)
from pytorchvideo_accelerate_tpu_torch.precision import f32_island
from pytorchvideo_accelerate_tpu_torch.trainer.optim import global_norm


def assert_batch_contract(batch: dict, leading_micro: bool = False) -> None:
    """The JAX step's batch contract (`assert_batch_contract`, its chex
    checks) in the port's layout: each clip (B, T, H, W, C), or with a view
    axis (B, V, T, H, W, C); "label" (B,) int32; "mask" (B,) float32; the
    clips, the label and the mask share the leading B; `leading_micro`
    (accumulation): one more leading (G,) axis on every leaf. Raises
    AssertionError."""
    lead = 2 if leading_micro else 1
    clips = [batch[k] for k in ("slow", "fast", "video") if k in batch]
    assert clips, "batch has neither 'video' nor 'slow'/'fast' clips"
    for c in clips:
        assert c.dim() in (4 + lead, 5 + lead), (
            f"clip of shape {tuple(c.shape)}: expected rank {4 + lead} or "
            f"{5 + lead}")
    prefix = tuple(clips[0].shape[:lead])
    if "label" in batch:
        label = batch["label"]
        assert label.dim() == lead, (
            f"label of shape {tuple(label.shape)}: expected rank {lead}")
        assert label.dtype == torch.int32, f"label dtype {label.dtype}, expected int32"
        assert tuple(label.shape[:lead]) == prefix, (
            f"label leading dims {tuple(label.shape[:lead])} != the clips' {prefix}")
    if batch.get("mask") is not None:
        mask = batch["mask"]
        assert mask.dtype == torch.float32, f"mask dtype {mask.dtype}, expected float32"
        assert tuple(mask.shape[:lead]) == prefix, (
            f"mask leading dims {tuple(mask.shape[:lead])} != the clips' {prefix}")


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


def _optimizer_tensors(optimizer) -> dict:
    """{(param index, state key): tensor} over the torch optimizer's state
    (SGD momentum buffers; AdamW moments and step counts)."""
    out = {}
    for i, p in enumerate(optimizer.trained):
        for key, v in optimizer.opt.state.get(p, {}).items():
            if torch.is_tensor(v):
                out[i, key] = v
    return out


class _Snapshot:
    """The step's state leaves, copied before it into one flat buffer per
    (dtype, device) and put back after it where `ok` is false: a foreach
    copy in, then a foreach copy out into a second flat buffer, one select
    of the two and a foreach copy back. The buffers are allocated again only
    when the leaves' shapes change (the first update creates the
    optimizer's state)."""

    def __init__(self):
        self._shapes = None
        self._groups = []
        self._old = []  # leaf index -> its view in the "before" buffer

    def take(self, leaves: List[torch.Tensor]) -> None:
        shapes = [(t.dtype, t.device, t.shape) for t in leaves]
        if shapes != self._shapes:
            self._shapes, self._groups = shapes, []
            self._old = [None] * len(leaves)
            by_kind = {}
            for i, t in enumerate(leaves):
                by_kind.setdefault((t.dtype, t.device), []).append(i)
            for (dtype, device), idx in by_kind.items():
                sizes = [leaves[i].numel() for i in idx]
                flat = [torch.empty(sum(sizes), dtype=dtype, device=device)
                        for _ in range(2)]
                views = [[v.view(leaves[i].shape)
                          for v, i in zip(f.split(sizes), idx)] for f in flat]
                self._groups.append((idx, flat, views))
                for i, v in zip(idx, views[0]):
                    self._old[i] = v
        for idx, _, (old, _) in self._groups:
            torch._foreach_copy_(old, [leaves[i] for i in idx])

    def before(self, count: int) -> List[torch.Tensor]:
        """The copies of the first `count` leaves, as `take` found them."""
        return self._old[:count]

    def restore(self, ok: torch.Tensor, leaves: List[torch.Tensor]) -> None:
        """leaves <- where(ok, leaves, snapshot): a select, not an ok * new
        + (1 - ok) * old blend, since 0 * NaN is NaN."""
        for idx, (old, new), (_, new_views) in self._groups:
            live = [leaves[i] for i in idx]
            torch._foreach_copy_(new_views, live)
            torch.where(ok, new, old, out=new)
            torch._foreach_copy_(live, new_views)


def fold_micro_axis(batch: dict) -> dict:
    """Every (G, B, ...) leaf of `batch` as (G B, ...)."""
    return {k: v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))
            for k, v in batch.items()}


def _make_update_step(model, optimizer, forward_loss: Callable,
                      accum_steps: int, ema_decay: float,
                      dropout_seed: Optional[int], with_accuracy: bool,
                      guard_skip: bool = False,
                      health_metrics: bool = False, pipeline=None,
                      debug_asserts: bool = False) -> Callable:
    """The optimizer step shared by the supervised and the MAE objective:
    `forward_loss(micro_batch, step, micro) -> (loss, correct, count)` per
    micro-batch in order, backward each, the summed grads divided by
    `accum_steps`, then the update (clip inside `optimizer.step`) and the
    EMA. Every `SeededDropout` of the model (head dropout, drop path) is
    reseeded at every step from (dropout_seed, step), each module on a
    stream of its own.

    `guard_skip`: when the loss or the gradient norm is not finite, the
    step keeps every old leaf (parameters, the BN running averages, which
    the forward updates and so are snapshot before the first micro-batch,
    the optimizer's state, the EMA) and advances only `state.step`; the
    metrics gain `skipped`, a device scalar (1.0 = skipped). The decision
    stays on the device (`_Snapshot`). Optimizer state that the skipped
    step created (the first step's momentum) is reset to zeros, which the
    next update treats exactly as absent state. Off, none of this runs.

    With a process group up, the averaged gradient is averaged again over
    the ranks (one flat all-reduce), and the loss, the hit count and the
    count are the ranks' mean, sum and sum (one small all-reduce), all
    before anything reads them; a nonfinite value on one rank is then
    nonfinite on every rank, which skips the step everywhere.

    `health_metrics` (the JAX step's, on with the obs layer): the metrics
    gain `param_norm` (the global norm of the parameters after the step),
    `update_ratio` (the global norm of the update, new - old, over
    max(param_norm, 1e-12)) and `nonfinite` (1 - isfinite(loss)), device
    scalars read with the others, never synced here. The update is the
    difference from a copy taken before the step: the guard's snapshot when
    `guard_skip` holds one, else a copy of the parameters of its own. Both
    norms sum shards' squares over their groups (`global_norm`), so every
    rank reads the same values; under `guard_skip` a skipped step reports
    the update it discarded and the parameters it kept, as the JAX step
    does.

    `pipeline` (an active `PipelinePlan`): the micro axis is folded into
    one forward (`fold_micro_axis`; the module docstring). `debug_asserts`:
    `assert_batch_contract` on each step's batch, before anything else."""
    named = dict(model.named_parameters())
    names = [n for n, p in named.items() if p.requires_grad]
    params = [named[n] for n in names]
    kinds, partial = param_kinds(model), set(partial_params(model))
    dropouts = [m for m in model.modules() if isinstance(m, SeededDropout)]
    buffers = [b for b in model.buffers() if b.is_floating_point()]
    snapshot = _Snapshot() if guard_skip else None
    # the parameters before the step, for the update's norm
    before = (snapshot if guard_skip else _Snapshot()) if health_metrics else None
    param_kinds_ = [kinds[n] for n in names]
    distributed = is_distributed()
    fold = is_active(pipeline) and accum_steps > 1
    micro_steps = 1 if fold else accum_steps

    def leaves(state, opt_keys):
        opt = _optimizer_tensors(optimizer)
        ema = list(state.ema.values()) if state.ema is not None else []
        return ([p.detach() for p in params] + buffers
                + [opt[k] for k in opt_keys] + ema)

    def step(state, batch: dict) -> dict:
        if debug_asserts:
            assert_batch_contract(batch, leading_micro=accum_steps > 1)
        model.train()
        if dropout_seed is not None:
            base = dropout_seed * 1_000_003 + state.step
            for i, d in enumerate(dropouts):
                d.reseed((base + i * 0x9E3779B97F4A7C15) % 2 ** 63)
        for p in params:
            p.grad = None
        if guard_skip:
            # before the first micro-batch: the forward moves the BN
            # running averages
            opt_keys = list(_optimizer_tensors(optimizer))
            snapshot.take(leaves(state, opt_keys))
        elif before is not None:
            before.take([p.detach() for p in params])
        losses, corrects, counts = [], [], []
        if fold:
            batch = fold_micro_axis(batch)
        for i in range(micro_steps):
            mb = batch if micro_steps == 1 else {k: v[i] for k, v in batch.items()}
            loss, correct, count = forward_loss(mb, state.step, i)
            loss.backward()
            losses.append(loss.detach())
            corrects.append(correct)
            counts.append(count)
        live = [(n, p.grad) for n, p in zip(names, params) if p.grad is not None]
        grads = [g for _, g in live]
        if micro_steps > 1:
            torch._foreach_div_(grads, float(micro_steps))
        loss = torch.stack(losses).mean()
        if with_accuracy:
            correct, count = torch.stack(corrects).sum(), torch.stack(counts).sum()
        if distributed:
            reduce_grads(live, kinds, partial)
            # [loss, correct, count]: their means over the batch shards,
            # then the sums scaled back
            sums = torch.stack([loss, correct.float(), count.float()]
                               if with_accuracy else [loss])
            all_reduce_mean_([sums], group=batch_group())
            loss = sums[0]
            if with_accuracy:
                slices = float(batch_count())
                correct, count = sums[1] * slices, sums[2] * slices
        grad_norm = global_norm(grads, [kinds[n] for n, _ in live])
        lr = optimizer.schedule(state.step)
        optimizer.step(state.step)
        if ema_decay > 0 and state.ema is not None:
            ema = list(state.ema.values())
            live = [named[k].detach() for k in state.ema]
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, live, alpha=1.0 - ema_decay)
        out = {"loss": loss, "grad_norm": grad_norm, "lr": lr}
        if health_metrics:
            with torch.no_grad():
                update = torch._foreach_sub([p.detach() for p in params],
                                            before.before(len(params)))
            update_norm = global_norm(update, param_kinds_)
            del update
        if guard_skip:
            ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
            with torch.no_grad():
                snapshot.restore(ok, leaves(state, opt_keys))
                for k, v in _optimizer_tensors(optimizer).items():
                    if k not in opt_keys:  # created by this update
                        v.copy_(torch.where(ok, v, torch.zeros_like(v)))
            out["skipped"] = 1.0 - ok.float()
        if health_metrics:
            param_norm = global_norm([p.detach() for p in params], param_kinds_)
            out["param_norm"] = param_norm
            out["update_ratio"] = update_norm / torch.clamp_min(param_norm, 1e-12)
            out["nonfinite"] = 1.0 - torch.isfinite(loss).float()
        state.step += 1
        if with_accuracy:
            out["accuracy"] = correct / torch.clamp_min(count, 1.0)
        return out

    return step


def reduce_grads(live, kinds, partial) -> None:
    """In place, the gradients `live` ([(name, grad)]) averaged as the step
    needs (the module docstring), by `kinds` ({name: `TP` / `FSDP` bits})
    and the `partial` names: with one rank of each shard (the data-parallel
    layout) one flat all-reduce of them all over the world; else the
    replicated ones over the world (the `partial` ones then times the
    tensor count), the tensor shards over the batch group, and the fsdp
    chunks (already summed over the fsdp group) over the data group, then
    divided by the fsdp count."""
    if batch_count() == process_count() and fsdp_count() == 1:
        all_reduce_mean_([g for _, g in live])
        return
    all_reduce_mean_([g for n, g in live if not kinds.get(n)])
    part = [g for n, g in live if n in partial]
    if part:
        torch._foreach_mul_(part, float(tensor_count()))
    shards = [g for n, g in live if kinds.get(n) == TP]
    if shards and batch_count() > 1:
        all_reduce_mean_(shards, group=batch_group())
    chunks = [g for n, g in live if kinds.get(n, 0) & FSDP]
    if chunks:
        if data_count() > 1:
            all_reduce_mean_(chunks, group=data_group())
        torch._foreach_div_(chunks, float(fsdp_count()))


@dataclass(frozen=True)
class MixDraw:
    """The host scalars of one micro-step's mix: cutmix or mixup, its
    lambda, and the cutmix box centre as fractions of H and W in [0, 1)."""

    use_cutmix: bool
    lam: float
    cy: float = 0.5
    cx: float = 0.5


def mix_draw(seed: int, step: int, micro: int, mixup_alpha: float,
             cutmix_alpha: float) -> MixDraw:
    """The draw of micro-step `micro` of optimizer step `step`, from numpy
    streams keyed by (seed, step, micro) (the host draws, so a seed gives
    one mix on every device and the card is never synced). Both alphas on:
    a fair coin picks cutmix per micro-batch; lambda ~ Beta(a, a) of the
    mode picked, from one stream whichever it is (the JAX package draws
    both lambdas from one key); the box centre uniform."""
    key = (seed, 0x313C, step, micro)
    coin = np.random.default_rng(key + (0,)).random() < 0.5
    use_cutmix = cutmix_alpha > 0 and (mixup_alpha <= 0 or bool(coin))
    alpha = cutmix_alpha if use_cutmix else mixup_alpha
    lam = float(np.random.default_rng(key + (1,)).beta(alpha, alpha))
    cy, cx = np.random.default_rng(key + (2,)).random(2)
    return MixDraw(use_cutmix, lam, float(cy), float(cx))


def mix_weight(draw: MixDraw, hh: int, ww: int, device) -> torch.Tensor:
    """The per-pixel weight w (H, W) of the clip against its flipped pair,
    in f32 on `device`: lambda everywhere (mixup), or 1 with a box of zeros
    (cutmix) of half-sizes sqrt(1 - lam) * H / 2 and sqrt(1 - lam) * W / 2
    around the drawn centre, clipped only by the grid. The box's edges are
    the JAX package's f32 formula, on the host: the device gets scalars,
    never a copy."""
    if not draw.use_cutmix:
        return torch.full((hh, ww), draw.lam, dtype=torch.float32, device=device)
    f32 = np.float32
    side = np.sqrt(f32(1.0) - f32(draw.lam))
    rh, rw = side * f32(hh), side * f32(ww)
    cy, cx = f32(draw.cy) * f32(hh), f32(draw.cx) * f32(ww)
    y0, y1 = float(cy - rh / f32(2)), float(cy + rh / f32(2))
    x0, x1 = float(cx - rw / f32(2)), float(cx + rw / f32(2))
    ih = torch.arange(hh, dtype=torch.float32, device=device)[:, None]
    iw = torch.arange(ww, dtype=torch.float32, device=device)[None, :]
    inside = (ih >= y0) & (ih < y1) & (iw >= x0) & (iw < x1)
    return 1.0 - inside.to(torch.float32)


def flip_global(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global batch flipped, x_global[::-1] (the
    JAX step flips the whole batch, pairing row i with row G - 1 - i):
    batch shard s's partners are shard (S - 1 - s)'s rows, reversed, from
    the peer in this rank's batch group. `x.flip(0)` with one process."""
    if not is_distributed() or batch_count() == 1:
        return x.flip(0)
    group = batch_group()
    peer = group_ranks(group)[batch_count() - 1 - batch_index()]
    return exchange(x, peer, group).flip(0)


def mix_batch(batch: dict, w_hw: torch.Tensor) -> dict:
    """Every clip pathway (video, or slow and fast) mixed with its flipped
    batch, out = w * x + (1 - w) * x[::-1] in f32, cast back (the global
    batch's flip under data parallelism, `flip_global`); the labels stay
    (the loss pairs them with the flipped ones)."""
    w = w_hw[None, None, :, :, None]  # (1, 1, H, W, 1) against NDHWC
    out = dict(batch)
    for k in ("video", "slow", "fast"):
        if k in out:
            x = out[k]
            x32 = f32_island(x)
            out[k] = (w * x32 + (1.0 - w) * flip_global(x32)).to(x.dtype)
    return out


def mixed_loss(logits, labels, lam: torch.Tensor, mask,
               label_smoothing: float):
    """The loss of a batch mixed with its flipped self, lam * CE(y) + (1 -
    lam) * CE(y[::-1]) (the mask flipped with the labels), and the hit
    count of the dominant label: `(loss, correct, count)`. `lam` is the
    device scalar mean(w)."""
    loss_a, correct_a, count = _loss_and_metrics(
        logits, labels, mask, label_smoothing)
    loss_b, correct_b, _ = _loss_and_metrics(
        logits, flip_global(labels), flip_global(mask), label_smoothing)
    loss = lam * loss_a + (1.0 - lam) * loss_b
    return loss, torch.where(lam >= 0.5, correct_a, correct_b), count


def make_train_step(model, optimizer, accum_steps: int = 1,
                    label_smoothing: float = 0.0, device_normalize=None,
                    ema_decay: float = 0.0,
                    dropout_seed: Optional[int] = None,
                    mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0,
                    guard_skip: bool = False,
                    health_metrics: bool = False, pipeline=None,
                    debug_asserts: bool = False) -> Callable:
    """Build `step(state, batch) -> metrics`. One call is one optimizer
    step: forward + backward per micro-batch in order (the BN running
    averages thread through them), the summed grads divided by
    `accum_steps`, then the update and the EMA. `metrics`: "loss" (mean over
    micro-steps), "grad_norm" (global norm of the averaged grads, before
    clipping), "accuracy" (device scalars) and "lr" (the schedule at the
    step before the update, a float). `dropout_seed`: every `SeededDropout`
    of the model (each head's dropout) is reseeded from (seed, step) at
    every step; it also seeds the mix draws.

    `mixup_alpha > 0` / `cutmix_alpha > 0` (the MViT and SlowFast K400
    recipes' augmentation, the JAX package's semantics): after the device
    normalize, each micro-batch is mixed with its flipped self through
    `mix_weight(mix_draw(seed, step, micro, ...))`; the loss is lam_eff *
    CE(y) + (1 - lam_eff) * CE(y[::-1]) with lam_eff = mean(w), and the
    accuracy counts the dominant label. `guard_skip`, `health_metrics`,
    `pipeline`, `debug_asserts`: see `_make_update_step`."""
    mixing = mixup_alpha > 0 or cutmix_alpha > 0
    seed = dropout_seed or 0

    def forward_loss(batch: dict, step: int, micro: int):
        batch = device_normalize_batch(batch, device_normalize)
        if not mixing:
            logits = model(model_inputs(batch))
            return _loss_and_metrics(logits, batch["label"], _mask_of(batch),
                                     label_smoothing)
        if batch.get("mask") is not None:
            raise ValueError(
                "mixup/cutmix with an explicit batch mask is "
                "unsupported: padded rows would mix into real clips "
                "(the train loader is drop_last, so this can't arise "
                "through Trainer)")
        clip = next(batch[k] for k in ("video", "slow", "fast") if k in batch)
        w_hw = mix_weight(mix_draw(seed, step, micro, mixup_alpha,
                                   cutmix_alpha),
                          clip.shape[-3], clip.shape[-2], clip.device)
        batch = mix_batch(batch, w_hw)
        logits = model(model_inputs(batch))
        # all-ones mask: no explicit mask gets here
        return mixed_loss(logits, batch["label"], w_hw.mean(),
                          _mask_of(batch), label_smoothing)

    return _make_update_step(model, optimizer, forward_loss, accum_steps,
                             ema_decay, dropout_seed, with_accuracy=True,
                             guard_skip=guard_skip, health_metrics=health_metrics,
                             pipeline=pipeline, debug_asserts=debug_asserts)


def mask_generator(seed: int, step: int, micro: int) -> torch.Generator:
    """The tube-mask generator of one pretraining micro-step (CPU: the
    mask is drawn on the host, so a seed gives one mask on every device)."""
    return torch.Generator().manual_seed(
        (seed * 1_000_003 + step) * 1_009 + micro)


def make_pretrain_step(model, optimizer, accum_steps: int = 1,
                       ema_decay: float = 0.0, seed: int = 0,
                       guard_skip: bool = False,
                       health_metrics: bool = False, pipeline=None,
                       debug_asserts: bool = False) -> Callable:
    """Build the VideoMAE self-supervised step `step(state, batch) ->
    metrics` (JAX `make_pretrain_step`): no labels, the model returns its
    own reconstruction loss under a tube mask drawn from
    `mask_generator(seed, step, micro)`; the same accumulation, clip, EMA,
    `guard_skip`, `health_metrics`, `pipeline` and `debug_asserts` as
    `make_train_step` (folded, one mask of micro-step 0 for the effective
    batch). `metrics`:
    "loss", "grad_norm", "lr" (and "skipped" under `guard_skip`, the three
    gauges under `health_metrics`)."""

    def forward_loss(batch: dict, step: int, micro: int):
        out = model(batch["video"], generator=mask_generator(seed, step, micro))
        zero = torch.zeros((), device=out["loss"].device)
        return out["loss"], zero, zero

    return _make_update_step(model, optimizer, forward_loss, accum_steps,
                             ema_decay, seed, with_accuracy=False,
                             guard_skip=guard_skip, health_metrics=health_metrics,
                             pipeline=pipeline, debug_asserts=debug_asserts)


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
