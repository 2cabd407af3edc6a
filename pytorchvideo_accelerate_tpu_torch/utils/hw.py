"""Peak numbers for utilization reporting (the port's copy of the JAX
package's `utils/hw.py`, for NVIDIA cards): the Trainer's `mfu`.

`peak_tflops` is the dense bf16 tensor-core peak of one card by the name
`torch.cuda.get_device_name` gives, from NVIDIA's data sheets; None for
the CPU and for a card the table does not know, and the caller then
leaves the MFU key out rather than report nonsense.

`resolve_peak` adds the measured fallback: where no data-sheet number
exists it calibrates an achievable matmul rate once per process and
reports MFU against THAT, labelled `measured`, so a reader never mistakes
it for a fraction of a data-sheet peak.

`count_step_flops` is the numerator: one training step's FLOPs, counted
with `torch.utils.flop_counter` on `meta` tensors (its docstring says why
there, and what it counts).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

# (substring of the card's name, dense bf16 TFLOP/s), most specific first
_PEAK_TFLOPS = [
    ("h100 pcie", 756.0),
    ("h100 nvl", 835.0),
    ("h100", 989.4),    # SXM5; "NVIDIA H100 80GB HBM3"
    ("h200", 989.4),
    ("gh200", 989.4),
    ("a100", 312.0),
]

_MEASURED: dict = {}  # card name -> measured peak (once per process)


def _name(device) -> Optional[str]:
    import torch

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def peak_tflops(device) -> Optional[float]:
    """Dense bf16 peak TFLOP/s of one card, or None (the CPU, or a card
    the table does not know)."""
    name = _name(device)
    if name is None:
        return None
    kind = name.lower()
    for key, tf in _PEAK_TFLOPS:
        if key in kind:
            return tf
    return None


def measured_peak_tflops(device, n: int = 512, reps: int = 3,
                         min_probe_s: float = 0.01, max_n: int = 4096,
                         ) -> Optional[float]:
    """Best-of-`reps` f32 `n`x`n` matmul rate on `device`, TFLOP/s: the
    measured stand-in for a missing data-sheet peak, cached per device
    (one short calibration per process). None when the probe itself
    fails. `n` doubles (to `max_n`) until one timed run takes at least
    `min_probe_s`, so the probe measures throughput, not launch
    latency."""
    import torch

    device = torch.device(device)
    key = (device.type, _name(device) or "cpu")
    if key in _MEASURED:
        return _MEASURED[key]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    try:
        def one_run(size: int, i: int) -> float:
            a = torch.ones((size, size), dtype=torch.float32, device=device)
            (a @ a).sum().item()  # warm for this size
            b = a * float(i + 1)  # fresh operand: no result caching
            sync()
            t0 = time.perf_counter()
            b @ b
            sync()
            return time.perf_counter() - t0

        dt = one_run(n, 0)
        while dt < min_probe_s and n < max_n:
            n *= 2
            dt = one_run(n, 0)
        best = 2.0 * n * n * n / max(dt, 1e-9) / 1e12
        for i in range(1, reps):
            dt = one_run(n, i)
            best = max(best, 2.0 * n * n * n / max(dt, 1e-9) / 1e12)
        _MEASURED[key] = best
    except Exception:
        _MEASURED[key] = None
    return _MEASURED[key]


def resolve_peak(device) -> Tuple[Optional[float], str]:
    """(peak TFLOP/s, source): the data-sheet number when one exists
    ("datasheet"), else a per-process measured matmul calibration
    ("measured"), else (None, "none"). An MFU carries its source label: a
    measured-peak MFU is a utilization proxy, never comparable to a
    fraction of a data-sheet peak."""
    peak = peak_tflops(device)
    if peak:
        return peak, "datasheet"
    peak = measured_peak_tflops(device)
    if peak:
        return peak, "measured"
    return None, "none"


def _valid_taps(size: int, k: int, stride: int, pad: int, dil: int,
                out: int) -> int:
    """The (output position, tap) pairs of one conv dimension whose input
    index lies inside the input: the taps that multiply real values."""
    return sum(1 for o in range(out) for t in range(k)
               if 0 <= o * stride - pad + t * dil < size)


def _conv_valid_flops(x_shape, w_shape, stride, padding, dilation,
                      out_shape) -> int:
    """2 x the multiplies of a (non-transposed) convolution that touch the
    input, its zero padding left out, as XLA's cost model counts a
    convolution (torch's own formula counts every tap)."""
    taps = 1
    for d in range(len(w_shape) - 2):
        taps *= _valid_taps(x_shape[2 + d], w_shape[2 + d], stride[d],
                            padding[d], dilation[d], out_shape[2 + d])
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


def _conv_flop(x_shape, w_shape, _bias, stride, padding, dilation,
               transposed, *args, out_shape=None, **kwargs) -> int:
    from torch.utils.flop_counter import conv_flop_count

    if transposed:
        return conv_flop_count(x_shape, w_shape, out_shape, transposed=True)
    return _conv_valid_flops(x_shape, w_shape, stride, padding, dilation,
                             out_shape)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, stride,
                        padding, dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None,
                        **kwargs) -> int:
    """dx and dw of a convolution each take the forward's multiplies: every
    valid (output, tap) pair once."""
    from torch.utils.flop_counter import conv_backward_flop

    if transposed:
        return conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias,
                                  stride, padding, dilation, transposed,
                                  _output_padding, _groups, output_mask,
                                  out_shape)
    fwd = _conv_valid_flops(x_shape, w_shape, stride, padding, dilation,
                            grad_out_shape)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


# elementwise arithmetic: one FLOP per output element, reductions one per
# input element (XLA's cost model counts them so; transcendentals, which it
# counts apart, and data movement are left out)
_POINTWISE_OPS = ("add", "add_", "sub", "sub_", "mul", "mul_", "div", "div_",
                  "neg", "clamp", "clamp_min", "clamp_max", "maximum",
                  "minimum", "where", "ge", "gt", "le", "lt", "eq", "ne",
                  "relu", "threshold_backward", "abs", "pow", "square",
                  "reciprocal", "addcmul", "addcmul_", "addcdiv_", "lerp",
                  "lerp_")
# in place over lists of tensors (the optimizer, the norms): one per element
_FOREACH_OPS = ("_foreach_add", "_foreach_add_", "_foreach_mul",
                "_foreach_mul_", "_foreach_div_", "_foreach_sub",
                "_foreach_addcmul_", "_foreach_addcdiv_", "_foreach_lerp_",
                "_foreach_norm")
_REDUCTION_OPS = ("sum", "mean", "amax", "amin", "var", "var_mean",
                  "_log_softmax", "_log_softmax_backward_data", "argmax",
                  "max_pool3d_with_indices",
                  "max_pool3d_with_indices_backward")


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _shapes(tree):
    """The shapes (int sequences) inside a tree of shapes."""
    if isinstance(tree, (list, tuple)) and tree and isinstance(
            tree[0], (list, tuple)):
        for t in tree:
            yield from _shapes(t)
    elif isinstance(tree, (list, tuple)) and all(
            isinstance(d, int) for d in tree):
        yield tree


def _pointwise_flop(*args, out_shape=None, **kwargs) -> int:
    return sum(_numel(s) for s in _shapes(out_shape))


def _reduction_flop(x_shape, *args, out_shape=None, **kwargs) -> int:
    return sum(_numel(s) for s in _shapes(x_shape))



# count_step_flops per (config, batch shapes): a process that fits one
# configuration again (a resume, the smoke's phases) counts it once
_STEP_FLOPS: Dict[tuple, float] = {}


def count_step_flops(cfg, batch: dict, *, pretraining: bool,
                     device_normalize=None, shards: int = 1) -> float:
    """The FLOPs of one optimizer step over the global batch: the forward
    and backward of every micro-batch of `batch` (this rank's, its micro
    axis folded) times `shards`, the batch shards of the global batch,
    then the gradient norm and one steady update of the optimizer.
    `torch.utils.flop_counter.FlopCounterMode` counts matmuls,
    convolutions and attention, and here also elementwise arithmetic and
    reductions, as XLA's cost model behind the JAX Trainer's `mfu` does. A
    convolution counts only the taps that land inside its input, as XLA's
    does: multiplies by padding are no model work.

    The count runs on `meta` tensors, through a copy of the model built
    there, so it costs the card nothing and takes the plain route of every
    kernel (`_use_kernel` launches a kernel only for a CUDA tensor; a
    `fused_kernels pallas` model is counted as `auto`, a ring or Ulysses
    attention as `dense`: the whole model, every token). That is on purpose:
    a hand kernel is an opaque `autograd.Function` call into ctypes-loaded
    CUDA that `FlopCounterMode` cannot see, so counting the kernel route
    would leave the fused GEMMs and the flash attention out entirely. The
    plain route computes the same function through the same custom
    backward, so the count is the same whatever implements the kernels."""
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.models.common import SeededDropout
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import (
        build_optimizer,
        global_norm,
    )
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
        _loss_and_metrics,
        _mask_of,
        device_normalize_batch,
        fold_micro_axis,
        mask_generator,
        model_inputs,
    )

    key = (repr(cfg.model), cfg.mixed_precision, repr(cfg.data), repr(cfg.optim),
           pretraining, repr(device_normalize), shards,
           tuple((k, tuple(v.shape), str(v.dtype)) for k, v in sorted(batch.items())
                 if torch.is_tensor(v)))
    if key in _STEP_FLOPS:
        return _STEP_FLOPS[key]
    aten = torch.ops.aten
    mcfg = cfg.model
    if mcfg.fused_kernels == "pallas":
        mcfg = dataclasses.replace(mcfg, fused_kernels="auto")
    if mcfg.attention in ("ring", "ulysses"):
        # context parallelism splits one attention's tokens over the
        # context group; the whole model on one host computes all of them
        mcfg = dataclasses.replace(mcfg, attention="dense")
    with torch.device("meta"):
        model = create_model(mcfg, cfg.mixed_precision, data_cfg=cfg.data,
                             init=False)
    model.train()
    for m in model.modules():
        # a mask's generator has no meta form, and a mask costs no FLOPs
        if isinstance(m, SeededDropout):
            m.eval()
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch.items() if torch.is_tensor(v)}
    if cfg.optim.gradient_accumulation_steps > 1:
        meta = fold_micro_axis(meta)
    mapping = {getattr(aten, n): _pointwise_flop for n in _POINTWISE_OPS}
    mapping.update({getattr(aten, n): _reduction_flop for n in _REDUCTION_OPS})
    mapping.update({getattr(aten, n): _reduction_flop for n in _FOREACH_OPS})
    mapping.update({aten.convolution: _conv_flop,
                    aten.convolution_backward: _conv_backward_flop})
    counter = FlopCounterMode(display=False, custom_mapping=mapping)
    with counter:
        if pretraining:
            loss = model(meta["video"],
                         generator=mask_generator(cfg.seed, 0, 0))["loss"]
        else:
            meta = device_normalize_batch(meta, device_normalize)
            loss = _loss_and_metrics(model(model_inputs(meta)), meta["label"],
                                     _mask_of(meta), 0.0)[0]
        loss.backward()
    flops = counter.get_total_flops() * shards
    # the update once its state exists (the first one only creates it)
    optimizer = build_optimizer(
        cfg.optim, 2, model.named_parameters(),
        backbone_filter=getattr(type(model), "backbone_param_filter", None),
        freeze_backbone=cfg.model.freeze_backbone)
    optimizer.step(0)
    with counter:
        global_norm([p.grad for p in optimizer.trained if p.grad is not None])
        optimizer.step(1)
    _STEP_FLOPS[key] = float(flops + counter.get_total_flops())
    return _STEP_FLOPS[key]
