#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: serve and train full-width SlowFast-R50
on one GPU.

    python3 chip_smoke.py            # from the repo root, on a CUDA machine

Drives the port only (no JAX), one JSON line per phase:

1. device   the card, and its name and power limit from nvidia-smi
2. build    both fused kernels compiled from ops/csrc with nvcc
3. weights  seeded SlowFast-R50 weights (K700 head), BN running stats
            calibrated to the real batch statistics, head classes 0-4
            planted on the 5 request clips (`plant_head`), written as an
            inference artifact with the port's `export_inference`
4. kernels  every fused site of one bucket-8 forward: the CUDA kernel held
            against its plain PyTorch version on the same bf16 inputs, and
            kernel / plain / library (cuDNN or cuBLAS + bias + act) device
            times from torch.profiler; then the same for the backward's dx
            launch of the kernel (the transposed stencil on a bf16 dz;
            library: `dz @ wf^T`, `torch.nn.grad.conv3d_input`)
5. serve    the port's HTTP server (`build_server`, micro scheduler) answers
            5 /predict requests (4 concurrent, then 1); the launch counters,
            zeroed just before, must show 41 pointwise and 51 conv launches
            per forward; logits must agree with the plain path
6. timing   bucket-8 forward with the kernels, the plain path and unfused
7. profile  device time per forward by kernel class, device busy share
8. train    `run.main` trains on the reference recipe's geometry (B=8 x
            accumulation 4, 32 frames at 256^2, bf16) for 4 steps; the
            counters, zeroed just before fit(), must show one forward and
            one dx launch per fused site per micro-step plus one forward
            per eval forward; the step-2 checkpoint restores bitwise; the
            exported artifact serves the trainer's logits
9. train_parity  one B=8 micro-step through the kernels against plain
            PyTorch (`train_parity_phase`)
10. train_timing  ms per micro-step through the kernels, unfused and
            plain; peak memory; a profiled micro-step

Then the kernels' JSON line (its ms, plain_ms, library_ms and bound_ms are
summed over the kernel's launches in one bucket-8 forward, for a dx row
over the dx launches of one B=8 micro-step; launches are the serve
phase's, for a dx row the train phase's), the nvidia-smi line, and as the
last line
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result. It exits non-zero at once without CUDA.

Tolerances. Kernel vs plain version: both multiply bf16 operands exactly,
sum in f32 and round once to bf16, so elementwise
|kernel - plain| <= 1e-2 * (1 + |plain|). Served logits vs the plain path:
every layer rounds to bf16 (relative 2^-9) in a different summation order,
compounded over ~50 layers: |served - plain| <= 5e-2 * (1 + |plain|), and
top-1 must agree wherever the plain top-1 margin exceeds 2 * 5e-2 * (1 +
|top logit|). The training loss, the head's gradient, and (with the
forward held fixed) the whole gradient and one SGD update: within 5e-2
(the gradients relative in the 2-norm).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
NUM_CLASSES = 700
FRAMES, CROP, ALPHA, BUCKET = 32, 256, 4, 8
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = 1e-2
LOGIT_TOL = 5e-2
PLANTED_LOGIT = 6.0
PW_PER_FORWARD, CONV_PER_FORWARD = 41, 51
SITES_PER_FORWARD = {"fused_pw_bn_act": PW_PER_FORWARD,
                     "fused_conv_bn_act": CONV_PER_FORWARD}
# the train phase: run.main on the reference recipe's geometry
TRAIN_BATCH, ACCUM, EPOCHS, TRAIN_VIDEOS, CKPT_EVERY = 8, 4, 2, 64, 2
BASE_LR = 0.1  # OptimConfig default, cosine to 0 over the run, no warmup
# main-path sites reported by name: module path -> label
NAMED_SITES = {
    "slow_res2.block1.conv_c": "slow res2 conv_c 64->256",
    "fast_res2.block0.branch1": "fast res2 branch1 Cin=8",
    "slow_res2.block1.conv_b": "slow res2 conv_b (1,3,3) 64->64",
    "fast_res2.block0.conv_a": "fast res2 conv_a (3,1,1) 8->8",
    "slow_res5.block1.conv_b": "slow res5 conv_b (1,3,3) 512->512",
    "slow_res4.block1.conv_a": "slow res4 conv_a (3,1,1) 1024->256",
}
SOURCES = {
    "fused_pw_bn_act": ("pytorchvideo_accelerate_tpu_torch/ops/csrc/fused_pw_bn_act.cu",
                        "pytorchvideo_accelerate_tpu/ops/pallas_fused.py:123"),
    "fused_conv_bn_act": ("pytorchvideo_accelerate_tpu_torch/ops/csrc/fused_conv_bn_act.cu",
                          "pytorchvideo_accelerate_tpu/ops/pallas_fused.py:183"),
    # the backward's dx launch of each kernel (ops/fused.py PwBnAct and
    # ConvBnAct), the port of the custom VJPs' dx pass
    "fused_pw_bn_act.bwd_dx": ("pytorchvideo_accelerate_tpu_torch/ops/csrc/fused_pw_bn_act.cu",
                               "pytorchvideo_accelerate_tpu/ops/pallas_fused.py:162"),
    "fused_conv_bn_act.bwd_dx": ("pytorchvideo_accelerate_tpu_torch/ops/csrc/fused_conv_bn_act.cu",
                                 "pytorchvideo_accelerate_tpu/ops/pallas_fused.py:252"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


EMPTY_PROFILES = [0]  # profiles that came back without device events
EVENT_TIMED = [0]  # device_ms calls timed with CUDA events instead


def device_events(torch, fn, reps: int, attempts: int = 5):
    """The device-side events (kernels, copies) of `reps` calls of `fn`,
    recorded by torch.profiler after one warm-up call. Now and then a
    profile on the card comes back with no device events at all; it is
    taken again, up to `attempts` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kev:
            return kev
        EMPTY_PROFILES[0] += 1
    return []


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one `fn()` call: the summed durations of the device
    work it launches, averaged over `reps` calls. Host launch overhead and
    the gaps between launches are left out. Should every profile come back
    empty, CUDA events around the `reps` calls time it instead (gaps
    included), and `EVENT_TIMED` counts it."""
    kev = device_events(torch, fn, reps)
    if kev:
        return sum(e.time_range.elapsed_us() for e in kev) / reps / 1e3
    EVENT_TIMED[0] += 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def serve_cfg(parse_cli, fused: str):
    return parse_cli([
        "--model.name", "slowfast_r50", "--model.num_classes", str(NUM_CLASSES),
        "--model.fused_kernels", fused, "--num_frames", str(FRAMES),
        "--data.crop_size", str(CROP), "--slowfast_alpha", str(ALPHA),
        "--data.host_cast", "u8", "--mixed_precision", "bf16",
        "--serve.max_batch_size", str(BUCKET)])


def seeded_state_dict(model, rng):
    """He-scaled conv weights, BN affine near identity, head std 1/sqrt(in)."""
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("conv.weight"):
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape, np.float32) * np.sqrt(2.0 / fan_in)
        elif name == "head.proj.weight":
            v = rng.standard_normal(shape, np.float32) / np.sqrt(shape[1])
        elif name.endswith("norm.weight"):
            v = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        elif name.endswith("norm.bias"):
            v = rng.standard_normal(shape, np.float32) * 0.05
        elif name == "head.proj.bias" or name.endswith("running_mean"):
            v = np.zeros(shape, np.float32)
        elif name.endswith("running_var"):
            v = np.ones(shape, np.float32)
        else:
            raise KeyError(f"no seeding rule for {name}")
        out[name] = v
    return out


def calibrate_bn(torch, model, clips, norm):
    """Set every BN's running stats to the batch statistics of its input on
    `clips` (one unfused bf16 forward), so activations stay O(1) through
    the ~50 layers and the logits are not all ~0."""
    from pytorchvideo_accelerate_tpu_torch.models.common import BNAffine
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
        device_normalize_batch,
    )

    def hook(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3, 4)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3, 4), unbiased=False))

    handles = [m.register_forward_pre_hook(hook)
               for m in model.modules() if isinstance(m, BNAffine)]
    try:
        with torch.inference_mode():
            b = device_normalize_batch(
                {k: torch.from_numpy(v).cuda() for k, v in clips.items()}, norm)
            model((b["slow"], b["fast"]))
    finally:
        for h in handles:
            h.remove()


def plant_head(torch, model, clips, norm, logit: float = PLANTED_LOGIT):
    """Plant head classes 0..n-1 on the n request clips: row i is clip i's
    pooled feature centred on the clips' mean, scaled so that clip i scores
    `logit` on class i (a nearest-mean classifier over the clips). The other
    rows stay random, so each request has an input-dependent top-1 with a
    margin the top-1 check can hold the served path to."""
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
        device_normalize_batch,
    )

    feats = []
    handle = model.head.proj.register_forward_pre_hook(
        lambda mod, args: feats.append(args[0].float().cpu().numpy()))
    try:
        with torch.inference_mode():
            b = device_normalize_batch(
                {k: torch.from_numpy(np.stack([c[k] for c in clips])).cuda()
                 for k in ("slow", "fast")}, norm)
            model((b["slow"], b["fast"]))
    finally:
        handle.remove()
    f = feats[0].astype(np.float64)
    mean = f.mean(axis=0)
    d = f - mean
    rows = logit * d / (d * d).sum(axis=1, keepdims=True)
    n = len(clips)
    with torch.no_grad():
        model.head.proj.weight[:n].copy_(torch.from_numpy(rows))
        model.head.proj.bias[:n].copy_(torch.from_numpy(-(rows @ mean)))


def record_sites(torch, model, run):
    """{module name: (NDHWC input shape, weight DHWIO shape, act)} of every
    fused ConvBNAct site that `run()` goes through."""
    from pytorchvideo_accelerate_tpu_torch.models.common import ConvBNAct

    sites = {}

    def make(name):
        def hook(mod, args):
            b, c, t, h, w = args[0].shape
            kt, kh, kw = mod.kernel
            sites[name] = ((b, t, h, w, c),
                           (kt, kh, kw, c, mod.conv.out_channels), mod.act)
        return hook

    handles = [m.register_forward_pre_hook(make(n))
               for n, m in model.named_modules()
               if isinstance(m, ConvBNAct) and m.fuse]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return sites


def act_(y, act: str):
    """The epilogue activation in place (the library yardstick's)."""
    import torch.nn.functional as F

    if act == "relu":
        return y.relu_()
    if act == "silu":
        return F.silu(y, inplace=True)
    return y


def inside_taps(k: int, n: int) -> int:
    """Taps of a stride-1 SAME window of odd width k over n positions that
    land inside the volume, summed over the n outputs: k*n - p*(p+1) for
    p = k//2 <= n."""
    p = k // 2
    return sum(max(0, n - abs(d)) for d in range(-p, p + 1))


def site_bound(x_shape, w_shape):
    """(flops, bytes) the site must do and move: each input read once, the
    output written once; only the multiplies by taps inside the volume
    (those by the SAME zero padding are not needed)."""
    b, t, h, w, _ = x_shape
    m = b * t * h * w
    kt, kh, kw, cin, cout = w_shape
    taps = inside_taps(kt, t) * inside_taps(kh, h) * inside_taps(kw, w)
    flops = 2.0 * b * taps * cin * cout
    nbytes = 2.0 * (m * cin + kt * kh * kw * cin * cout + m * cout) + 4.0 * cout
    return flops, nbytes


def _kernel_row(torch, kname, names, x_shape, w_shape, act, kern, plain,
                library, bound_x, bound_w) -> dict:
    """Hold `kern()` against `plain()` and time kernel, plain and library
    (device time); the bound is `site_bound(bound_x, bound_w)`."""
    got = kern().float()
    want = plain().float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{names[0]}: non-finite output")
    err = (got - want).abs()
    excess = (err - KERNEL_TOL * (1 + want.abs())).max().item()
    max_err = err.max().item()
    check(excess <= 0, f"{names[0]} ({kname} {x_shape} {w_shape} {act}): "
          f"max_abs_err {max_err} over tolerance")
    kernel_ms = device_ms(torch, kern)
    plain_ms = device_ms(torch, plain)
    library_ms = device_ms(torch, library)
    flops, nbytes = site_bound(bound_x, bound_w)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    row = {"kernel": kname, "sites": names, "per_forward": len(names),
           "x": list(x_shape), "w": list(w_shape), "act": act,
           "max_abs_err": max_err, "tolerance": f"{KERNEL_TOL}*(1+|plain|)",
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "flop_ms": t_ops, "byte_ms": t_bytes,
           "named": [NAMED_SITES[n] for n in names if n in NAMED_SITES]}
    emit("kernels", **row)
    return row


def kernel_phase(torch, sites):
    """Hold each kernel against its plain version at every site shape and
    time kernel, plain and library versions there: the forward launch, and
    the backward's dx launch (the same kernel against the transposed,
    for a conv tap-flipped, weights on a bf16 dz)."""
    import torch.nn.functional as F

    from pytorchvideo_accelerate_tpu_torch.ops import fused

    rng = np.random.default_rng(SEED + 1)
    uniq = {}
    for name, key in sites.items():
        uniq.setdefault(key, []).append(name)
    rows = []
    for (x_shape, w_shape, act), names in uniq.items():
        kt, kh, kw, cin, cout = w_shape
        b, t, h, w, _ = x_shape
        pw = (kt, kh, kw) == (1, 1, 1)
        kname = "fused_pw_bn_act" if pw else "fused_conv_bn_act"
        x = torch.from_numpy(rng.standard_normal(x_shape, np.float32)).cuda().bfloat16()
        wf = torch.from_numpy(
            rng.standard_normal(w_shape, np.float32)
            * np.sqrt(2.0 / (kt * kh * kw * cin))).cuda().bfloat16()
        bias = torch.from_numpy(rng.standard_normal(cout, np.float32) * 0.1).cuda()
        dz = torch.from_numpy(rng.standard_normal(
            (b, t, h, w, cout), np.float32)).cuda().bfloat16()
        zeros = torch.zeros(cin, device="cuda")
        bias16 = bias.bfloat16()
        pads = (kt // 2, kh // 2, kw // 2)
        if pw:
            x2d, w2d = x.reshape(-1, cin), wf.reshape(cin, cout)
            dz2d, wt = dz.reshape(-1, cout), wf.reshape(cin, cout).t().contiguous()
            fwd = (lambda: fused._pw_cuda(x2d, w2d, bias, act),
                   lambda: fused.pw_bn_act_plain(x2d, w2d, bias, act),
                   lambda: act_(torch.addmm(bias16, x2d, w2d), act))
            bwd = (lambda: fused._pw_cuda(dz2d, wt, zeros, "identity",
                                          "fused_pw_bn_act.bwd_dx"),
                   lambda: fused.pw_bn_act_plain(dz2d, wt, zeros, "identity"),
                   lambda: dz2d @ wt)
        else:
            xc, dzc = x.permute(0, 4, 1, 2, 3), dz.permute(0, 4, 1, 2, 3)
            wc = wf.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            wt = wf.flip(0, 1, 2).transpose(3, 4).contiguous()
            fwd = (lambda: fused._conv_cuda(x, wf, bias, act),
                   lambda: fused.conv_bn_act_plain(x, wf, bias, act),
                   lambda: act_(F.conv3d(xc, wc, bias16, padding=pads), act))
            bwd = (lambda: fused._conv_cuda(dz, wt, zeros, "identity",
                                            "fused_conv_bn_act.bwd_dx"),
                   lambda: fused.conv_bn_act_plain(dz, wt, zeros, "identity"),
                   lambda: torch.nn.grad.conv3d_input(
                       (b, cin, t, h, w), wc, dzc, padding=pads))
        rows.append(_kernel_row(torch, kname, names, x_shape, w_shape, act,
                                *fwd, x_shape, w_shape))
        # dx: the same stencil with Cin and Cout swapped
        rows.append(_kernel_row(torch, kname + ".bwd_dx", names, x_shape,
                                w_shape, "identity", *bwd,
                                (b, t, h, w, cout), (kt, kh, kw, cout, cin)))
    for label_site in NAMED_SITES:
        check(label_site in sites, f"named site {label_site} not on the path")
    return rows


KERNEL_CLASSES = (  # (class, substrings of the device kernel's name)
    ("fused_pw_bn_act", ("fused_pw_bn_act",)),
    ("fused_conv_bn_act", ("fused_conv_bn_act",)),
    ("memcpy", ("memcpy", "Memcpy")),
    # cuDNN's convolutions first: their names hold "gemm" too
    ("cudnn_conv", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "Gemm")),
    ("pool", ("pool",)),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def profile_forward(torch, engine, batch, reps: int = 3) -> dict:
    """Device time by kernel class over `reps` bucket-8 forwards
    (torch.profiler), and the device's busy share between the first kernel
    start and the last kernel end."""
    return profile_of(torch, lambda: engine.predict(batch), reps, "forward")


def profile_of(torch, fn, reps: int, unit: str) -> dict:
    """Device time by kernel class over `reps` calls of `fn`, per call, and
    the device's busy share of the span the calls' device work covers."""
    kev = device_events(torch, fn, reps)
    if not kev:
        return {"device_events": 0}
    span_us = (max(e.time_range.end for e in kev)
               - min(e.time_range.start for e in kev))
    busy_us = sum(e.time_range.elapsed_us() for e in kev)
    classes: dict = {}
    names: dict = {}
    for e in kev:
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in e.name for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + e.time_range.elapsed_us()
        names[e.name] = names.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return {
        "device_events": len(kev), "reps": reps,
        f"device_ms_per_{unit}": busy_us / reps / 1e3,
        f"span_ms_per_{unit}": span_us / reps / 1e3,
        "device_busy_share": busy_us / span_us,
        f"ms_per_{unit}_by_class": {k: v / reps / 1e3 for k, v in
                                    sorted(classes.items(), key=lambda kv: -kv[1])},
        f"top_kernels_ms_per_{unit}": [[n[:90], v / reps / 1e3] for n, v in top],
        f"launches_per_{unit}_by_class": {
            k: sum(1 for e in kev if next(
                (c for c, keys in KERNEL_CLASSES if any(q in e.name for q in keys)),
                "other") == k) / reps for k in classes},
    }


def train_argv(out: str, fused: str = "auto"):
    """The reference recipe (32 frames at 256^2, batch 8 x accumulation 4,
    bf16) on synthetic clips, 2 epochs of 64 videos."""
    return ["--synthetic", "--model.name", "slowfast_r50",
            "--model.num_classes", str(NUM_CLASSES), "--num_frames", str(FRAMES),
            "--data.crop_size", str(CROP), "--batch_size", str(TRAIN_BATCH),
            "--gradient_accumulation_steps", str(ACCUM),
            "--num_epochs", str(EPOCHS),
            "--data.synthetic_num_videos", str(TRAIN_VIDEOS),
            "--checkpointing_steps", str(CKPT_EVERY), "--mixed_precision", "bf16",
            "--model.fused_kernels", fused, "--output_dir", out,
            "--log_every", "1"]


def expected_train_launches() -> dict:
    """Launch totals of one fit() of `train_argv`, from the code: the loader
    drops the last partial batch, so an epoch is TRAIN_VIDEOS // (B * accum)
    optimizer steps of `accum` micro-steps; the val source holds
    max(TRAIN_VIDEOS // 4, 4) clips in ceil(n / B) eval forwards per epoch.
    Each micro-step launches every fused site's kernel once forward and once
    for dx (every site's input needs a gradient: it depends on the stem's
    weights); an eval forward launches each once."""
    steps = TRAIN_VIDEOS // (TRAIN_BATCH * ACCUM) * EPOCHS
    micro = steps * ACCUM
    val = max(TRAIN_VIDEOS // 4, 4)
    evals = -(-val // TRAIN_BATCH) * EPOCHS
    return {"steps": steps, "micro_steps": micro, "eval_forwards": evals,
            "fused_pw_bn_act": PW_PER_FORWARD * (micro + evals),
            "fused_conv_bn_act": CONV_PER_FORWARD * (micro + evals),
            "fused_pw_bn_act.bwd_dx": PW_PER_FORWARD * micro,
            "fused_conv_bn_act.bwd_dx": CONV_PER_FORWARD * micro}


def host_copy(state) -> dict:
    """Params + BN running averages, SGD momentum buffers and the step of a
    TrainState, copied to the host."""
    opt = state.optimizer.opt
    return {"model": {k: v.detach().cpu().clone()
                      for k, v in state.model.state_dict().items()},
            "momentum": {n: opt.state[p]["momentum_buffer"].detach().cpu().clone()
                         for n, p in state.model.named_parameters()},
            "step": state.step}


def train_phase(torch, work: str) -> dict:
    """Train full-width SlowFast-R50 through `run.main`: the launch counters
    zeroed just before fit(), read just after; lr per step against the
    closed-form cosine; the step-2 checkpoint restored bitwise; the final
    checkpoint exported and served by slice 1's InferenceEngine, its logits
    held against the trainer's eval-mode forward."""
    import math
    import os

    from pytorchvideo_accelerate_tpu_torch import run as trun
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine
    from pytorchvideo_accelerate_tpu_torch.trainer import loop

    out = os.path.join(work, "train")
    argv = train_argv(out)
    seen = {"metrics": [], "snap": None}
    make_step = loop.make_train_step

    def recording(model, optimizer, **kw):
        step = make_step(model, optimizer, **kw)

        def wrapped(state, batch):
            m = step(state, batch)
            seen["metrics"].append(m)
            if state.step == CKPT_EVERY:
                seen["snap"] = host_copy(state)
            return m
        return wrapped

    want = expected_train_launches()
    loop.make_train_step = recording
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = trun.main(argv)
    finally:
        loop.make_train_step = make_step
    fit_s = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    losses = [m["loss"].item() for m in seen["metrics"]]
    lrs = [m["lr"] for m in seen["metrics"]]
    check(result["steps"] == want["steps"] == len(losses),
          f"steps {result['steps']} / {len(losses)}, expected {want['steps']}")
    check(all(math.isfinite(v) for v in losses + [result["train_loss"]]),
          f"non-finite loss {losses} {result['train_loss']}")
    cosine = [BASE_LR * 0.5 * (1 + math.cos(math.pi * k / want["steps"]))
              for k in range(want["steps"])]
    check(all(abs(a - b) <= 1e-12 for a, b in zip(lrs, cosine)),
          f"lr per step {lrs}, schedule {cosine}")
    check(all(launches[k] == want[k] for k in SOURCES),
          f"launches {launches}, expected {want}")

    # the step-2 checkpoint restores bitwise
    tr = loop.Trainer(parse_cli(argv + ["--resume_from_checkpoint", "auto"]))
    extra, step = tr.checkpointer.restore(tr.state, step=CKPT_EVERY)
    got, snap = host_copy(tr.state), seen["snap"]
    check(step == got["step"] == snap["step"] == CKPT_EVERY, f"restored step {step}")
    bad = [k for k in snap["model"] if not torch.equal(got["model"][k], snap["model"][k])]
    bad += [k for k in snap["momentum"]
            if not torch.equal(got["momentum"][k], snap["momentum"][k])]
    check(not bad, f"restore not bitwise at {bad[:4]}")
    check(extra["data_state"] == {"epoch": 0, "position": CKPT_EVERY},
          f"restored LoaderState {extra['data_state']}")

    # export the final checkpoint; slice 1's engine serves it
    art = os.path.join(work, "trained_artifact")
    trun.main(argv + ["--resume_from_checkpoint", "auto", "--export_inference", art])
    tr._maybe_resume()
    rng = np.random.default_rng(SEED + 2)
    clips = {"slow": rng.standard_normal((TRAIN_BATCH, FRAMES // ALPHA, CROP, CROP, 3), np.float32),
             "fast": rng.standard_normal((TRAIN_BATCH, FRAMES, CROP, CROP, 3), np.float32)}
    tr.model.eval()
    with torch.no_grad():
        plain = tr.model((torch.from_numpy(clips["slow"]).cuda(),
                          torch.from_numpy(clips["fast"]).cuda())).float().cpu().numpy()
    tr.close()
    del tr
    engine = InferenceEngine.from_artifact(art)
    served = engine.predict(clips)
    del engine
    err = np.abs(served - plain)
    check(bool(np.isfinite(served).all()) and bool(
        (err <= LOGIT_TOL * (1 + np.abs(plain))).all()),
        f"served trained logits differ from the trainer's: max {err.max()}")
    free_cuda(torch)
    return {"fit_s": fit_s, "result": result, "losses": losses, "lr": lrs,
            "launches": launches, "expected_launches": want,
            "launches_per_micro_step": {
                k: (launches[k] - (0 if k.endswith("bwd_dx") else
                                   want["eval_forwards"] * SITES_PER_FORWARD[k]))
                / want["micro_steps"] for k in SOURCES},
            "restored_step": step, "restored_loader_state": extra["data_state"],
            "restore_bitwise": True, "served_logit_max_abs_err": float(err.max()),
            "served_logit_std": float(plain.std())}


def free_cuda(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def micro_step_fn(torch, fused_mode: str, batch, seed: int = 0):
    """(model, forward, fn) for a fresh seeded SlowFast-R50 in bf16 through
    `fused_mode` on `batch`: forward() returns the training loss, fn() runs
    one training micro-step (forward + backward)."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import _loss_and_metrics

    cfg = parse_cli(train_argv("unused", fused_mode) + ["--model.dropout_rate", "0"])
    model = create_model(cfg.model, "bf16", seed=seed).cuda().train()
    inputs = (batch["slow"], batch["fast"])
    ones = torch.ones(batch["label"].shape[0], device="cuda")

    def forward():
        return _loss_and_metrics(model(inputs), batch["label"], ones, 0.0)[0]

    def fn():
        model.zero_grad(set_to_none=True)
        loss = forward()
        loss.backward()
        return loss
    return model, forward, fn


def train_batch(torch, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"slow": torch.from_numpy(rng.standard_normal(
                (TRAIN_BATCH, FRAMES // ALPHA, CROP, CROP, 3), np.float32)).cuda(),
            "fast": torch.from_numpy(rng.standard_normal(
                (TRAIN_BATCH, FRAMES, CROP, CROP, 3), np.float32)).cuda(),
            "label": torch.from_numpy(rng.integers(0, NUM_CLASSES, TRAIN_BATCH)).cuda()}


def with_site_backward(make, fn):
    """`fn()` with the custom backward of each fused site's Function
    (`PwBnAct`, `ConvBnAct`) replaced by `make(Function, its backward)`."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    saved = {cls: cls.__dict__["backward"] for cls in (fused.PwBnAct, fused.ConvBnAct)}
    for cls, backward in saved.items():
        cls.backward = staticmethod(make(cls, backward.__func__))
    try:
        return fn()
    finally:
        for cls, backward in saved.items():
            cls.backward = backward


def plain_site_backward(torch, cls, _):
    """A backward for `PwBnAct`/`ConvBnAct` that differentiates the site's
    plain version with torch autograd at the operands its forward saved:
    the reference that the custom backward (dx through the kernel) is held
    to."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    plain = fused.pw_bn_act_plain if cls is fused.PwBnAct else fused.conv_bn_act_plain

    def backward(ctx, g):
        ops = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = plain(*ops, ctx.act)
        got = iter(torch.autograd.grad(y, [t for t in ops if t.requires_grad], g))
        return (*(next(got) if t.requires_grad else None for t in ops), None, None)
    return backward


def sgd_updates(torch, model, grad_sets):
    """The parameter change of one trainer SGD step from `model`'s current
    parameters for each list of gradients in `grad_sets`."""
    from pytorchvideo_accelerate_tpu_torch.config import OptimConfig
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer

    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    updates = []
    for grads in grad_sets:
        for p, g in zip(params, grads):
            p.grad = g
        build_optimizer(OptimConfig(), 4, model.named_parameters()).step(0)
        with torch.no_grad():
            updates.append(torch.cat([(p - b).flatten() for p, b in zip(params, before)]))
            for p, b in zip(params, before):
                p.copy_(b)
    return updates


def rel_err(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def train_parity_phase(torch) -> dict:
    """One training micro-step through the kernels (`auto`) against plain
    PyTorch (TF32 off), on one fixed B=8 batch and the same seeded weights.

    (a) End to end, `auto` against `xla` (plain autograd): the loss, and the
    gradient of the head, which depends only on the forward, within the
    tolerance. The whole gradient of this net at init is chaotic in bf16:
    ReLU masks and max-pool winners flip where the lowerings round an
    activation differently, and each flip reroutes a gradient element; two
    plain lowerings (`off` against `xla`) differ as much. That whole-gradient
    difference is printed for both pairs, and held to nothing.
    (b) With the forward held fixed: the kernels' micro-step graph
    differentiated twice, once through the custom backward (dx launches the
    kernels) and once with each site's backward swapped for torch autograd
    of its plain version. The whole gradient and one SGD step's update must
    agree within the tolerance."""
    batch = train_batch(torch, SEED + 3)
    e2e = {}
    for mode in ("auto", "xla", "off"):
        model, _, fn = micro_step_fn(torch, mode, batch)
        loss = fn().item()
        e2e[mode] = (loss, torch.cat([p.grad.float().flatten() for p in model.parameters()]),
                     model.head.proj.weight.grad.float().clone())
        del model, fn
        free_cuda(torch)
    (lk, gk, hk), (lp, gp, hp), (_, go, ho) = e2e["auto"], e2e["xla"], e2e["off"]
    out = {"loss_kernels": lk, "loss_plain": lp, "loss_abs_err": abs(lk - lp),
           "loss_tolerance": LOGIT_TOL * (1 + abs(lp)),
           "head_grad_rel_err": rel_err(hk, hp),
           "head_grad_rel_err_off_vs_xla": rel_err(ho, hp),
           "grad_rel_err_end_to_end": rel_err(gk, gp),
           "grad_rel_err_end_to_end_off_vs_xla": rel_err(go, gp),
           "rel_tolerance": LOGIT_TOL}
    del e2e, gk, gp, go, hk, hp, ho
    check(out["loss_abs_err"] <= out["loss_tolerance"], f"train loss {out}")
    check(out["head_grad_rel_err"] <= LOGIT_TOL, f"head gradient {out}")

    model, forward, _ = micro_step_fn(torch, "auto", batch)
    loss = forward()
    loss.backward(retain_graph=True)
    params = list(model.parameters())
    g_kernel = [p.grad for p in params]
    model.zero_grad(set_to_none=True)
    with_site_backward(lambda cls, inner: plain_site_backward(torch, cls, inner),
                       loss.backward)
    g_plain = [p.grad for p in params]
    del loss
    uk, up = sgd_updates(torch, model, [g_kernel, g_plain])
    out["grad_rel_err_same_forward"] = rel_err(
        torch.cat([g.float().flatten() for g in g_kernel]),
        torch.cat([g.float().flatten() for g in g_plain]))
    out["update_rel_err_same_forward"] = rel_err(uk, up)
    del model, forward, g_kernel, g_plain, params
    free_cuda(torch)
    check(out["grad_rel_err_same_forward"] <= LOGIT_TOL, f"gradients {out}")
    check(out["update_rel_err_same_forward"] <= LOGIT_TOL, f"SGD update {out}")
    return out


def count_strided_grads(fn):
    """(not contiguous, all) of the gradients that reach the fused sites'
    custom backward in one `fn()`: each strided one costs a hidden copy
    before its dx launch."""
    seen = [0, 0]

    def counting(cls, inner):
        def backward(ctx, g):
            seen[0] += not g.is_contiguous()
            seen[1] += 1
            return inner(ctx, g)
        return backward

    with_site_backward(counting, fn)
    return seen


def train_timing_phase(torch) -> dict:
    """ms per micro-step (forward + backward at B=8, host clock around
    synchronised steps) through the kernels, unfused (cuDNN + BN passes)
    and the plain lowering; peak device memory of each; the profile of the
    kernels' micro-step, and how many gradients reach its fused sites
    strided."""
    batch = train_batch(torch, SEED + 4)
    out = {}
    for mode in ("auto", "off", "xla"):
        model, _, fn = micro_step_fn(torch, mode, batch)
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[f"micro_step_ms_{mode}"] = times
        out[f"peak_mem_gb_{mode}"] = torch.cuda.max_memory_allocated() / 1e9
        if mode == "auto":
            out["profile"] = profile_of(torch, fn, 2, "micro_step")
            out["site_grads_not_contiguous"], out["site_grads"] = \
                count_strided_grads(fn)
        del model, fn
        free_cuda(torch)
    return out


def post(url: str, body: bytes, timeout: float = 300.0):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        payload = json.loads(r.read())
        return r.status, payload, (time.perf_counter() - t0) * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from pytorchvideo_accelerate_tpu_torch.ops import _build

    # the plain versions are the references: full f32, no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    seconds = _build.build()
    regs = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
            for k, v in _build.build_logs.items()}
    emit("build", seconds=seconds, total_s=time.perf_counter() - t0,
         ptxas=regs)

    with tempfile.TemporaryDirectory(prefix="pva_chip_smoke_") as work:
        return run(torch, work, smi, kind)


def run(torch, work: str, smi: str, kind: str) -> int:
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine
    from pytorchvideo_accelerate_tpu_torch.serving.server import build_server
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import (
        export_inference,
        load_inference,
    )

    # 3. weights + artifact
    art = os.path.join(work, "serve_artifact")
    t0 = time.perf_counter()
    cfg = serve_cfg(parse_cli, "auto")
    rng = np.random.default_rng(SEED)
    norm = (cfg.data.mean, cfg.data.std)
    calib = create_model(serve_cfg(parse_cli, "off").model, "bf16").eval()
    state = seeded_state_dict(calib, rng)
    calib.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    calib.cuda()
    calib_clips = {
        "slow": rng.integers(0, 256, (2, FRAMES // ALPHA, CROP, CROP, 3), np.uint8),
        "fast": rng.integers(0, 256, (2, FRAMES, CROP, CROP, 3), np.uint8)}
    calibrate_bn(torch, calib, calib_clips, norm)
    # requests: 5 distinct seeded u8 clips at the serving geometry
    clips = [{"slow": rng.integers(0, 256, (FRAMES // ALPHA, CROP, CROP, 3), np.uint8),
              "fast": rng.integers(0, 256, (FRAMES, CROP, CROP, 3), np.uint8)}
             for _ in range(5)]
    plant_head(torch, calib, clips, norm)
    export_inference(art, calib, cfg, meta={"num_classes": NUM_CLASSES,
                                            "model": "slowfast_r50"})
    del calib
    state, meta = load_inference(art)
    n_params = int(sum(v.size for k, v in state.items()
                       if not k.endswith(("running_mean", "running_var"))))
    emit("weights", artifact=art, params=n_params, seconds=time.perf_counter() - t0)

    batch = {k: np.stack([c[k] for c in clips] + [clips[0][k]] * (BUCKET - 5))
             for k in ("slow", "fast")}

    # the plain path: the same weights through fused_kernels xla
    plain_engine = InferenceEngine(
        create_model(serve_cfg(parse_cli, "xla").model, "bf16"), state,
        num_classes=NUM_CLASSES, max_batch_size=BUCKET, device_normalize=norm,
        input_dtype="uint8", model_name="slowfast_r50")
    sites = record_sites(torch, plain_engine.model,
                         lambda: plain_engine.predict(batch))
    n_pw = sum(1 for s in sites.values() if s[1][:3] == (1, 1, 1))
    check(n_pw == PW_PER_FORWARD and len(sites) - n_pw == CONV_PER_FORWARD,
          f"fused sites {n_pw} pointwise / {len(sites) - n_pw} conv, expected "
          f"{PW_PER_FORWARD} / {CONV_PER_FORWARD}")
    plain_logits = plain_engine.predict(batch)[:5]

    # 4. kernels at every site shape of the bucket-8 forward
    rows = kernel_phase(torch, sites)

    # 5. serve: the main path, counters zeroed just before it
    bodies = [json.dumps({k: v.tolist() for k, v in c.items()},
                         separators=(",", ":")).encode() for c in clips]
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    server = build_server(parse_cli([
        "--serve.checkpoint", art, "--serve.port", "0",
        "--serve.scheduler", "micro", "--serve.max_wait_ms", "12000"]))
    server.start()
    try:
        build_s = time.perf_counter() - t0
        host, port = server.address
        url = f"http://{host}:{port}/predict"
        with ThreadPoolExecutor(max_workers=4) as pool:
            first = list(pool.map(lambda b: post(url, b), bodies[:4]))
        last = post(url, bodies[4])
        with urllib.request.urlopen(f"http://{host}:{port}/stats") as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(f"http://{host}:{port}/healthz") as r:
            health = json.loads(r.read())
    finally:
        server.close()
    launches = dict(fused.LAUNCHES)
    responses = first + [last]
    check(all(code == 200 for code, _, _ in responses),
          f"HTTP codes {[code for code, _, _ in responses]}")
    forwards = len(server.engine.buckets) + int(stats["batches"])
    check(launches["fused_pw_bn_act"] == PW_PER_FORWARD * forwards
          and launches["fused_conv_bn_act"] == CONV_PER_FORWARD * forwards,
          f"launches {launches} over {forwards} forwards")
    served = np.stack([np.asarray(p["logits"], np.float32)
                       for _, p, _ in responses])
    check(served.shape == (5, NUM_CLASSES) and bool(np.isfinite(served).all()),
          f"served logits shape {served.shape} or non-finite")
    tol = LOGIT_TOL * (1 + np.abs(plain_logits))
    err = np.abs(served - plain_logits)
    check(bool((err <= tol).all()), f"logits differ: max {err.max()}")
    top2 = np.sort(plain_logits, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    decisive = margin > 2 * LOGIT_TOL * (1 + np.abs(top2[:, 1]))
    agree = served.argmax(1) == plain_logits.argmax(1)
    check(bool(decisive.any()), "no request has a decisive plain top-1 margin")
    check(bool(agree[decisive].all()), "top-1 differs on a decisive row")
    emit("serve", requests=len(responses), http=[c for c, _, _ in responses],
         server_build_s=build_s, buckets=list(server.engine.buckets),
         forwards=forwards, launches=launches,
         launches_per_forward={k: v / forwards for k, v in launches.items()},
         request_ms_client=[ms for _, _, ms in responses],
         request_ms_server=[p["latency_ms"] for _, p, _ in responses],
         logit_max_abs_err=float(err.max()), logit_std=float(plain_logits.std()),
         logit_tolerance=f"{LOGIT_TOL}*(1+|plain|)",
         top1_agree=int(agree.sum()), top1_decisive=int(decisive.sum()),
         top1_planted=int((plain_logits.argmax(1) == np.arange(5)).sum()),
         top1_margin=margin.tolist(),
         stats=stats, health=health)

    # 6. bucket-8 forward times, host clock around synchronised forwards
    def forward_ms(engine, reps=5):
        engine.predict(batch)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.predict(batch)
            times.append((time.perf_counter() - t) * 1e3)
        return times

    kernel_times = forward_ms(server.engine)
    plain_times = forward_ms(plain_engine)
    off_engine = InferenceEngine(
        create_model(serve_cfg(parse_cli, "off").model, "bf16"), state,
        num_classes=NUM_CLASSES, max_batch_size=BUCKET, device_normalize=norm,
        input_dtype="uint8", model_name="slowfast_r50")
    off_times = forward_ms(off_engine)
    emit("timing", bucket=BUCKET, forward_ms_kernels=kernel_times,
         forward_ms_plain=plain_times, forward_ms_unfused_cudnn=off_times,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("profile", bucket=BUCKET, **profile_forward(torch, server.engine, batch))
    del server, plain_engine, off_engine
    free_cuda(torch)

    # 8. train: the main training path, counters zeroed just before fit()
    train = train_phase(torch, work)
    emit("train", **train)
    # 9. kernels against plain on one training micro-step
    emit("train_parity", **train_parity_phase(torch))
    # 10. micro-step times, clips/s of fit()'s steady epoch, memory, profile
    emit("train_timing", batch=TRAIN_BATCH, nvidia_smi=smi,
         fit_clips_per_sec=train["result"].get("clips_per_sec"),
         fit_input_wait_frac=train["result"].get("input_wait_frac"),
         **train_timing_phase(torch), empty_profiles=EMPTY_PROFILES[0],
         event_timed=EVENT_TIMED[0])

    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == kname]
        flop_ms = sum(r["flop_ms"] * r["per_forward"] for r in mine)
        byte_ms = sum(r["byte_ms"] * r["per_forward"] for r in mine)
        # forward launches: the serve phase's; dx launches: the train phase's
        count = train["launches"][kname] if kname.endswith("bwd_dx") else launches[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": count,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["kernel_ms"] * r["per_forward"] for r in mine),
            "plain_ms": sum(r["plain_ms"] * r["per_forward"] for r in mine),
            "bound_ms": sum(r["bound_ms"] * r["per_forward"] for r in mine),
            "bound_by": "operations" if flop_ms > byte_ms else "bytes",
            "library_ms": sum(r["library_ms"] * r["per_forward"] for r in mine),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
