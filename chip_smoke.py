#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: serve full-width SlowFast-R50 on one GPU.

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
            times from torch.profiler
5. serve    the port's HTTP server (`build_server`, micro scheduler) answers
            5 /predict requests (4 concurrent, then 1); the launch counters,
            zeroed just before, must show 41 pointwise and 51 conv launches
            per forward; logits must agree with the plain path
6. timing   bucket-8 forward with the kernels, the plain path and unfused
7. profile  device time per forward by kernel class, device busy share

Then the kernels' JSON line (its ms, plain_ms, library_ms and bound_ms are
summed over the kernel's launches in one bucket-8 forward; launches are
the serve phase's), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result. It exits non-zero at once without CUDA.

Tolerances. Kernel vs plain version: both multiply bf16 operands exactly,
sum in f32 and round once to bf16, so elementwise
|kernel - plain| <= 1e-2 * (1 + |plain|). Served logits vs the plain path:
every layer rounds to bf16 (relative 2^-9) in a different summation order,
compounded over ~50 layers: |served - plain| <= 5e-2 * (1 + |plain|), and
top-1 must agree wherever the plain top-1 margin exceeds 2 * 5e-2 * (1 +
|top logit|).
"""

from __future__ import annotations

import json
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
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def device_events(torch, fn, reps: int):
    """The device-side events (kernels, copies) of `reps` calls of `fn`,
    recorded by torch.profiler after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one `fn()` call: the summed durations of the device
    work it launches, averaged over `reps` calls. Host launch overhead and
    the gaps between launches are left out."""
    kev = device_events(torch, fn, reps)
    check(bool(kev), "torch.profiler recorded no device events")
    return sum(e.time_range.elapsed_us() for e in kev) / reps / 1e3


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


def kernel_phase(torch, sites):
    """Hold each kernel against its plain version at every site shape and
    time kernel, plain and library versions there."""
    import torch.nn.functional as F

    from pytorchvideo_accelerate_tpu_torch.ops import fused

    rng = np.random.default_rng(SEED + 1)
    uniq = {}
    for name, key in sites.items():
        uniq.setdefault(key, []).append(name)
    rows = []
    for (x_shape, w_shape, act), names in uniq.items():
        kt, kh, kw, cin, cout = w_shape
        pw = (kt, kh, kw) == (1, 1, 1)
        kname = "fused_pw_bn_act" if pw else "fused_conv_bn_act"
        x = torch.from_numpy(rng.standard_normal(x_shape, np.float32)).cuda().bfloat16()
        wf = torch.from_numpy(
            rng.standard_normal(w_shape, np.float32)
            * np.sqrt(2.0 / (kt * kh * kw * cin))).cuda().bfloat16()
        bias = torch.from_numpy(rng.standard_normal(cout, np.float32) * 0.1).cuda()
        if pw:
            x2d, w2d = x.reshape(-1, cin), wf.reshape(cin, cout)
            kern = lambda: fused._pw_cuda(x2d, w2d, bias, act)  # noqa: E731
            plain = lambda: fused.pw_bn_act_plain(x2d, w2d, bias, act)  # noqa: E731
            bias16 = bias.bfloat16()

            def library():
                return act_(torch.addmm(bias16, x2d, w2d), act)
        else:
            kern = lambda: fused._conv_cuda(x, wf, bias, act)  # noqa: E731
            plain = lambda: fused.conv_bn_act_plain(x, wf, bias, act)  # noqa: E731
            xc = x.permute(0, 4, 1, 2, 3)
            wc = wf.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            bias16 = bias.bfloat16()
            pads = (kt // 2, kh // 2, kw // 2)

            def library():
                return act_(F.conv3d(xc, wc, bias16, padding=pads), act)
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
        flops, nbytes = site_bound(x_shape, w_shape)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        row = {"kernel": kname, "sites": names, "per_forward": len(names),
               "x": list(x_shape), "w": list(w_shape), "act": act,
               "max_abs_err": max_err, "tolerance": f"{KERNEL_TOL}*(1+|plain|)",
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops > t_bytes else "bytes",
               "flop_ms": t_ops, "byte_ms": t_bytes,
               "named": [NAMED_SITES[n] for n in names if n in NAMED_SITES]}
        rows.append(row)
        emit("kernels", **row)
    for label_site in NAMED_SITES:
        check(label_site in sites, f"named site {label_site} not on the path")
    return rows


KERNEL_CLASSES = (  # (class, substrings of the device kernel's name)
    ("fused_pw_bn_act", ("fused_pw_bn_act",)),
    ("fused_conv_bn_act", ("fused_conv_bn_act",)),
    ("memcpy", ("memcpy", "Memcpy")),
    ("cudnn_conv", ("conv", "xmma", "cudnn", "implicit", "sm90", "cutlass")),
    ("pool", ("pool",)),
    ("reduce", ("reduce", "Reduce")),
    ("gemm", ("gemm", "Gemm")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def profile_forward(torch, engine, batch, reps: int = 3) -> dict:
    """Device time by kernel class over `reps` bucket-8 forwards
    (torch.profiler), and the device's busy share between the first kernel
    start and the last kernel end."""
    kev = device_events(torch, lambda: engine.predict(batch), reps)
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
        "device_ms_per_forward": busy_us / reps / 1e3,
        "span_ms_per_forward": span_us / reps / 1e3,
        "device_busy_share": busy_us / span_us,
        "ms_per_forward_by_class": {k: v / reps / 1e3 for k, v in
                                    sorted(classes.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_forward": [[n[:90], v / reps / 1e3] for n, v in top],
    }


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

    with tempfile.TemporaryDirectory(prefix="pva_chip_smoke_") as art:
        return run(torch, art, smi, kind)


def run(torch, art: str, smi: str, kind: str) -> int:
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
    t0 = time.perf_counter()
    cfg = serve_cfg(parse_cli, "auto")
    rng = np.random.default_rng(SEED)
    norm = (cfg.data.mean, cfg.data.std)
    calib = create_model(serve_cfg(parse_cli, "off").model, "bf16")
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

    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == kname]
        flop_ms = sum(r["flop_ms"] * r["per_forward"] for r in mine)
        byte_ms = sum(r["byte_ms"] * r["per_forward"] for r in mine)
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
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
