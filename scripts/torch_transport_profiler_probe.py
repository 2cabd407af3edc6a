#!/usr/bin/env python3
"""Probes behind the PyTorch port's process transport and profile windows,
on a CUDA machine (prints one JSON line per probe):

- threads: the bytes of `F.interpolate` (the transforms' bilinear resize)
  on torch's default intra-op thread count against one thread, on one
  full-width SlowFast-R50 train sample (32 frames at 256^2, fp32), in the
  parent and in a forked shm worker (which runs torch on one thread);
- transport: one 48-clip epoch of that sample stream, B=8, 8 workers, in
  turns: the thread transport with the decode threads on the default
  thread count (a plain thread pool), on one thread each (the port's
  `_decode_pool`), and the process transport; fp32 and bf16 clips;
- profiler: torch.profiler windows of 0.5 s (CPU + CUDA activity) opened
  on a background thread while another thread launches kernels (the
  server's `POST /profile` shape), with and without torch's
  `profile_all_threads`; the kernels, runtime calls and CPU ops each holds.

    python3 scripts/torch_transport_profiler_probe.py [threads|transport|profiler ...]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.config import parse_cli  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.data import pipeline  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.data.transforms import make_transform  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.native.shm_loader import ShmWorkerPool  # noqa: E402


def source(dtype: str, n: int):
    d = parse_cli(cs.train_argv(tempfile.gettempdir(), spec=cs.OBSERVE_TRAIN)).data
    tf = make_transform(training=True, num_frames=d.num_frames, is_slowfast=True,
                        slowfast_alpha=cs.ALPHA, min_short_side_scale=d.min_short_side_scale,
                        max_short_side_scale=d.max_short_side_scale,
                        crop_size=d.crop_size, mean=d.mean, std=d.std,
                        horizontal_flip_p=d.horizontal_flip_p, output_dtype=dtype)
    return pipeline.SyntheticClipSource(tf, num_videos=n, num_classes=cs.NUM_CLASSES,
                                        seed=cs.SEED)


def diff(a: dict, b: dict) -> dict:
    return {k: {"max_abs": float(np.abs(np.asarray(a[k], np.float64) - b[k]).max()),
                "differ": int((np.asarray(a[k]) != np.asarray(b[k])).sum()),
                "of": int(np.asarray(a[k]).size)} for k in a}


def threads_probe() -> dict:
    src = source("float32", 1)
    default = src.get(0, 0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    one = src.get(0, 0)
    torch.set_num_threads(n)
    pool = ShmWorkerPool(src, num_workers=1, timeout_ms=60_000)
    child = None
    for sample, done in pool.map_epoch([0], 0):
        child = {k: np.array(v) for k, v in sample.items()}
        done()
    return {"probe": "threads", "threads": n,
            "cpu": torch.backends.cpu.get_cpu_capability(),
            "default_vs_one": diff(default, one), "child_vs_one": diff(child, one)}


def transport_probe(clips: int = 48) -> dict:
    out = {}
    for dtype in ("float32", "bfloat16"):
        src = source(dtype, clips)
        for label in ("default_threads", "one_thread", "process") * 2:
            decode_pool = pipeline._decode_pool
            if label == "default_threads":
                pipeline._decode_pool = lambda n: ThreadPoolExecutor(max_workers=n)
            try:
                loader = pipeline.ClipLoader(
                    src, 8, shuffle=True, seed=cs.SEED, num_workers=8,
                    transport="process" if label == "process" else "thread")
            finally:
                pipeline._decode_pool = decode_pool
            t = time.perf_counter()
            sum(1 for _ in loader.epoch(0))
            out.setdefault(f"{dtype}/{label}", []).append(
                clips / (time.perf_counter() - t))
            loader.close()
    return {"probe": "transport", "clips": clips, "clips_per_sec": out}


def profiler_probe() -> dict:
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(512, 512, device="cuda")
    stop, launched = threading.Event(), [0]

    def launcher():
        while not stop.is_set():
            with torch.profiler.record_function("launcher_step"):
                torch.relu_(x @ x)
            launched[0] += 2
            torch.cuda.synchronize()
            time.sleep(0.002)

    def window(all_threads: bool) -> dict:
        path = os.path.join(tempfile.mkdtemp(), "trace.json")
        kw = {"activities": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
        if all_threads:
            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)

        def body():
            p = profile(**kw)
            torch.cuda.synchronize()
            p.start()
            time.sleep(0.5)
            torch.cuda.synchronize()
            p.stop()
            p.export_chrome_trace(path)

        n0 = launched[0]
        t = threading.Thread(target=body)
        t.start()
        t.join()
        cats = {}
        for e in json.load(open(path))["traceEvents"]:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        return {"launched": launched[0] - n0, "kernel": cats.get("kernel", 0),
                "cuda_runtime": cats.get("cuda_runtime", 0),
                "cpu_op": cats.get("cpu_op", 0)}

    th = threading.Thread(target=launcher, daemon=True)
    th.start()
    time.sleep(0.2)
    try:
        res = {"background": window(False), "background_again": window(False),
               "background_all_threads": window(True)}
    finally:
        stop.set()
        th.join()
    return {"probe": "profiler", "torch": torch.__version__, **res}


PROBES = {"threads": threads_probe, "transport": transport_probe,
          "profiler": profiler_probe}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA machine", file=sys.stderr)
        return 2
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    for name in argv or list(PROBES):
        print(json.dumps({"nvidia_smi": smi, **PROBES[name]()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
