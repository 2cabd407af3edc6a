"""The port's serving path against the JAX package's, on the CPU in float32.

- Inference artifacts cross both ways: an artifact written by either
  package serves in the other with the same logits (atol 1e-4).
- `build_server(--cpu ...)` on a slowfast_t artifact answers /predict over
  HTTP with the JAX engine's logits (atol 1e-4).
- Entry points default to the CUDA card and raise on this CUDA-less host;
  streaming, unknown schedulers and quantization modes, and the unported
  routes are refused (the default scheduler, int8, /metrics and /drain:
  tests/test_torch_metrics.py, tests/test_torch_quantize.py).
"""

import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from pytorchvideo_accelerate_tpu import config as jcfg
from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.serving import engine as jengine
from pytorchvideo_accelerate_tpu.trainer import checkpoint as jckpt
from pytorchvideo_accelerate_tpu_torch import config as tcfg
from pytorchvideo_accelerate_tpu_torch.models import create_model
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.serving import engine as tengine
from pytorchvideo_accelerate_tpu_torch.serving.admission import (
    DEGRADED,
    DRAINING,
    HEALTHY,
    AdmissionController,
)
from pytorchvideo_accelerate_tpu_torch.serving.batcher import MicroBatcher
from pytorchvideo_accelerate_tpu_torch.serving.server import build_server
from pytorchvideo_accelerate_tpu_torch.trainer import checkpoint as tckpt

ATOL = 1e-4
ARGV = ["--model.name", "slowfast_t", "--model.num_classes", "5",
        "--num_frames", "8", "--data.crop_size", "32", "--mixed_precision",
        "fp32", "--data.host_cast", "u8", "--model.fused_kernels", "xla"]
META = {"num_classes": 5, "model": "slowfast_t"}


def _seeded_variables(cfg):
    """numpy-seeded flax variables for cfg's model (He-scaled kernels, BN
    statistics away from identity, head std 1/sqrt(in))."""
    model = jmodels.create_model(cfg.model, cfg.mixed_precision)
    spec = {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in
            jmodels.model_input_spec(cfg.model, cfg.data).items()}
    tree = jax.eval_shape(lambda s: model.init(
        jax.random.PRNGKey(0), (s["slow"], s["fast"]), train=False), spec)
    rng = np.random.default_rng(3)
    flat = {}
    for key, leaf in flatten_tree(tree).items():
        shape = leaf.shape
        if key.endswith("kernel") and len(shape) == 5:
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:4]))
        elif key.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif key.endswith(("scale", "var")):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.standard_normal(shape) * 0.1
        flat[key] = v.astype(np.float32)
    return unflatten_tree(flat)


def _clips(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"slow": rng.integers(0, 256, (n, 2, 32, 32, 3), np.uint8),
            "fast": rng.integers(0, 256, (n, 8, 32, 32, 3), np.uint8)}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """A JAX-written artifact, and the JAX engine's logits on 8 clips."""
    cfg = jcfg.parse_cli(ARGV)
    variables = _seeded_variables(cfg)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  ema_params=None, step=3)
    art = str(tmp_path_factory.mktemp("jax_art"))
    jckpt.export_inference(art, state, config=cfg, meta=META)
    eng = jengine.InferenceEngine.from_artifact(art)
    clips = _clips(eng.buckets[0])
    return art, clips, eng.predict(clips)


def test_jax_artifact_serves_in_the_port(jax_side):
    art, clips, want = jax_side
    eng = tengine.InferenceEngine.from_artifact(art, device="cpu",
                                                max_batch_size=len(want))
    got = eng.predict(clips)
    assert got.shape == want.shape == (len(want), 5)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_port_artifact_serves_in_jax(jax_side, tmp_path):
    art, clips, want = jax_side
    state, meta = tckpt.load_inference(art)
    model = create_model(tcfg.config_from_dict(meta["config"]).model, "fp32")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    out = tckpt.export_inference(str(tmp_path / "port_art"), model,
                                 tcfg.parse_cli(ARGV), meta=META)
    got = jengine.InferenceEngine.from_artifact(out).predict(clips)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    jmeta = jckpt.load_inference(out)[2]
    assert (jcfg.config_from_dict(jmeta["config"]).to_dict()
            == jcfg.parse_cli(ARGV).to_dict())


@pytest.fixture(scope="module")
def server(jax_side):
    art, _, _ = jax_side
    srv = build_server(tcfg.parse_cli(
        ["--serve.checkpoint", art, "--cpu", "--serve.scheduler", "micro",
         "--serve.port", "0", "--serve.max_batch_size", "4",
         "--serve.max_wait_ms", "1"])).start()
    yield srv
    srv.close()


def _url(srv, path):
    host, port = srv.address
    return f"http://{host}:{port}{path}"


def _post(srv, path, body):
    req = urllib.request.Request(_url(srv, path), data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("row", [0, 5])
def test_http_predict_matches_jax_engine(jax_side, server, row):
    _, clips, want = jax_side
    code, payload = _post(server, "/predict",
                          {k: v[row].tolist() for k, v in clips.items()})
    assert code == 200
    np.testing.assert_allclose(np.asarray(payload["logits"]), want[row],
                               atol=ATOL, rtol=0)
    assert payload["top1"] == int(np.argmax(want[row]))


def test_healthz_and_stats(server):
    with urllib.request.urlopen(_url(server, "/healthz")) as r:
        health = json.loads(r.read())
    assert health["status"] == HEALTHY and health["platform"] == "cpu"
    assert health["buckets"] == [1, 2, 4]
    assert health["clip_spec"] == {"slow": [2, 32, 32, 3], "fast": [8, 32, 32, 3]}
    with urllib.request.urlopen(_url(server, "/stats")) as r:
        stats = json.loads(r.read())
    assert stats["compiled_buckets"] >= 3  # warmup ran every bucket
    assert {"p50_ms", "p99_ms", "batch_fill_ratio", "rejected_400"} <= set(stats)


@pytest.mark.parametrize("path", ["/history", "/profile"])
def test_unported_get_routes_are_404(server, path):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, path))
    assert e.value.code == 404


@pytest.mark.parametrize("path", ["/stream", "/history", "/profile"])
def test_unported_post_routes_are_404(server, path):
    assert _post(server, path, {})[0] == 404


def test_off_geometry_request_is_400(server):
    clips = _clips(1)
    code, payload = _post(server, "/predict",
                          {"slow": clips["slow"][0, :1].tolist(),
                           "fast": clips["fast"][0].tolist()})
    assert code == 400 and "geometry" in payload["error"]


def test_entry_points_need_cuda_unless_asked_for_cpu(jax_side):
    art = jax_side[0]
    model = create_model(tcfg.parse_cli(ARGV).model, "fp32")
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.InferenceEngine(model, num_classes=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.InferenceEngine.from_artifact(art)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_server(tcfg.parse_cli(["--serve.checkpoint", art,
                                     "--serve.scheduler", "micro"]))


@pytest.mark.parametrize("extra", [["--serve.scheduler", "fifo"],
                                   ["--serve.streaming"],
                                   ["--serve.quantization", "int4"]])
def test_unported_serving_options_refused(jax_side, extra):
    with pytest.raises(SystemExit):
        build_server(tcfg.parse_cli(["--serve.checkpoint", jax_side[0],
                                     "--cpu", *extra]))


def test_int8_artifact_raises(tmp_path, jax_side):
    """int8 artifacts load now (tests/test_torch_quantize.py); one whose
    weights are missing raises at the weights, an unknown mode at its meta."""
    art = tmp_path / "q"
    art.mkdir()
    (art / "meta.json").write_text(json.dumps(
        {"format": tckpt.INFERENCE_FORMAT, "quantization": "int8"}))
    with pytest.raises(FileNotFoundError, match="weights.npz"):
        tckpt.load_inference(str(art))
    (art / "meta.json").write_text(json.dumps(
        {"format": tckpt.INFERENCE_FORMAT, "quantization": "int4"}))
    with pytest.raises(ValueError, match="int4"):
        tckpt.load_inference(str(art))


@pytest.mark.parametrize("max_batch,shards", [(8, 1), (1, 1), (12, 1),
                                              (8, 8), (10, 3)])
def test_compute_buckets_matches_jax(max_batch, shards):
    assert (tengine.compute_buckets(max_batch, shards)
            == jengine.compute_buckets(max_batch, shards))


class _RowEngine:
    """Engine stub: logits row i = [first value of request i's clip]."""

    buckets = (1, 2, 4)

    def __init__(self):
        self.seen = []

    def bucket_for(self, n):
        return next(b for b in self.buckets if b >= n)

    def predict(self, batch):
        self.seen.append(batch["video"].shape[0])
        return batch["video"].reshape(len(batch["video"]), -1)[:, :1].astype(np.float32)


def test_batcher_pads_to_a_bucket_and_returns_each_row():
    eng = _RowEngine()
    b = MicroBatcher(eng, max_wait_ms=200.0)
    try:
        futs = [b.submit({"video": np.full((1, 2, 2, 3), i + 1, np.uint8)})
                for i in range(3)]
        got = [float(f.result(timeout=10)[0]) for f in futs]
    finally:
        b.close()
    assert got == [1.0, 2.0, 3.0]
    assert eng.seen == [4]  # 3 requests, padded to the 4-bucket


def test_batcher_under_thread_pressure_answers_every_request_once():
    """More submitting threads than cores, a short switch interval: every
    future resolves with its own row and the stats count each request once."""
    import sys
    import threading

    from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats

    eng, stats = _RowEngine(), ServingStats()
    b = MicroBatcher(eng, max_wait_ms=1.0, stats=stats, max_queue=1024)
    results, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def client(i):
        try:
            for j in range(8):
                v = (i * 8 + j) % 250 + 1
                got = b.submit({"video": np.full((1, 1, 1, 1), v, np.uint8)})
                results[(i, j)] = (v, float(got.result(timeout=30)[0]))
        except Exception as e:  # noqa: BLE001 - surfaced by the assert below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        b.close()
    assert not errors
    assert len(results) == 128 and all(v == got for v, got in results.values())
    assert stats.snapshot()["requests"] == 128.0


def test_admission_sheds_recovers_and_drains():
    adm = AdmissionController(max_queue=10, shed_frac=0.5, recover_frac=0.2)
    assert adm.admit(0) == (True, 0.0)
    assert adm.admit(5)[0] is False and adm.state() == DEGRADED
    assert adm.admit(3)[0] is True and adm.state() == DEGRADED
    assert adm.admit(2)[0] is True and adm.state() == HEALTHY
    adm.start_draining()
    assert adm.admit(0)[0] is False and adm.state() == DRAINING
