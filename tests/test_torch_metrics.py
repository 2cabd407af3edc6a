"""The port's `/metrics` (obs/registry.py, serving/stats.py) against the JAX
package's, and the serving defaults over HTTP on the CPU.

- The same sequence of `observe_*` calls renders byte-equal Prometheus text
  from the JAX `ServingStats` and the port's (with a fixed clock), with the
  shared latency ladder, with `--serve.latency_buckets_ms` bounds and with
  a registered bucket family; the registries' scrape and quantile agree.
- `build_server(--cpu)` with no `--serve.scheduler` flag serves through the
  EDF scheduler with the JAX engine's logits; a `deadline_ms` under the
  service time is shed with 503 + Retry-After and counted in `/stats` and
  `/metrics`; `/metrics` counts equal the requests answered; `POST /drain`
  turns `/healthz` to 503 and sheds new work; a bad
  `--serve.latency_buckets_ms` is refused with the JAX server's text.
"""

import inspect
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from pytorchvideo_accelerate_tpu import config as jcfg
from pytorchvideo_accelerate_tpu.obs import registry as jreg
from pytorchvideo_accelerate_tpu.serving import engine as jengine
from pytorchvideo_accelerate_tpu.serving import server as jserver
from pytorchvideo_accelerate_tpu.serving import stats as jstats
from pytorchvideo_accelerate_tpu.trainer import checkpoint as jckpt
from pytorchvideo_accelerate_tpu_torch import config as tcfg
from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
from pytorchvideo_accelerate_tpu_torch.obs import registry as treg
from pytorchvideo_accelerate_tpu_torch.serving import stats as tstats
from pytorchvideo_accelerate_tpu_torch.serving.admission import DRAINING
from pytorchvideo_accelerate_tpu_torch.serving.server import build_server

import test_torch_serving as tsv

SEQUENCES = {
    "served": [("batch", 3, 4, [0.004, 0.02, 0.3]), ("batch", 1, 1, [7.5]),
               ("rejected", "400"), ("rejected", "503"), ("rejected", "503"),
               ("shed", "degraded"), ("shed", "deadline"), ("error",),
               ("compile",), ("compile",), ("batch", 2, 2, [0.0011, 45.0])],
    "empty": [],
}


class _Clock:
    """A fixed monotonic clock for both stats modules (the uptime gauge)."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


def _drive(stats, seq):
    for op, *args in seq:
        getattr(stats, f"observe_{op}")(*args)


@pytest.fixture
def clocks(monkeypatch):
    clock = _Clock()
    for mod in (jstats, tstats):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=clock.monotonic))
    return clock


@pytest.mark.parametrize("buckets", [None, (0.005, 0.01, 0.025, 0.05, 0.1,
                                           0.25, 1.0)])
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_metrics_text_is_byte_equal_to_jax(clocks, seq, buckets):
    j = jstats.ServingStats(registry=jreg.Registry(), latency_buckets=buckets)
    t = tstats.ServingStats(latency_buckets=buckets)
    j.queue_depth_fn = t.queue_depth_fn = lambda: 3
    _drive(j, SEQUENCES[seq])
    _drive(t, SEQUENCES[seq])
    clocks.t += 12.5
    want = j.registry.render()
    assert t.registry.render() == want
    assert "pva_serving_request_latency_seconds_bucket" in want
    assert t.registry.scrape() == j.registry.scrape()
    snap_j, snap_t = j.snapshot(), t.snapshot()
    snap_j.pop("uptime_s"), snap_t.pop("uptime_s")
    assert snap_t == snap_j


def test_family_buckets_and_quantile_match_jax(clocks, monkeypatch):
    monkeypatch.setattr(jreg, "_FAMILY_BUCKETS", {})
    monkeypatch.setattr(treg, "_FAMILY_BUCKETS", {})
    for mod in (jreg, treg):
        mod.set_family_buckets("pva_serving_request", [0.5, 0.1, 2.0])
    j = jstats.ServingStats(registry=jreg.Registry())
    t = tstats.ServingStats()
    _drive(j, SEQUENCES["served"])
    _drive(t, SEQUENCES["served"])
    assert t.registry.render() == j.registry.render()
    name = "pva_serving_request_latency_seconds"
    for q in (0.0, 0.5, 0.9, 1.0):
        assert (t.registry.get(name).quantile(q)
                == pytest.approx(j.registry.get(name).quantile(q)))
    with pytest.raises(ValueError):
        treg.set_family_buckets("x", [])


def test_registry_kinds_and_labels_refuse_like_jax():
    r = treg.Registry()
    c = r.counter("c_total", "c", labelnames=("op",))
    assert r.counter("c_total") is c
    with pytest.raises(ValueError, match="labels"):
        c.inc(1)
    with pytest.raises(ValueError, match="decrease"):
        c.inc(-1, op="x")
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("c_total")
    g = r.gauge("g", "g")
    g.set_function(lambda: 1 / 0)
    assert "g NaN" in r.render()  # a dying callback does not break a scrape


# --- the serving defaults over HTTP ------------------------------------------


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The slowfast_t artifact of tests/test_torch_serving.py and the JAX
    engine's logits on its clips."""
    cfg = jcfg.parse_cli(tsv.ARGV)
    variables = tsv._seeded_variables(cfg)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  ema_params=None, step=3)
    art = str(tmp_path_factory.mktemp("metrics_art"))
    jckpt.export_inference(art, state, config=cfg, meta=tsv.META)
    eng = jengine.InferenceEngine.from_artifact(art)
    clips = tsv._clips(eng.buckets[0])
    return art, clips, eng.predict(clips)


def _get(srv, path):
    try:
        with urllib.request.urlopen(tsv._url(srv, path), timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _post(srv, path, body):
    req = urllib.request.Request(tsv._url(srv, path),
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def _metric(text, line_prefix):
    for line in text.splitlines():
        if line.startswith(line_prefix + " "):
            return float(line.rsplit(" ", 1)[1])
    raise KeyError(line_prefix)


def test_default_server_sheds_meters_and_drains(artifact):
    art, clips, want = artifact
    srv = build_server(tcfg.parse_cli(
        ["--serve.checkpoint", art, "--cpu", "--serve.port", "0",
         "--serve.max_batch_size", "4",
         "--serve.latency_buckets_ms", "5,10,25,50,100,250,1000,30000"])).start()
    try:
        assert isinstance(srv.batcher, Scheduler)  # no flag: edf
        answered = 0
        for row, prio in ((0, "realtime"), (5, "batch"), (2, None)):
            body = {k: v[row].tolist() for k, v in clips.items()}
            if prio:
                body["priority"] = prio
            code, _, payload = _post(srv, "/predict", body)
            assert code == 200
            np.testing.assert_allclose(np.asarray(payload["logits"]), want[row],
                                       atol=tsv.ATOL, rtol=0)
            answered += 1
        body = {k: v[1].tolist() for k, v in clips.items()}
        code, headers, payload = _post(srv, "/predict",
                                       dict(body, deadline_ms=1.0))
        assert code == 503 and int(headers["Retry-After"]) >= 1
        assert "deadline" in payload["error"]
        code, _, payload = _post(srv, "/predict", dict(body, priority="urgent"))
        assert code == 400 and "priority" in payload["error"]
        code, _, stats = _post(srv, "/stats", {})
        assert code == 404  # /stats is a GET
        stats = json.loads(_get(srv, "/stats")[2])
        assert stats["requests"] == answered and stats["shed"] == 1.0
        assert stats["rejected_400"] == 1.0
        code, headers, text = _get(srv, "/metrics")
        text = text.decode()
        assert code == 200
        assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
        assert _metric(text, "pva_serving_requests_total") == answered
        assert _metric(text, "pva_serving_request_latency_seconds_count") == answered
        assert _metric(text, 'pva_serving_shed_total{state="deadline"}') == 1.0
        assert _metric(text, 'pva_serving_request_latency_seconds_bucket{le="0.005"}') >= 0
        assert 'le="30"' in text  # the bounds of --serve.latency_buckets_ms
        code, _, health = _post(srv, "/drain", {})
        assert code == 200 and health == {"draining": True, "status": DRAINING,
                                          "queue_depth": 0}
        code, _, health = _get(srv, "/healthz")
        assert code == 503 and json.loads(health)["status"] == DRAINING
        code, headers, _ = _post(srv, "/predict", body)
        assert code == 503 and "Retry-After" in headers
        text = _get(srv, "/metrics")[2].decode()
        assert _metric(text, 'pva_serving_shed_total{state="draining"}') == 1.0
    finally:
        srv.close()


def test_bad_latency_buckets_refused_with_the_jax_text(artifact):
    parts = ("expected comma-separated millisecond bounds, e.g. ",
             "'5,10,25,50,100,250,1000'")
    source = inspect.getsource(jserver.build_server)
    assert all(f'"{p}"' in source for p in parts)  # the JAX server's text
    text = "".join(parts)
    with pytest.raises(SystemExit) as e:
        build_server(tcfg.parse_cli(["--serve.checkpoint", artifact[0], "--cpu",
                                     "--serve.latency_buckets_ms", "5,ten"]))
    assert str(e.value) == f"--serve.latency_buckets_ms '5,ten': {text}"
