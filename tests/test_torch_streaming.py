"""The port's streaming sessions against the JAX package's, on the CPU in
float32.

Each ring kind is built twice from one set of numpy-seeded flax variables
(carried into the port by `state_dict_from_jax`): a JAX `StreamingEngine`
and the port's, each over its package's `InferenceEngine`, built once per
module. The same seeded frames go through both.

- `SessionTable`: lease, advance, end, admission and TTL eviction give the
  JAX table's states and verdicts.
- Port against JAX, establish and one ring wraparound, logits at atol 1e-4
  (the serving tests' tolerance): the `frames` ring (tiny3d), the dual
  rings (slowfast_t) and the token ring (videomae_t).
- The port's incremental logits against its own `full_recompute` over two
  wraparounds; the step keys do not change once the stream is warm.
- Eviction under the budget, per-item errors that leave their neighbours
  alone, `_validate`'s refusals with the JAX messages.
- The scheduler's session launch and capability; `/stream` on a `--cpu`
  server (200, 400, 409, 503, /healthz's flag).
- The hot-swap carry: the green engine's advance sent with no window
  equals green's `full_recompute` at atol 1e-4.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu import config as jcfg
from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.obs.registry import Registry as JRegistry
from pytorchvideo_accelerate_tpu.serving import engine as jengine
from pytorchvideo_accelerate_tpu.streaming import StreamingEngine as JStreamingEngine
from pytorchvideo_accelerate_tpu.streaming import session as jsession
from pytorchvideo_accelerate_tpu_torch import config as tcfg
from pytorchvideo_accelerate_tpu_torch import models as tmodels
from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    state_dict_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.obs import alerts as obs_alerts
from pytorchvideo_accelerate_tpu_torch.obs import history as obs_history
from pytorchvideo_accelerate_tpu_torch.obs import memory as obs_memory
from pytorchvideo_accelerate_tpu_torch.obs.registry import Registry
from pytorchvideo_accelerate_tpu_torch.serving import engine as tengine
from pytorchvideo_accelerate_tpu_torch.serving.server import build_server
from pytorchvideo_accelerate_tpu_torch.serving.stub import StubEngine
from pytorchvideo_accelerate_tpu_torch.streaming import (
    SessionAdmissionError,
    SessionError,
    SessionTable,
    SessionUnknownError,
    StreamingEngine,
)
from pytorchvideo_accelerate_tpu_torch.trainer import checkpoint as tckpt

T, S, CROP, NCLS, ALPHA = 8, 2, 16, 8, 4
ATOL = 1e-4
STRIDE = {"tiny3d": S, "slowfast_t": ALPHA, "videomae_t": S}


def seeded_variables(name, seed=5, **model_kw):
    """numpy-seeded flax variables of `name` at T x CROP^2 (kernels std
    1/sqrt(fan_in), scales and BN variances in [0.5, 1.5], the rest std
    0.1), from the shapes alone (no flax init)."""
    model = jmodels.create_model(jcfg.ModelConfig(
        name=name, num_classes=NCLS, dropout_rate=0.0, **model_kw), "fp32")
    clip = jax.ShapeDtypeStruct((1, T, CROP, CROP, 3), jnp.float32)
    if name.startswith("slowfast"):
        slow = jax.ShapeDtypeStruct((1, T // ALPHA, CROP, CROP, 3), jnp.float32)
        tree = jax.eval_shape(lambda s, f: model.init(
            jax.random.PRNGKey(0), (s, f), train=False), slow, clip)
    else:
        tree = jax.eval_shape(lambda x: model.init(
            jax.random.PRNGKey(0), x, train=False), clip)
    rng = np.random.default_rng(seed)
    flat = {}
    for key, leaf in flatten_tree(tree).items():
        shape = leaf.shape
        if key.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif key.endswith(("scale", "var")):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.standard_normal(shape) * 0.1
        flat[key] = v.astype(np.float32)
    return model, unflatten_tree(flat)


def jax_stream(name, model, variables, *, quant="off", sname=None, **kw):
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables.get("batch_stats", {}))
    eng = jengine.InferenceEngine(model, params, stats, num_classes=NCLS,
                                  max_batch_size=2, model_name=name,
                                  quantization=quant)
    return JStreamingEngine(eng, session_budget_mb=4.0, session_ttl_s=60.0,
                            registry=JRegistry(), name=sname or f"j-{name}", **kw)


def port_stream(name, variables, *, quant="off", sname=None, model_kw=None,
                compute_dtype=torch.float32, **kw):
    model = tmodels.create_model(
        tcfg.ModelConfig(name=name, num_classes=NCLS, dropout_rate=0.0,
                         **(model_kw or {})), "fp32",
        data_cfg=tcfg.DataConfig(num_frames=T, crop_size=CROP))
    eng = tengine.InferenceEngine(
        model, state_dict_from_jax(variables), num_classes=NCLS,
        max_batch_size=2, model_name=name, device="cpu", quantization=quant,
        compute_dtype=compute_dtype)
    return StreamingEngine(eng, session_budget_mb=4.0, session_ttl_s=60.0,
                           registry=Registry(), name=sname or f"t-{name}", **kw)


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX stream, port stream), built on first use."""
    built = {}

    def get(name):
        if name not in built:
            model, variables = seeded_variables(name)
            built[name] = (jax_stream(name, model, variables),
                           port_stream(name, variables))
        return built[name]

    return get


def frames(rng, n, count=T):
    return rng.standard_normal((n, count, CROP, CROP, 3)).astype(np.float32)


# --- the session table -------------------------------------------------------

def _table_script(table_cls, error_cls):
    """One run of lease / advance / wrap / re-establish / end / admission /
    TTL eviction; returns every observable state and verdict."""
    out = []
    t = table_cls(ttl_s=60.0, registry=(Registry() if table_cls is SessionTable
                                        else JRegistry()), name="tbl")
    t.register_pool(("g",), capacity=2)
    s = t.establish("a", ("g",), stride=2, window=8)
    out.append((s.slot, s.off))
    for _ in range(5):
        t.advanced("a", 2)
        out.append((t.get("a").off, t.get("a").frames_seen))
    out.append(t.establish("a", ("g",), stride=2, window=8).slot)
    t.establish("b", ("g",), stride=2, window=8)
    try:
        t.establish("c", ("g",), stride=2, window=8)
        out.append("admitted")
    except error_cls as e:
        out.append(("refused", str(e), e.retry_after_s))
    with t._lock:
        t._sessions["a"].last_active -= 1e6  # a expires
    c = t.establish("c", ("g",), stride=2, window=8)
    out.append((c.sid, c.slot, t.get("a") is None))
    out.append((t.end("b"), t.end("b"), t.sweep()))
    with t._lock:
        t._sessions["c"].last_active -= 1e6
    out.append((t.sweep(), t.snapshot()))
    return out


def test_session_table_matches_jax():
    assert (_table_script(SessionTable, SessionAdmissionError)
            == _table_script(jsession.SessionTable, jsession.SessionAdmissionError))


def test_session_table_under_thread_pressure():
    """More threads than cores establish, advance and end sessions of one
    pool under a short switch interval: no slot is ever leased twice, and
    every slot is free or held once at the end."""
    import sys
    import threading

    t = SessionTable(ttl_s=60.0, registry=Registry(), name="pressure")
    t.register_pool(("g",), capacity=8)
    errors, held = [], {}
    lock = threading.Lock()

    def client(i):
        try:
            for j in range(50):
                sid = f"s{i}-{j % 3}"
                try:
                    s = t.establish(sid, ("g",), stride=2, window=8)
                except SessionAdmissionError:
                    continue
                with lock:
                    owner = held.get(s.slot)
                    assert owner in (None, sid), (s.slot, owner, sid)
                    held[s.slot] = sid
                t.advanced(sid, 2)
                with lock:
                    if held.get(s.slot) == sid:
                        del held[s.slot]
                t.end(sid)
        except Exception as e:  # noqa: BLE001 - surfaced by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    live = [s.slot for s in t.sessions()]
    assert len(live) == len(set(live))
    assert sorted(live + t._free[("g",)]) == list(range(8))


def test_session_errors_are_the_serving_errors():
    from pytorchvideo_accelerate_tpu_torch.serving.batcher import QueueFullError

    assert issubclass(SessionAdmissionError, QueueFullError)
    assert issubclass(SessionUnknownError, SessionError)
    assert issubclass(SessionError, ValueError)


# --- port against JAX --------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny3d", "slowfast_t", "videomae_t"])
def test_port_matches_jax_through_a_wraparound(pairs, name):
    """Establish two sessions, then advance them through one full ring
    wraparound: every launch's logits equal the JAX engine's."""
    js, ts = pairs(name)
    assert ts.kind == js.kind == {"tiny3d": "frames", "slowfast_t": "dual",
                                  "videomae_t": "tokens"}[name]
    assert ts._ring_names == js._ring_names
    stride = STRIDE[name]
    rng = np.random.default_rng(1)
    sids = (f"w-{name}-a", f"w-{name}-b")
    win = frames(rng, 2)
    items = [{"sid": s, "window": win[i], "stride": stride} for i, s in enumerate(sids)]
    got, want = ts.advance_batch(items), js.advance_batch(items)
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=ATOL, rtol=0)
    for _ in range(T // stride):
        f = frames(rng, 2, stride)
        items = [{"sid": s, "frames": f[i]} for i, s in enumerate(sids)]
        got, want = ts.advance_batch(items), js.advance_batch(items)
        np.testing.assert_allclose(np.stack(got), np.stack(want), atol=ATOL, rtol=0)
    assert np.abs(np.stack(want)).max() > 0.1
    for s in sids:
        assert ts.end_session(s) and js.end_session(s)


@pytest.mark.parametrize("name", ["tiny3d", "slowfast_t", "videomae_t"])
def test_incremental_matches_full_recompute(pairs, name):
    """Two wraparounds: each advance equals `full_recompute` of the window
    the client holds; once warm, a steady stream adds no step key."""
    _, ts = pairs(name)
    stride = STRIDE[name]
    rng = np.random.default_rng(2)
    sids = (f"r-{name}-a", f"r-{name}-b")
    wins = frames(rng, 2)
    out = ts.advance_batch([{"sid": s, "window": wins[i], "stride": stride}
                            for i, s in enumerate(sids)])
    np.testing.assert_allclose(np.stack(out), ts.full_recompute(wins), atol=ATOL, rtol=0)
    keys = None
    for step in range(2 * T // stride):
        f = frames(rng, 2, stride)
        wins = np.concatenate([wins[:, stride:], f], axis=1)
        out = ts.advance_batch([{"sid": s, "frames": f[i]} for i, s in enumerate(sids)])
        np.testing.assert_allclose(np.stack(out), ts.full_recompute(wins),
                                   atol=ATOL, rtol=0)
        if step == 0:
            keys = ts.compiled_stream_keys()
    assert ts.compiled_stream_keys() == keys
    for s in sids:
        assert ts.end_session(s)


def test_eviction_under_budget(pairs):
    """A full pool refuses a session while its holder is live
    (`SessionAdmissionError`, the 503) and reclaims an expired holder's
    slot, whose rows then serve the new session."""
    _, ts = pairs("tiny3d")
    rng = np.random.default_rng(4)
    geom = ts.geom_key(T, CROP, CROP, 3, ts.input_dtype)
    win = frames(rng, 1)[0]
    ts.advance_batch([{"sid": "ev-a", "window": win, "stride": S}])
    with ts.table._lock:
        saved = list(ts.table._free[geom])
        ts.table._free[geom] = []
    try:
        out = ts.advance_batch([{"sid": "ev-b", "window": win, "stride": S}])
        assert isinstance(out[0], SessionAdmissionError)
        with ts.table._lock:
            ts.table._sessions["ev-a"].last_active -= 1e6
        win_b = frames(rng, 1)[0]
        out = ts.advance_batch([{"sid": "ev-b", "window": win_b, "stride": S}])
        assert not isinstance(out[0], Exception)
        assert ts.table.get("ev-a") is None
        f = frames(rng, 1, S)[0]
        adv = ts.advance_batch([{"sid": "ev-b", "frames": f}])[0]
        np.testing.assert_allclose(
            adv, ts.full_recompute(np.concatenate([win_b[S:], f])[None])[0],
            atol=ATOL, rtol=0)
    finally:
        with ts.table._lock:
            ts.table._free[geom].extend(saved)
        ts.end_session("ev-b")


def test_per_item_errors_do_not_fail_neighbours(pairs):
    js, ts = pairs("tiny3d")
    win = frames(np.random.default_rng(5), 1)[0]
    items = [{"sid": "n-bad", "window": win, "stride": 3},  # 3 does not divide 8
             {"sid": "n-good", "window": win, "stride": S},
             {"sid": "n-unk", "frames": win[:S]},           # no window, no state
             {"sid": "", "frames": win[:S]}]
    got, want = ts.advance_batch(items), js.advance_batch(items)
    assert [type(g).__name__ for g in got] == [type(w).__name__ for w in want] \
        == ["SessionError", "ndarray", "SessionUnknownError", "SessionError"]
    assert [str(g) for g in got if isinstance(g, Exception)] \
        == [str(w) for w in want if isinstance(w, Exception)]
    np.testing.assert_allclose(got[1], want[1], atol=ATOL, rtol=0)
    assert ts.end_session("n-good") and js.end_session("n-good")


@pytest.mark.parametrize("name,geom,stride", [
    ("tiny3d", (8, 16, 16, 3), 3),
    ("tiny3d", (8, 16, 16, 3), 0),
    ("slowfast_t", (8, 16, 16, 3), 2),
    ("slowfast_t", (6, 16, 16, 3), 2),
    ("videomae_t", (8, 16, 16, 3), 1),
    ("videomae_t", (8, 12, 16, 3), 2),
])
def test_validate_refusals_match_jax(pairs, name, geom, stride):
    js, ts = pairs(name)
    key = ts.geom_key(*geom, "float32")
    with pytest.raises(SessionError) as got:
        ts._validate(key, stride)
    with pytest.raises(jsession.SessionError) as want:
        js._validate(key, stride)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,trunk", [("tiny3d", "causal"),
                                        ("slowfast_t", "windowed"),
                                        ("tiny3d", "bogus"),
                                        ("videomae_t", "windowed")])
def test_trunk_refusals_match_jax(pairs, name, trunk):
    """K/V trunks need a VideoMAE token seam, and windowed needs a band
    width: the same refusals and texts as the JAX engine's."""
    js, ts = pairs(name)
    with pytest.raises(SessionError) as got:
        StreamingEngine(ts.engine, trunk=trunk, registry=Registry())
    with pytest.raises(jsession.SessionError) as want:
        JStreamingEngine(js.engine, trunk=trunk, registry=JRegistry())
    assert str(got.value) == str(want.value)


# --- the scheduler and /stream -----------------------------------------------

def test_scheduler_session_launch_and_capability(pairs):
    _, ts = pairs("videomae_t")
    sched = Scheduler(ts, max_queue=32, realtime_deadline_ms=60000.0)
    try:
        assert sched.supports_sessions is True
        rng = np.random.default_rng(6)
        win = frames(rng, 1)[0]
        fut = sched.submit({}, session={"sid": "sch-a", "window": win, "stride": S})
        np.testing.assert_allclose(fut.result(timeout=120),
                                   ts.full_recompute(win[None])[0], atol=ATOL, rtol=0)
        f = frames(rng, 1, S)[0]
        win = np.concatenate([win[S:], f])
        bad = sched.submit({"video": f}, session={"sid": "sch-unknown"})
        fut = sched.submit({"video": f}, session={"sid": "sch-a"})
        np.testing.assert_allclose(fut.result(timeout=120),
                                   ts.full_recompute(win[None])[0], atol=ATOL, rtol=0)
        with pytest.raises(SessionUnknownError):
            bad.result(timeout=120)
        with pytest.raises(ValueError, match="sid"):
            sched.submit({"video": f}, session={})
    finally:
        sched.close()
        ts.end_session("sch-a")
    plain = Scheduler(StubEngine(), max_queue=8)
    try:
        assert plain.supports_sessions is False
        with pytest.raises(ValueError, match="streaming"):
            plain.submit({"video": np.zeros((2, 4, 4, 3), np.float32)},
                         session={"sid": "x"})
    finally:
        plain.close()


ART_ARGV = ["--model.name", "tiny3d", "--model.num_classes", str(NCLS),
            "--num_frames", str(T), "--data.crop_size", str(CROP),
            "--mixed_precision", "fp32", "--data.host_cast", "u8"]
# one tiny3d u8 session ring (8 x 16 x 16 x 3 bytes) fits, two do not
ONE_SESSION_MB = "0.01"


@pytest.fixture(scope="module")
def stream_server(tmp_path_factory):
    art = str(tmp_path_factory.mktemp("stream_art"))
    cfg = tcfg.parse_cli(ART_ARGV)
    model = tmodels.create_model(cfg.model, "fp32", data_cfg=cfg.data)
    tckpt.export_inference(art, model, cfg, meta={"num_classes": NCLS,
                                                  "model": "tiny3d"})
    srv = build_server(tcfg.parse_cli([
        "--serve.checkpoint", art, "--cpu", "--serve.port", "0",
        "--serve.max_batch_size", "2", "--serve.streaming",
        "--serve.stream_strides", f"{S},3",
        "--serve.stream_session_budget_mb", ONE_SESSION_MB,
        "--output_dir", str(tmp_path_factory.mktemp("stream_out"))])).start()
    yield srv
    srv.close()
    # leave the process-default ledger, history and alert engine disarmed,
    # as other tests of this process expect to find them
    for mod in (obs_memory, obs_history, obs_alerts):
        mod.configure(enabled=False)


def _post(srv, path, body):
    host, port = srv.address
    req = urllib.request.Request(f"http://{host}:{port}{path}",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_http_stream_happy_path_and_errors(stream_server):
    srv = stream_server
    se = srv.batcher.engine
    assert isinstance(se, StreamingEngine) and se.kind == "frames"
    # the warm-up ran stride 2 at both buckets; stride 3 was skipped
    assert {k[3] for k in se.compiled_stream_keys()} == {S}
    host, port = srv.address
    with urllib.request.urlopen(f"http://{host}:{port}/healthz") as r:
        assert json.loads(r.read())["streaming"] is True
    rng = np.random.default_rng(7)
    win = rng.integers(0, 256, (T, CROP, CROP, 3), np.uint8)
    code, _, body = _post(srv, "/stream", {"session": "h-a", "window": win.tolist(),
                                           "stride": S})
    assert code == 200 and body["session"] == "h-a"
    np.testing.assert_allclose(body["logits"], se.full_recompute(win[None])[0],
                               atol=ATOL, rtol=0)
    for _ in range(T // S + 1):
        f = rng.integers(0, 256, (S, CROP, CROP, 3), np.uint8)
        win = np.concatenate([win[S:], f])
        code, _, body = _post(srv, "/stream", {"session": "h-a", "frames": f.tolist()})
        assert code == 200
        np.testing.assert_allclose(body["logits"], se.full_recompute(win[None])[0],
                                   atol=ATOL, rtol=0)
        assert body["top1"] == int(np.argmax(body["logits"]))
    # 400: no session id; a stride that does not divide the window
    assert _post(srv, "/stream", {"frames": f.tolist()})[0] == 400
    assert _post(srv, "/stream", {"session": "h-b", "window": win.tolist(),
                                  "stride": 3})[0] == 400
    # 409: an unknown session that sends no window
    code, _, body = _post(srv, "/stream", {"session": "h-unknown", "frames": f.tolist()})
    assert code == 409 and "resendable window" in body["error"]
    # 503 + Retry-After: the budget holds one session, and h-a is live
    code, headers, body = _post(srv, "/stream", {"session": "h-c", "window": win.tolist(),
                                                 "stride": S})
    assert code == 503 and int(headers["Retry-After"]) >= 1
    assert "budget" in body["error"]
    # an end frees the slot: the refused session gets in
    assert _post(srv, "/stream", {"session": "h-a", "frames": f.tolist(),
                                  "end": True})[0] == 200
    assert _post(srv, "/stream", {"session": "h-c", "window": win.tolist(),
                                  "stride": S})[0] == 200
    se.end_session("h-c")


def test_streaming_needs_the_edf_scheduler(tmp_path):
    with pytest.raises(SystemExit, match="edf"):
        build_server(tcfg.parse_cli(["--serve.checkpoint", str(tmp_path), "--cpu",
                                     "--serve.streaming", "--serve.scheduler", "micro"]))


# --- the hot-swap carry ------------------------------------------------------

def test_hotswap_carry_without_resend(pairs):
    """Blue serves a live session; green (the same model, weights x1.25)
    is prepared from blue, then swapped in under the launch lock after
    one more blue advance: green's next advance, sent with no window,
    equals green's `full_recompute` of the window, and not blue's."""
    _, blue = pairs("videomae_t")
    sched = Scheduler(blue, max_queue=32, realtime_deadline_ms=60000.0)
    try:
        rng = np.random.default_rng(8)
        win = frames(rng, 1)[0]
        sched.submit({}, session={"sid": "hs", "window": win, "stride": S}).result(timeout=120)
        _, variables = seeded_variables("videomae_t")
        green = port_stream("videomae_t", jax.tree.map(lambda x: x * 1.25, variables),
                            sname="t-green")
        assert green.prepare_carry_from(blue) >= 2
        f = frames(rng, 1, S)[0]
        win = np.concatenate([win[S:], f])
        sched.submit({"video": f}, session={"sid": "hs"}).result(timeout=120)
        t0 = time.perf_counter()
        sched.swap_engine(green)
        assert time.perf_counter() - t0 < 60
        assert sched.current_engine() is green and green.table.get("hs") is not None
        f = frames(rng, 1, S)[0]
        win = np.concatenate([win[S:], f])
        out = sched.submit({"video": f}, session={"sid": "hs"}).result(timeout=120)
        ref = green.full_recompute(win[None])[0]
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
        assert not np.allclose(ref, blue.full_recompute(win[None])[0], atol=1e-3)
        assert green.end_session("hs")
    finally:
        sched.close()
