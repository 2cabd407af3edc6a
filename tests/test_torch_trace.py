"""Distributed tracing and on-demand profiling in the port (`obs/trace.py`,
`obs/tracetool.py`, `obs/profiler.py`, the registry's exemplars and the
hooks in spans, the prefetcher, the serving fronts, the server and the
Trainer) against the JAX package's modules, with the same seeds: the same
sampling decisions, trace and span ids; `traceparent` across packages;
the spans hook; exemplar text; `pva-torch-trace` merges; `parse_steps`'s
errors. Then the port's own behaviour (the counterparts of
tests/test_ztrace.py and test_zhbmobs.py's profiler tests): atomic
`profile_<tag>/` windows on the CPU with busy / 409 / 503, a tiny CPU
Trainer with `--data.transport process --obs.profile_steps 1..2
--obs.trace_sample_rate 1` against the thread transport, and a CPU
server's `/profile` and `traceparent` echo."""

import json
import os
import random
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pytorchvideo_accelerate_tpu import obs as jobs
from pytorchvideo_accelerate_tpu.obs import profiler as jprofiler
from pytorchvideo_accelerate_tpu.obs import spans as jspans
from pytorchvideo_accelerate_tpu.obs import trace as jtrace
from pytorchvideo_accelerate_tpu.obs import tracetool as jtracetool
from pytorchvideo_accelerate_tpu.obs.registry import Registry as JRegistry
from pytorchvideo_accelerate_tpu.serving.stats import ServingStats as JServingStats
from pytorchvideo_accelerate_tpu_torch import obs
from pytorchvideo_accelerate_tpu_torch.config import parse_cli
from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
from pytorchvideo_accelerate_tpu_torch.obs import profiler, trace, tracetool
from pytorchvideo_accelerate_tpu_torch.obs.flight_recorder import FlightRecorder
from pytorchvideo_accelerate_tpu_torch.obs.registry import Registry
from pytorchvideo_accelerate_tpu_torch.serving.batcher import MicroBatcher
from pytorchvideo_accelerate_tpu_torch.serving.server import InferenceServer
from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats
from pytorchvideo_accelerate_tpu_torch.serving.stub import StubEngine
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOLATILE = ("ts", "dur", "pid", "tid")


def _disarm():
    for mod in (trace, jtrace):
        mod.disable_tracing()
    profiler.configure(enabled=False)
    jprofiler.configure(enabled=False)


@pytest.fixture(autouse=True)
def disarmed():
    """Every test starts and leaves with both packages' tracer and profiler
    disarmed (other files' servers arm them in this process), and runs with
    both packages' process-default span collectors enabled (another file's
    `obs.configure(enabled=False)` may have left one off); their prior
    state comes back on exit."""
    _disarm()
    prior = [(mod, mod.get_collector().enabled) for mod in (obs, jobs)]
    for mod, _ in prior:
        mod.configure(enabled=True)
    yield
    _disarm()
    for mod, enabled in prior:
        mod.configure(enabled=enabled)


@pytest.fixture
def tracer():
    return trace.configure_tracing(1.0, seed=0, capacity=1024)


def _seed_ids(seed):
    """The same id stream in both packages (each draws its ids from a
    module-level `random.Random`, urandom-seeded by default)."""
    for mod in (trace, jtrace):
        mod._ids = random.Random(seed)
        mod._ids_pid = os.getpid()


def _stable(events):
    return [{k: v for k, v in e.items() if k not in VOLATILE} for e in events]


def _script(mod, t):
    """One sequence of roots, forced probes, spans, queue events and a
    continued trace."""
    decisions = []
    for i in range(24):
        if i % 5 == 4:
            with t.start("probe", force=True, i=i):
                pass
        h = t.start("request", i=i)
        decisions.append(h is not None)
        if h is None:
            continue
        with h:
            with mod.span("device_dispatch", batch=2):
                pass
            t.event(h.ctx, "sched_wait", 1.0, 0.25, priority="batch")
    remote = mod.TraceContext("ab" * 16, "cd" * 8)
    with t.continue_trace(mod.format_traceparent(remote), "http_predict"):
        with mod.span("inner"):
            pass
    return decisions


def test_same_decisions_trace_and_span_ids_as_jax():
    _seed_ids(11)
    mine = trace.configure_tracing(0.5, seed=7, capacity=512)
    theirs = jtrace.configure_tracing(0.5, seed=7, capacity=512)
    got, want = _script(trace, mine), _script(jtrace, theirs)
    assert got == want and 0 < sum(got) < len(got)
    assert _stable(mine.export()["traceEvents"]) == _stable(
        theirs.export()["traceEvents"])
    drop = ("overhead_s", "last_export")
    assert ({k: v for k, v in mine.stats().items() if k not in drop}
            == {k: v for k, v in theirs.stats().items() if k not in drop})
    # the same roots (their order is by measured duration)
    assert sorted(e["trace_id"] for e in mine.slowest(50)) == sorted(
        e["trace_id"] for e in theirs.slowest(50))


def test_traceparent_crosses_packages():
    ctx = trace.TraceContext("12" * 16, "34" * 8)
    back = jtrace.parse_traceparent(trace.format_traceparent(ctx))
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    jctx = jtrace.TraceContext("56" * 16, "78" * 8)
    back = trace.parse_traceparent(jtrace.format_traceparent(jctx))
    assert (back.trace_id, back.span_id) == (jctx.trace_id, jctx.span_id)
    unsampled = f"00-{'ab' * 16}-{'cd' * 8}-00"  # flag 00: the head said no
    for bad in ("", "junk", "00-zz-xx-01", unsampled,
                "00-short-cdcdcdcdcdcdcdcd-01", None):
        assert trace.parse_traceparent(bad) is None
        assert jtrace.parse_traceparent(bad) is None


def test_spans_hook_matches_jax():
    """Under an armed tracer an obs span on a traced thread is also a trace
    event, in both packages alike; untraced or disarmed it is none."""
    _seed_ids(5)
    events = []
    for mod, spans_mod in ((trace, obs.spans), (jtrace, jspans)):
        t = mod.configure_tracing(1.0, seed=3, capacity=64)
        with spans_mod.span("orphan"):  # no active trace: no event
            pass
        with t.start("step_root", force=True, gstep=7):
            with spans_mod.span("step"):
                with spans_mod.span("log"):
                    pass
        spans_mod.get_collector().pop_window()
        events.append(_stable(t.export()["traceEvents"]))
        mod.disable_tracing()
    assert events[0] == events[1]
    by_name = {e["name"]: e["args"] for e in events[0]}
    assert set(by_name) == {"log", "step", "step_root"}
    assert by_name["step"]["parent_id"] == by_name["step_root"]["span_id"]
    assert by_name["log"]["parent_id"] == by_name["step"]["span_id"]
    with obs.span("disarmed") as s:
        assert s._trace is None
    obs.get_collector().pop_window()


def test_exemplar_text_equals_jax(monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1_700_000_000.123456)
    mine, theirs = ServingStats(window=32), JServingStats(window=32)
    for stats in (mine, theirs):
        stats.observe_batch(1, 2, [0.004], trace_ids=["slow-trace"])
        stats.observe_batch(2, 2, [0.0005, 0.2], trace_ids=["fast", None])
        stats.observe_batch(1, 2, [0.0004], trace_ids=[None])  # no pin
        stats.observe_batch(1, 2, [99.0], trace_ids=['q"uote'])  # +Inf
    h_mine, h_theirs = mine._h_latency, theirs._h_latency
    assert h_mine.render(exemplars=True) == h_theirs.render(exemplars=True)
    assert h_mine.render() == h_theirs.render()
    assert "trace_id=" not in h_mine.render()
    assert h_mine.exemplars() == h_theirs.exemplars()
    assert mine.slowest_traces() == theirs.slowest_traces()
    reg, jreg = Registry(), JRegistry()
    for r in (reg, jreg):
        r.histogram("pva_x_seconds", "x", buckets=(0.1, 1.0)).observe(
            0.5, trace_id="t1")
        r.counter("pva_y_total", "y").inc()
    assert reg.render(exemplars=True) == jreg.render(exemplars=True)
    assert '# {trace_id="t1"} 0.5 1700000000.123' in reg.render(exemplars=True)


def _trace_inputs(tmp_path):
    _seed_ids(2)
    t = trace.Tracer(sample_rate=1.0, seed=0, capacity=64)
    for i in range(3):
        with t.start("request", force=True, i=i):
            with t.span("work"):
                pass
    ring = str(tmp_path / "trace_ring.json")
    t.dump(ring)
    rec = FlightRecorder(capacity=32)
    rec.record("watchdog", "stall", stalled=["train"])
    rec.warn("slow step", step=3)
    flight = str(tmp_path / "flight_record.json")
    rec.dump(flight)
    torn = tmp_path / "torn.json"
    torn.write_text('{"traceEvents": [')
    return [ring, flight, str(torn)]


def test_tracetool_merges_equal_to_jax(tmp_path, capsys):
    inputs = _trace_inputs(tmp_path)
    outs = {}
    for name, mod in (("torch", tracetool), ("jax", jtracetool)):
        out = str(tmp_path / f"merged_{name}.json")
        assert mod.main(["--out", out, "--slowest", "2", *inputs]) == 0
        cap = capsys.readouterr()
        summary = json.loads(cap.out)
        summary.pop("out")
        assert "skipping" in cap.err and "torn.json" in cap.err
        outs[name] = (json.load(open(out)), summary)
    assert outs["torch"] == outs["jax"]
    merged, summary = outs["torch"]
    assert summary["events"] == 8 and summary["traces"] == 3
    assert {e["ph"] for e in merged["traceEvents"]} == {"X", "i"}
    ts = [e["ts"] for e in merged["traceEvents"]]
    assert ts == sorted(ts)
    for mod in (tracetool, jtracetool):
        assert mod.main([inputs[2]]) == 2  # nothing readable
    capsys.readouterr()
    assert tracetool.linked_traces(merged, ["request", "work"]) == sorted(
        {e["args"]["trace_id"] for e in merged["traceEvents"]
         if e["ph"] == "X"})


@pytest.mark.parametrize("spec", ["", "5..10", "0..1", "5", "10..5", "-1..4",
                                  "3..3", "a..b", "1..2..3", " 1..2"])
def test_parse_steps_raises_what_jax_raises(spec):
    def run(fn):
        try:
            return ("ok", fn(spec))
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(profiler.parse_steps) == run(jprofiler.parse_steps)


# --- the port's tracer on its own ---------------------------------------------

def test_sampling_deterministic_and_bounds():
    a = trace.Tracer(sample_rate=0.5, seed=123)
    b = trace.Tracer(sample_rate=0.5, seed=123)
    da = [a.start("r") is not None for _ in range(64)]
    assert da == [b.start("r") is not None for _ in range(64)]
    assert 0 < sum(da) < 64
    c = trace.Tracer(sample_rate=0.5, seed=123)
    dc = []
    for _ in range(64):  # forced starts do not consume the decision stream
        assert c.start("probe", force=True) is not None
        dc.append(c.start("r") is not None)
    assert dc == da and a.stats()["sampled"] == sum(da)
    with pytest.raises(ValueError):
        trace.Tracer(sample_rate=1.5)
    assert trace.configure_tracing(0.0) is None and trace.get_tracer() is None


def test_disarmed_costs_one_global_read():
    trace.disable_tracing()
    assert trace.root("x", k=1) is trace.NOOP
    assert trace.span("x") is trace.NOOP
    assert trace.attach(None) is trace.NOOP
    assert trace.capture() is None and trace.current_traceparent() is None
    assert trace.dump() is None and trace.snapshot() == {"enabled": False}


def test_thread_handoff_ring_bound_and_dump(tracer, tmp_path):
    h = tracer.start("root", force=True)
    with h:
        ctx = trace.capture()
        assert ctx is h.ctx and trace.current_traceparent().split("-")[1] == \
            h.ctx.trace_id

        def worker():
            with trace.attach(ctx), trace.span("child_work"):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()
    events = tracer.export()["traceEvents"]
    assert [e["name"] for e in events] == ["child_work", "root"]
    assert events[0]["args"]["parent_id"] == h.ctx.span_id
    for e in events:
        assert e["ph"] == "X" and isinstance(e["ts"], float) and e["dur"] >= 0
    path = tracer.dump(str(tmp_path / "ring.json"))
    assert json.load(open(path))["traceEvents"] == json.loads(
        json.dumps(events))
    small = trace.Tracer(sample_rate=1.0, seed=0, capacity=16)
    for i in range(40):
        with small.start("r", force=True, seq=i):
            pass
    st = small.stats()
    assert (st["ring_occupancy"], st["events_recorded"],
            st["events_evicted"]) == (16, 40, 24)
    assert trace.rank_file_name(0) == "trace_ring.json"
    assert trace.rank_file_name(2) == "trace_ring.rank2.json"


@pytest.mark.parametrize("front", ["edf", "micro"])
def test_queue_hop_carries_the_context(tracer, front):
    """Scheduler and MicroBatcher: the submitter's context crosses the
    queue; its wait and the dispatch join the trace, and the completion
    pins the exemplar and the slowest list."""
    stats = ServingStats(window=64)
    engine = StubEngine(forward_s=0.001)
    fe = (Scheduler(engine, stats=stats, max_queue=64) if front == "edf"
          else MicroBatcher(engine, stats=stats, max_wait_ms=1.0))
    try:
        h = tracer.start("request", force=True)
        with h:
            fut = fe.submit({"video": np.zeros((2, 4, 4, 3), np.float32)})
        fut.result(timeout=10)
        untraced = fe.submit({"video": np.zeros((2, 4, 4, 3), np.float32)})
        untraced.result(timeout=10)
    finally:
        fe.close()
    by_name = {e["name"]: e["args"] for e in tracer.export()["traceEvents"]}
    wait = "sched_wait" if front == "edf" else "queue_wait"
    assert by_name[wait]["trace_id"] == h.ctx.trace_id
    assert by_name["device_dispatch"]["trace_id"] == h.ctx.trace_id
    assert by_name["device_dispatch"]["parent_id"] == h.ctx.span_id
    assert [ex[0] for ex in stats._h_latency.exemplars().values()] == [
        h.ctx.trace_id]
    assert [s["trace_id"] for s in stats.slowest_traces()] == [h.ctx.trace_id]


def test_multiprocess_merge_two_children(tmp_path):
    """Two child processes each dump a ring; the merge puts both on one
    timeline with their own pids."""
    child = """
import json, sys
sys.path.insert(0, {root!r})
from pytorchvideo_accelerate_tpu_torch.obs import trace
t = trace.configure_tracing(1.0, seed={seed}, capacity=64)
with t.start("child_root", force=True, host={seed}):
    with trace.span("child_work"):
        pass
print(json.dumps({{"path": t.dump({path!r})}}))
"""
    paths = []
    for i in (0, 1):
        out = str(tmp_path / f"ring_{i}.json")
        proc = subprocess.run([sys.executable, "-c",
                               child.format(root=ROOT, seed=i, path=out)],
                              timeout=120, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["path"] == out
        paths.append(out)
    summary = tracetool.summarize(tracetool.merge_paths(paths))
    assert summary["events"] == 4 and summary["traces"] == 2
    assert len(summary["pids"]) == 2


# --- the profiler ---------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.events, self.warns = [], []

    def record(self, kind, name, **fields):
        self.events.append((kind, name, fields))

    def warn(self, message, **fields):
        self.warns.append((message, fields))


def _names(trace_json):
    return {e.get("name") for e in json.load(open(trace_json))["traceEvents"]}


def test_profiler_atomic_publish_and_singleton(tmp_path):
    rec = _Recorder()
    prof = profiler.ProfilerCapture(str(tmp_path), recorder=rec)
    assert prof.start(tag="t1") is True and prof.busy
    # mid-capture only the dot-prefixed temporary directory exists
    assert os.path.isdir(tmp_path / ".profile_tmp_t1")
    assert not os.path.isdir(tmp_path / "profile_t1")
    assert prof.start(tag="t2") is False  # one window at a time
    with torch.profiler.record_function("pva_marker"):
        torch.ones(4) @ torch.ones(4)
    final = prof.stop()
    assert final == str(tmp_path / "profile_t1")
    assert "pva_marker" in _names(tmp_path / "profile_t1" / "trace.json")
    assert sorted(os.listdir(tmp_path)) == ["profile_t1"]
    assert prof.snapshot()["captures"] == 1 and prof.stop() is None
    assert [(k, n) for k, n, _ in rec.events] == [("profile", "start"),
                                                  ("profile", "stop")]
    ranked = profiler.ProfilerCapture(str(tmp_path), rank=1)
    assert ranked.start(tag="t3") and ranked.stop() == str(
        tmp_path / "profile_t3.rank1")


def test_profiler_capture_for_background_stop(tmp_path):
    prof = profiler.ProfilerCapture(str(tmp_path))
    assert prof.capture_for(2.0, tag="bg") == "bg"
    assert prof.busy and prof.capture_for(0.05) is None  # busy
    prof.join(timeout=20)
    assert os.path.isfile(tmp_path / "profile_bg" / "trace.json")
    assert not prof.busy and prof.snapshot()["captures"] == 1


def test_profiler_refusal_is_recorded_not_raised(tmp_path):
    """A second torch.profiler session while another runs: torch would run
    both into one another; the capture refuses, records it, returns False."""
    rec = _Recorder()
    prof = profiler.ProfilerCapture(str(tmp_path), recorder=rec)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert prof.start(tag="x") is False
    assert not prof.busy
    assert any("refused" in m for m, _ in rec.warns)
    assert not os.path.isdir(tmp_path / ".profile_tmp_x")
    assert profiler.get_profiler() is None
    assert profiler.configure(output_dir=str(tmp_path)) is profiler.get_profiler()
    assert profiler.configure(enabled=False, output_dir=str(tmp_path)) is None


# --- the Trainer ----------------------------------------------------------------

_RUN = ["--cpu", "--synthetic", "--model.name", "tiny3d", "--num_frames", "4",
        "--data.crop_size", "32", "--data.min_short_side_scale", "32",
        "--data.max_short_side_scale", "40", "--batch_size", "2",
        "--gradient_accumulation_steps", "2", "--num_epochs", "1",
        "--data.synthetic_num_videos", "16", "--num_workers", "2",
        "--model.fused_kernels", "auto", "--mixed_precision", "fp32"]


def _fit(out, transport, extra=()):
    tr = Trainer(parse_cli(_RUN + ["--data.transport", transport,
                                   "--output_dir", str(out), *extra]))
    losses = []
    step = tr.train_step

    def recording(state, batch):
        metrics = step(state, batch)
        losses.append(metrics["loss"].detach().clone())
        return metrics

    tr.train_step = recording
    res = tr.fit()
    return tr, res, torch.stack(losses)


def test_trainer_process_transport_profile_window_and_trace(tmp_path):
    armed = ["--obs.profile_steps", "1..2", "--obs.trace_sample_rate", "1"]
    tr, res, losses = _fit(tmp_path / "process", "process", armed)
    assert tr.train_loader.transport == "process"
    _, _, want = _fit(tmp_path / "thread", "thread")
    assert res["steps"] == 4 and torch.equal(losses, want)  # bitwise
    out = tmp_path / "process"
    assert sorted(p for p in os.listdir(out) if "profile" in p) == [
        "profile_steps_1_2"]  # published, no temporary directory left
    assert "train" in _names(out / "profile_steps_1_2" / "trace.json")
    events = json.load(open(out / "trace_ring.json"))["traceEvents"]
    roots = [e for e in events if e["name"] == "train_step"]
    assert [e["args"]["gstep"] for e in roots] == [0, 1, 2, 3]
    assert all("parent_id" not in e["args"] and e["args"]["epoch"] == 0
               for e in roots)
    ids = {e["args"]["trace_id"] for e in roots}
    steps = [e for e in events if e["name"] == "step"]
    assert len(steps) == 4 and {e["args"]["trace_id"] for e in steps} == ids
    # the prefetcher's placements from the second step on join a step
    h2d = [e for e in events if e["name"] == "h2d"]
    assert h2d and {e["args"]["trace_id"] for e in h2d} <= ids
    merged = tracetool.merge_paths([str(out / "trace_ring.json"),
                                    str(out / "flight_record.json")])
    summary = tracetool.summarize(merged)
    assert summary["traces"] == 4 and summary["events"] == len(
        merged["traceEvents"])


def test_profile_flag_window_lands_in_profile_dir(tmp_path):
    """`--profile`: run-relative steps 2-5 into `profile_dir`, and no
    "not ported" line."""
    tr, res, _ = _fit(tmp_path / "out", "thread",
                      ["--profile", "--profile_dir", str(tmp_path / "prof"),
                       "--data.synthetic_num_videos", "28"])
    assert res["steps"] == 7
    assert os.listdir(tmp_path / "prof") == ["profile_steps_2_6"]
    assert "train" in _names(tmp_path / "prof" / "profile_steps_2_6" / "trace.json")


# --- the server -------------------------------------------------------------------

def _post(url, path, body=b"", headers=None):
    req = urllib.request.Request(url + path, data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_server_profile_and_traceparent_echo(tmp_path):
    t = trace.configure_tracing(1.0, seed=0, capacity=256,
                                output_dir=str(tmp_path))
    engine = StubEngine(forward_s=0.001)
    stats = ServingStats(window=64)
    srv = InferenceServer(engine, Scheduler(engine, stats=stats, max_queue=64),
                          stats, request_timeout_s=10.0).start()
    url = "http://%s:%d" % srv.address
    body = json.dumps({"video": np.zeros((2, 4, 4, 3)).tolist()}).encode()
    try:
        assert _post(url, "/profile?seconds=1")[0] == 503  # disarmed
        prof = profiler.configure(output_dir=str(tmp_path))
        code, _, out = _post(url, "/profile?seconds=1")
        assert code == 202 and out["capturing"] is True
        assert _post(url, "/profile?seconds=1")[0] == 409  # one at a time
        assert _post(url, "/profile?seconds=0")[0] == 400
        remote = trace.TraceContext("ab" * 16, "cd" * 8)
        code, hdrs, _ = _post(url, "/predict", body, {
            "traceparent": trace.format_traceparent(remote)})
        assert code == 200 and hdrs["x-pva-trace-id"] == remote.trace_id
        code, hdrs, _ = _post(url, "/predict", body)  # a fresh head trace
        fresh = hdrs["x-pva-trace-id"]
        assert code == 200 and fresh not in ("", remote.trace_id)
        with urllib.request.urlopen(url + "/stats", timeout=10) as r:
            snap = json.loads(r.read())
        assert {s["trace_id"] for s in snap["slowest_traces"]} == {
            remote.trace_id, fresh}
        prof.join(timeout=20)
        assert os.path.isfile(tmp_path / f"profile_{out['tag']}" / "trace.json")
    finally:
        srv.drain(grace_s=5)
    ring = json.load(open(tmp_path / "trace_ring.json"))["traceEvents"]
    mine = {e["name"]: e["args"] for e in ring
            if e["args"]["trace_id"] == remote.trace_id}
    assert set(mine) == {"http_predict", "sched_wait", "device_dispatch"}
    assert mine["http_predict"]["parent_id"] == remote.span_id
    assert t.stats()["continued"] == 1
