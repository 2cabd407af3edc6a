"""The port's telemetry and checkpoint defaults (obs/, the health gauges,
the asynchronous Checkpointer) against the JAX package's, on the CPU.

Tolerances, each stated where it is used:

- spans, flight recorder, history (ticks at injected `now=` times), alerts
  and the memory ledger (an injected allocator reading): the same call
  sequence through both packages gives equal windows, records (apart from
  their wall-clock `ts` and thread), `to_json` payloads, rule states and
  registry text, exactly;
- the health gauges against the JAX `make_train_step(health_metrics=True)`,
  fp32, within 1e-5 relative: videomae_t (AdamW) all three; slowfast_t
  (SGD) `param_norm` and `nonfinite`, and `update_ratio` within 1e-5 of the
  JAX formula (`optax.global_norm`) over the port's own parameters before
  and after the step. Against the JAX step slowfast_t's update carries the
  two frameworks' gradient difference, which tests/test_torch_train.py
  documents (narrow fast-pathway channels amplify f32 rounding; whole
  gradient within 5e-3 relative): held at 1e-2 there, measured 1.0e-3;
- at fsdp 2 (two gloo ranks, `tests/_torch_dp_worker.py health`) every rank
  reads the same gauges bitwise, and `param_norm` is one process's within
  1e-5 relative;
- the Trainer's jsonl with obs on holds the JAX Trainer's keys, apart from
  the JAX-only layers' (`JAX_ONLY_KEYS`); windows compare without the
  background spans (`h2d`, `eval_h2d`, `decode`), whose worker threads land
  them in whichever window is open;
- checkpoints: bitwise.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pytorchvideo_accelerate_tpu import obs as jobs
from pytorchvideo_accelerate_tpu.config import parse_cli as jparse_cli
from pytorchvideo_accelerate_tpu.obs import alerts as jalerts
from pytorchvideo_accelerate_tpu.obs import flight_recorder as jflight
from pytorchvideo_accelerate_tpu.obs import history as jhistory
from pytorchvideo_accelerate_tpu.obs import memory as jmemory
from pytorchvideo_accelerate_tpu.obs import registry as jreg
from pytorchvideo_accelerate_tpu.obs import spans as jspans
from pytorchvideo_accelerate_tpu.parallel.sharding import shard_batch
from pytorchvideo_accelerate_tpu.trainer import optim as joptim
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu.trainer.loop import Trainer as JTrainer
from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState as JState
from pytorchvideo_accelerate_tpu_torch import obs as tobs
from pytorchvideo_accelerate_tpu_torch import run as trun
from pytorchvideo_accelerate_tpu_torch.config import ReliabilityConfig, parse_cli
from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
from pytorchvideo_accelerate_tpu_torch.models.convert import unflatten_tree
from pytorchvideo_accelerate_tpu_torch.obs import alerts as talerts
from pytorchvideo_accelerate_tpu_torch.obs import flight_recorder as tflight
from pytorchvideo_accelerate_tpu_torch.obs import history as thistory
from pytorchvideo_accelerate_tpu_torch.obs import memory as tmemory
from pytorchvideo_accelerate_tpu_torch.obs import registry as treg
from pytorchvideo_accelerate_tpu_torch.obs import spans as tspans
from pytorchvideo_accelerate_tpu_torch.reliability.guard import GuardAction, TrainGuard
from pytorchvideo_accelerate_tpu_torch.serving.server import InferenceServer, build_server
from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats
from pytorchvideo_accelerate_tpu_torch.serving.stub import StubEngine
from pytorchvideo_accelerate_tpu_torch.trainer import checkpoint as tckpt
from pytorchvideo_accelerate_tpu_torch.trainer import optim as toptim
from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps
from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer
from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

from _torch_dp_worker import health_case, run_group
from test_torch_train import (
    _clips,
    _jax_model,
    _labels,
    _mesh1,
    _opt_cfgs,
    _seeded_flat,
    _torch_model,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# jsonl keys of layers the port does not have: the JAX package's analytic
# FLOPs counter and XLA recompile probe on the epoch line, the compile
# probe's span in the windows
JAX_ONLY_KEYS = {"mfu_analytic", "train_recompiles", "obs/compile_probe_s"}
# spans of worker threads: in whichever window is open when they end
BACKGROUND_KEYS = {"obs/h2d_s", "obs/eval_h2d_s", "obs/decode_s"}


@pytest.fixture(autouse=True)
def _disarm_defaults():
    """Leave both packages' process-default ledger, history and alert
    engine disarmed, as other tests expect to find them, and both
    packages' process-default span collectors as they were (an
    `--obs.enabled false` run below turns its package's off)."""
    prior = [(mod, mod.get_collector().enabled) for mod in (tobs, jobs)]
    yield
    for mod in (jmemory, jhistory, jalerts, tmemory, thistory, talerts):
        mod.configure(enabled=False)
    for mod, enabled in prior:
        mod.configure(enabled=enabled)


def _events(recorder):
    """A recorder's events without their wall-clock time and thread."""
    return [{k: v for k, v in e.items() if k not in ("ts", "thread")}
            for e in recorder.snapshot()]


# --- spans and the flight recorder -------------------------------------------


def _span_calls(spans_mod, flight_mod):
    rec = flight_mod.FlightRecorder(capacity=64)
    col = spans_mod.SpanCollector(recorder=rec)
    col.observe("input_wait", 0.25)
    col.observe("decode", 0.125)  # aggregated, kept out of the ring
    col.observe("step", 0.5, error=True)
    with col.span("step"):
        with col.span("log"):
            nested = col.current_stacks()
    with pytest.raises(RuntimeError):
        with col.span("ckpt"):
            raise RuntimeError("boom")
    window = col.pop_window()
    after = col.pop_window()
    col.enabled = False
    assert col.span("step").__enter__() is col.span("eval").__enter__()
    col.observe("step", 1.0)
    return rec, window, after, nested, col.pop_window()


def test_span_windows_and_records_match_jax():
    got = _span_calls(tspans, tflight)
    want = _span_calls(jspans, jflight)
    (trec, twin, tafter, tnest, toff), (jrec, jwin, jafter, jnest, joff) = got, want
    assert sorted(twin) == sorted(jwin) == ["ckpt", "decode", "input_wait", "log", "step"]
    assert {k: c for k, (_, c) in twin.items()} == {k: c for k, (_, c) in jwin.items()}
    for k in ("input_wait", "decode"):
        assert twin[k] == jwin[k]
    assert tafter == jafter == {} and toff == joff == {}
    assert list(tnest.values()) == list(jnest.values()) == [["step", "log"]]
    strip = lambda ev: [{k: v for k, v in e.items() if k != "dur_s"} for e in ev]  # noqa: E731
    assert strip(_events(trec)) == strip(_events(jrec))
    assert [e["name"] for e in _events(trec)] == ["input_wait", "step", "log", "step", "ckpt"]
    assert tspans.BACKGROUND == jspans.BACKGROUND
    assert tspans.RECORDER_EXCLUDE == jspans.RECORDER_EXCLUDE


def _flight_calls(flight_mod, path):
    rec = flight_mod.FlightRecorder(capacity=4)  # raised to the minimum, 16
    for i in range(20):
        rec.record("span", f"s{i}", dur_s=i * 0.5)
    rec.warn("non-finite loss", step=7)
    rec.set_capacity(18)
    rec.record("preempt", "SIGTERM")
    assert rec.dump() is None  # nothing installed: nowhere to write
    out = rec.dump(str(path))
    with open(out) as f:
        payload = json.load(f)
    return rec, payload


def test_flight_recorder_ring_and_dump_match_jax(tmp_path):
    trec, tpay = _flight_calls(tflight, tmp_path / "t" / "flight_record.json")
    jrec, jpay = _flight_calls(jflight, tmp_path / "j" / "flight_record.json")
    assert _events(trec) == _events(jrec)
    assert len(_events(trec)) == 17  # 16 kept, then room for 18
    assert _events(trec)[-2:] == [
        {"kind": "warning", "name": "non-finite loss", "step": 7},
        {"kind": "preempt", "name": "SIGTERM"}]
    assert trec.snapshot(last=3)[-1]["name"] == jrec.snapshot(last=3)[-1]["name"]
    strip = lambda p: [{k: v for k, v in e.items() if k not in ("ts", "thread")}  # noqa: E731
                       for e in p["events"]]
    assert strip(tpay) == strip(jpay) and sorted(tpay) == sorted(jpay)
    trec._output_dir = str(tmp_path / "installed")
    assert trec.default_path() == os.path.join(str(tmp_path / "installed"),
                                               "flight_record.json")


def test_obs_configure_switches_like_jax():
    for mod in (tobs, jobs):
        col = mod.configure(enabled=False, capacity=32)
        assert col.enabled is False and col.recorder is None
        assert mod.get_recorder()._events.maxlen == 32
        col = mod.configure(enabled=True, capacity=512)
        assert col.enabled is True and col.recorder is mod.get_recorder()


# --- history and alerts ------------------------------------------------------


def _serving_registry(reg_mod):
    reg = reg_mod.Registry()
    req = reg.counter("pva_serving_requests_total", "requests")
    shed = reg.counter("pva_serving_shed_total", "sheds", labelnames=("state",))
    err = reg.counter("pva_serving_errors_total", "errors")
    lat = reg.histogram("pva_serving_request_latency_seconds", "latency")
    depth = reg.gauge("pva_serving_queue_depth", "depth")
    return reg, (req, shed, err, lat, depth)


# per tick: requests, sheds (state), errors, latencies, queue depth
_TICKS = [(10, {}, 0, [0.01] * 10, 1), (10, {"deadline": 4}, 0, [0.2] * 10, 6),
          (10, {"deadline": 3, "degraded": 3}, 1, [0.3] * 10, 9),
          (10, {"deadline": 5}, 2, [0.25] * 10, 12), (10, {}, 0, [0.01] * 10, 1),
          (10, {}, 0, [0.01] * 10, 0), (10, {}, 0, [0.01] * 10, 0),
          (10, {}, 0, [0.01] * 10, 0)]


def _drive_ticks(metrics, tick, t0=1000.0, dt=10.0):
    req, shed, err, lat, depth = metrics
    out = []
    for i, (n, sheds, e, lats, d) in enumerate(_TICKS):
        req.inc(n)
        for state, k in sheds.items():
            shed.inc(k, state=state)
        if e:
            err.inc(e)
        for v in lats:
            lat.observe(v)
        depth.set(d)
        out.append(tick(now=t0 + i * dt))
    return out


@pytest.mark.parametrize("read", ["to_json", "keys", "window", "reads"])
def test_history_reads_match_jax(read):
    sides = {}
    for name, reg_mod, hist_mod in (("port", treg, thistory), ("jax", jreg, jhistory)):
        reg, metrics = _serving_registry(reg_mod)
        hist = hist_mod.MetricsHistory(registry=reg, capacity=6)
        _drive_ticks(metrics, hist.tick)
        sides[name] = hist
    t, j = sides["port"], sides["jax"]
    now = 1000.0 + 7 * 10.0
    if read == "to_json":
        assert t.to_json() == j.to_json()
        assert t.to_json()["occupancy"] == 6 and t.to_json()["total_ticks"] == 8
    elif read == "keys":
        keys = ["pva_serving_requests_total", "pva_serving_queue_depth", "missing"]
        assert t.to_json(keys=keys) == j.to_json(keys=keys)
    elif read == "window":
        for key in ("pva_serving_shed_total", "pva_serving_queue_depth"):
            for win in (None, 25.0, 1e9):
                assert (t.series(key, window_s=win, now=now)
                        == j.series(key, window_s=win, now=now))
    else:
        for fn, args in (("ratio", ("pva_serving_shed_total",
                                    "pva_serving_requests_total", 40.0)),
                         ("ratio", ("pva_serving_errors_total",
                                    "pva_serving_requests_total", 5.0)),
                         ("window_mean", ("pva_serving_queue_depth", 35.0))):
            assert getattr(t, fn)(*args, now=now) == getattr(j, fn)(*args, now=now)
        assert t.snapshot() == j.snapshot()
    with pytest.raises(ValueError):
        thistory.MetricsHistory(registry=treg.Registry(), capacity=1)


def _alert_run(reg_mod, hist_mod, alerts_mod, flight_mod):
    reg, metrics = _serving_registry(reg_mod)
    rec = flight_mod.FlightRecorder()
    hist = hist_mod.MetricsHistory(registry=reg, capacity=64)
    rules = alerts_mod.default_rules() + [alerts_mod.AlertRule(
        name="depth_burn", key="pva_serving_queue_depth", objective=5.0,
        fast_s=15.0, slow_s=35.0)]
    eng = alerts_mod.AlertEngine(hist, rules, registry=reg, recorder=rec)
    active = _drive_ticks(metrics, eng.tick)
    alert_text = "".join(ln for ln in reg.render().splitlines(True) if "pva_alert" in ln)
    return active, eng.snapshot(), alert_text, rec


def test_alert_engine_fires_and_clears_like_jax():
    tact, tsnap, ttext, trec = _alert_run(treg, thistory, talerts, tflight)
    jact, jsnap, jtext, jrec = _alert_run(jreg, jhistory, jalerts, jflight)
    assert tact == jact and tsnap == jsnap and ttext == jtext
    assert _events(trec) == _events(jrec)
    assert any("depth_burn" in a for a in tact)
    assert 'pva_alert_transitions_total{rule="depth_burn",to="firing"} 1' in ttext
    assert [r.name for r in talerts.default_rules()] == [
        r.name for r in jalerts.default_rules()]
    with pytest.raises(ValueError):
        talerts.AlertRule(name="x", objective=1.0, fast_s=10.0, slow_s=5.0)


# --- the memory ledger -------------------------------------------------------


class _Stats:
    """An allocator reading that steps through `readings` per call."""

    def __init__(self, readings):
        self.readings, self.i = readings, 0

    def __call__(self):
        r = self.readings[min(self.i, len(self.readings) - 1)]
        self.i += 1
        return None if r is None else dict(r)


_READINGS = [{"bytes_in_use": 1000, "peak_bytes_in_use": 1500, "bytes_limit": 2000},
             {"bytes_in_use": 1900, "peak_bytes_in_use": 1950, "bytes_limit": 2000},
             {"bytes_in_use": 500, "peak_bytes_in_use": 1950, "bytes_limit": 2000}]


def _ledger_run(reg_mod, mem_mod, flight_mod, readings):
    reg = reg_mod.Registry()
    rec = flight_mod.FlightRecorder()
    stats = _Stats(readings)
    led = mem_mod.MemoryLedger(registry=reg, recorder=rec, stats_fn=stats)
    snaps = []
    led.register("train_state", 600)
    snaps.append(led.snapshot())
    if readings[0] is not None:
        # the watermark crossed, then recovered, then crossed again
        stats.i = 3
        stats.readings = readings[1:2] * 2 + readings[2:3] * 4 + readings[1:2] * 8
    led.register("prefetch_ring:input_wait", 300)
    led.register("prefetch_ring:input_wait", 100)
    snaps.append(led.snapshot())
    led.release("prefetch_ring:input_wait", 300)
    led.release("model_weights:x", 10)  # clamped at zero
    led.register("model_weights:x", 50)
    snaps.append(led.snapshot())
    led.release("train_state")
    snaps.append((led.snapshot(), led.component_bytes("model_weights:x"), led.source()))
    return snaps, reg.render(), rec


@pytest.mark.parametrize("readings", ["card", "cpu"])
def test_memory_ledger_matches_jax(readings):
    seq = _READINGS if readings == "card" else [None]
    tsnaps, ttext, trec = _ledger_run(treg, tmemory, tflight, seq)
    jsnaps, jtext, jrec = _ledger_run(jreg, jmemory, jflight, seq)
    # nothing declares an estimate here: no drift in either ledger
    for snap in tsnaps[:3] + [tsnaps[3][0]]:
        assert snap["drift"] == {} and snap["drift_over_tol"] == []
    assert tsnaps == jsnaps and ttext == jtext
    assert _events(trec) == _events(jrec)
    if readings == "card":
        assert [e["name"] for e in _events(trec)] == ["hbm watermark crossed"]
        assert 'pva_hbm_bytes{component="unattributed"}' in ttext
    else:
        assert tsnaps[-1][1:] == (50, "estimate") and _events(trec) == []


def test_a_failed_device_reading_raises():
    def failing():
        raise RuntimeError("allocator reading failed")

    led = tmemory.MemoryLedger(registry=treg.Registry(), stats_fn=failing)
    for read in (led.source, led.snapshot, led.attributed_frac):
        with pytest.raises(RuntimeError, match="allocator reading failed"):
            read()


def test_ledger_reads_no_device_on_the_cpu_and_counts_the_train_state():
    assert tmemory.default_device_stats(torch.device("cpu")) is None
    led = tmemory.MemoryLedger(registry=treg.Registry(), device="cpu")
    assert led.device_stats() is None and led.source() == "estimate"
    model = _torch_model("tiny3d", "auto")
    opt = toptim.build_optimizer(_opt_cfgs()[1], 4, model.named_parameters())
    state = TrainState.create(model, opt, ema_decay=0.5)
    step = tsteps.make_train_step(model, opt)
    step(state, {**{k: torch.from_numpy(v) for k, v in _clips("tiny3d", 2, 5).items()},
                 "label": torch.from_numpy(_labels(2, 5))})
    tensors = (list(model.parameters()) + list(model.buffers())
               + [v for st in opt.opt.state.values() for v in st.values()
                  if torch.is_tensor(v)] + list(state.ema.values()))
    assert tmemory.tree_nbytes(state) == sum(t.numel() * t.element_size() for t in tensors)
    assert tmemory.tree_nbytes({"a": [np.zeros(3, np.float32)], "b": None}) == 12
    tmemory.configure(device="cpu", registry=treg.Registry())
    tmemory.register("x", 5)
    assert tmemory.get_ledger().component_bytes("x") == 5
    tmemory.configure(enabled=False)
    tmemory.register("x", 5)  # disarmed: a no-op
    assert tmemory.get_ledger() is None


# --- the health gauges -------------------------------------------------------


def _health_both(name, opt_kw, steps):
    """`steps` optimizer steps of `name` through the JAX step and the port's,
    both with the health gauges; per step (JAX metrics, port metrics,
    optax.global_norm of the port's parameters after, and of its update)."""
    accum, total = 2, 4
    jcfg, tcfg = _opt_cfgs(warmup_steps=0, **opt_kw)
    jm = _jax_model(name, "off")
    tree = unflatten_tree(_seeded_flat(name))
    tx = joptim.build_optimizer(jcfg, total)
    jstate = JState.create(jax.tree.map(jnp.asarray, tree["params"]),
                           jax.tree.map(jnp.asarray, tree["batch_stats"]), tx)
    mesh = _mesh1()
    jstep = jsteps.make_train_step(jm, tx, mesh, accum_steps=accum,
                                   lr_schedule=joptim.build_lr_schedule(jcfg, total),
                                   health_metrics=True)
    tm = _torch_model(name, "auto")
    topt = toptim.build_optimizer(tcfg, total, tm.named_parameters())
    tstate = TrainState.create(tm, topt)
    tstep = tsteps.make_train_step(tm, topt, accum_steps=accum, health_metrics=True)
    out = []
    for i in range(steps):
        batch = {**_clips(name, 2, 20 + i, lead=(accum,)),
                 "label": _labels(2, 20 + i, lead=(accum,))}
        jstate, jm_i = jstep(jstate, shard_batch(mesh, batch, micro_dim=True),
                             jax.random.key(i))
        before = [p.detach().numpy().copy() for p in tm.parameters()]
        tm_i = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        after = [p.detach().numpy() for p in tm.parameters()]
        pn = float(optax.global_norm([jnp.asarray(a) for a in after]))
        un = float(optax.global_norm([jnp.asarray(a - b) for a, b in zip(after, before)]))
        out.append(({k: float(v) for k, v in jm_i.items()},
                    {k: float(v) for k, v in tm_i.items()}, pn, un / max(pn, 1e-12)))
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_health_gauges_match_jax_step_videomae_adamw():
    for jm_i, tm_i, pn, ratio in _health_both(
            "videomae_t", dict(optimizer="adamw", weight_decay=0.05,
                               grad_clip_norm=0.5), steps=2):
        for k in ("param_norm", "update_ratio"):
            assert _rel(tm_i[k], jm_i[k]) <= 1e-5, (k, tm_i[k], jm_i[k])
        assert tm_i["nonfinite"] == jm_i["nonfinite"] == 0.0
        assert _rel(tm_i["param_norm"], pn) <= 1e-5
        assert _rel(tm_i["update_ratio"], ratio) <= 1e-5 and ratio > 0


def test_health_gauges_match_jax_step_slowfast_sgd():
    ((jm_i, tm_i, pn, ratio),) = _health_both("slowfast_t", {}, steps=1)
    assert _rel(tm_i["param_norm"], jm_i["param_norm"]) <= 1e-5
    assert tm_i["nonfinite"] == jm_i["nonfinite"] == 0.0
    assert _rel(tm_i["param_norm"], pn) <= 1e-5
    assert _rel(tm_i["update_ratio"], ratio) <= 1e-5 and ratio > 0
    # the update carries the frameworks' documented gradient difference
    assert _rel(tm_i["update_ratio"], jm_i["update_ratio"]) <= 1e-2


def test_health_gauges_of_a_skipped_step_and_a_nan_loss():
    """Under the guard's skip a NaN step reports nonfinite 1, the kept
    parameters' norm, and reuses the guard's snapshot (no second copy)."""
    model = _torch_model("tiny3d", "auto")
    opt = toptim.build_optimizer(_opt_cfgs(warmup_steps=0)[1], 4,
                                 model.named_parameters())
    state = TrainState.create(model, opt)
    step = tsteps.make_train_step(model, opt, guard_skip=True, health_metrics=True)
    clips = {k: torch.from_numpy(v) for k, v in _clips("tiny3d", 2, 6).items()}
    batch = {**clips, "label": torch.from_numpy(_labels(2, 6))}
    m = step(state, batch)
    assert float(m["nonfinite"]) == 0.0 and float(m["update_ratio"]) > 0
    before = torch.cat([p.detach().flatten() for p in model.parameters()])
    m = step(state, {**{k: v * float("nan") for k, v in clips.items()},
                     "label": batch["label"]})
    assert float(m["nonfinite"]) == 1.0 and float(m["skipped"]) == 1.0
    after = torch.cat([p.detach().flatten() for p in model.parameters()])
    assert torch.equal(after, before)  # kept bitwise; the norm sums per leaf
    assert float(m["param_norm"]) == pytest.approx(
        float(torch.linalg.vector_norm(before)), rel=1e-5)


def test_health_gauges_agree_on_every_rank_at_fsdp_2(tmp_path):
    one = health_case(1)
    ranks = run_group("health", tmp_path, world=2)
    assert all(r["fsdp_leaves"] > 0 for r in ranks)  # slowfast_t's res5 convs
    assert ranks[0] == ranks[1]
    assert _rel(ranks[0]["param_norm"], one["param_norm"]) <= 1e-5
    assert ranks[0]["nonfinite"] == one["nonfinite"] == 0.0
    assert _rel(ranks[0]["update_ratio"], one["update_ratio"]) <= 1e-3


# --- the Trainer ---------------------------------------------------------------


_RUN = ["--synthetic", "--model.name", "tiny3d", "--num_frames", "4",
        "--data.crop_size", "32", "--data.min_short_side_scale", "32",
        "--data.max_short_side_scale", "40",
        "--num_epochs", "2", "--data.synthetic_num_videos", "16",
        "--mixed_precision", "fp32", "--tracking.with_tracking",
        "--tracking.trackers", "jsonl", "--log_every", "1",
        "--checkpointing_steps", "2"]


def _lines(path):
    with open(path) as f:
        out = [json.loads(ln) for ln in f]
    for d in out:
        d.pop("time", None)
    return out


def test_trainer_with_obs_writes_the_jax_trainers_jsonl_keys(tmp_path):
    """The same config with obs on (the default) through both Trainers: the
    same lines in the same order, each with the JAX line's keys (apart from
    JAX-only and background keys), the same keys over the whole file, and
    the port's values sane: windows' components within their wall time,
    health gauges finite."""
    logs = {}
    for side in ("port", "jax"):
        logdir = str(tmp_path / side / "logs")
        argv = _RUN + ["--tracking.logging_dir", logdir,
                       "--output_dir", str(tmp_path / side / "out")]
        if side == "port":
            res = trun.main(argv + ["--cpu", "--batch_size", "8"])
        else:
            JTrainer(jparse_cli(argv + ["--batch_size", "1"])).fit()
        (name,) = os.listdir(logdir)
        logs[side] = _lines(os.path.join(logdir, name))
    got, want = logs["port"], logs["jax"]
    assert len(got) == len(want)
    drop = JAX_ONLY_KEYS | BACKGROUND_KEYS
    for g, w in zip(got, want):
        assert set(g) - drop == set(w) - drop, (sorted(g), sorted(w))
        assert g.get("step") == w.get("step")
    keys = lambda lines: set().union(*lines) - JAX_ONLY_KEYS  # noqa: E731
    assert keys(got) == keys(want)
    assert {"obs/step_s", "obs/input_wait_s", "obs/h2d_s", "obs/window_wall_s",
            "obs/unattributed_s", "obs/log_s", "obs/sync_s", "obs/ckpt_s",
            "obs/eval_s", "obs/param_norm", "obs/update_ratio", "obs/nonfinite",
            "obs_step_s", "obs_input_wait_frac", "obs_h2d_s"} <= keys(got)
    for ln in got:
        if "obs/window_wall_s" in ln:
            consumer = sum(v for k, v in ln.items() if k.startswith("obs/")
                           and k.endswith("_s") and k not in BACKGROUND_KEYS
                           and k not in ("obs/window_wall_s", "obs/unattributed_s"))
            assert consumer <= ln["obs/window_wall_s"]
        if "obs/param_norm" in ln:
            assert np.isfinite(ln["obs/param_norm"]) and ln["obs/nonfinite"] == 0.0
    assert res["obs_step_s"] > 0 and 0 <= res["obs_input_wait_frac"] <= 1


def test_obs_off_logs_no_obs_key_and_arms_nothing(tmp_path):
    logdir = str(tmp_path / "logs")
    res = trun.main(_RUN + ["--cpu", "--batch_size", "8", "--num_epochs", "1",
                            "--obs.enabled", "false", "--tracking.logging_dir",
                            logdir, "--output_dir", str(tmp_path / "out")])
    (name,) = os.listdir(logdir)
    lines = _lines(os.path.join(logdir, name))
    assert not [k for ln in lines for k in ln if k.startswith("obs")]
    assert not [k for k in res if k.startswith("obs")]
    steps = [ln for ln in lines if "train_loss_step" in ln]
    assert steps and all(set(ln) == {"step", "train_loss_step", "lr", "grad_norm"}
                         for ln in steps)
    assert tmemory.get_ledger() is None and thistory.get_history() is None
    assert not os.path.exists(tmp_path / "out" / "flight_record.json")


def test_fit_exception_dumps_flight_record(tmp_path):
    out = tmp_path / "out"
    tr = Trainer(parse_cli(_RUN + ["--cpu", "--batch_size", "8",
                                   "--tracking.logging_dir", str(tmp_path / "logs"),
                                   "--output_dir", str(out)]))
    led = tmemory.get_ledger()
    assert led is not None and led.component_bytes("train_state") == (
        tmemory.tree_nbytes(tr.state))

    def boom(state, batch):
        raise RuntimeError("injected step failure")

    tr.train_step = boom
    with pytest.raises(RuntimeError, match="injected step failure"):
        tr.fit()
    with open(out / "flight_record.json") as f:
        data = json.load(f)
    exc = [e for e in data["events"] if e["kind"] == "exception"]
    assert exc and exc[-1]["name"] == "RuntimeError"
    assert "injected step failure" in exc[-1]["message"] and exc[-1]["step"] == 0
    assert any(e["kind"] == "span" and e["name"] == "step" and e.get("error")
               for e in data["events"])


# --- asynchronous checkpoints -------------------------------------------------


def _state(seed=0):
    model = _torch_model("tiny3d", "auto")
    opt = toptim.build_optimizer(_opt_cfgs()[1], 4, model.named_parameters())
    state = TrainState.create(model, opt, ema_decay=0.5)
    step = tsteps.make_train_step(model, opt, ema_decay=0.5)
    step(state, {**{k: torch.from_numpy(v) for k, v in _clips("tiny3d", 2, seed).items()},
                 "label": torch.from_numpy(_labels(2, seed))})
    return state, step


def _flat(sd, prefix=""):
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if torch.is_tensor(fa[k]):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_async_save_restores_bitwise_like_a_sync_one(tmp_path):
    state, step = _state()
    want = _flat({k: (v if not isinstance(v, dict) else _flat(v))
                  for k, v in state.state_dict().items()})
    want = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in want.items()}
    a = Checkpointer(str(tmp_path / "a"))
    s = Checkpointer(str(tmp_path / "s"), use_async=False)
    assert a.use_async and not s.use_async
    a.save(1, state, {"kind": "step"})
    s.save(1, state, {"kind": "step"})
    # the step after the dispatch changes the live state in place: the
    # queued host copy is what lands
    step(state, {**{k: torch.from_numpy(v) for k, v in _clips("tiny3d", 2, 9).items()},
                 "label": torch.from_numpy(_labels(2, 9))})
    a.wait()
    assert a.all_steps() == s.all_steps() == [1]
    load = lambda c: torch.load(os.path.join(c.directory, "1", "state.pt"),  # noqa: E731
                                weights_only=True)
    _assert_bitwise(load(a), load(s))
    got = load(a)
    _assert_bitwise(_flat({k: (v if not isinstance(v, dict) else _flat(v))
                           for k, v in got.items()}), want)
    other, _ = _state(seed=3)
    extra, st = a.restore(other)
    assert st == 1 and extra == {"kind": "step"}
    _assert_bitwise(other.state_dict(), load(s))
    assert [e["step"] for e in a.write_log] == [1]
    assert {"fence_s", "dispatch_s", "write_s"} <= set(a.write_log[0])
    a.close()
    assert a._writer is None


def test_a_failed_async_write_surfaces_from_wait(tmp_path, monkeypatch):
    state, _ = _state()

    def failing(obj, path):
        raise OSError(28, "No space left on device (injected)")

    monkeypatch.setattr(tckpt.torch, "save", failing)
    ck = Checkpointer(str(tmp_path / "ck"), reliability=ReliabilityConfig(
        ckpt_retries=2, retry_base_delay_s=0.001))
    ck.save(3, state, {"kind": "step"})  # returns: the write is queued
    with pytest.raises(OSError, match="injected"):
        ck.wait()
    ck.wait()  # reported once
    ck.save(4, state, {"kind": "step"})
    with pytest.raises(OSError, match="injected"):
        ck.close()
    monkeypatch.undo()
    assert ck.all_steps() == [] and os.listdir(ck.directory) == []


class _Closing:
    """A checkpointer or guard stand-in: `close(barrier)` records its
    argument and raises `error`, if any."""

    def __init__(self, error=None):
        self.error, self.calls = error, []

    def close(self, barrier=True):
        self.calls.append(barrier)
        if self.error is not None:
            raise self.error


def test_trainer_close_fences_every_writer_and_keeps_the_unwound_error(tmp_path):
    tr = Trainer(parse_cli(_RUN + ["--cpu", "--tracking.logging_dir", str(tmp_path / "logs"),
                                   "--output_dir", str(tmp_path / "a")]))
    tr.checkpointer, tr.train_guard = _Closing(OSError("run write failed")), _Closing()
    with pytest.raises(OSError, match="run write failed"):
        tr.close()
    # the guard's ring is fenced although the run's checkpointer raised
    assert tr.checkpointer.calls == [True] and tr.train_guard.calls == [True]
    tr = Trainer(parse_cli(_RUN + ["--cpu", "--tracking.logging_dir", str(tmp_path / "logs"),
                                   "--output_dir", str(tmp_path / "b")]))
    tr.checkpointer = _Closing()
    tr.train_guard = _Closing(OSError("ring write failed"))
    unwound = RuntimeError("step failed")
    tr.close(unwound)  # adds to the error on its way out, never replaces it
    assert tr.checkpointer.calls == [False] and tr.train_guard.calls == [False]
    assert unwound.__notes__ == [
        "also raised while closing: OSError('ring write failed')"]


def test_a_failed_write_rides_on_the_exception_that_ends_fit(tmp_path, monkeypatch):
    tr = Trainer(parse_cli(_RUN + ["--cpu", "--batch_size", "8", "--checkpointing_steps",
                                   "1", "--reliability.ckpt_retries", "1",
                                   "--tracking.logging_dir", str(tmp_path / "logs"),
                                   "--output_dir", str(tmp_path / "out")]))
    step_fn = tr.train_step

    def step(state, batch):
        m = step_fn(state, batch)
        if state.step == 2:
            raise RuntimeError("injected step failure")
        return m

    def failing(obj, path):
        raise OSError(28, "No space left on device (injected)")

    tr.train_step = step
    monkeypatch.setattr(tckpt.torch, "save", failing)
    with pytest.raises(RuntimeError, match="injected step failure") as info:
        tr.fit()
    assert [n for n in info.value.__notes__ if "No space left" in n]


def test_a_rank_unwinding_after_an_async_save_fences_without_the_barrier(tmp_path):
    r0, r1 = run_group("unwind", tmp_path, timeout_s=120)
    assert r0["error"] == repr(RuntimeError("rank 0 step failure"))
    assert r0["notes"] == [] and r0["seconds"] < 60
    assert r0["steps"] == r1["steps"] == [1]  # rank 0's writer was joined
    # its all-reduce failed as rank 0 left, well before the group's deadline
    assert r1["error"] != "None" and r1["seconds"] < 60


_KILLED_WRITER = r"""
import sys, time, torch
sys.path.insert(0, {repo!r})
from pytorchvideo_accelerate_tpu_torch.config import ModelConfig, OptimConfig
from pytorchvideo_accelerate_tpu_torch.models import create_model
from pytorchvideo_accelerate_tpu_torch.trainer import checkpoint as tckpt
from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState
model = create_model(ModelConfig(name="tiny3d", num_classes=5), "fp32", seed=1)
state = TrainState.create(model, build_optimizer(OptimConfig(), 4,
                                                 model.named_parameters()))
ck = tckpt.Checkpointer({d!r})
ck.save(1, state, {{"kind": "step"}})
ck.wait()
def slow(obj, path):
    with open(path, "wb") as f:
        f.write(b"partial")
    print("WRITING", flush=True)
    time.sleep(600)
tckpt.torch.save = slow
ck.save(2, state, {{"kind": "step"}})
time.sleep(600)
"""


def test_a_writer_killed_mid_write_leaves_the_last_complete_step(tmp_path):
    d = str(tmp_path / "ck")
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILLED_WRITER.format(repo=REPO, d=d)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("WRITING"):
                break
        assert lines and lines[-1].startswith("WRITING"), "".join(lines)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        proc.kill()
    ck = Checkpointer(d)
    assert ck.latest_step() == 1 and ck.all_steps() == [1]
    names = os.listdir(d)
    assert sorted(n for n in names if n.isdigit()) == ["1"]
    assert all(n == "1" or n.startswith(".tmp-2-") for n in names)
    from pytorchvideo_accelerate_tpu_torch.config import ModelConfig, OptimConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model

    model = create_model(ModelConfig(name="tiny3d", num_classes=5), "fp32", seed=2)
    state = TrainState.create(model, toptim.build_optimizer(
        OptimConfig(), 4, model.named_parameters()))
    assert ck.restore(state)[1] == 1


def test_guard_rollback_after_async_lkg_saves_is_bitwise(tmp_path):
    from pytorchvideo_accelerate_tpu_torch.config import GuardConfig
    from pytorchvideo_accelerate_tpu_torch.data.pipeline import LoaderState

    state, step = _state()
    guard = TrainGuard(GuardConfig(enabled=True, lkg_every_steps=1, lkg_keep=2,
                                   warmup_steps=0),
                       output_dir=str(tmp_path))
    assert guard._checkpointer().use_async
    pos = LoaderState(epoch=0, position=1)
    ok = {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(1.0)}
    guard.step(1, ok, {}, pos, state)
    guard.step(2, ok, {}, pos, state)  # observes step 1: the LKG of step 2
    want = state.state_dict()
    want = {k: (v if not isinstance(v, dict) else _flat(v)) for k, v in want.items()}
    want = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in _flat(want).items()}
    for i in range(2):  # the live state moves on
        step(state, {**{k: torch.from_numpy(v)
                        for k, v in _clips("tiny3d", 2, 30 + i).items()},
                     "label": torch.from_numpy(_labels(2, 30 + i))})
    action = GuardAction(kind="rollback", lkg_step=guard.lkg_step,
                         resume_position={"epoch": 0, "position": 2})
    _, got_step = guard.restore(state, action)
    assert got_step == 2
    got = state.state_dict()
    got = _flat({k: (v if not isinstance(v, dict) else _flat(v)) for k, v in got.items()})
    _assert_bitwise(got, want)
    reg = tobs.get_registry().get("pva_guard_events_total")
    assert reg is not None and reg.value(action="lkg_save") >= 1
    guard.close()
    assert guard._ckpt is None


# --- /history -------------------------------------------------------------------


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _history_servers(armed):
    """The port's and the JAX server over stub engines, each stats registry
    driven by the same request sequence and ticked at the same `now=`
    times (10 s apart, ending 5 s ago) when `armed`; the alert tickers off."""
    from pytorchvideo_accelerate_tpu.fleet.scheduler import Scheduler as JScheduler
    from pytorchvideo_accelerate_tpu.serving.server import InferenceServer as JServer
    from pytorchvideo_accelerate_tpu.serving.stats import ServingStats as JStats
    from pytorchvideo_accelerate_tpu.serving.stub import StubEngine as JStub

    out = {}
    t_end = time.time() - 5.0
    for side in ("port", "jax"):
        if side == "port":
            stats = ServingStats(window=64)
            sched = Scheduler(StubEngine(), stats=stats, max_queue=8)
            hist_mod, alerts_mod = thistory, talerts
        else:
            stats = JStats(window=64, registry=jreg.Registry())
            sched = JScheduler(JStub(), stats=stats, max_queue=8)
            hist_mod, alerts_mod = jhistory, jalerts
        stats.queue_depth_fn = lambda: 2
        hist = hist_mod.configure(enabled=armed, capacity=16, registry=stats.registry)
        alerts_mod.configure(enabled=armed, history=hist, registry=stats.registry)
        server_cls = InferenceServer if side == "port" else JServer
        engine = StubEngine() if side == "port" else JStub()
        srv = server_cls(engine, sched, stats, host="127.0.0.1", port=0)
        srv.alert_tick_s = 0
        srv.start()
        for i in range(4):
            stats.observe_batch(2, 2, [0.01 * (i + 1), 0.2])
            if i == 2:
                stats.observe_shed("deadline")
            if armed:
                alerts_mod.get_engine().tick(now=t_end - (3 - i) * 10.0)
        host, port = srv.address
        out[side] = (srv, f"http://{host}:{port}")
    return out


@pytest.mark.parametrize("query", [
    "", "?keys=pva_serving_requests_total,pva_serving_shed_total",
    "?window_s=25&keys=pva_serving_requests_total", "?window_s=abc",
    "?keys=pva_serving_queue_depth&keys=pva_serving_requests_total"])
def test_history_answers_like_the_jax_server(query):
    servers = _history_servers(armed=True)
    try:
        (tcode, tbody), (jcode, jbody) = (_get(servers[s][1], "/history" + query)
                                          for s in ("port", "jax"))
    finally:
        for srv, _ in servers.values():
            srv.close()
    assert tcode == jcode
    if query == "?window_s=abc":
        assert tcode == 400 and tbody == jbody
        return
    assert tcode == 200
    tseries, jseries = tbody.pop("series"), jbody.pop("series")
    # the uptime gauge reads each server's own clock; every other series
    # is the same ticks of the same counts
    for series in (tseries, jseries):
        series.pop("pva_serving_uptime_seconds", None)
    assert tseries == jseries and tbody == jbody
    if "window_s=25" in query:
        assert [len(v) for v in tseries.values()] == [2]
    else:
        assert tbody["occupancy"] == 4
    assert set(tbody["alerts"]) == {"serve_latency_burn", "shed_burn", "error_burn"}


def test_history_is_503_while_disarmed_like_the_jax_server():
    servers = _history_servers(armed=False)
    try:
        (tcode, tbody), (jcode, jbody) = (_get(servers[s][1], "/history")
                                          for s in ("port", "jax"))
    finally:
        for srv, _ in servers.values():
            srv.close()
    assert tcode == jcode == 503 and tbody == jbody


def test_build_server_arms_the_ledger_history_and_alerts(tmp_path):
    """build_server with obs on: /metrics carries the engine's weight
    bytes, /history answers 200 once the ticker has ticked; with
    `--obs.enabled false` /history is 503."""
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import export_inference

    argv = ["--model.name", "tiny3d", "--model.num_classes", "5", "--num_frames", "4",
            "--data.crop_size", "32", "--mixed_precision", "fp32"]
    cfg = parse_cli(argv)
    model = create_model(cfg.model, "fp32", data_cfg=cfg.data)
    art = export_inference(str(tmp_path / "art"), model, config=cfg,
                           meta={"num_classes": 5, "model": "tiny3d"})
    weight_bytes = tmemory.tree_nbytes(model)
    serve = ["--serve.checkpoint", art, "--cpu", "--serve.port", "0",
             "--serve.max_batch_size", "1", "--output_dir", str(tmp_path / "srv")]
    srv = build_server(parse_cli(serve))
    srv.alert_tick_s = 0.05
    srv.start()
    try:
        host, port = srv.address
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        line = 'pva_hbm_bytes{component="model_weights:tiny3d"} '
        assert any(ln.startswith(line) and float(ln.split()[-1]) == weight_bytes
                   for ln in text.splitlines())
        deadline = time.time() + 10
        while True:
            code, body = _get(base, "/history?keys=pva_serving_queue_depth")
            if code == 200 and body["series"]["pva_serving_queue_depth"]:
                break
            assert time.time() < deadline, (code, body)
            time.sleep(0.05)
    finally:
        srv.close()
    assert tmemory.get_ledger().component_bytes("model_weights:tiny3d") == 0
    off = build_server(parse_cli(serve + ["--obs.enabled", "false"])).start()
    try:
        host, port = off.address
        assert _get(f"http://{host}:{port}", "/history")[0] == 503
    finally:
        off.close()
