"""The port's fleet control loops (`fleet/control/`: signals, autoscaler,
multi-model budget, canary), `analysis/perfdiff.diff_rounds` and the memory
ledger's declared estimates against the JAX package's, on the CPU, with
the same inputs through both and the clock frozen or scripted in both:

- `SignalReader.read()` over the same registry scrape and pooled windows,
  and its EWMA off an attached history ring;
- the `Autoscaler`'s action sequence over the same scripted signals on a
  fake clock (up under backlog, hold in cooldown, down when idle, never
  the last replica, replace a confirmed-dead member);
- `ModelBudget` priority, footprint source and sheds, measured (a ledger
  that reads a device) and declared, and `MultiModelFleet`'s budget shed;
- the `CanaryController`'s ladder verdicts: a regressing canary strikes,
  then rolls back; a clean one promotes;
- `diff_rounds` on the same synthetic rounds;
- `drift()`, the snapshot and the `pva_hbm_drift_frac` gauge text.
"""

import itertools
from concurrent.futures import Future

import numpy as np
import pytest

from pytorchvideo_accelerate_tpu.analysis import perfdiff as jperfdiff
from pytorchvideo_accelerate_tpu.fleet import control as jcontrol
from pytorchvideo_accelerate_tpu.fleet import pool as jpool
from pytorchvideo_accelerate_tpu.fleet import router as jrouter
from pytorchvideo_accelerate_tpu.obs import history as jhistory
from pytorchvideo_accelerate_tpu.obs import memory as jmemory
from pytorchvideo_accelerate_tpu.obs.flight_recorder import FlightRecorder as JRecorder
from pytorchvideo_accelerate_tpu.obs.registry import Registry as JRegistry
from pytorchvideo_accelerate_tpu.serving.batcher import QueueFullError as JQueueFull
from pytorchvideo_accelerate_tpu.serving.stats import ServingStats as JStats
from pytorchvideo_accelerate_tpu_torch.analysis import perfdiff
from pytorchvideo_accelerate_tpu_torch.fleet import control, pool, router
from pytorchvideo_accelerate_tpu_torch.obs import history, memory
from pytorchvideo_accelerate_tpu_torch.obs.flight_recorder import FlightRecorder
from pytorchvideo_accelerate_tpu_torch.obs.registry import Registry
from pytorchvideo_accelerate_tpu_torch.serving.batcher import QueueFullError
from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats

SIDES = {
    "port": dict(control=control, pool=pool, router=router, history=history,
                 memory=memory, registry=Registry, stats=ServingStats,
                 shed=QueueFullError, recorder=FlightRecorder),
    "jax": dict(control=jcontrol, pool=jpool, router=jrouter, history=jhistory,
                memory=jmemory, registry=JRegistry, stats=JStats,
                shed=JQueueFull, recorder=JRecorder),
}


@pytest.fixture(autouse=True)
def _ledgers_disarmed():
    """Both packages' process-default ledgers disarmed on exit, as other
    tests expect to find them."""
    yield
    for mod in (memory, jmemory):
        mod.configure(enabled=False)


class Clock:
    """A scripted `time.monotonic` / `time.time`: `now` moves only when the
    test says so, and every read advances it by `tick`."""

    def __init__(self, start=1000.0, tick=0.0):
        self.now, self.tick = start, tick

    def __call__(self):
        self.now += self.tick
        return self.now


class Replica:
    """A replica double with the surface the control loops read."""

    def __init__(self, name, model=None, stats=None, engine=None):
        self.name, self.model, self.stats = name, model, stats
        self.state = "healthy"
        self.drained = False
        self.scheduler = _Sched(engine if engine is not None else f"{name}-blue")

    def submit(self, clip, **kw):
        f = Future()
        f.set_result(np.asarray([0.0, 1.0], np.float32))
        return f

    def health(self):
        return self.state

    def drain(self):
        self.drained = True
        self.state = "draining"
        return True

    def queue_depth(self):
        return 0

    def snapshot(self):
        return self.stats.snapshot() if self.stats is not None else {}

    def close(self):
        self.state = "dead"


class _Sched:
    def __init__(self, engine):
        self.engine = engine
        self.swaps = []

    def current_engine(self):
        return self.engine

    def swap_engine(self, green):
        self.swaps.append(green)
        self.engine = green
        return 0.0


class Pool:
    """The pool surface the controllers actuate, without a poller."""

    name = "ctl"

    def __init__(self, replicas, registry):
        self.replicas = list(replicas)
        self.down = set()
        self._g = registry.gauge("pva_fleet_healthy_replicas",
                                 "replicas currently in the routable set, "
                                 "by pool", labelnames=("pool",))
        self._g.set_function(lambda: float(len(self.routable())), pool=self.name)

    def routable(self):
        return [r for r in self.replicas if r.name not in self.down]

    def mark_down(self, replica):
        self.down.add(replica.name)

    def add_replica(self, replica):
        if any(r.name == replica.name for r in self.replicas):
            raise ValueError(replica.name)
        self.replicas = self.replicas + [replica]

    def remove_replica(self, replica, close=True):
        self.replicas = [r for r in self.replicas if r.name != replica.name]
        self.down.discard(replica.name)
        if close:
            replica.close()

    def close(self):
        pass


def _stats(side, lat):
    st = SIDES[side]["stats"](window=256)
    for i, chunk in enumerate(lat):
        st.observe_batch(len(chunk), 2, chunk)
    return st


# --- signals ------------------------------------------------------------------


def _signals(side, monkeypatch):
    clock = Clock(tick=0.125)
    monkeypatch.setattr("time.monotonic", clock)
    monkeypatch.setattr("time.time", clock)
    reg = SIDES[side]["registry"]()
    reps = [Replica(f"r{i}", stats=_stats(side, [[0.01 * (i + 1), 0.03], [0.2]]))
            for i in range(2)]
    p = Pool(reps, reg)
    rt = SIDES[side]["router"].Router(p, registry=reg)
    hist = SIDES[side]["history"].MetricsHistory(registry=reg, capacity=32)
    reader = SIDES[side]["control"].SignalReader(rt, history=hist)
    out = []
    for step in range(4):
        rt._track("r0", +step)
        rt._track("r1", +1)
        rt._c_shed.inc(pool="ctl")
        if step == 2:
            p.down.add("r1")
        sig = reader.read()
        out.append({k: v for k, v in vars(sig).items() if k != "t"})
        out[-1]["qpr"] = sig.queue_per_replica()
        out[-1]["ewma_q"] = reader.ewma("pva_fleet_queue_per_replica", 0.5)
        out[-1]["ewma_p99"] = reader.ewma("pva_fleet_p99_ms", 0.5)
    monkeypatch.undo()
    return out


def test_signal_reader_equals_jax(monkeypatch):
    got = _signals("port", monkeypatch)
    want = _signals("jax", monkeypatch)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-12), k
    assert got[2]["routable"] == 1.0 and got[3]["shed_total"] == 4.0
    assert got[3]["per_replica_outstanding"] == {"r0": 6.0, "r1": 4.0}
    assert got[0]["p99_ms"] > 0 and got[3]["ewma_q"] is not None


# --- autoscaler ---------------------------------------------------------------

# (queue_depth, p99_ms) per tick: backlog, cooldown, more backlog, idle,
# idle past the floor, a death
_SCRIPT = [(40.0, 100.0), (40.0, 100.0), (40.0, 2000.0), (40.0, 100.0),
           (0.0, 10.0), (0.0, 10.0), (0.0, 10.0), (0.0, 10.0), (0.0, 10.0),
           (0.0, 10.0), (0.0, 10.0), (0.0, 10.0)]


def _autoscale(side, monkeypatch):
    clock = Clock()
    monkeypatch.setattr("time.monotonic", clock)
    reg = SIDES[side]["registry"]()
    p = Pool([Replica("r0"), Replica("r1")], reg)
    rt = SIDES[side]["router"].Router(p, registry=reg)
    ctl = SIDES[side]["control"]
    sig = {"q": 0.0, "p99": 0.0}

    class Reader:
        history = None

        def read(self, model=None):
            return ctl.ControlSignals(
                t=clock.now, routable=float(len(p.routable())),
                members=float(len(p.replicas)), outstanding=0.0,
                queue_depth=sig["q"], p99_ms=sig["p99"], throughput_rps=0.0,
                shed_total=0.0)

    spawned, reaped = [], []

    def spawn():
        r = Replica(f"s{len(spawned)}")
        spawned.append(r.name)
        return r

    scaler = ctl.Autoscaler(rt, spawn_fn=spawn, reap_fn=lambda r: reaped.append(r.name),
                            min_replicas=1, max_replicas=4, slo_p99_ms=500.0,
                            queue_high=4.0, queue_low=0.5, cooldown_s=2.0,
                            interval_s=0.25, ewma_alpha=0.5, drain_grace_s=0.0,
                            dead_after_ticks=2, reader=Reader())
    actions = []
    for i, (q, p99) in enumerate(_SCRIPT):
        sig["q"], sig["p99"] = q, p99
        if i == 9:  # a member dies: confirmed after two ticks, replaced
            victim = p.replicas[-1]
            victim.state = "dead"
            p.down.add(victim.name)
        actions.append((scaler.step(), scaler.target,
                        sorted(r.name for r in p.replicas)))
        clock.now += 1.5
    history = [{k: v for k, v in e.items() if k != "t"} for e in scaler.history]
    monkeypatch.undo()
    return actions, history, spawned, reaped


def test_autoscaler_action_sequence_equals_jax(monkeypatch):
    got = _autoscale("port", monkeypatch)
    want = _autoscale("jax", monkeypatch)
    assert got == want
    actions, history, spawned, reaped = got
    kinds = [a for a, _, _ in actions]
    assert kinds[0] == "up" and kinds[1] == "hold"  # the cooldown holds
    assert "down" in kinds and "replace" in kinds
    # never below one routable member, and never past the maximum
    assert all(1 <= len(m) <= 4 for _, _, m in actions)
    assert spawned and reaped and len(history) == sum(k != "hold" for k in kinds)
    with pytest.raises(ValueError):
        control.Autoscaler(None, min_replicas=0)


def test_autoscaler_never_drains_the_last_replica(monkeypatch):
    for side in ("port", "jax"):
        reg = SIDES[side]["registry"]()
        p = Pool([Replica("only")], reg)
        rt = SIDES[side]["router"].Router(p, registry=reg)
        ctl = SIDES[side]["control"]
        scaler = ctl.Autoscaler(rt, spawn_fn=lambda: Replica("x"),
                                min_replicas=1, max_replicas=2,
                                cooldown_s=0.0)
        assert scaler._drain_one(p.routable()) is False
        assert [r.name for r in p.replicas] == ["only"]


# --- the multi-model budget ---------------------------------------------------


def _budget(side, measured):
    mem = SIDES[side]["memory"]
    stats = {"bytes_in_use": 10**9, "peak_bytes_in_use": 10**9,
             "bytes_limit": 8 * 10**9}
    if measured:
        led = mem.configure(registry=SIDES[side]["registry"](),
                            stats_fn=lambda: dict(stats))
        led.register("model_weights:a", 300 * 10**6)
        led.register("model_weights:b", 900 * 10**6)
    else:
        mem.configure(enabled=False)
    ctl = SIDES[side]["control"]
    budget = ctl.ModelBudget(1000.0)
    for m, mb in (("a", 100.0), ("b", 500.0), ("c", 600.0)):
        budget.register(m, mb)
    out = {"usage": budget.usage_mb(), "over": budget.over_budget(),
           "fp": {m: budget.footprint_mb(m) for m in "abc"},
           "src": {m: budget.footprint_source(m) for m in "abc"}}
    reg = SIDES[side]["registry"]()
    reps = [Replica(f"{m}{i}", model=m) for m in "abc" for i in range(2)]
    rt = SIDES[side]["router"].Router(Pool(reps, reg), registry=reg)
    fleet = ctl.MultiModelFleet(rt, budget)
    fleet.register_model("d", 50.0, latency_buckets_ms=(5, 50))
    outcomes = []
    for m in "abcd":
        try:
            f = fleet.submit({"video": np.zeros((2, 4, 4, 3), np.float32)}, model=m)
            outcomes.append((m, "ok", float(f.result(timeout=5)[1])))
        except SIDES[side]["shed"] as e:
            outcomes.append((m, "shed", e.retry_after_s))
    out["outcomes"] = outcomes
    out["models"] = fleet.models()
    out["budget_shed"] = {m: fleet.model_snapshot(m)["budget_shed"] for m in "abc"}
    out["ladder"] = fleet.stats_for("d")._h_latency.render().count("_bucket")
    mem.configure(enabled=False)
    return out


@pytest.mark.parametrize("measured", [True, False], ids=["measured", "declared"])
def test_model_budget_priority_and_sheds_equal_jax(measured):
    got, want = _budget("port", measured), _budget("jax", measured)
    assert got == want
    if measured:
        assert got["src"] == {"a": "measured", "b": "measured", "c": "declared"}
        assert got["fp"]["b"] == 900.0 and got["over"] == ["b", "c"]
    else:
        assert set(got["src"].values()) == {"declared"}
        assert got["over"] == ["c"]
    assert ("a", "ok", 0.0 + 1.0) in got["outcomes"]


# --- the canary ---------------------------------------------------------------


class _WindowStats:
    """A replica's stats as the canary reads them: a window of (done_ts,
    latency_s), counters, exemplars; the same script for both packages."""

    def __init__(self):
        self.lat, self.counts = [], {"requests": 0.0, "errors": 0.0,
                                     "shed": 0.0, "rejected": 0.0}

    def add(self, ts, lat_s, n=1, errors=0):
        self.lat.extend((ts + 0.001 * i, lat_s) for i in range(n))
        self.counts["requests"] += n
        self.counts["errors"] += errors

    def window(self):
        return list(self.lat), []

    def snapshot(self):
        return dict(self.counts)

    def slowest_traces(self, k=5):
        return [{"trace_id": "t-slow", "latency_ms": 120.0}][:k]


def _canary(side, monkeypatch, regress):
    clock = Clock()
    monkeypatch.setattr("time.monotonic", clock)
    reg = SIDES[side]["registry"]()
    reps = [Replica(f"r{i}", stats=_WindowStats()) for i in range(4)]
    p = Pool(reps, reg)
    rt = SIDES[side]["router"].Router(p, registry=reg)
    ctl = SIDES[side]["control"].CanaryController(rt, fraction=0.5,
                                                 prewarm=False)
    verdicts = []
    entry = ctl.start_rollout(lambda r: f"{r.name}-green", label="v2")
    canaries = entry["canaries"]
    for window in range(3):
        clock.now += 10.0
        for r in reps:
            slow = regress and r.name in canaries
            r.stats.add(clock.now, 0.30 if slow else 0.05, n=20,
                        errors=1 if slow else 0)
        v = ctl.evaluate()
        verdicts.append({k: v[k] for k in ("action", "strikes", "regressions",
                                           "rolled_back", "keys")})
        verdicts[-1]["canary"] = v["canary"]
        if v["action"] == "rollback":
            break
    if not regress:
        verdicts.append(ctl.promote())
    engines = {r.name: r.scheduler.engine for r in reps}
    monkeypatch.undo()
    return canaries, verdicts, ctl.state, engines


@pytest.mark.parametrize("regress", [True, False], ids=["rollback", "promote"])
def test_canary_ladder_verdicts_equal_jax(monkeypatch, regress):
    got = _canary("port", monkeypatch, regress)
    want = _canary("jax", monkeypatch, regress)
    assert got == want
    canaries, verdicts, state, engines = got
    assert canaries == ["r0", "r1"]
    if regress:
        assert [v["action"] for v in verdicts] == ["observe", "rollback"]
        assert [v["strikes"] for v in verdicts] == [1, 2]
        assert "serve_p99_ms" in verdicts[0]["regressions"]
        assert state == "rolled_back" and engines["r0"] == "r0-blue"
    else:
        assert all(v.get("strikes", 0) == 0 for v in verdicts[:-1])
        assert state == "promoted"
        assert set(engines.values()) == {f"r{i}-green" for i in range(4)}


# --- perfdiff -----------------------------------------------------------------


def test_diff_rounds_equals_jax():
    old = {"metric": "m", "value": 10.0, "serve_p99_ms": 100.0, "mfu": None,
           "fleet_shed_frac": 0.0, "swap_blackout_ms": 4.0,
           "models": {"x3d_m": 5.0, "slowfast_r50": 2.0, "bad": "err"}}
    new = {"metric": "m", "value": 8.0, "serve_p99_ms": 90.0, "mfu": 0.4,
           "fleet_shed_frac": 0.3, "swap_blackout_ms": 4.1,
           "models": {"x3d_m": 6.0, "slowfast_r50": 1.0, "bad": 3.0}}
    for thr in (0.05, 0.2):
        got = perfdiff.diff_rounds(old, new, threshold=thr)
        assert got == jperfdiff.diff_rounds(old, new, threshold=thr)
    got = perfdiff.diff_rounds(old, new, threshold=0.05)
    assert got["regressions"] == ["fleet_shed_frac", "models.slowfast_r50", "value"]
    assert got["appeared"] == ["mfu"] and not got["ok"]
    assert perfdiff.HIGHER_BETTER == jperfdiff.HIGHER_BETTER
    assert perfdiff.LOWER_BETTER == jperfdiff.LOWER_BETTER


# --- the ledger's declared estimates ------------------------------------------


def _drift(side):
    mem = SIDES[side]["memory"]
    reg = SIDES[side]["registry"]()
    readings = itertools.chain(
        [{"bytes_in_use": 5000, "peak_bytes_in_use": 6000, "bytes_limit": 10**6}],
        itertools.repeat({"bytes_in_use": 7000, "peak_bytes_in_use": 8000,
                          "bytes_limit": 10**6}))
    led = mem.MemoryLedger(registry=reg, recorder=SIDES[side]["recorder"](),
                           stats_fn=lambda: dict(next(readings)))
    snaps = []
    led.register("stream_rings:a", 900, declared=1000)
    led.register("stream_rings:a", 1300, declared=1000)  # a lying estimate
    led.register("model_weights:m", 400)
    snaps.append((led.drift(), led.snapshot()))
    led.release("stream_rings:a", 900, declared=1000)
    snaps.append((led.drift(), led.snapshot()))
    led.release("stream_rings:a")
    snaps.append((led.drift(), led.snapshot(), led.measured_bytes("model_weights:m")))
    return snaps, reg.render()


def test_ledger_drift_and_gauge_text_equal_jax():
    got, got_text = _drift("port")
    want, want_text = _drift("jax")
    assert got == want and got_text == want_text
    assert got[0][0] == {"stream_rings:a": pytest.approx(0.1)}
    assert got[1][0] == {"stream_rings:a": pytest.approx(0.3)}
    assert got[1][1]["drift_over_tol"] == ["stream_rings:a"]
    assert got[2][0] == {} and got[2][2] == 400
    assert 'pva_hbm_drift_frac{component="stream_rings:a"}' in got_text
    # the module hooks pass the estimate through; disarmed they are a no-op
    led = memory.configure(registry=Registry(), stats_fn=lambda: None)
    memory.register("x", 10, declared=20)
    assert led.drift() == {"x": 0.5} and led.measured_bytes("x") is None
    memory.configure(enabled=False)
    memory.register("x", 10, declared=20)
