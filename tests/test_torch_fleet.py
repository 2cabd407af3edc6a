"""The port's serving fleet (`fleet/pool.py`, `router.py`, `hotswap.py`,
`loadgen.py`) against the JAX package's, on the CPU.

- the router's choice of replica and each request's outcome, request by
  request, through both packages' `Router` over the same scripted fake
  replicas (no threads, no clocks): idle spread, least-outstanding, death
  mid-flight, every candidate shedding, and session affinity falling
  through to another replica;
- pool health gating through both packages' `ReplicaPool` pollers;
- `fleet_snapshot` equal key by key (the clock frozen in both);
- `piecewise_arrivals` and the profiles byte-equal for one seed, and the
  load generator's report classification equal;
- the port's own fleet over `StubEngine` schedulers: route-around with
  work in flight, zero failures through a hot swap under load,
  `prewarm_like` over `compiled_keys`, the `pva-torch-loadgen` selftest;
- one end-to-end `slowfast_t` fleet in fp32: two port replicas on weights
  carried from the JAX tree by `state_dict_from_jax`, hot-swapped under
  load to a green artifact the JAX package exported; zero failures, and
  every response within 1e-4 * (1 + |x|) of the JAX engine's blue or green
  logits, the post-swap ones green's.

Every wait is bounded and every pool, router and generator is closed in a
`finally`.
"""

import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from pytorchvideo_accelerate_tpu.fleet import loadgen as jloadgen
from pytorchvideo_accelerate_tpu.fleet import pool as jpool
from pytorchvideo_accelerate_tpu.fleet import router as jrouter
from pytorchvideo_accelerate_tpu.obs.registry import Registry as JRegistry
from pytorchvideo_accelerate_tpu.serving.batcher import QueueFullError as JQueueFull
from pytorchvideo_accelerate_tpu.serving.stats import ServingStats as JStats
from pytorchvideo_accelerate_tpu_torch.fleet import loadgen, pool, router
from pytorchvideo_accelerate_tpu_torch.fleet.hotswap import (
    hot_swap,
    prewarm_like,
    swap_replica,
)
from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
from pytorchvideo_accelerate_tpu_torch.obs.registry import Registry
from pytorchvideo_accelerate_tpu_torch.serving.batcher import QueueFullError
from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats
from pytorchvideo_accelerate_tpu_torch.serving.stub import StubEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each package's own classes: a fake replica raises the router's own
SIDES = {
    "port": dict(router=router, pool=pool, loadgen=loadgen,
                 shed=QueueFullError, registry=Registry, stats=ServingStats),
    "jax": dict(router=jrouter, pool=jpool, loadgen=jloadgen,
                shed=JQueueFull, registry=JRegistry, stats=JStats),
}


class FakeReplica:
    """A replica whose answers the test scripts: `mode` "ok" (a Future the
    test resolves), "shed" (raises the package's QueueFullError), "dead"
    (raises its ReplicaDeadError)."""

    def __init__(self, name, side, model=None):
        self.name, self.side, self.model = name, side, model
        self.mode = "ok"
        self.pending = []  # (tag, Future) per accepted request
        self.stats = None
        self.state = "healthy"

    def submit(self, clip, **kwargs):
        if self.mode == "shed":
            raise SIDES[self.side]["shed"]("full", retry_after_s=0.5)
        if self.mode == "dead":
            raise SIDES[self.side]["pool"].ReplicaDeadError(self.name)
        f = Future()
        self.pending.append((clip["tag"], f))
        return f

    def health(self):
        return self.state

    def queue_depth(self):
        return len(self.pending)

    def snapshot(self):
        return {}

    def close(self):
        pass


class FakePool:
    """The pool surface the router reads, without a poller."""

    name = "fake"

    def __init__(self, replicas):
        self.replicas = list(replicas)
        self.down = set()

    def routable(self):
        return [r for r in self.replicas if r.name not in self.down]

    def mark_down(self, replica):
        self.down.add(replica.name)

    def close(self):
        pass


def _outcome(f):
    if not f.done():
        return "pending"
    err = f.exception()
    return type(err).__name__ if err is not None else float(f.result()[0])


def _router_script(side):
    """One scripted run; returns [(request, replicas it was submitted to,
    outcome)] plus the router's counters."""
    reps = [FakeReplica(f"r{i}", side) for i in range(3)]
    fake = FakePool(reps)
    rt = SIDES[side]["router"].Router(fake, retries=2,
                                      registry=SIDES[side]["registry"]())
    log = []

    def send(tag, **kw):
        before = {r.name: len(r.pending) for r in reps}
        fut = rt.submit({"tag": tag}, **kw)
        to = [r.name for r in reps if len(r.pending) > before[r.name]]
        log.append([tag, to, fut])
        return fut

    def resolve(rep, i=0, err=None):
        tag, f = rep.pending.pop(i)
        if err is None:
            f.set_result(np.asarray([tag], np.float32))
        else:
            f.set_exception(err)

    # idle spread: one at a time, each answered at once
    for t in range(6):
        send(float(t))
        for r in reps:
            while r.pending:
                resolve(r)
    # least outstanding: three in flight, then a fourth
    for t in range(6, 10):
        send(float(t))
    # death mid-flight: r0's in-flight request fails as dead; re-dispatched
    r0_tags = [tag for tag, _ in reps[0].pending]
    resolve(reps[0], 0, SIDES[side]["pool"].ReplicaDeadError("r0 died"))
    for r in reps:
        while r.pending:
            resolve(r)
    assert "r0" in fake.down
    fake.down.clear()
    # a replica shed: tried on the next replica
    reps[1].mode = "shed"
    send(10.0)
    # every candidate sheds: the router sheds
    for r in reps:
        r.mode = "shed"
    shed_fut = send(11.0)
    for r in reps:
        r.mode = "ok"
    # session affinity: pinned, then its replica down, then re-pinned
    for t in (12.0, 13.0):
        send(t, session={"sid": "s1", "stride": 4})
    pinned = log[-1][1][-1]
    fake.down.add(pinned)
    send(14.0, session={"sid": "s1", "stride": 4})
    fake.down.clear()
    send(15.0, session={"sid": "s1", "stride": 4, "end": True})
    for r in reps:
        while r.pending:
            resolve(r)
    out = [(tag, to, _outcome(f)) for tag, to, f in log]
    counters = {
        "routed": sorted((labels["replica"], v) for labels, v
                         in rt._c_routed.samples()),
        "retried": rt._c_retried.value(pool="fake"),
        "shed": rt._c_shed.value(pool="fake"),
        "affine": len(rt._affinity),
        "r0_tags": r0_tags,
        "shed_retry_after": shed_fut.exception().retry_after_s,
    }
    return out, counters


def test_router_decisions_and_outcomes_equal_jax():
    got, got_c = _router_script("port")
    want, want_c = _router_script("jax")
    assert got == want and got_c == want_c
    # the script reaches every case it names: idle traffic spreads over
    # all three, four in flight put two on one replica at most
    assert len({to[0] for _, to, _ in got[:6]}) == 3
    assert max(sum(to == [n] for _, to, _ in got[6:10])
               for n in ("r0", "r1", "r2")) == 2
    assert got[10][2] == 10.0 and len(got[10][1]) == 1
    assert got[11][2] == "QueueFullError" and got[11][1] == []
    assert got_c["retried"] >= 1 and got_c["shed"] == 1
    # affinity: the two pinned advances land on one replica, the third
    # falls through elsewhere and re-pins there, and `end` forgets it
    assert got[12][1] == got[13][1]
    assert got[14][1] != got[13][1] and got[15][1] == got[14][1]
    assert got_c["affine"] == 0
    assert [o for _, _, o in got] == [float(t) for t in range(11)] + [
        "QueueFullError"] + [float(t) for t in range(12, 16)]


def _pool_script(side):
    reps = [FakeReplica(f"r{i}", side) for i in range(3)]
    p = SIDES[side]["pool"].ReplicaPool(reps, health_interval_s=0.01,
                                        registry=SIDES[side]["registry"]())
    seen = []

    def settle(want):
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            names = sorted(r.name for r in p.routable())
            if names == want:
                break
            time.sleep(0.005)
        seen.append(sorted(r.name for r in p.routable()))

    try:
        settle(["r0", "r1", "r2"])
        reps[0].state = "degraded"   # shedding at its door: still routable
        reps[1].state = "draining"
        settle(["r0", "r2"])
        reps[2].state = "dead"
        settle(["r0"])
        reps[1].state = "healthy"    # recovered: rejoins
        settle(["r0", "r1"])
        p.mark_down(reps[0])         # a router-observed death, at once
        seen.append(sorted(r.name for r in p.routable()))
        extra = FakeReplica("r3", side)
        p.add_replica(extra)
        with pytest.raises(ValueError):
            p.add_replica(extra)
        p.remove_replica(reps[2])
        seen.append(sorted(r.name for r in p.replicas))
    finally:
        p.close()
    return seen


def test_pool_health_gating_equals_jax():
    got, want = _pool_script("port"), _pool_script("jax")
    assert got == want
    assert got[:4] == [["r0", "r1", "r2"], ["r0", "r2"], ["r0"], ["r0", "r1"]]
    assert got[-1] == ["r0", "r1", "r3"]


def _snapshot(side, monkeypatch):
    clock = iter(np.arange(1000.0, 2000.0, 0.25))
    monkeypatch.setattr("time.monotonic", lambda: float(next(clock)))
    reps = []
    for i in range(2):
        stats = SIDES[side]["stats"](window=64)
        stats.observe_batch(2, 2, [0.01 * (i + 1), 0.02 * (i + 1)])
        stats.observe_batch(1, 2, [0.05])
        stats.observe_shed("deadline")
        rep = FakeReplica(f"r{i}", side, model="m")
        rep.stats = stats
        reps.append(rep)

    class Remote(FakeReplica):
        def snapshot(self):
            return {"requests": 7.0, "shed": 2.0, "rejected_503": 1.0}

    reps.append(Remote("remote", side, model="m"))
    rt = SIDES[side]["router"].Router(FakePool(reps),
                                      registry=SIDES[side]["registry"]())
    rt._track("r0", +2)
    snaps = [rt.fleet_snapshot(), rt.fleet_snapshot(model="m")]
    monkeypatch.undo()
    return snaps


def test_fleet_snapshot_equals_jax_key_by_key(monkeypatch):
    got = _snapshot("port", monkeypatch)
    want = _snapshot("jax", monkeypatch)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-12), k
    assert got[0]["requests"] == 6.0 + 7.0 and got[0]["replicas_windowed"] == 2.0
    assert got[0]["outstanding"] == 2.0 and got[1]["model_routed"] == 0.0


def test_profiles_and_arrivals_byte_equal_jax():
    profiles = [
        (loadgen.step_profile((1.0, 20.0), (0.5, 5.0, 40.0)),
         jloadgen.step_profile((1.0, 20.0), (0.5, 5.0, 40.0))),
        (loadgen.ramp_profile(2.0, 1.0, 30.0), jloadgen.ramp_profile(2.0, 1.0, 30.0)),
        (loadgen.spike_profile(10.0, 80.0, duration_s=3.0, spike_at_s=1.0,
                               spike_s=0.5),
         jloadgen.spike_profile(10.0, 80.0, duration_s=3.0, spike_at_s=1.0,
                                spike_s=0.5)),
    ]
    for mine, theirs in profiles:
        assert mine == theirs
        a = loadgen.piecewise_arrivals(np.random.default_rng(5), mine)
        b = jloadgen.piecewise_arrivals(np.random.default_rng(5), theirs)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes() and a.size > 10
        assert loadgen.profile_mean_rps(mine) == jloadgen.profile_mean_rps(theirs)
    for bad in ([(0.0, 1.0)], [(1.0, -1.0)], [(1.0, 2.0, 3.0, 4.0)], []):
        for mod in (loadgen, jloadgen):
            with pytest.raises(ValueError):
                mod.step_profile(*bad)
    base = {"video": np.zeros((2, 4, 4, 3), np.float32)}
    fa = loadgen.heavy_tail_clip_factory(base)
    fb = jloadgen.heavy_tail_clip_factory(base)
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    shapes = [(fa(ra)["video"].shape, fb(rb)["video"].shape) for _ in range(64)]
    assert all(x == y for x, y in shapes) and any(len(x) == 5 for x, _ in shapes)


class _ScriptedFront:
    """Every third request sheds at submit, every third fails, the rest
    complete: the same script for both generators."""

    def __init__(self, shed_cls):
        self.n, self.shed_cls = 0, shed_cls

    def __call__(self, clip, **kw):
        self.n += 1
        if self.n % 3 == 0:
            raise self.shed_cls("full", retry_after_s=0.5)
        f = Future()
        if self.n % 3 == 1:
            f.set_result(np.zeros(4, np.float32))
        else:
            f.set_exception(RuntimeError("boom"))
        return f


def test_loadgen_report_classification_equals_jax():
    reports = {}
    for side in ("port", "jax"):
        mod = SIDES[side]["loadgen"]
        gen = mod.LoadGen(_ScriptedFront(SIDES[side]["shed"]), rate_rps=300.0,
                          duration_s=0.2, seed=1, grace_s=5.0,
                          clip_factory=mod.heavy_tail_clip_factory(
                              {"video": np.zeros((2, 4, 4, 3), np.float32)}))
        reports[side] = gen.run()
    keys = ("offered", "completed", "shed", "failed", "shed_frac")
    got, want = reports["port"], reports["jax"]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert sorted(got) == sorted(want)
    assert got["offered"] == got["completed"] + got["shed"] + got["failed"]
    assert got["shed"] > 0 and got["failed"] > 0
    v_port = loadgen.assert_slo(got, slo_p99_ms=1e4)
    v_jax = jloadgen.assert_slo({**got}, slo_p99_ms=1e4)
    assert v_port == v_jax and any("non-shed" in v for v in v_port)
    ok = {"completed": 5.0, "p99_ms": 1.0, "failed": 0.0,
          "open_loop_ok": True, "shed_frac": 0.0}
    assert loadgen.assert_slo(ok, slo_p99_ms=10.0) == []
    assert loadgen.assert_slo({**ok, "p99_ms": 20.0}, slo_p99_ms=10.0)


# --- the port's fleet over StubEngine schedulers ----------------------------


def _clip(tag=0.0):
    v = np.zeros((2, 4, 4, 3), np.float32)
    v[0, 0, 0, 0] = tag
    return {"video": v}


def _stub_fleet(n=2, forward_s=0.001, health_interval_s=0.05):
    reps = []
    for i in range(n):
        stats = ServingStats(window=256)
        sched = Scheduler(StubEngine(tag=float(i), forward_s=forward_s),
                          stats=stats)
        reps.append(pool.LocalReplica(f"r{i}", sched))
    p = pool.ReplicaPool(reps, health_interval_s=health_interval_s,
                         registry=Registry())
    return reps, p, router.Router(p, registry=Registry())


def test_route_around_death_with_work_in_flight():
    reps, p, rt = _stub_fleet(forward_s=0.02)
    try:
        futs = [rt.submit(_clip(float(i))) for i in range(8)]
        time.sleep(0.01)
        reps[0].scheduler.close()  # dies with work queued and in flight
        out = [f.result(timeout=15) for f in futs]
        assert all(o[1] in (0.0, 1.0) for o in out)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and len(p.routable()) != 1:
            time.sleep(0.01)
        assert [r.name for r in p.routable()] == ["r1"]
        assert rt.submit(_clip()).result(timeout=10)[1] == 1.0
        # a fresh replica added back takes traffic again
        fresh = pool.LocalReplica("r2", Scheduler(StubEngine(tag=2.0),
                                                  stats=ServingStats()))
        p.add_replica(fresh)
        tags = {float(rt.submit(_clip()).result(timeout=10)[1]) for _ in range(6)}
        assert 2.0 in tags
    finally:
        rt.close()


def test_hot_swap_under_load_zero_failures_and_prewarm():
    reps, p, rt = _stub_fleet(forward_s=0.002)
    try:
        gen = loadgen.LoadGen(rt.submit, rate_rps=150.0, duration_s=0.8,
                              clip_factory=loadgen.heavy_tail_clip_factory(_clip()),
                              seed=0, grace_s=10.0)
        swapped = {}

        def swapper():
            time.sleep(0.3)
            for r in reps:
                swapped[r.name] = swap_replica(
                    r, StubEngine(tag=9.0, forward_s=0.002), prewarm=False)

        t = threading.Thread(target=swapper, daemon=True)
        t.start()
        rep = gen.run()
        t.join(timeout=10)
        assert rep["failed"] == 0 and rep["completed"] > 0, rep
        assert loadgen.assert_slo(rep, slo_p99_ms=5000.0) == []
        assert sorted(swapped) == ["r0", "r1"]
        assert rt.submit(_clip()).result(timeout=10)[1] == 9.0
        snap = rt.fleet_snapshot()
        assert snap["replicas"] == 2.0 and snap["requests"] >= rep["completed"]
    finally:
        rt.close()

    class Recording(StubEngine):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.shapes = []

        def predict(self, batch):
            self.shapes.append(batch["video"].shape)
            return super().predict(batch)

    blue = StubEngine(tag=1.0)
    blue.compiled_keys = ((("video", (2, 2, 4, 4, 3)),),
                          (("video", (4, 2, 4, 4, 3)),))
    green = Recording(tag=2.0)
    assert prewarm_like(green, blue) == 2
    assert green.shapes == [(2, 2, 4, 4, 3), (4, 2, 4, 4, 3)]


def test_loadgen_selftest_cli_exit_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "pytorchvideo_accelerate_tpu_torch.fleet.loadgen",
         "--selftest", "--rps", "80", "--duration", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["slo_ok"] is True and report["failed"] == 0.0
    assert loadgen.main(["--rps", "1"]) == 2  # no --url, no --selftest


# --- slowfast_t end to end through a hot swap -------------------------------


def test_slowfast_t_fleet_hot_swap_matches_jax_engine(tmp_path):
    import jax
    import optax

    from pytorchvideo_accelerate_tpu import models as jmodels
    from pytorchvideo_accelerate_tpu.config import (
        DataConfig as JDataConfig,
        MeshConfig as JMeshConfig,
        ModelConfig as JModelConfig,
        TrainConfig as JTrainConfig,
    )
    from pytorchvideo_accelerate_tpu.parallel.mesh import make_mesh
    from pytorchvideo_accelerate_tpu.serving.engine import (
        InferenceEngine as JEngine,
    )
    from pytorchvideo_accelerate_tpu.trainer.checkpoint import (
        export_inference as jexport,
    )
    from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState as JState
    from pytorchvideo_accelerate_tpu_torch.config import ModelConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.models.convert import (
        flatten_tree,
        state_dict_from_jax,
    )
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine

    frames, crop, classes = 4, 32, 5
    jcfg = JTrainConfig(
        mesh=JMeshConfig(data=1), mixed_precision="fp32",
        model=JModelConfig(name="slowfast_t", num_classes=classes,
                           dropout_rate=0.0),
        data=JDataConfig(num_frames=frames, crop_size=crop))
    jm = jmodels.create_model(jcfg.model, "fp32")
    rng = np.random.default_rng(0)
    clip = {"slow": rng.standard_normal((1, crop, crop, 3)).astype(np.float32),
            "fast": rng.standard_normal((frames, crop, crop, 3)).astype(np.float32)}
    variables = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.key(0), (clip["slow"][None], clip["fast"][None]))
    blue_p, bstats = variables["params"], variables["batch_stats"]
    green_p = jax.tree.map(lambda x: x * 1.5 + 0.01, blue_p)
    mesh = make_mesh(JMeshConfig(data=1), devices=jax.devices()[:1])
    oracle = {}
    for name, params in (("blue", blue_p), ("green", green_p)):
        eng = JEngine(jm, params, bstats, mesh, num_classes=classes,
                      max_batch_size=1, model_name="slowfast_t")
        oracle[name] = np.asarray(eng.predict(
            {k: v[None] for k, v in clip.items()}))[0]
    assert not np.allclose(oracle["blue"], oracle["green"], atol=1e-3)
    art = str(tmp_path / "green")
    jexport(art, JState.create(green_p, bstats, optax.sgd(0.1)), config=jcfg,
            meta={"num_classes": classes, "model": "slowfast_t"})
    sd = state_dict_from_jax(flatten_tree({"params": jax.device_get(blue_p),
                                           "batch_stats": jax.device_get(bstats)}))
    reps = []
    for i in range(2):
        model = create_model(ModelConfig(name="slowfast_t", num_classes=classes,
                                         dropout_rate=0.0), "fp32")
        stats = ServingStats(window=512)
        eng = InferenceEngine(model, sd, num_classes=classes, max_batch_size=1,
                              model_name="slowfast_t", stats=stats, device="cpu")
        eng.warmup(clip)
        reps.append(pool.LocalReplica(f"sf{i}", Scheduler(eng, stats=stats)))
    p = pool.ReplicaPool(reps, health_interval_s=0.1, registry=Registry())
    rt = router.Router(p, registry=Registry())
    futures = []

    def submit(c, **kw):
        futures.append(rt.submit(c, **kw))
        return futures[-1]

    def swapper():
        time.sleep(0.4)
        box["swap"] = hot_swap(reps, art)

    box = {}
    try:
        gen = loadgen.LoadGen(submit, rate_rps=20.0, duration_s=1.2, seed=4,
                              grace_s=20.0,
                              clip_factory=loadgen.heavy_tail_clip_factory(
                                  clip, view_mix=((1, 0.9), (2, 0.1))))
        t = threading.Thread(target=swapper, daemon=True)
        t.start()
        rep = gen.run()
        t.join(timeout=60)
        responses = [np.asarray(f.result(timeout=30)) for f in futures]
        assert rep["failed"] == 0 and rep["completed"] > 10, rep
        assert set(box["swap"]["per_replica_ms"]) == {"sf0", "sf1"}
        post = [np.asarray(rt.submit(clip).result(timeout=30)) for _ in range(4)]
    finally:
        rt.close()

    def near(x, ref):
        return np.all(np.abs(x - ref) <= 1e-4 * (1 + np.abs(ref)))

    kinds = [("blue" if near(r, oracle["blue"]) else
              "green" if near(r, oracle["green"]) else "neither")
             for r in responses]
    assert "neither" not in kinds and {"blue", "green"} <= set(kinds), kinds
    assert all(near(r, oracle["green"]) for r in post)
    assert all(int(np.argmax(r)) == int(np.argmax(oracle[k]))
               for r, k in zip(responses, kinds))


def test_streaming_hot_swap_keeps_the_ledger_and_the_budget(tmp_path):
    """A streaming replica hot-swapped with a ledger that reads a device
    (a fixed reading on the CPU): green takes blue's name, so it shares
    blue's `stream_rings:` component. Its pre-warm pool fits a budget of
    1.5 rings (the budget counts green's own pools, not blue's bytes in
    the shared component), the live session carries, and after the swap
    the component holds green's pools and the declared bytes beside them:
    `drift()` 0 for these exact estimates, the gauge published."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.obs import memory
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine
    from pytorchvideo_accelerate_tpu_torch.streaming import StreamingEngine
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import export_inference

    frames, crop, stride = 4, 16, 2
    cfg = parse_cli(["--model.name", "tiny3d", "--model.num_classes", "4",
                     "--num_frames", str(frames), "--data.crop_size", str(crop),
                     "--mixed_precision", "fp32", "--serve.max_batch_size", "1"])
    green_art = export_inference(str(tmp_path / "green"),
                                 create_model(cfg.model, "fp32", seed=5), cfg,
                                 meta={"num_classes": 4, "model": "tiny3d"})
    led = memory.configure(registry=Registry(), stats_fn=lambda: {
        "bytes_in_use": 10**9, "peak_bytes_in_use": 10**9, "bytes_limit": 10**10})
    rep = None
    try:
        eng = InferenceEngine(create_model(cfg.model, "fp32", seed=4), num_classes=4,
                              max_batch_size=1, model_name="tiny3d", device="cpu")
        ring = StreamingEngine(eng, name="swap").ring_bytes(
            StreamingEngine.geom_key(frames, crop, crop, 3, "float32"))
        se = StreamingEngine(eng, session_budget_mb=1.5 * ring / 1e6, name="swap")
        rep = pool.LocalReplica("s0", Scheduler(se, stats=ServingStats()))
        rng = np.random.default_rng(0)
        win = rng.standard_normal((frames, crop, crop, 3)).astype(np.float32)
        rep.submit({}, session={"sid": "a", "window": win, "stride": stride}
                   ).result(timeout=30)
        assert led.component_bytes("stream_rings:swap") == se._measured > 0
        out = hot_swap([rep], green_art)
        green = rep.scheduler.current_engine()
        assert green is not se and green.name == "swap" and out["per_replica_ms"]
        new = rng.standard_normal((stride, crop, crop, 3)).astype(np.float32)
        got = rep.submit({"video": new}, session={"sid": "a"}).result(timeout=30)
        want = green.full_recompute(np.concatenate([win[stride:], new])[None])[0]
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert led.component_bytes("stream_rings:swap") == green._measured > 0
        assert led.drift() == {"stream_rings:swap": 0.0}
        assert 'pva_hbm_drift_frac{component="stream_rings:swap"} 0' in led.registry.render()
    finally:
        if rep is not None:
            rep.close()
        memory.configure(enabled=False)


def test_http_replica_against_a_cpu_server(tmp_path):
    """`HttpReplica` against a `--cpu` server of a tiny3d artifact: /predict
    logits equal the engine's, health and queue depth from /healthz, the
    counters from /stats, a request for an unknown session with no window
    is `SessionUnknownError` (409), POST /drain turns health to draining,
    and a closed server reads dead and raises `ReplicaDeadError`."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.serving.server import build_server
    from pytorchvideo_accelerate_tpu_torch.streaming.session import SessionUnknownError
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import export_inference

    cfg = parse_cli(["--model.name", "tiny3d", "--model.num_classes", "4",
                     "--num_frames", "4", "--data.crop_size", "16",
                     "--mixed_precision", "fp32", "--serve.max_batch_size", "2"])
    art = export_inference(str(tmp_path / "art"), create_model(cfg.model, "fp32", seed=6),
                           cfg, meta={"num_classes": 4, "model": "tiny3d"})
    srv = build_server(parse_cli(["--serve.checkpoint", art, "--cpu", "--serve.port", "0",
                                  "--serve.streaming", "true", "--serve.stream_strides", "2",
                                  "--obs.enabled", "false"])).start()
    host, port = srv.address
    rep = pool.HttpReplica("h0", f"http://{host}:{port}", timeout_s=30.0)
    clip = {"video": np.random.default_rng(2).standard_normal((4, 16, 16, 3)).astype(np.float32)}
    try:
        got = rep.submit(clip).result(timeout=30)
        want = srv.engine.predict({"video": np.stack([clip["video"]] * 2)})[0]
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert rep.health() == "healthy" and rep.queue_depth() == 0
        assert rep.snapshot()["requests"] == 1.0
        with pytest.raises(SessionUnknownError):
            rep.submit({"video": clip["video"][:2]},
                       session={"sid": "nope"}).result(timeout=30)
        assert rep.drain() is True and rep.health() == "draining"
    finally:
        srv.close()
        rep.close()
    dead = pool.HttpReplica("h1", f"http://{host}:{port}", timeout_s=5.0)
    try:
        assert dead.health() == "dead"
        with pytest.raises(pool.ReplicaDeadError):
            dead.submit(clip).result(timeout=30)
    finally:
        dead.close()
