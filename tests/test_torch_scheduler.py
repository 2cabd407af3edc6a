"""The port's EDF scheduler (fleet/scheduler.py) against the JAX package's,
on host-side stub engines (no model).

Mirrors the JAX package's scheduler tests (tests/test_zfleet.py): each
request resolves with its own row; realtime is work-conserving while batch
coalesces; an unmeetable deadline is shed as `ShedError` (a 503); the queue
bound and close semantics; validation; a swap waits out the launch in
flight and refuses a bucket drift; `ServingStats.merge` pools windows and
counts a shed once. Then one seeded arrival trace goes through the JAX
`Scheduler` and the port's, each on its own stub: the launches come in the
same order with the same rows. Timing margins are 4x or more: the suite
runs under parallel workers.
"""

import threading
import time

import numpy as np
import pytest

from pytorchvideo_accelerate_tpu.fleet import scheduler as jsched
from pytorchvideo_accelerate_tpu.obs.registry import Registry as JRegistry
from pytorchvideo_accelerate_tpu.serving.stats import ServingStats as JServingStats
from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import (
    BATCH,
    REALTIME,
    Scheduler,
    ShedError,
)
from pytorchvideo_accelerate_tpu_torch.serving.batcher import QueueFullError
from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats
from pytorchvideo_accelerate_tpu_torch.serving.stub import StubEngine


class RowEngine(StubEngine):
    """The stub with each row's tag in column 0 and every launch recorded
    (rows, mask, tags)."""

    def __init__(self, tag=0.0, forward_s=0.001, buckets=(2, 4)):
        super().__init__(tag=tag, forward_s=forward_s, buckets=buckets)
        self.launches = []

    def predict(self, batch):
        out = super().predict(batch)
        rows = next(iter(v for k, v in batch.items() if k != "mask"))
        n = rows.shape[0]
        tags = rows.reshape(n, -1)[:, 0]
        self.launches.append((n, np.asarray(batch.get("mask")), tags.tolist()))
        out[:, 0] = tags
        return out


def _clip(tag=0.0, views=0, size=4):
    v = np.zeros((2, size, size, 3), np.float32)
    v[0, 0, 0, 0] = tag
    if views:
        v = np.stack([v] * views)
        v[:, 0, 0, 0, 0] = tag
    return {"video": v}


def _sched(engine=None, **kw):
    kw.setdefault("stats", ServingStats(window=128))
    return Scheduler(engine if engine is not None else RowEngine(), **kw)


def test_scheduler_resolves_each_request_with_its_own_row():
    s = _sched()
    try:
        futs = [s.submit(_clip(float(t))) for t in (7, 8, 9)]
        out = [f.result(timeout=30) for f in futs]
        for t, logits in zip((7, 8, 9), out):
            assert logits[0] == t  # no cross-request mix-ups
        views = s.submit(_clip(5.0, views=3)).result(timeout=30)
        assert views[0] == 5.0
    finally:
        s.close()


def test_scheduler_realtime_is_work_conserving_batch_coalesces():
    eng = RowEngine(forward_s=0.0)
    s = _sched(eng, batch_max_wait_ms=1000.0)
    try:
        # batch class: 3 requests inside the coalescing window share ONE
        # launch, although the engine sits idle meanwhile
        futs = [s.submit(_clip(float(i)), priority=BATCH) for i in range(3)]
        for f in futs:
            f.result(timeout=30)
        assert len(eng.launches) == 1, eng.launches
        n, mask, tags = eng.launches[0]
        assert n == 4  # 3 real rows padded to bucket 4
        np.testing.assert_array_equal(mask, [1, 1, 1, 0])
        assert tags == [0.0, 1.0, 2.0, 0.0]
        # realtime launches at once, without waiting for a fill
        t0 = time.monotonic()
        s.submit(_clip(1.0), priority=REALTIME).result(timeout=30)
        assert time.monotonic() - t0 < 0.25  # 4x under the batch window
        assert eng.launches[-1][0] == 2  # the smallest bucket
    finally:
        s.close()


def test_scheduler_sheds_unmeetable_deadlines_as_503():
    s = _sched(RowEngine(forward_s=0.02))
    try:
        s.submit(_clip()).result(timeout=30)  # learn the service time
        fut = s.submit(_clip(), deadline_ms=1.0)
        with pytest.raises(ShedError) as ei:
            fut.result(timeout=30)
        assert ei.value.retry_after_s > 0  # rides 503 + Retry-After
        assert isinstance(ei.value, QueueFullError)
        snap = s.stats.snapshot()
        assert snap["shed"] == 1.0 and snap["requests"] == 1.0
        assert s.stats.registry.scrape()['pva_serving_shed_total{state="deadline"}'] == 1.0
    finally:
        s.close()


def test_scheduler_queue_bound_and_close_semantics():
    release = threading.Event()
    started = threading.Event()

    class Blocking(RowEngine):
        def predict(self, batch):
            started.set()
            release.wait(30.0)
            return super().predict(batch)

    s = _sched(Blocking(), max_queue=2)
    try:
        first = s.submit(_clip(1.0))
        assert started.wait(30.0)  # the flush thread is inside predict
        s.submit(_clip(2.0))
        s.submit(_clip(3.0))
        with pytest.raises(QueueFullError):
            s.submit(_clip(4.0))
        assert s.stats.snapshot()["rejected_503"] == 1.0
        assert s.queue_depth() == 2
        release.set()
        assert first.result(timeout=30) is not None
    finally:
        release.set()
        s.close()
    with pytest.raises(RuntimeError):
        s.submit(_clip(5.0))


def test_scheduler_close_fails_pending_requests():
    release = threading.Event()
    started = threading.Event()

    class Blocking(RowEngine):
        def predict(self, batch):
            started.set()
            release.wait(30.0)
            return super().predict(batch)

    s = _sched(Blocking())
    first = s.submit(_clip(1.0))
    assert started.wait(30.0)
    pending = s.submit(_clip(2.0))
    closer = threading.Thread(target=s.close)
    closer.start()
    release.set()
    closer.join(60.0)
    assert not closer.is_alive()
    assert first.result(timeout=30)[0] == 1.0
    with pytest.raises(RuntimeError, match="closed"):
        pending.result(timeout=30)


def test_scheduler_under_thread_pressure_answers_every_request_once():
    """32 submitting threads (more than the cores) with a short switch
    interval, both classes and both geometries: every request resolves
    exactly once with its own row, and the counters add up."""
    import sys

    eng = RowEngine(forward_s=0.0, buckets=(1, 2, 4, 8))
    s = _sched(eng, batch_max_wait_ms=2.0)
    results, errors = {}, []
    lock = threading.Lock()

    def client(c):
        try:
            for j in range(8):
                tag = float(c * 100 + j + 1)
                prio = BATCH if (c + j) % 2 else REALTIME
                got = s.submit(_clip(tag, size=4 + 4 * (j % 2)),
                               priority=prio).result(timeout=60)
                with lock:
                    results[tag] = results.get(tag, 0) + (got[0] == tag)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        s.close()
    assert not errors, errors[:3]
    assert len(results) == 256 and set(results.values()) == {1}
    snap = s.stats.snapshot()
    assert snap["requests"] == 256 and snap["shed"] == 0.0
    assert sum(int(np.asarray(m).sum()) for _, m, _ in eng.launches) == 256


def test_scheduler_validates_requests():
    s = _sched()
    try:
        with pytest.raises(ValueError, match="priority"):
            s.submit(_clip(), priority="urgent")
        with pytest.raises(ValueError, match="video"):
            s.submit({"label": np.zeros((1,), np.int32)})
        with pytest.raises(ValueError, match="shape"):
            s.submit({"video": np.zeros((4, 4, 3), np.float32)})
        assert s.supports_priority and not s.supports_sessions
    finally:
        s.close()


def test_scheduler_swap_waits_out_inflight_launch_no_mixed_weights():
    """swap_engine blocks until the launch in flight is done; that launch
    answers from the old engine, the next from the new one."""
    release = threading.Event()
    started = threading.Event()

    class Blue(RowEngine):
        def predict(self, batch):
            started.set()
            release.wait(30.0)
            return super().predict(batch)

    blue = Blue(tag=1.0)
    s = _sched(blue)
    try:
        inflight = s.submit(_clip())
        assert started.wait(30.0)
        green = RowEngine(tag=2.0, forward_s=0.0)
        result = {}
        swapper = threading.Thread(
            target=lambda: result.update(blackout=s.swap_engine(green)))
        swapper.start()
        time.sleep(0.4)
        assert swapper.is_alive()  # waiting out the launch in flight
        release.set()
        swapper.join(30.0)
        assert not swapper.is_alive()
        assert inflight.result(timeout=30)[1] == 1.0  # old weights, whole
        assert s.submit(_clip()).result(timeout=30)[1] == 2.0  # new ones
        assert s.current_engine() is green
        assert result["blackout"] >= 0.1
    finally:
        release.set()
        s.close()


def test_scheduler_swap_refuses_bucket_drift():
    s = _sched()
    try:
        with pytest.raises(ValueError, match="bucket ladder"):
            s.swap_engine(RowEngine(buckets=(3, 6)))
    finally:
        s.close()


def test_stats_merge_pools_windows_instead_of_averaging_percentiles():
    a, b = ServingStats(), ServingStats()
    a.observe_batch(4, 4, [0.010] * 4)    # a fast replica
    b.observe_batch(4, 4, [0.100] * 4)    # a slow one
    merged = ServingStats.merge([a, b])
    assert merged["p99_ms"] == 100.0
    assert merged["p50_ms"] in (10.0, 100.0)
    assert merged["requests"] == 8.0
    assert merged["batch_fill_ratio"] == 1.0
    assert merged["replicas"] == 2.0


def test_stats_merge_counts_sheds_exactly_once():
    a, b = ServingStats(), ServingStats()
    a.observe_shed("degraded")
    merged = ServingStats.merge([a, b], extra={"router_shed": 3.0})
    assert merged["shed"] == 1.0          # replica sheds only
    assert merged["router_shed"] == 3.0   # router sheds ride separately
    ja, jb = JServingStats(registry=JRegistry()), JServingStats(registry=JRegistry())
    ja.observe_shed("degraded")
    want = JServingStats.merge([ja, jb], extra={"router_shed": 3.0})
    assert sorted(want) == sorted(merged)
    for k in ("shed", "router_shed", "requests", "replicas", "rejected"):
        assert merged[k] == want[k], k


class _GatedEngine:
    """Blocks its first launch until released and records every launch's
    row tags; the same class drives both schedulers."""

    model_name = "stub"
    input_dtype = "float32"
    num_classes = 4

    def __init__(self, buckets=(1, 2, 4)):
        self.buckets = buckets
        self.release = threading.Event()
        self.started = threading.Event()
        self.launches = []

    def bucket_for(self, n):
        return next(b for b in self.buckets if b >= n)

    def predict(self, batch):
        self.started.set()
        self.release.wait(60.0)
        rows = next(iter(v for k, v in batch.items() if k != "mask"))
        n = int(np.asarray(batch["mask"]).sum())
        self.launches.append(rows.reshape(rows.shape[0], -1)[:n, 0].tolist())
        out = np.zeros((rows.shape[0], self.num_classes), np.float32)
        out[:, 0] = rows.reshape(rows.shape[0], -1)[:, 0]
        return out


def _trace(seed=3, n=14):
    """A seeded arrival trace: (tag, priority, deadline_ms, geometry)."""
    rng = np.random.default_rng(seed)
    return [(float(i + 1), PRIORITY[int(rng.integers(0, 2))],
             float(rng.integers(20, 60)) * 1e3, int(rng.choice([4, 8])))
            for i in range(n)]


PRIORITY = (REALTIME, BATCH)


def _run_trace(sched_cls, stats, trace):
    eng = _GatedEngine()
    s = sched_cls(eng, stats=stats, batch_max_wait_ms=0.0,
                  realtime_deadline_ms=60_000.0, batch_deadline_ms=60_000.0)
    try:
        head = s.submit(_clip(0.0))  # blocks the engine: the rest queue up
        assert eng.started.wait(60.0)
        futs = [s.submit(_clip(tag, size=size), priority=prio, deadline_ms=dl)
                for tag, prio, dl, size in trace]
        eng.release.set()
        head.result(timeout=60)
        got = [f.result(timeout=60)[0] for f in futs]
    finally:
        eng.release.set()
        s.close()
    assert got == [t[0] for t in trace]  # each its own row
    return eng.launches


def test_one_arrival_trace_launches_in_the_jax_order():
    trace = _trace()
    want = _run_trace(jsched.Scheduler,
                      JServingStats(window=128, registry=JRegistry()), trace)
    got = _run_trace(Scheduler, ServingStats(window=128),
                     trace)
    assert got == want
    assert len(want) > 3 and any(len(g) > 1 for g in want)
