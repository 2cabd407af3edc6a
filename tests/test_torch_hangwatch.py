"""The port's hang attribution and seeded fault points against the JAX
package's modules, on the CPU: `reliability/faults.py` (the plan, its 8
hazard sites), `obs/watchdog.py`, `parallel/hangcheck.py`,
`parallel/schedule_recorder.py`, `--debug_nans`, `--debug_asserts` and
`--device_init_timeout`.

Held exactly (no tolerance: these are decisions and strings, not numbers):
the fired hits of the same `FaultPlan` in both packages (every kind, 3
seeds, 200 hits a point); the watchdog's stalled lists, attributions, dump
header lines and flight-recorder events on one heartbeat script under an
injected clock; `diff_schedules` and `format_divergence` on matching,
reordered, missing-op and extra-op schedules; `collective_section`'s
details and schedule records. The JAX Trainer runs nowhere here: the
port's Trainer is held to the JAX modules' behaviour directly.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pytorchvideo_accelerate_tpu.obs import flight_recorder as jflight
from pytorchvideo_accelerate_tpu.obs import spans as jspans
from pytorchvideo_accelerate_tpu.obs import watchdog as jwatchdog
from pytorchvideo_accelerate_tpu.parallel import hangcheck as jhangcheck
from pytorchvideo_accelerate_tpu.parallel import schedule_recorder as jsched
from pytorchvideo_accelerate_tpu.reliability import faults as jfaults
from pytorchvideo_accelerate_tpu.trainer.steps import (
    assert_batch_contract as jassert_batch_contract,
)
from pytorchvideo_accelerate_tpu_torch import obs as tobs
from pytorchvideo_accelerate_tpu_torch.config import parse_cli
from pytorchvideo_accelerate_tpu_torch.data import device_prefetch as tprefetch
from pytorchvideo_accelerate_tpu_torch.data.manifest import Quarantine, scan_directory
from pytorchvideo_accelerate_tpu_torch.data.pipeline import (
    ClipLoader,
    SyntheticClipSource,
    VideoClipSource,
)
from pytorchvideo_accelerate_tpu_torch.data.transforms import make_transform
from pytorchvideo_accelerate_tpu_torch.obs import flight_recorder as tflight
from pytorchvideo_accelerate_tpu_torch.obs import spans as tspans
from pytorchvideo_accelerate_tpu_torch.obs import watchdog as twatchdog
from pytorchvideo_accelerate_tpu_torch.parallel import hangcheck as thangcheck
from pytorchvideo_accelerate_tpu_torch.parallel import schedule_recorder as tsched
from pytorchvideo_accelerate_tpu_torch.parallel.pipeline import stage_tag
from pytorchvideo_accelerate_tpu_torch.reliability import atomic as tatomic
from pytorchvideo_accelerate_tpu_torch.reliability import faults as tfaults
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer
from pytorchvideo_accelerate_tpu_torch.trainer.steps import assert_batch_contract
from pytorchvideo_accelerate_tpu_torch.trainer.tracking import TrackerHub
from pytorchvideo_accelerate_tpu_torch.utils import device_doctor

from _torch_dp_worker import HANG_BARRIER, HANG_DELAY_S, HANG_TIMEOUT_S, run_group

# the tiny twin the Trainer tests run (tests/test_torch_train.py's `_RUN`)
_RUN = ["--cpu", "--synthetic", "--model.name", "tiny3d", "--num_frames", "4",
        "--data.crop_size", "32", "--data.min_short_side_scale", "32",
        "--data.max_short_side_scale", "40", "--batch_size", "2",
        "--gradient_accumulation_steps", "2", "--num_epochs", "1",
        "--data.synthetic_num_videos", "8", "--num_workers", "1",
        "--mixed_precision", "fp32"]


@pytest.fixture(autouse=True)
def _disarmed():
    """No plan, watchdog or schedule recorder outlives a test, in either
    package."""
    yield
    for faults in (tfaults, jfaults):
        faults.disarm()
    for hang in (thangcheck, jhangcheck):
        hang.uninstall_collective_watch()
        hang._set_schedule_recorder(None)


def _events(recorder, kinds):
    return [{k: v for k, v in e.items() if k not in ("ts", "thread")}
            for e in recorder.snapshot() if e["kind"] in kinds]


# --- the fault plan: the same hits as the JAX registry -----------------------

_SPECS = [
    dict(point="decode.read", kind="raise", p=0.3, path_substr="clip_3"),
    dict(point="decode.read", kind="delay", p=0.3, delay_s=0.0),
    dict(point="prefetch.h2d", kind="delay", p=1.0, delay_s=0.0, max_fires=5),
    dict(point="ckpt.write", kind="partial_write", p=0.3),
    dict(point="tracker.log", kind="raise", p=1.0, at_hits=(3, 50, 199)),
    dict(point="serve.flush", kind="kill_thread", p=0.3),
    dict(point="step.dispatch", kind="nan", p=0.3),
    dict(point="step.dispatch", kind="raise", p=1.0, max_fires=2),
    dict(point="collective.sync", kind="delay", p=1.0, delay_s=0.0,
         path_substr="name=checkpoint_close", max_fires=7),
]
_HITS = 200


def _drive(faults, plan, scratch):
    """200 hits of every point through `faults`; each hit's outcome (the
    returned kind or the raised class) and, for ckpt.write, the size of its
    in-flight file after the hit."""
    faults.arm(plan)
    out = []
    for point in sorted({s["point"] for s in _SPECS}):
        for hit in range(_HITS):
            path = (f"clip_{hit % 7}.mp4" if point == "decode.read" else
                    "barrier host=0/2 name=checkpoint_close" if hit % 3 == 0
                    else "host_allgather host=0/2")
            write_path = None
            if point == "ckpt.write":
                write_path = os.path.join(scratch, "inflight.bin")
                with open(write_path, "wb") as f:
                    f.write(b"x" * 100)
            try:
                got = faults.fault_point(point, path=path, write_path=write_path)
            except (faults.InjectedFault, faults.InjectedThreadKill) as e:
                got = type(e).__name__
            size = os.path.getsize(write_path) if write_path else None
            out.append((point, hit, got, size))
    faults.disarm()
    return out


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_fault_plan_fires_the_jax_hits(seed, tmp_path):
    counter = tobs.get_registry().counter(
        "pva_fault_injected_total", "faults fired by the armed fault plan, by point",
        labelnames=("point",))
    before = {s["point"]: counter.value(point=s["point"]) for s in _SPECS}
    outcomes = {}
    for side, faults in (("port", tfaults), ("jax", jfaults)):
        os.makedirs(tmp_path / side)
        plan = faults.FaultPlan(seed, [faults.FaultSpec(**s) for s in _SPECS])
        outcomes[side] = (_drive(faults, plan, str(tmp_path / side)),
                          [{k: v for k, v in h.items() if k != "ts"}
                           for h in faults.fault_history()])
    assert outcomes["port"] == outcomes["jax"]
    fired = outcomes["port"][1]
    kinds = {h["kind"] for h in fired}
    assert kinds == {"raise", "delay", "partial_write", "kill_thread", "nan"}
    assert {h["point"] for h in fired} == {s["point"] for s in _SPECS}
    # a path_substr spec fires only on its clip; partial_write halves the file
    assert all(r[2] != "InjectedFault" or r[1] % 7 == 3
               for r in outcomes["port"][0] if r[0] == "decode.read")
    assert {r[3] for r in outcomes["port"][0] if r[0] == "ckpt.write"} == {50, 100}
    for point in before:
        n = sum(1 for h in fired if h["point"] == point)
        assert counter.value(point=point) - before[point] == n


def test_fault_spec_refuses_unknown_kinds_and_disarmed_is_a_noop():
    with pytest.raises(ValueError, match="fault kind"):
        tfaults.FaultSpec("decode.read", kind="segfault")
    assert tfaults.fault_point("decode.read") is None  # disarmed


# --- the watchdog: one script through both -----------------------------------


def _watchdog_script(mod, flight, spans, out_dir, clock, capsys):
    recorder = flight.FlightRecorder()
    collector = spans.SpanCollector()
    wd = mod.Watchdog(2.0, output_dir=out_dir, recorder=recorder,
                      collector=collector, poll_s=60.0)  # check() by hand
    seen = []

    def check():
        stalled = wd.check(now=clock[0])
        err = capsys.readouterr().err
        header = err.split("\n--- thread")[0].splitlines() if err else []
        seen.append((stalled, wd.stall_count, list(wd.last_stalled),
                     dict(wd.last_attribution), header))

    wd.heartbeat("train")
    wd.beat_fn("prefetch_train")()
    clock[0] += 1.5
    check()                                   # nothing past 2 s
    sec = wd.section("collective", "barrier host=1/2 name=checkpoint_close")
    sec.__enter__()
    with collector.span("ckpt"):
        clock[0] += 2.5
        check()                               # all three, one attributed
        check()                               # one-shot: nothing new
    wd.heartbeat("train")                     # re-arms train
    clock[0] += 2.25
    check()                                   # train again, collective done
    sec.__exit__(None, None, None)            # leaving clears it
    wd.clear("prefetch_train")
    wd.heartbeat("train")
    clock[0] += 10.0
    check()                                   # train only
    wd.clear("train")
    clock[0] += 10.0
    check()                                   # idle is no stall
    with open(os.path.join(out_dir, "flight_record.json")) as f:
        dumped = [{k: v for k, v in e.items() if k not in ("ts", "thread")}
                  for e in json.load(f)["events"]]
    return seen, _events(recorder, ("watchdog",)), dumped


def test_watchdog_matches_jax_on_one_script(tmp_path, monkeypatch, capsys):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    got = {}
    for side, mod, flight, spans in (("port", twatchdog, tflight, tspans),
                                     ("jax", jwatchdog, jflight, jspans)):
        clock[0] = 1000.0
        os.makedirs(tmp_path / side)
        got[side] = _watchdog_script(mod, flight, spans, str(tmp_path / side),
                                     clock, capsys)
    assert got["port"] == got["jax"]
    seen, events, dumped = got["port"]
    assert [s[0] for s in seen] == [[], ["collective", "prefetch_train", "train"],
                                    [], ["train"], ["train"], []]
    assert seen[1][3] == {"collective": ("barrier host=1/2 name=checkpoint_close", 2.5)}
    assert seen[1][4][1] == ("[watchdog] collective wedged inside 'barrier "
                             "host=1/2 name=checkpoint_close' for 2.5s")
    assert "[watchdog] open spans:" in seen[1][4][2]
    assert len(events) == 3 and events[0]["attribution"] == {
        "collective": "barrier host=1/2 name=checkpoint_close (2.5s)"}
    assert dumped[-1] == events[-1]


def test_watchdog_dumps_to_its_rank_file(tmp_path, capfd):
    """Rank r > 0 of a shared output dir dumps to flight_record.rank<r>.json;
    the poll thread fires on its own and never kills."""
    recorder = tflight.FlightRecorder()
    recorder.install("", tflight.rank_file_name(1))
    stalls = []
    wd = twatchdog.Watchdog(0.2, output_dir=str(tmp_path), recorder=recorder,
                            on_stall=stalls.append).start()
    try:
        wd.heartbeat("train")
        deadline = time.monotonic() + 10
        while not stalls and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    assert stalls[0] == ["train"] and wd.stall_count == 1
    assert "--- thread MainThread" in capfd.readouterr().err
    with open(tmp_path / "flight_record.rank1.json") as f:
        assert [e["name"] for e in json.load(f)["events"]] == ["stall"]
    assert not os.path.exists(tmp_path / "flight_record.json")
    wd.start()  # restartable after stop
    try:
        assert wd._thread.is_alive()
    finally:
        wd.stop()


# --- the schedule recorder and the differ --------------------------------------

_BASE = [("host_allgather", ""), ("step_dispatch", "gstep=1"),
         ("barrier", "name=checkpoint_save"), ("epoch_sync", "step=4"),
         ("ckpt_close", "")]
_CASES = {
    "matching": list(_BASE),
    "reordered": [_BASE[0], _BASE[2], _BASE[1], *_BASE[3:]],
    "missing_op": _BASE[:3] + _BASE[4:],
    "extra_op": _BASE[:3] + [("any_process", "")] + _BASE[3:],
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_schedule_diff_matches_jax(case):
    got = {}
    for side, mod in (("port", tsched), ("jax", jsched)):
        rec = mod.CollectiveScheduleRecorder()
        for host, sched in (("host=0/2", _BASE), ("host=1/2", _CASES[case])):
            with rec.as_host(host):
                for op, detail in sched:
                    rec.record(op, detail)
        report = mod.diff_schedules(rec.schedules(), window=2)
        got[side] = (report, mod.format_divergence(report), rec.snapshot(),
                     rec.counts())
    assert got["port"] == got["jax"]
    report = got["port"][0]
    assert report["diverged"] == (case != "matching")
    if case == "missing_op":
        assert report["first_divergence"]["tick"] == 3
    tsched.publish_schedule_report(report)
    gauge = tobs.get_registry().get("pva_spmd_schedule_divergence")
    assert gauge.value() == float(case != "matching")


# --- collective sections ----------------------------------------------------------


class _FakeWatchdog:
    def __init__(self):
        self.details = []

    def section(self, name, detail=""):
        self.details.append((name, detail))
        return threading.Lock()  # any context manager


_SECTIONS = [("host_allgather", {}), ("barrier", {"name": "checkpoint_close"}),
             ("epoch_sync", {"step": 1200}), ("desync_check", {"name": "params@epoch0"}),
             ("ckpt_restore", {"step": 4}), ("ckpt_wait", {})]


@pytest.mark.parametrize("stage", [None, (2, 4)], ids=["no_stage", "stage"])
def test_collective_section_details_match_jax(stage, monkeypatch):
    """The same (op, info, host) gives the JAX detail and the same schedule
    record; the step dispatch's detail, with `stage=` on a pipelined rank,
    is the one the JAX loop builds (its `loop.py` `host_tag` and
    `step_dispatch` f-strings)."""
    for mod in (thangcheck, jhangcheck):
        monkeypatch.setattr(mod, "host_tag", lambda: "host=3/16")
    got = {}
    for side, hang, sched in (("port", thangcheck, tsched), ("jax", jhangcheck, jsched)):
        wd = _FakeWatchdog()
        hang.install_collective_watch(wd)
        rec = sched.CollectiveScheduleRecorder("host=3/16")
        sched.install_schedule_recorder(rec)
        for op, info in _SECTIONS:
            with hang.collective_section(op, **info):
                pass
        got[side] = (wd.details, rec.schedules())
    assert got["port"] == got["jax"]
    assert got["port"][0][1] == ("collective", "barrier host=3/16 name=checkpoint_close")
    # the dispatch section: stage s of the (1, 4) train mesh's model axis
    note, host = "", jhangcheck.host_tag()
    if stage is not None:
        tag = stage_tag((1, 4), [stage[0]])
        assert tag == f"{stage[0]}/{stage[1]}"
        note = f"stage={tag}"
        host = f"{host} stage={tag}".strip()
    wd = _FakeWatchdog()
    thangcheck.install_collective_watch(wd)
    with thangcheck.collective_section("step_dispatch", host_note=note, gstep=7):
        pass
    assert wd.details == [("collective", f"step_dispatch {host} gstep=7")]


def test_collective_sync_fires_inside_its_section(monkeypatch):
    """`collective.sync` fires inside the open section, with the detail as
    its path: a `path_substr` spec pins one collective; disarmed, a section
    records nothing and formats nothing."""
    from pytorchvideo_accelerate_tpu_torch.parallel.distributed import (
        sync_global_devices,
    )

    wd = twatchdog.Watchdog(60.0)
    open_at_fire = []
    real_hit = tfaults.FaultPlan.hit

    def hit(self, point, path=None, write_path=None):
        open_at_fire.append((path, dict(wd._sections)))
        return real_hit(self, point, path, write_path)

    monkeypatch.setattr(tfaults.FaultPlan, "hit", hit)
    thangcheck.install_collective_watch(wd)
    tfaults.arm(tfaults.FaultPlan(0, [tfaults.FaultSpec(
        "collective.sync", kind="raise", path_substr="name=checkpoint_close")]))
    sync_global_devices("checkpoint_save")  # no group: no section at all
    with thangcheck.collective_section("barrier", name="checkpoint_save"):
        pass
    with pytest.raises(tfaults.InjectedFault):
        with thangcheck.collective_section("barrier", name="checkpoint_close"):
            pass
    assert [p for p, _ in open_at_fire] == [
        "barrier host=0/1 name=checkpoint_save", "barrier host=0/1 name=checkpoint_close"]
    assert all("collective" in s for _, s in open_at_fire)
    assert "collective" not in wd._sections  # exit clears it
    assert [h["hit"] for h in tfaults.fault_history()] == [1]


# --- the 8 fault points at their sites ----------------------------------------


def _write_video(path, seed, frames=12):
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (64, 48))
    assert w.isOpened()
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 256, (48, 64, 3), np.uint8))
    w.release()


def test_decode_read_raise_quarantines_exactly_that_clip(tmp_path):
    root = tmp_path / "videos"
    for i in range(4):
        (root / f"c{i % 2}").mkdir(parents=True, exist_ok=True)
        _write_video(root / f"c{i % 2}" / f"{i}.mp4", i)
    quarantine = Quarantine(str(tmp_path / "quarantine.json"), budget=1)
    tf = make_transform(training=False, num_frames=4, crop_size=32,
                        min_short_side_scale=32, max_short_side_scale=32)
    source = VideoClipSource(scan_directory(str(root)), tf, 0.4, training=False,
                             quarantine=quarantine, decode_retries=2,
                             retry_base_delay_s=0.0)
    tfaults.arm(tfaults.FaultPlan(0, [tfaults.FaultSpec(
        "decode.read", kind="raise", path_substr="2.mp4")]))
    clips = [source.get(i, 0) for i in range(len(source))]
    assert all(c["video"].shape == (4, 32, 32, 3) for c in clips)
    assert quarantine.paths() == {str(root / "c0" / "2.mp4")}
    fired = tfaults.fault_history()
    assert len(fired) == 2 and {h["kind"] for h in fired} == {"raise"}  # 2 attempts


def test_ckpt_write_partial_write_leaves_no_truncated_file(tmp_path):
    dest = tmp_path / "meta.json"
    tatomic.atomic_write_bytes(str(dest), b"old complete content")
    tfaults.arm(tfaults.FaultPlan(0, [tfaults.FaultSpec(
        "ckpt.write", kind="partial_write", at_hits=(0,))]))
    with pytest.raises(tfaults.InjectedFault, match="ckpt.write"):
        tatomic.atomic_write_bytes(str(dest), b"new content that dies half way")
    assert dest.read_bytes() == b"old complete content"
    assert os.listdir(tmp_path) == ["meta.json"]  # no tmp file left
    tatomic.atomic_write_bytes(str(dest), b"new")  # hit 1: lands
    assert dest.read_bytes() == b"new"


@pytest.mark.parametrize("fires", [1, 2])
def test_tracker_log_raise_retries_then_disables(fires, tmp_path):
    hub = TrackerHub("jsonl", str(tmp_path), retries=2)
    tfaults.arm(tfaults.FaultPlan(0, [tfaults.FaultSpec(
        "tracker.log", kind="raise", at_hits=tuple(range(1, 1 + fires)))]))
    hub.start("run", {})
    hub.log({"loss": 1.5}, step=1)  # hits 1..fires raise
    lines = (tmp_path / "run.jsonl").read_text().splitlines()
    if fires == 1:  # the retry lands the line
        assert len(hub.trackers) == 1 and json.loads(lines[-1]) == {"step": 1, "loss": 1.5}
    else:  # both attempts raised: the tracker is off, the step goes on
        assert hub.trackers == [] and len(lines) == 1
    hub.finish()


def _status_codes(side, front):
    """Two /predict requests through a stub-engine server of `side` (port
    or jax) behind `front` (micro or edf) with `serve.flush` armed to raise
    at its first batch: the HTTP codes, and whether the flush thread
    lives."""
    if side == "port":
        from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
        from pytorchvideo_accelerate_tpu_torch.serving.batcher import MicroBatcher
        from pytorchvideo_accelerate_tpu_torch.serving.server import InferenceServer
        from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats
        from pytorchvideo_accelerate_tpu_torch.serving.stub import StubEngine
        faults = tfaults
        stats = ServingStats(window=16)
    else:
        from pytorchvideo_accelerate_tpu.fleet.scheduler import Scheduler
        from pytorchvideo_accelerate_tpu.obs import registry as jreg
        from pytorchvideo_accelerate_tpu.serving.batcher import MicroBatcher
        from pytorchvideo_accelerate_tpu.serving.server import InferenceServer
        from pytorchvideo_accelerate_tpu.serving.stats import ServingStats
        from pytorchvideo_accelerate_tpu.serving.stub import StubEngine
        faults = jfaults
        stats = ServingStats(window=16, registry=jreg.Registry())
    engine = StubEngine()
    batcher = (MicroBatcher(engine, max_wait_ms=1.0, stats=stats) if front == "micro"
               else Scheduler(engine, stats=stats, max_queue=8))
    srv = InferenceServer(engine, batcher, stats, host="127.0.0.1", port=0)
    srv.alert_tick_s = 0
    srv.start()
    faults.arm(faults.FaultPlan(0, [faults.FaultSpec("serve.flush", at_hits=(0,))]))
    host, port = srv.address
    body = json.dumps({"video": np.zeros((2, 4, 4, 3)).tolist()}).encode()
    codes = []
    try:
        for _ in range(2):
            req = urllib.request.Request(f"http://{host}:{port}/predict", data=body)
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
    finally:
        srv.close()
        faults.disarm()
    return codes


@pytest.mark.parametrize("front", ["micro", "edf"])
def test_serve_flush_raise_fails_that_request_with_the_jax_status(front):
    port = _status_codes("port", front)
    assert port == _status_codes("jax", front) == [500, 200]


def test_prefetch_h2d_delay_is_a_starved_link():
    tf = make_transform(training=True, num_frames=4, crop_size=32,
                        min_short_side_scale=32, max_short_side_scale=40)
    loader = ClipLoader(SyntheticClipSource(tf, num_videos=8, num_classes=4), 2,
                        shuffle=False, drop_last=True, num_workers=1)
    wd = twatchdog.Watchdog(60.0)
    beats, beat = [], wd.heartbeat
    wd.heartbeat = lambda name: (beats.append(name), beat(name))
    prefetch = tprefetch.DevicePrefetcher(loader, torch.device("cpu"), depth=1,
                                          watchdog=wd, watchdog_name="prefetch_train")
    tfaults.arm(tfaults.FaultPlan(0, [tfaults.FaultSpec(
        "prefetch.h2d", kind="delay", delay_s=0.3, at_hits=(1,))]))
    batches = list(prefetch.epoch(0))
    assert len(batches) == 4 and prefetch.pop_wait() >= 0.25
    assert [h["hit"] for h in tfaults.fault_history()] == [1]
    assert beats[:4] == ["prefetch_train"] * 4 and "prefetch_train" not in wd._beats


def test_step_dispatch_nan_reaches_the_guards_skip(tmp_path):
    tr = Trainer(parse_cli(_RUN + ["--guard.enabled", "--output_dir", str(tmp_path)]))
    tfaults.arm(tfaults.FaultPlan(0, [tfaults.FaultSpec(
        "step.dispatch", kind="nan", at_hits=(1,))]))
    res = tr.fit()
    assert res["steps"] == 2 and tr.train_guard.skips == 1
    assert res["guard_rollbacks"] == 0
    assert [(h["point"], h["hit"], h["kind"]) for h in tfaults.fault_history()] == [
        ("step.dispatch", 1, "nan")]


# --- the Trainer's watchdog ----------------------------------------------------------


def test_stalled_fit_trips_the_watchdog(tmp_path, capfd):
    """JAX `tests/test_zobs.py` `test_zz_stalled_train_loop_trips_watchdog`:
    a step stalled past `obs.watchdog_timeout_s` dumps the stacks and the
    flight record before any external timeout; fit() finishes; close()
    stops the watchdog and uninstalls the collective watch."""
    tr = Trainer(parse_cli(_RUN + ["--obs.watchdog_timeout_s", "0.2",
                                   "--data.limit_train_batches", "2",
                                   "--output_dir", str(tmp_path)]))
    assert tr.watchdog is not None and thangcheck.current_watchdog() is tr.watchdog
    real_step = tr.train_step

    def stalled_step(state, batch):
        time.sleep(0.7)  # > the timeout, inside one step
        return real_step(state, batch)

    tr.train_step = stalled_step
    watchdog = tr.watchdog
    res = tr.fit()
    assert res["steps"] == 2 and watchdog.stall_count >= 1
    err = capfd.readouterr().err
    assert "NO PROGRESS" in err and "--- thread" in err
    # the first dispatch runs unwatched; the second in its section
    assert "collective wedged inside 'step_dispatch host=0/1 gstep=1'" in err
    assert "collective wedged inside 'step_dispatch host=0/1 gstep=0'" not in err
    with open(tmp_path / "flight_record.json") as f:
        assert any(e["kind"] == "watchdog" for e in json.load(f)["events"])
    assert thangcheck.current_watchdog() is None
    assert watchdog._thread is None


def test_two_ranks_attribute_the_same_wedged_collective(tmp_path):
    """Two gloo ranks of the tiny twin, rank 1 delayed HANG_DELAY_S inside
    the barrier of its last checkpoint fence: both watchdogs attribute
    their stall to that barrier, rank 1's flight record alone holds the
    fault, both hold the stall, and the two recorded schedules agree."""
    recs = run_group("hangwatch", tmp_path)
    for rank, rec in enumerate(recs):
        assert rec["result"]["steps"] == 2
        assert rec["stall_count"] >= 1 and "collective" in rec["last_stalled"]
        detail, age = rec["attribution"]["collective"]
        assert detail == f"barrier host={rank}/2 {HANG_BARRIER}"
        assert HANG_TIMEOUT_S < age < HANG_DELAY_S + 1
        kinds = [(e["kind"], e["name"]) for e in rec["flight"]]
        assert ("watchdog", "stall") in kinds
        assert (("fault", "collective.sync") in kinds) == (rank == 1)
    assert [h["kind"] for h in recs[1]["fired"]] == ["delay"] and recs[0]["fired"] == []
    merged = {**recs[0]["schedule"], **recs[1]["schedule"]}
    assert sorted(merged) == ["host=0/2", "host=1/2"]
    report = tsched.diff_schedules(merged)
    assert not report["diverged"], tsched.format_divergence(report)
    counts = tsched.op_counts(merged["host=0/2"])
    # 2 steps a rank (16 clips, global batch 8): one watched dispatch; a
    # save at step 2 (checkpointing_steps) and the final one, the same step
    assert counts["step_dispatch"] == 1 and counts["epoch_sync"] == 1
    assert counts["ckpt_close"] == 1 and counts["ckpt_save"] == 2
    assert counts["barrier"] == counts["ckpt_wait"] >= 1
    assert counts["any_process"] == 2 and counts["host_reduce_sum"] == 1


# --- debug_asserts, debug_nans, device_init_timeout ---------------------------------

_GOOD = [
    ({"video": (4, 2, 8, 8, 3), "label": ((4,), "int32"), "mask": ((4,), "float32")}, False),
    ({"slow": (2, 4, 2, 8, 8, 3), "fast": (2, 4, 8, 8, 8, 3),
      "label": ((2, 4), "int32")}, True),
    ({"video": (4, 3, 2, 8, 8, 3), "label": ((4,), "int32")}, False),  # views
]
_BAD = [
    ({"video": (8, 4, 32, 32, 3), "label": ((8, 1), "int32")}, False),  # JAX's
    ({"video": (4, 2, 8, 8, 3), "label": ((3,), "int32")}, False),
    ({"video": (4, 8, 8, 3), "label": ((4,), "int32")}, False),
    ({"video": (4, 2, 8, 8, 3), "label": ((4,), "int32"),
      "mask": ((4,), "float16")}, False),
    ({"label": ((4,), "int32")}, False),
    ({"slow": (4, 2, 8, 8, 3), "fast": (4, 8, 8, 8, 3),
      "label": ((4,), "int32")}, True),  # no micro axis under accumulation
]


def _batch(spec, lib):
    out = {}
    for k, v in spec.items():
        shape, dtype = (v, "float32") if isinstance(v[0], int) else v
        out[k] = (torch.zeros(shape, dtype=getattr(torch, dtype)) if lib == "torch"
                  else np.zeros(shape, dtype))
    return out


@pytest.mark.parametrize("spec,micro", _GOOD + _BAD,
                         ids=[f"good{i}" for i in range(len(_GOOD))]
                         + [f"bad{i}" for i in range(len(_BAD))])
def test_batch_contract_accepts_and_rejects_what_jax_does(spec, micro):
    """JAX `tests/test_fault_injection.py` `TestDebugAsserts` and more, in
    the port's layout (the same NDHWC clips, int32 labels)."""
    import jax.numpy as jnp

    outcome = {}
    for side, check, batch in (
            ("port", assert_batch_contract, _batch(spec, "torch")),
            ("jax", jassert_batch_contract,
             {k: jnp.asarray(v) for k, v in _batch(spec, "np").items()})):
        try:
            check(batch, leading_micro=micro)
            outcome[side] = "ok"
        except AssertionError:
            outcome[side] = "AssertionError"
    assert outcome["port"] == outcome["jax"]
    assert outcome["port"] == ("ok" if (spec, micro) in _GOOD else "AssertionError")


def test_debug_asserts_rejects_a_bad_batch_before_the_step(tmp_path):
    tr = Trainer(parse_cli(_RUN + ["--debug_asserts", "--output_dir", str(tmp_path)]))
    try:
        good = next(iter(tr.train_prefetch.epoch(0)))
        bad = dict(good, label=good["label"][..., None])  # a label of rank 3
        params = [p.detach().clone() for p in tr.model.parameters()]
        with pytest.raises(AssertionError, match="label of shape"):
            tr.train_step(tr.state, bad)
        assert tr.state.step == 0
        assert all(torch.equal(a, b) for a, b in zip(params, tr.model.parameters()))
        tr.train_step(tr.state, good)
        assert tr.state.step == 1
    finally:
        tr.close()


def test_debug_nans_raises_naming_the_module(tmp_path):
    tr = Trainer(parse_cli(_RUN + ["--debug_nans", "--output_dir", str(tmp_path)]))
    tfaults.arm(tfaults.FaultPlan(0, [tfaults.FaultSpec(
        "step.dispatch", kind="nan", at_hits=(1,))]))
    with pytest.raises(FloatingPointError, match=r"NaN in the output of module \S+ \("):
        tr.fit()
    assert tr.state.step == 1 and not torch.is_anomaly_enabled()
    with open(tmp_path / "flight_record.json") as f:
        exc = [e for e in json.load(f)["events"] if e["kind"] == "exception"]
    assert exc[-1]["name"] == "FloatingPointError"


def test_device_init_timeout_probes_the_card(tmp_path, monkeypatch):
    """No card answers here: the probe child fails and the Trainer raises
    its RuntimeError (not the later "no CUDA device" one); a child that
    outlives the deadline is killed and raises too; with --cpu no probe
    runs."""
    argv = [a for a in _RUN if a != "--cpu"] + ["--output_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA device init did not complete"):
        Trainer(parse_cli(argv + ["--device_init_timeout", "60"]))
    monkeypatch.setattr(device_doctor, "PROBE_CODE", "import time; time.sleep(60)")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timeout"):
        Trainer(parse_cli(argv + ["--device_init_timeout", "1"]))
    assert time.monotonic() - t0 < 20

    def no_probe(*a, **k):
        raise AssertionError("--cpu runs no probe")

    monkeypatch.setattr(device_doctor, "quick_probe", no_probe)
    tr = Trainer(parse_cli(_RUN + ["--device_init_timeout", "1",
                                   "--output_dir", str(tmp_path)]))
    assert tr.device_probe is None
    tr.close()
