"""The port's experiment tracking (`trainer/tracking.py`) against the JAX
package's, on the CPU: the jsonl lines of the same calls (apart from
`time`), what `"all"` resolves to, the hub's retry-then-disable, the
one-step-late `DeferredStepLogger`, and the jsonl keys a `--cpu` Trainer
with `--tracking.with_tracking` writes against the JAX Trainer's on the
same config, with `--obs.enabled false` (the keys without telemetry; the
obs-on keys are held in tests/test_torch_obs.py).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pytorchvideo_accelerate_tpu import obs as jobs
from pytorchvideo_accelerate_tpu.config import parse_cli as jparse_cli
from pytorchvideo_accelerate_tpu.trainer import tracking as jtracking
from pytorchvideo_accelerate_tpu.trainer.loop import Trainer as JTrainer
from pytorchvideo_accelerate_tpu_torch import obs as tobs
from pytorchvideo_accelerate_tpu_torch import run as trun
from pytorchvideo_accelerate_tpu_torch.trainer import tracking as ttracking

# epoch-line keys of layers the port does not have: the JAX package's
# analytic FLOPs counter (mfu_analytic) and its XLA recompile probe
# (train_recompiles)
JAX_ONLY_EPOCH_KEYS = {"mfu_analytic", "train_recompiles"}


@pytest.fixture(autouse=True)
def _collectors_restored():
    """The Trainers below run with `--obs.enabled false`, which turns the
    process-default span collector of their package off; later files on
    the same worker expect it as they left it, so both come back."""
    prior = [(mod, mod.get_collector().enabled) for mod in (tobs, jobs)]
    yield
    for mod, enabled in prior:
        mod.configure(enabled=enabled)


def _lines(path):
    with open(path) as f:
        out = [json.loads(ln) for ln in f]
    for d in out:
        d.pop("time", None)
    return out


def _calls(tracker):
    tracker.start("run", {"lr": 0.1, "model": {"name": "tiny3d"}, "dirs": ("a",)})
    tracker.log({"train_loss_step": np.float32(1.5), "lr": 0.1,
                 "grad_norm": torch.tensor(2.25)}, step=3)
    tracker.log({"accuracy": 0.5, "epoch": 0}, step=np.int64(0))
    tracker.finish()


def test_jsonl_lines_equal_jax(tmp_path):
    _calls(ttracking.JsonlTracker(str(tmp_path / "t")))
    _calls(jtracking.JsonlTracker(str(tmp_path / "j")))
    got, want = _lines(tmp_path / "t" / "run.jsonl"), _lines(tmp_path / "j" / "run.jsonl")
    assert got == want and len(got) == 4
    assert got[0]["event"] == "start" and got[-1] == {"event": "end"}
    assert got[1] == {"step": 3, "train_loss_step": 1.5, "lr": 0.1,
                      "grad_norm": 2.25}


def test_resolve_all_is_what_imports(tmp_path):
    want = ["jsonl"] + [n for n in ("tensorboard", "wandb")
                        if importlib.util.find_spec(n) is not None]
    got = ttracking.resolve_trackers("all", str(tmp_path))
    assert [t.name for t in got] == want
    assert [t.name for t in ttracking.resolve_trackers(
        " jsonl , no_such_tracker", str(tmp_path))] == ["jsonl"]


def test_tensorboard_tracker_writes_events(tmp_path):
    if importlib.util.find_spec("tensorboard") is None:
        pytest.skip("tensorboard is not installed")
    t = ttracking.TensorBoardTracker(str(tmp_path))
    t.start("run", {"lr": 0.1})
    t.log({"loss": 1.0}, step=1)
    t.finish()
    assert any(f.startswith("events.out") for f in os.listdir(tmp_path / "run"))


class _Flaky(ttracking.Tracker):
    name = "flaky"

    def __init__(self, failures):
        self.failures, self.calls, self.logged = failures, 0, []

    def start(self, run_name, config):
        pass

    def log(self, values, step):
        self.calls += 1
        if self.calls <= self.failures:
            raise OSError("disk full")
        self.logged.append(step)


def test_hub_retries_then_disables_a_failing_tracker(tmp_path):
    hub = ttracking.TrackerHub("jsonl", str(tmp_path), retries=2)
    blip, dead = _Flaky(1), _Flaky(10 ** 6)
    hub.trackers = hub.trackers + [blip, dead]
    hub.start("run", {})
    hub.log({"loss": 1.0}, step=1)
    hub.log({"loss": 2.0}, step=2)
    hub.finish()
    assert blip.logged == [1, 2] and blip in hub.trackers
    assert dead not in hub.trackers and dead.calls == 2
    assert [d.get("step") for d in _lines(tmp_path / "run.jsonl")] == [None, 1, 2, None]


def test_deferred_logger_flushes_one_step_late_and_drops_nothing():
    seen = []

    class Hub:
        def log(self, values, step):
            seen.append(("hub", step, values))

    printed = []
    d = ttracking.DeferredStepLogger(Hub(), on_flush=lambda v, s: printed.append(s))
    d.flush()  # nothing pending
    d.defer({"loss": torch.tensor(1.0)}, step=1)
    assert seen == []  # not read at the step that produced it
    d.flush()
    assert seen == [("hub", 1, {"loss": 1.0})] and printed == [1]
    d.defer({"loss": torch.tensor(2.0)}, step=2)
    d.defer({"loss": torch.tensor(3.0)}, step=3)  # flushes step 2 first
    d.flush()
    assert [s for _, s, _ in seen] == [1, 2, 3] and printed == [1, 2, 3]
    assert all(isinstance(v["loss"], float) for _, _, v in seen)
    alone = ttracking.DeferredStepLogger(None, on_flush=lambda v, s: printed.append(s))
    alone.defer({"loss": 4.0}, step=4)
    alone.flush()
    assert printed[-1] == 4


# a batch of 8 clips: the port's batch_size, the JAX Trainer's per-device
# batch_size 1 times the 8 CPU devices of tests/conftest.py
_RUN = ["--synthetic", "--model.name", "tiny3d", "--num_frames", "4",
        "--data.crop_size", "32", "--data.min_short_side_scale", "32",
        "--data.max_short_side_scale", "40",
        "--num_epochs", "2", "--data.synthetic_num_videos", "16",
        "--mixed_precision", "fp32", "--tracking.with_tracking",
        "--tracking.trackers", "jsonl", "--log_every", "1",
        "--obs.enabled", "false"]


def test_trainer_writes_the_jax_trainers_jsonl_keys(tmp_path):
    """The same config through both Trainers: the same lines in the same
    order (start, every logged step, every epoch, end) with the same keys,
    the epoch lines apart from the JAX-only layers' keys; evaluate() logs
    its result in both."""
    logs = {}
    for side, make in (("port", None), ("jax", JTrainer)):
        logdir = str(tmp_path / side / "logs")
        argv = _RUN + ["--tracking.logging_dir", logdir,
                       "--output_dir", str(tmp_path / side / "out")]
        if make is None:
            trun.main(argv + ["--cpu", "--batch_size", "8"])
        else:
            make(jparse_cli(argv + ["--batch_size", "1"])).fit()
        (name,) = os.listdir(logdir)
        logs[side] = _lines(os.path.join(logdir, name))
    got, want = logs["port"], logs["jax"]
    assert len(got) == len(want) == 1 + 4 + 2 + 1
    assert sorted(got[0]) == sorted(want[0])
    assert sorted(got[0]["config"]) == sorted(want[0]["config"])
    for g, w in zip(got[1:], want[1:]):
        if "epoch" in w:
            assert set(g) == set(w) - JAX_ONLY_EPOCH_KEYS
            assert g["step"] == w["step"] and g["epoch"] == w["epoch"]
        else:
            assert set(g) == set(w)
            assert g.get("step") == w.get("step")
    steps = [g for g in got if "train_loss_step" in g]
    assert [g["step"] for g in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(g["train_loss_step"]) and g["grad_norm"] > 0
               for g in steps)
    logdir = str(tmp_path / "eval_logs")
    res = trun.main(_RUN + ["--cpu", "--batch_size", "8", "--eval_only",
                            "--tracking.logging_dir", logdir,
                            "--output_dir", str(tmp_path / "eval")])
    (name,) = os.listdir(logdir)
    start, logged, end = _lines(os.path.join(logdir, name))
    assert start["event"] == "start" and end == {"event": "end"}
    assert logged == {"step": 0, **res}
