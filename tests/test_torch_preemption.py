"""The port's preemption grace path (reliability/preemption.py, trainer/
loop.py) and checkpoint retries against the JAX package's, on the CPU.

- `get_guard().request()` mid-`fit()` ends the run after the step in
  flight: `preempted: True`, a checkpoint of kind "preempt" at the consumed
  loader position, no eval, no final save; the emergency record reads back
  through the JAX package's `read_emergency_record` with the same fields.
- `--resume_from_checkpoint auto` finishes with the per-step losses of an
  unbroken run (fp32, rtol 1e-6) and its step count.
- A real SIGTERM to a `--cpu` child `run.py` exits 0 and resumes; a second
  signal kills; `uninstall` restores the previous handlers exactly; a stale
  request does not stop the next fit.
- An OSError injected twice into a checkpoint write is retried to success;
  one injected `ckpt_retries` times is raised, and no partial step is left.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pytorchvideo_accelerate_tpu.reliability import preemption as jpreempt
from pytorchvideo_accelerate_tpu_torch import run as trun
from pytorchvideo_accelerate_tpu_torch.config import ReliabilityConfig, parse_cli
from pytorchvideo_accelerate_tpu_torch.reliability import preemption as tpreempt
from pytorchvideo_accelerate_tpu_torch.trainer import checkpoint as tckpt
from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 2 epochs of 3 optimizer steps (B=2 x accumulation 2 over 12 videos), fp32
_RUN = ["--cpu", "--synthetic", "--model.name", "tiny3d", "--num_frames", "4",
        "--data.crop_size", "32", "--data.min_short_side_scale", "32",
        "--data.max_short_side_scale", "40", "--batch_size", "2",
        "--gradient_accumulation_steps", "2", "--num_epochs", "2",
        "--data.synthetic_num_videos", "12", "--num_workers", "2",
        "--mixed_precision", "fp32", "--model.fused_kernels", "auto",
        "--tracking.log_every", "1"]


def _fit(argv, request_after=None, reason="api"):
    """fit() with every optimizer step's loss recorded; `request_after` asks
    the process guard for preemption once that step is dispatched."""
    trainer = Trainer(parse_cli(argv))
    losses = {}
    step_fn = trainer.train_step

    def recording_step(state, batch):
        metrics = step_fn(state, batch)
        losses[state.step] = float(metrics["loss"])
        if request_after is not None and state.step == request_after:
            tpreempt.get_guard().request(reason)
        return metrics

    trainer.train_step = recording_step
    return trainer.fit(), losses


def _kind(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, str(step), "extra.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("unbroken"))
    return _fit(_RUN + ["--output_dir", out])


@pytest.fixture(scope="module")
def preempted(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("preempted"))
    res, losses = _fit(_RUN + ["--output_dir", out], request_after=4,
                       reason="test")
    return out, res, losses


def test_request_mid_fit_stops_after_the_step_in_flight(preempted):
    out, res, losses = preempted
    assert res["preempted"] is True and res["steps"] == 4
    assert sorted(losses) == [1, 2, 3, 4]
    ckpt = os.path.join(out, "checkpoints")
    # no checkpointing_steps: the grace path made the checkpointer
    assert Checkpointer(ckpt).all_steps() == [4]  # no final save
    extra = _kind(ckpt, 4)
    assert extra["kind"] == "preempt" and extra["epoch"] == 1
    # the consumed position: one step into the second epoch
    assert extra["data_state"]["epoch"] == 1
    assert extra["data_state"]["position"] == 1  # yields consumed
    assert res["epoch_train_times"] and len(res["epoch_train_times"]) == 1
    assert not tpreempt.get_guard().requested  # cleared for the next fit


def test_emergency_record_reads_back_through_jax(preempted):
    out = preempted[0]
    want = jpreempt.read_emergency_record(out)
    got = tpreempt.read_emergency_record(out)
    assert want == got
    assert set(got) == {"step", "epoch", "checkpoint_dir", "reason", "pid",
                        "ts", "path"}
    assert got["step"] == 4 and got["epoch"] == 1 and got["reason"] == "test"
    assert got["checkpoint_dir"] == os.path.join(out, "checkpoints")
    assert tpreempt.EMERGENCY_RECORD == jpreempt.EMERGENCY_RECORD


def test_auto_resume_finishes_with_the_unbroken_losses(preempted, unbroken):
    out, _, first = preempted
    want_res, want = unbroken
    res, rest = _fit(_RUN + ["--output_dir", out,
                                "--resume_from_checkpoint", "auto"])
    assert res["preempted"] is False
    assert res["steps"] == want_res["steps"] == 6
    got = {**first, **rest}
    assert sorted(got) == sorted(want) == [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(want)], rtol=1e-6)
    assert np.isfinite(res["val_accuracy"])


def test_a_step_boundary_checkpoint_is_not_saved_twice(tmp_path):
    out = str(tmp_path / "run")
    res, _ = _fit(_RUN + ["--output_dir", out, "--checkpointing_steps", "2"],
                     request_after=2)
    assert res["preempted"] is True and res["steps"] == 2
    ckpt = os.path.join(out, "checkpoints")
    assert Checkpointer(ckpt).all_steps() == [2]
    assert _kind(ckpt, 2)["kind"] == "step"
    assert tpreempt.read_emergency_record(out)["step"] == 2


def test_graceful_shutdown_off_trains_through_a_request(tmp_path):
    res, _ = _fit(_RUN + ["--output_dir", str(tmp_path / "run"),
                          "--reliability.graceful_shutdown", "false"],
                  request_after=2)
    assert res["preempted"] is False and res["steps"] == 6
    tpreempt.get_guard().uninstall()  # clear the request no fit consumed


def test_a_stale_request_does_not_stop_the_next_fit(tmp_path):
    tpreempt.get_guard().request("stale")
    res, _ = _fit(_RUN + ["--output_dir", str(tmp_path / "run"),
                          "--num_epochs", "1"])
    assert res["preempted"] is False and res["steps"] == 3


def test_uninstall_restores_the_previous_handlers():
    calls = []

    def prev_term(signum, frame):
        calls.append(signum)

    before_int = signal.getsignal(signal.SIGINT)
    old_term = signal.signal(signal.SIGTERM, prev_term)
    guard = tpreempt.PreemptionGuard()
    try:
        assert guard.install()
        assert signal.getsignal(signal.SIGTERM) == guard._handler
        assert signal.getsignal(signal.SIGINT) == guard._handler
        # first strike: a request, the previous handler is not called
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert guard.requested and guard.reason == "SIGTERM" and calls == []
        # second strike: the previous disposition, signal re-delivered
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert calls == [signal.SIGTERM]
        guard.uninstall()
        assert signal.getsignal(signal.SIGTERM) is prev_term
        assert signal.getsignal(signal.SIGINT) is before_int
        assert not guard.requested
    finally:
        signal.signal(signal.SIGTERM, old_term)


def _child(out, extra=()):
    argv = [sys.executable, "-u", "-m", "pytorchvideo_accelerate_tpu_torch.run",
            *_RUN, "--num_epochs", "40", "--output_dir", out, *extra]
    return subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONPATH=REPO))


def _wait_for_step(proc, timeout_s=240.0):
    """Read the child's log until its first step line; returns the lines."""
    lines, t0 = [], time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith("step "):
            return lines
    proc.kill()
    raise AssertionError("child printed no step line:\n" + "".join(lines))


def test_sigterm_to_a_child_run_exits_zero_and_resumes(tmp_path):
    out = str(tmp_path / "child")
    proc = _child(out)
    try:
        _wait_for_step(proc)
        proc.send_signal(signal.SIGTERM)
        log, _ = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, log
    assert "preempted (SIGTERM)" in log
    rec = jpreempt.read_emergency_record(out)
    assert rec["reason"] == "SIGTERM" and 0 < rec["step"] < 120
    ckpt = Checkpointer(os.path.join(out, "checkpoints"))
    assert ckpt.all_steps() == [rec["step"]]
    assert _kind(ckpt.directory, rec["step"])["kind"] == "preempt"
    # resume=auto lands on that step: one more epoch than the checkpoint's
    epoch = _kind(ckpt.directory, rec["step"])["data_state"]["epoch"]
    res = trun.main(_RUN + ["--num_epochs", str(epoch + 1), "--output_dir", out,
                            "--resume_from_checkpoint", "auto"])
    assert res["preempted"] is False and res["steps"] == 3 * (epoch + 1)


def test_a_second_signal_kills_the_child(tmp_path):
    proc = _child(str(tmp_path / "child"))
    try:
        _wait_for_step(proc)
        proc.send_signal(signal.SIGTERM)
        proc.send_signal(signal.SIGINT)
        log, _ = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode in (-signal.SIGTERM, -signal.SIGINT, 130), (
        proc.returncode, log)


class _FlakySave:
    """torch.save that raises OSError its first `fails` calls."""

    def __init__(self, fails):
        self.fails = fails
        self.calls = 0
        self._save = torch.save

    def __call__(self, obj, path):
        self.calls += 1
        if self.calls <= self.fails:
            with open(path, "wb") as f:
                f.write(b"partial")
            raise OSError(28, "No space left on device (injected)")
        return self._save(obj, path)


def _state():
    trainer = Trainer(parse_cli(_RUN + ["--output_dir", "unused"]))
    trainer.close()
    return trainer.state


@pytest.mark.parametrize("fails,retries,ok", [(2, 3, True), (3, 3, False),
                                              (1, 1, False)])
def test_checkpoint_write_retries_oserror(tmp_path, monkeypatch, fails,
                                          retries, ok):
    flaky = _FlakySave(fails)
    monkeypatch.setattr(tckpt.torch, "save", flaky)
    ck = Checkpointer(str(tmp_path / "ck"), reliability=ReliabilityConfig(
        ckpt_retries=retries, retry_base_delay_s=0.001))
    state = _state()
    if ok:
        ck.save(5, state, {"kind": "step"})
        assert ck.all_steps() == [5]
        monkeypatch.undo()
        extra, step = ck.restore(_state())
        assert step == 5 and extra == {"kind": "step"}
    else:
        with pytest.raises(OSError, match="injected"):
            ck.save(5, state, {"kind": "step"})
        assert ck.all_steps() == []
    assert flaky.calls == min(fails + 1, retries) if ok else retries
    # every attempt starts from a clean temporary directory, none is left
    assert sorted(os.listdir(ck.directory)) == (["5"] if ok else [])


def test_trainer_checkpoints_retry_ckpt_retries_times(tmp_path):
    cfg = parse_cli(_RUN + ["--output_dir", str(tmp_path / "run"),
                            "--checkpointing_steps", "2", "--guard.enabled",
                            "--reliability.ckpt_retries", "5",
                            "--reliability.retry_base_delay_s", "0.01"])
    trainer = Trainer(cfg)
    try:
        # one retry policy, the run's, in both places that save
        assert trainer.checkpointer.reliability is cfg.reliability
        assert trainer.train_guard._checkpointer().reliability is cfg.reliability
        assert cfg.reliability.ckpt_retries == 5
        assert cfg.reliability.retry_base_delay_s == 0.01
    finally:
        trainer.close()
