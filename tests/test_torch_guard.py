"""The port's training guard against the JAX package's, on the CPU:
`reliability/guard.py` (SpikeDetector, replay bundles, the TrainGuard
ladder), `data/manifest.py Quarantine`, `data/samplers.py
substitute_indices`, the train step's `guard_skip`, and a Trainer that
quarantines a clip that fails to decode.

The ladder runs the metric sequences of tests/test_zguard.py through both
guards, fed the way fit() feeds them (step N stashed, observed at N + 1),
each guard saving its last-known-good ring with its own package's
checkpointer; the actions (kind, LKG step, resume position), the skip and
rollback counts, the LKG step and the halts must be the same. Verdicts,
bundle bytes, sidecars and substituted indices are compared exactly;
`guard_skip` must leave the state bitwise unchanged.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorchvideo_accelerate_tpu.config import GuardConfig as JGuardConfig
from pytorchvideo_accelerate_tpu.data import manifest as jman
from pytorchvideo_accelerate_tpu.data import pipeline as jpipe
from pytorchvideo_accelerate_tpu.data import samplers as jsamplers
from pytorchvideo_accelerate_tpu.reliability import guard as jguard
from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState as JTrainState
from pytorchvideo_accelerate_tpu_torch import run as trun
from pytorchvideo_accelerate_tpu_torch.config import (
    GuardConfig,
    ModelConfig,
    OptimConfig,
    parse_cli,
)
from pytorchvideo_accelerate_tpu_torch.data import decode as tdecode
from pytorchvideo_accelerate_tpu_torch.data import manifest as tman
from pytorchvideo_accelerate_tpu_torch.data import pipeline as tpipe
from pytorchvideo_accelerate_tpu_torch.data import samplers as tsamplers
from pytorchvideo_accelerate_tpu_torch.models import create_model
from pytorchvideo_accelerate_tpu_torch.reliability import guard as tguard
from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer
from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

NAN = float("nan")


# --- SpikeDetector ----------------------------------------------------------

def _sequences():
    rng = np.random.default_rng(0)
    noisy = [2.0 + float(v) * 0.05 for v in rng.normal(size=40)]
    return {
        "warmup_cliff": ((0.1, 4.0, 20), [5.0 * 0.8 ** i for i in range(20)]),
        "lr_drop": ((0.1, 4.0, 5), noisy + [0.4, 0.45]),
        "spike": ((0.1, 4.0, 5),
                  [1.0 + float(v) * 0.05
                   for v in np.random.default_rng(1).normal(size=40)]
                  + [25.0, 1.0, 25.0]),
        "spike_not_absorbed": ((0.5, 3.0, 2), [1.0] * 20
                               + [1.1, 0.9, 1.05, 0.95] * 3 + [50.0, 50.0]),
        "nan_in_warmup": ((0.05, 6.0, 100),
                          [1.0, NAN, float("inf"), 1.0, NAN]),
    }


@pytest.mark.parametrize("case", sorted(_sequences()))
def test_spike_detector_verdicts_equal(case):
    (alpha, z, warmup), seq = _sequences()[case]
    t = tguard.SpikeDetector(alpha=alpha, zscore=z, warmup=warmup)
    j = jguard.SpikeDetector(alpha=alpha, zscore=z, warmup=warmup)
    got, want = [t.update(v) for v in seq], [j.update(v) for v in seq]
    assert got == want
    assert (t.n, t.mean, t.var) == (j.n, j.mean, j.var)
    assert any(v is not None for v in want) == (case not in ("warmup_cliff",
                                                             "lr_drop"))


# --- replay bundles ---------------------------------------------------------

def _bundle_batch():
    video = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4) / 8
    return ({"video": torch.from_numpy(video).to(torch.bfloat16),
             "label": torch.tensor([1, 2], dtype=torch.int32),
             "mask": torch.tensor([1.0, 0.0])},
            {"video": jnp.asarray(video, jnp.bfloat16),
             "label": np.int32([1, 2]), "mask": jnp.asarray([1.0, 0.0])})


def test_replay_bundle_bytes_equal_jax_and_cross_load(tmp_path):
    tb, jb = _bundle_batch()
    meta = {"step": 7, "seed": 42, "verdict": {"kind": "nonfinite"}}
    a = tguard.dump_replay_bundle(str(tmp_path / "port"), tb, meta)
    b = jguard.dump_replay_bundle(str(tmp_path / "jax"), jb, meta)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == [
        "label.npy", "mask.npy", "meta.json", "video.npy"]
    for fname in os.listdir(a):
        with open(os.path.join(a, fname), "rb") as fa, \
                open(os.path.join(b, fname), "rb") as fb:
            assert fa.read() == fb.read(), fname
    again = tguard.dump_replay_bundle(str(tmp_path / "port"), tb, meta)
    assert again == a and not [d for d in os.listdir(tmp_path) if ".tmp" in d]
    for load, path in ((tguard.load_replay_bundle, b),
                       (jguard.load_replay_bundle, a)):
        got_meta, arrays = load(path)
        assert got_meta["arrays"]["video"]["source_dtype"] == "bfloat16"
        assert arrays["video"].dtype == np.float32
        np.testing.assert_array_equal(arrays["video"],
                                      tb["video"].float().numpy())
        np.testing.assert_array_equal(arrays["label"], [1, 2])


def test_poison_batch_floats_only():
    batch = {"video": torch.ones(2, 3), "slow": torch.ones(2, 2, dtype=torch.uint8),
             "label": torch.tensor([1, 2])}
    out = tguard.poison_batch(batch)
    assert torch.isnan(out["video"]).all()
    assert torch.equal(out["slow"], batch["slow"])
    assert torch.equal(out["label"], batch["label"])
    assert torch.equal(batch["video"], torch.ones(2, 3))  # a copy


# --- quarantine and substitution --------------------------------------------

def test_quarantine_budget_and_persistence(tmp_path):
    sidecar = str(tmp_path / "q.json")
    q = tman.Quarantine(sidecar, budget=3)
    err = IOError("moov atom not found")
    assert q.record("/d/bad.mp4", err) is False
    assert q.record("/d/bad.mp4", err) is False
    assert not q.contains("/d/bad.mp4")
    assert q.record("/d/bad.mp4", err) is True
    assert q.contains("/d/bad.mp4") and q.record("/d/bad.mp4", err) is False
    q2 = tman.Quarantine(sidecar, budget=3)
    assert q2.contains("/d/bad.mp4") and len(q2) == 1
    q2.record("/d/other.mp4", err)
    snap = tman.Quarantine(sidecar, budget=3).snapshot()
    assert snap["failures_under_budget"] == {"/d/other.mp4": 1}
    assert "/d/bad.mp4" in snap["quarantined"]


def test_quarantine_sidecar_crosses_both_ways(tmp_path):
    """The same records give byte-equal sidecars in both packages, and each
    package reads the other's."""
    err = IOError("moov atom not found")
    t_path, j_path = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tq, jq = tman.Quarantine(t_path, budget=2), jman.Quarantine(j_path, budget=2)
    for path in ("/d/a.mp4", "/d/b.mp4", "/d/a.mp4"):
        assert tq.record(path, err) == jq.record(path, err)
    with open(t_path, "rb") as ft, open(j_path, "rb") as fj:
        assert ft.read() == fj.read()
    assert jman.Quarantine(t_path, budget=2).snapshot() == tq.snapshot()
    assert tman.Quarantine(j_path, budget=2).snapshot() == jq.snapshot()


@pytest.mark.parametrize("body", ["{not json", "[1, 2]", ""])
def test_unreadable_sidecar_starts_fresh(tmp_path, body):
    sidecar = tmp_path / "q.json"
    sidecar.write_text(body)
    q = tman.Quarantine(str(sidecar), budget=1)
    assert len(q) == 0 and q.snapshot()["failures_under_budget"] == {}


@pytest.mark.parametrize("excluded,total,seed,epoch", [
    ({2, 7}, 10, 3, 1), ({0}, 5, 0, 0), (set(range(10)), 10, 3, 1),
    (set(), 6, 1, 2), ({1, 3, 5, 7, 9}, 12, 11, 4)])
def test_substitute_indices_equal_jax(excluded, total, seed, epoch):
    idx = np.random.default_rng(seed).permutation(total)
    got = tsamplers.substitute_indices(idx, excluded, total, seed, epoch)
    want = jsamplers.substitute_indices(idx, excluded, total, seed, epoch)
    np.testing.assert_array_equal(got, want)
    assert len(got) == total
    if len(excluded) < total:
        assert not (excluded & set(got.tolist()))


# --- the ladder -------------------------------------------------------------

def _port_state():
    model = torch.nn.Linear(4, 2)
    opt = build_optimizer(OptimConfig(), 4, model.named_parameters())
    return TrainState.create(model, opt)


def _jax_state():
    return JTrainState.create({"w": jnp.ones((4,))}, {}, optax.sgd(0.1))


def _run(guard, metrics_seq, state, loader_state_cls, start_step=0):
    """Feed a metric stream through the per-step hook as fit() does; the
    actions as comparable tuples."""
    actions = []
    for i, m in enumerate(metrics_seq):
        gstep = start_step + i + 1
        if hasattr(state, "step") and isinstance(state.step, int):
            state.step = gstep
        pos = loader_state_cls(epoch=0, position=gstep)
        batch = {"video": np.full((2, 2), m["loss"], np.float32)}
        a = guard.step(gstep, m, batch, pos, state)
        actions.append(None if a is None else
                       (a.kind, a.lkg_step, a.resume_position))
    return actions


def _both(tmp_path, **over):
    kw = dict(enabled=True, lkg_every_steps=2, lkg_keep=2, rollback_after=2,
              max_rollbacks=1, warmup_steps=1000)
    kw.update(over)
    t = tguard.TrainGuard(GuardConfig(**kw), output_dir=str(tmp_path / "t"),
                          seed=1)
    j = jguard.TrainGuard(JGuardConfig(**kw), output_dir=str(tmp_path / "j"),
                          seed=1)
    return t, j


def _m(loss):
    return {"loss": loss, "grad_norm": abs(loss)}


def _ladder(tmp_path, over, stages):
    """Run `stages` [(metrics, start_step)] through both guards: the
    actions, counts and halts must be equal."""
    t, j = _both(tmp_path, **over)
    ts, js = _port_state(), _jax_state()
    outcome = []
    for seq, start in stages:
        got = want = None
        try:
            got = _run(t, seq, ts, tpipe.LoaderState, start)
        except tguard.GuardHalt as e:
            got = ("halt", "rollback" in str(e), "no last-known-good" in str(e))
        try:
            want = _run(j, seq, js, jpipe.LoaderState, start)
        except jguard.GuardHalt as e:
            want = ("halt", "rollback" in str(e), "no last-known-good" in str(e))
        assert got == want
        assert (t.skips, t.rollbacks, t.lkg_step) == (j.skips, j.rollbacks,
                                                      j.lkg_step)
        outcome.append(got)
    if j._ckpt is not None:
        j._ckpt.wait()
    return t, j, outcome


def test_ladder_skip_then_rollback_to_lkg(tmp_path):
    t, _, (actions,) = _ladder(
        tmp_path, {}, [([_m(1.0)] * 5 + [_m(NAN)] * 2 + [_m(1.0)], 0)])
    rollbacks = [a for a in actions if a is not None]
    assert t.skips == 1 and len(rollbacks) == 1
    kind, lkg, position = rollbacks[0]
    assert kind == "rollback" and lkg == t.lkg_step and position["position"] == 7
    assert os.path.isdir(t.last_rollback["bundle"])
    t.restore(_port_state(), tguard.GuardAction("rollback", lkg, position))


def test_ladder_halt_after_max_rollbacks(tmp_path):
    _, _, outcome = _ladder(tmp_path, {}, [
        ([_m(1.0)] * 4 + [_m(NAN)] * 2 + [_m(1.0)], 0),
        ([_m(NAN)] * 4, 10)])
    assert outcome[1] == ("halt", True, False)


def test_ladder_halt_when_no_lkg_exists(tmp_path):
    _, _, outcome = _ladder(tmp_path, {"lkg_every_steps": 1000},
                            [([_m(NAN)] * 4, 0)])
    assert outcome[0] == ("halt", False, True)


def test_ladder_ring_pruned_to_keep(tmp_path):
    t, j, _ = _ladder(tmp_path, {"lkg_every_steps": 1, "lkg_keep": 2},
                      [([_m(1.0)] * 6, 0)])
    assert t.ring_steps() == j.ring_steps() and len(t.ring_steps()) == 2
    assert t.lkg_step == max(t.ring_steps())


def test_ladder_requires_healthy_window(tmp_path):
    t, _, _ = _ladder(
        tmp_path, {"lkg_every_steps": 3, "rollback_after": 100,
                   "max_rollbacks": 100},
        [([_m(1.0)] * 4, 0), ([_m(NAN)] * 2, 4), ([_m(NAN)] * 8, 6),
         ([_m(1.0)] * 8, 14)])
    assert t.lkg_step > 4


def test_ladder_spike_policy(tmp_path):
    """A spike past the warmup escalates like a nonfinite step; under the
    spike-only policy a NaN does not."""
    seq = [_m(1.0 + 0.01 * (i % 3)) for i in range(30)] + [_m(80.0)] * 2 + [_m(1.0)]
    _ladder(tmp_path / "a", {"warmup_steps": 5, "lkg_every_steps": 5}, [(seq, 0)])
    _ladder(tmp_path / "b", {"policy": "spike"},
            [([_m(1.0)] * 3 + [_m(NAN)] * 3 + [_m(1.0)], 0)])


# --- guard_skip in the train step ---------------------------------------------

def _skip_setup(optimizer, ema):
    # no head dropout: the skipped step's forward would advance its draws
    model = create_model(ModelConfig(name="tiny3d", num_classes=4,
                                     dropout_rate=0.0), "fp32", seed=0)
    opt = build_optimizer(OptimConfig(optimizer=optimizer, lr=0.1,
                                      schedule="constant"),
                          4, model.named_parameters())
    state = TrainState.create(model, opt, ema_decay=0.9 if ema else 0.0)
    step = tsteps.make_train_step(model, opt, accum_steps=2,
                                  ema_decay=0.9 if ema else 0.0,
                                  guard_skip=True)
    return model, state, step


def _batch(seed, poison=False):
    rng = np.random.default_rng(seed)
    video = torch.from_numpy(rng.standard_normal((2, 2, 4, 16, 16, 3)).astype(np.float32))
    batch = {"video": video,
             "label": torch.from_numpy(rng.integers(0, 4, (2, 2)))}
    return tguard.poison_batch(batch) if poison else batch


def _snapshot(state):
    opt = {(id(p), k): v.clone() for p, st in state.optimizer.opt.state.items()
           for k, v in st.items() if torch.is_tensor(v)}
    return ({k: v.clone() for k, v in state.model.state_dict().items()}, opt,
            {k: v.clone() for k, v in (state.ema or {}).items()})


def _same(a, b):
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_guard_skip_leaves_the_state_bitwise_unchanged(optimizer):
    """A NaN batch: the parameters, the BN running averages (which its
    forward wrote), the optimizer's state and the EMA keep their values
    bit for bit; only the step advances, and `skipped` reads 1."""
    model, state, step = _skip_setup(optimizer, ema=True)
    m = step(state, _batch(0))
    assert m["skipped"].item() == 0.0 and state.step == 1
    before = _snapshot(state)
    m = step(state, _batch(1, poison=True))
    assert not torch.isfinite(m["loss"]) and m["skipped"].item() == 1.0
    assert state.step == 2
    _same(_snapshot(state), before)
    m = step(state, _batch(2))  # and the run goes on
    assert torch.isfinite(m["loss"]) and m["skipped"].item() == 0.0


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_guard_skip_of_the_first_step_leaves_fresh_state(optimizer):
    """A skipped first step leaves the optimizer state it created at zeros,
    which the next update treats as absent: a clean step after it equals a
    fresh run's first clean step, bit for bit (constant LR)."""
    _, skipped, step = _skip_setup(optimizer, ema=False)
    step(skipped, _batch(1, poison=True))
    step(skipped, _batch(2))
    _, fresh, fresh_step = _skip_setup(optimizer, ema=False)
    fresh_step(fresh, _batch(2))
    got, want = _snapshot(skipped), _snapshot(fresh)
    _same(got[:1], want[:1])
    assert sorted(k for _, k in got[1]) == sorted(k for _, k in want[1])


def test_disarmed_step_reports_no_skip():
    model = create_model(ModelConfig(name="tiny3d", num_classes=4), "fp32", seed=0)
    opt = build_optimizer(OptimConfig(), 4, model.named_parameters())
    m = tsteps.make_train_step(model, opt, accum_steps=2)(
        TrainState.create(model, opt), _batch(0))
    assert "skipped" not in m


# --- a Trainer with a quarantine --------------------------------------------

def _write_video(path, seed, frames=24):
    cv2 = pytest.importorskip("cv2")
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (64, 48))
    assert w.isOpened()
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 256, (48, 64, 3), np.uint8))
    w.release()


def test_trainer_quarantines_a_failing_clip(tmp_path, monkeypatch):
    """`--guard.enabled --guard.quarantine_budget 1` on a list manifest with
    one corrupt file, one batch of all five clips per epoch: the first
    epoch sidelines it (the sidecar names it),
    the second epoch never asks the source for its index and never opens
    it, fit() finishes; a second run reads the sidecar and never opens the
    file at all."""
    root = tmp_path / "videos"
    (root / "v").mkdir(parents=True)
    for i in range(4):
        _write_video(root / "v" / f"{i}.mp4", i)
    (root / "v" / "bad.mp4").write_bytes(b"not a video container" * 8)
    names = [f"v/{i}.mp4" for i in range(4)] + ["v/bad.mp4"]
    train = tmp_path / "train.txt"
    train.write_text("".join(f"{n} {i % 2}\n" for i, n in enumerate(names)))
    val = tmp_path / "val.txt"
    val.write_text("v/0.mp4 0\nv/1.mp4 1\n")
    out = tmp_path / "run"
    argv = ["--cpu", "--data_dir", str(root), "--data.train_list", str(train),
            "--data.val_list", str(val), "--model.name", "tiny3d",
            "--num_frames", "4", "--data.crop_size", "32",
            "--data.min_short_side_scale", "48", "--data.max_short_side_scale",
            "48", "--batch_size", "5", "--num_epochs", "2", "--num_workers", "2",
            "--sampling_rate", "2", "--mixed_precision", "fp32",
            "--guard.enabled", "--guard.quarantine_budget", "1",
            "--reliability.decode_retries", "1", "--output_dir", str(out)]
    opened = []
    real_probe = tdecode.probe

    def probe(path):
        opened.append((epoch_of[0], os.path.basename(path)))
        return real_probe(path)

    monkeypatch.setattr(tdecode, "probe", probe)
    epoch_of = [None]
    asked = []
    real_get = tpipe.VideoClipSource.get

    def get(self, index, epoch):
        if self.training:
            asked.append((epoch, index))
            epoch_of[0] = epoch
        return real_get(self, index, epoch)

    monkeypatch.setattr(tpipe.VideoClipSource, "get", get)
    tr = Trainer(parse_cli(argv))
    res = tr.fit()
    assert res["steps"] == 2 and np.isfinite(res["train_loss"])
    assert res["quarantined_clips"] == 1 and res["guard_rollbacks"] == 0
    with open(out / "quarantine.json") as f:
        sidecar = json.load(f)
    assert list(sidecar["quarantined"]) == [str(root / "v" / "bad.mp4")]
    assert (0, 4) in asked and (1, 4) not in asked
    assert [e for e, name in opened if name == "bad.mp4"] == [0]
    opened.clear()
    res = trun.main(argv + ["--num_epochs", "1"])
    assert res["quarantined_clips"] == 1
    assert "bad.mp4" not in [name for _, name in opened]
