"""The port's data-parallel training against the JAX package's, on the CPU
over gloo in float32.

Two ranks run as spawned processes (`tests/_torch_dp_worker.py`), each
group on a FileStore under the test's tmp_path and with a deadline. Held:

- (i) each rank's batches byte-equal to the JAX `ClipLoader` at the same
  (process_index, process_count): train, a val set of odd length (padding,
  and the JAX geometry of `len // process_count` clips a rank), and after
  a mid-epoch `LoaderState` resume (in this process: no group needed);
- (ii) one optimizer step of `slowfast_t`, accumulation 2, at world 2
  against the JAX step on a (2,1) train mesh over 2 of the conftest's CPU
  devices, from the same numpy-seeded weights and global batch, within the
  bounds `tests/test_torch_train.py` states for `slowfast_t` (loss atol
  1e-5; each gradient leaf within 1e-2 * (1 + max|g|), the whole gradient
  within 5e-3 relative; parameters and BN running averages atol 2e-5 after
  one step); the same run with the statistics' all-reduce patched out in
  the ranks (each rank's own batch statistics) must fail those bounds;
- (iii) world-2 eval top-1/top-5 equal to the JAX model's over the JAX
  loaders of both ranks (5 val clips, 3 and 2 a rank: a padded row);
- (iv) `auto` resume at world 2 (preempted on rank 0 only) reproducing an
  unbroken run's losses at rtol 1e-6, and an export of the resumed state
  that rank 0 writes; (vi) that preemption stops both ranks at one step
  with one "preempt" checkpoint;
- (v) a NaN planted in rank 1's batch only: both ranks skip the step, and
  their states stay bitwise equal;
- (vii) mixing: each rank's clips mixed with its partner rows of the
  flipped global batch, bitwise the global x[::-1] mix (the JAX step's
  flip of the whole batch); each rank's dropout, drop-path and MAE tube
  masks its rows of the one global-batch mask.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dp_worker import run_group
from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.config import MeshConfig as JMeshConfig
from pytorchvideo_accelerate_tpu.config import ModelConfig as JModelConfig
from pytorchvideo_accelerate_tpu.data import pipeline as jpipe
from pytorchvideo_accelerate_tpu.data import transforms as jtf
from pytorchvideo_accelerate_tpu.parallel.mesh import make_mesh, make_train_mesh
from pytorchvideo_accelerate_tpu.parallel.sharding import shard_batch
from pytorchvideo_accelerate_tpu.trainer import optim as joptim
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState as JState
from pytorchvideo_accelerate_tpu_torch.config import parse_cli
from pytorchvideo_accelerate_tpu_torch.data import pipeline as tpipe
from pytorchvideo_accelerate_tpu_torch.data import transforms as ttf
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    jax_tree_from_state_dict,
    state_dict_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps
from test_torch_train import (
    NUM_CLASSES,
    _clips,
    _close_per_leaf,
    _jax_model,
    _labels,
    _opt_cfgs,
    _seeded_flat,
)

WORLD = 2


# --- (i) the per-rank loader ---------------------------------------------------


def _sources(training: bool, num_videos: int):
    kw = dict(num_frames=8, min_short_side_scale=72, max_short_side_scale=72,
              crop_size=64, training=training, is_slowfast=True,
              output_dtype="float32")
    src_kw = dict(num_videos=num_videos, num_classes=3, seed=11)
    return (jpipe.SyntheticClipSource(jtf.make_transform(**kw), **src_kw),
            tpipe.SyntheticClipSource(ttf.make_transform(**kw), **src_kw))


def _assert_batches_equal(tb, jb):
    assert len(tb) == len(jb) > 0
    for a, b in zip(tb, jb):
        assert sorted(a) == sorted(b)
        for k in b:
            got = np.asarray(a[k])
            assert got.dtype == b[k].dtype and got.shape == b[k].shape, k
            np.testing.assert_array_equal(got, b[k], err_msg=k)


@pytest.mark.parametrize("split", ["train", "val_odd", "resume"])
def test_per_rank_batches_byte_equal_to_jax(split):
    training = split != "val_odd"
    js, ts = _sources(training, 21 if split == "val_odd" else 20)
    kw = (dict(accum_steps=2, shuffle=True, drop_last=True, seed=3)
          if training else dict(shuffle=False, drop_last=False, seed=3))
    for rank in range(WORLD):
        common = dict(num_workers=2, process_index=rank, process_count=WORLD, **kw)
        jl = jpipe.ClipLoader(js, 6 if not training else 4, transport="thread", **common)
        tl = tpipe.ClipLoader(ts, 6 if not training else 4, **common)
        try:
            assert tl.local_batch_size == jl.local_batch_size
            assert tl.steps_per_epoch() == jl.steps_per_epoch()
            np.testing.assert_array_equal(tl._epoch_indices(1), jl._epoch_indices(1))
            if split == "resume":
                for loader in (jl, tl):
                    it = loader.epoch(0)
                    next(it)
                    it.close()
                    assert loader.state.to_dict() == {"epoch": 0, "position": 1}
            _assert_batches_equal(list(tl.epoch(0)), list(jl.epoch(0)))
            assert tl.state.to_dict() == jl.state.to_dict()
        finally:
            jl.close()
            tl.close()
    if split == "val_odd":
        # 21 clips, 3 a rank a batch: 21 // 2 = 10 clips give each rank 4
        # batches; rank 0's share holds 11 clips, rank 1's 10, so the last
        # batches carry 2 and 1 real rows
        for rank, mask in ((0, [1, 1, 0]), (1, [1, 0, 0])):
            tl = tpipe.ClipLoader(ts, 6, process_index=rank, process_count=WORLD,
                                  shuffle=False, drop_last=False, num_workers=1)
            batches = list(tl.epoch(0))
            tl.close()
            assert len(batches) == 4
            np.testing.assert_array_equal(batches[-1]["mask"], mask)


def test_global_batch_must_split_evenly():
    _, ts = _sources(True, 8)
    with pytest.raises(ValueError, match="not divisible by process_count 2"):
        tpipe.ClipLoader(ts, 3, process_index=0, process_count=2)


# --- (ii) one optimizer step against the JAX step on a (2,1) mesh ------------


def _spec(tmp_path):
    name, accum, batch = "slowfast_t", 2, 8
    clips = _clips(name, batch, 21, lead=(accum,))
    labels = _labels(batch, 21, lead=(accum,))
    flat = _seeded_flat(name)
    np.savez(tmp_path / "spec.npz", num_classes=NUM_CLASSES, label=labels,
             **clips, **{f"w/{k}": v for k, v in flat.items()})
    return clips, labels, flat


def _jax_step(clips, labels, flat):
    """The JAX step on a (2,1) train mesh over 2 CPU devices, and the JAX
    gradient of the global batch (the mean over micro-steps of each
    micro-batch's gradient, as its step takes it)."""
    tree = unflatten_tree(flat)
    jcfg, _ = _opt_cfgs()
    jm = _jax_model("slowfast_t", "xla")
    tx = joptim.build_optimizer(jcfg, 4)
    jstate = JState.create(jax.tree.map(jnp.asarray, tree["params"]),
                           jax.tree.map(jnp.asarray, tree["batch_stats"]), tx)
    mesh = make_train_mesh(JMeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    assert dict(mesh.shape) == {"data": WORLD, "model": 1}
    jstep = jsteps.make_train_step(jm, tx, mesh, accum_steps=2,
                                   lr_schedule=joptim.build_lr_schedule(jcfg, 4))
    batch = {**clips, "label": labels}
    jstate, jmetrics = jstep(jstate, shard_batch(mesh, batch, micro_dim=True),
                             jax.random.key(0))

    def loss_of(params, micro):
        logits, _ = jm.apply(
            {"params": params, "batch_stats": tree["batch_stats"]},
            (clips["slow"][micro], clips["fast"][micro]), train=True,
            mutable=["batch_stats"])
        loss, _, _ = jsteps._loss_and_metrics(
            logits, jnp.asarray(labels[micro]), jnp.ones(labels.shape[1]), 0.0)
        return loss

    grad = jax.jit(jax.grad(loss_of), static_argnums=1)
    grads = jax.tree.map(lambda a, b: (a + b) / 2, grad(tree["params"], 0),
                         grad(tree["params"], 1))
    want_g = state_dict_from_jax({"params": jax.device_get(grads)})
    want_s = state_dict_from_jax({"params": jax.device_get(jstate.params),
                                  "batch_stats": jax.device_get(jstate.batch_stats)})
    return {k: float(v) for k, v in jmetrics.items()}, want_g, want_s


def _bound_failures(out, jmetrics, want_g, want_s) -> list:
    """The bounds of the module docstring, each failure named."""
    fails = []
    if abs(out["loss"] - jmetrics["loss"]) > 1e-5:
        fails.append(("loss", out["loss"], jmetrics["loss"]))
    try:
        _close_per_leaf(out["grads"], want_g, 1e-2)
    except AssertionError as e:
        fails.append(("gradient leaf", str(e)[:200]))
    err = sum(float(((out["grads"][k] - want_g[k]) ** 2).sum()) for k in want_g)
    ref = sum(float((want_g[k] ** 2).sum()) for k in want_g)
    if (err / ref) ** 0.5 > 5e-3:
        fails.append(("whole gradient", (err / ref) ** 0.5))
    for k in want_s:
        d = float(np.abs(out["state"][k] - want_s[k]).max())
        if d > 2e-5:
            fails.append((k, d))
    return fails


def test_one_step_matches_the_jax_data_parallel_step(tmp_path):
    """Sync BN, the gradient all-reduce and the global metrics: rank 0's
    loss, gradient and new state against the JAX (2,1)-mesh step, rank 1's
    bitwise rank 0's; the control with each rank's own statistics fails."""
    clips, labels, flat = _spec(tmp_path)
    r0, r1 = run_group("train_step", tmp_path, timeout_s=240)
    jmetrics, want_g, want_s = _jax_step(clips, labels, flat)
    assert r0["sync"]["loss"] == r1["sync"]["loss"]
    for k in r0["sync"]["state"]:
        np.testing.assert_array_equal(r0["sync"]["state"][k], r1["sync"]["state"][k],
                                      err_msg=k)
    assert _bound_failures(r0["sync"], jmetrics, want_g, want_s) == []
    np.testing.assert_allclose(r0["sync"]["grad_norm"], jmetrics["grad_norm"], rtol=1e-3)
    np.testing.assert_allclose(r0["sync"]["accuracy"], jmetrics["accuracy"], atol=1e-7)
    control = _bound_failures(r0["control"], jmetrics, want_g, want_s)
    assert any(k.endswith("running_mean") or k.endswith("running_var")
               for k, *_ in control), control


# --- (iii)-(vi) the Trainer at world 2 -------------------------------------------


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_trainer")
    return d, run_group("trainer", d, timeout_s=300)


def _jax_eval(weights, cfg):
    """Top-1 / top-5 of the JAX model over the JAX val loaders of both
    ranks (the JAX package's global eval at 2 processes)."""
    d = cfg.data
    tree = jax_tree_from_state_dict(weights)
    jm = jmodels.create_model(JModelConfig(name=cfg.model.name,
                                           num_classes=cfg.model.num_classes,
                                           fused_kernels="off"), "fp32")
    tf = jtf.make_transform(
        training=False, num_spatial_crops=d.eval_num_spatial_crops,
        num_frames=d.num_frames, is_slowfast=False, slowfast_alpha=cfg.model.slowfast_alpha,
        min_short_side_scale=d.min_short_side_scale,
        max_short_side_scale=d.max_short_side_scale, crop_size=d.crop_size,
        mean=d.mean, std=d.std, horizontal_flip_p=d.horizontal_flip_p,
        output_dtype="float32")
    src = jpipe.SyntheticClipSource(tf, num_videos=max(d.synthetic_num_videos // 4, 4),
                                    num_classes=cfg.model.num_classes,
                                    seed=cfg.seed + 1, num_clips=d.eval_num_clips)
    mesh = make_mesh(JMeshConfig(data=1), devices=jax.devices()[:1])
    jstate = JState.create(jax.tree.map(jnp.asarray, tree["params"]),
                           jax.tree.map(jnp.asarray, tree["batch_stats"]),
                           joptim.build_optimizer(_opt_cfgs()[0], 4))
    step = jsteps.make_eval_step(jm, mesh)
    sums = {"correct": 0.0, "correct5": 0.0, "count": 0.0}
    for rank in range(WORLD):
        loader = jpipe.ClipLoader(src, d.batch_size * WORLD, shuffle=False,
                                  drop_last=False, num_workers=1, process_index=rank,
                                  process_count=WORLD, transport="thread")
        for batch in loader.epoch(0):
            out = step(jstate, shard_batch(mesh, batch))
            for k in sums:
                sums[k] += float(out.get(k, 0.0))
        loader.close()
    return sums


def test_eval_at_world_two_matches_jax_global_eval(trainer_runs):
    d, (r0, r1) = trainer_runs
    assert r0["eval"] == r1["eval"]
    for k in r0["eval_weights"]:
        np.testing.assert_array_equal(r0["eval_weights"][k], r1["eval_weights"][k])
    cfg = parse_cli(["--cpu", "--synthetic", "--model.name", "tiny3d",
                     "--num_frames", "4", "--data.crop_size", "32",
                     "--data.min_short_side_scale", "32",
                     "--data.max_short_side_scale", "40", "--batch_size", "3",
                     "--data.synthetic_num_videos", "20"])
    cfg.model.num_classes = cfg.model.num_classes or 4
    sums = _jax_eval(r0["eval_weights"], cfg)
    # 5 val clips, one batch of 3 a rank: rank 0 all real, rank 1 a padded row
    assert sums["count"] == 5
    assert r0["eval"]["val_accuracy"] == pytest.approx(sums["correct"] / sums["count"], abs=1e-12)
    assert r0["eval"]["val_accuracy_top5"] == pytest.approx(
        sums["correct5"] / sums["count"], abs=1e-12)


def test_auto_resume_at_world_two_reproduces_the_unbroken_run(trainer_runs):
    """(iv) and (vi): rank 0 alone asks to stop after step 2; both ranks
    stop there, one "preempt" checkpoint lands, and the resumed pair ends
    at the unbroken run's 4 steps with its losses."""
    d, (r0, r1) = trainer_runs
    for out in (r0, r1):
        res, seen, state = out["preempted"]
        assert res["preempted"] and res["steps"] == 2
        assert [s for s, *_ in seen] == [1, 2]
    ckpt = d / "resume" / "checkpoints"
    with open(ckpt / "2" / "extra.json") as f:
        extra = json.load(f)
    assert extra["kind"] == "preempt" and extra["data_state"] == {"epoch": 0, "position": 2}
    with open(d / "resume" / "emergency_checkpoint.json") as f:
        assert json.load(f)["step"] == 2
    for out in (r0, r1):
        unbroken = [loss for _, loss, _ in out["unbroken"][1]]
        resumed = [loss for _, loss, _ in out["preempted"][1] + out["resumed"][1]]
        assert out["unbroken"][0]["steps"] == out["resumed"][0]["steps"] == 4
        np.testing.assert_allclose(resumed, unbroken, rtol=1e-6)
    for k in r0["resumed"][2]:
        np.testing.assert_array_equal(r0["resumed"][2][k], r1["resumed"][2][k])
    assert sorted(os.listdir(ckpt)) == ["2", "3", "4"]
    # the export of the resumed state: rank 0 writes it, both ranks return
    # its path, and it holds the final weights
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import load_inference

    assert r0["exported"] == r1["exported"] == {"exported": str(d / "artifact")}
    weights, meta = load_inference(str(d / "artifact"))
    assert meta["step"] == 4
    for k, v in weights.items():
        np.testing.assert_array_equal(np.asarray(v), r0["resumed"][2][k], err_msg=k)


def test_a_nan_on_one_rank_skips_the_step_on_both(trainer_runs):
    """(v): rank 1's second batch is poisoned; the global loss is NaN on
    both ranks, both skip step 2 and train on, bitwise equal."""
    _, (r0, r1) = trainer_runs
    for out in (r0, r1):
        _, seen, _ = out["nan"]
        assert [skip for *_, skip in seen] == [0.0, 1.0, 0.0]
        assert np.isnan(seen[1][1]) and np.isfinite(seen[2][1])
    s0, s1 = r0["nan"][2], r1["nan"][2]
    for k in s0:
        assert np.isfinite(s0[k]).all(), k
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)


# --- (vii) mixing against the global batch's flip ----------------------------------


def test_mixing_pairs_rows_across_ranks_like_the_global_flip(tmp_path):
    rng = np.random.default_rng(4)
    b, hh, ww = 6, 8, 8
    x = rng.standard_normal((b, 2, hh, ww, 3)).astype(np.float32)
    labels = rng.integers(0, 5, b).astype(np.int64)
    logits = rng.standard_normal((b, 5)).astype(np.float32)
    draw = tsteps.MixDraw(use_cutmix=True, lam=0.6, cy=0.3, cx=0.7)
    w = tsteps.mix_weight(draw, hh, ww, "cpu").numpy()
    np.savez(tmp_path / "mix.npz", x=x, labels=labels, logits=logits, w=w)
    outs = run_group("mix", tmp_path, timeout_s=120)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    wx = w[None, None, :, :, None]
    want = torch.from_numpy(wx * xb + (1 - wx) * xb[::-1]).to(torch.bfloat16).float().numpy()
    got = np.concatenate([o["video"] for o in outs])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.concatenate([o["flipped_labels"] for o in outs]),
                                  labels[::-1])
    # the loss of the global batch is the mean of the ranks' (equal shares)
    loss, correct, _ = tsteps.mixed_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                         torch.from_numpy(w).mean(), torch.ones(b), 0.1)
    assert np.mean([o["loss"] for o in outs]) == pytest.approx(float(loss), abs=1e-6)
    assert sum(o["correct"] for o in outs) == float(correct)


def test_random_masks_are_rows_of_the_global_batch_mask(tmp_path):
    """Dropout, drop path and the MAE tube mask: each rank keeps its rows
    of what one stream draws for the whole global batch (the JAX package's
    one key over the global batch): the ranks' masks differ, and together
    they are one process's."""
    from pytorchvideo_accelerate_tpu_torch.models.common import DropPath, SeededDropout
    from pytorchvideo_accelerate_tpu_torch.models.videomae import tube_mask_indices

    rng = np.random.default_rng(4)
    np.savez(tmp_path / "mix.npz", x=rng.standard_normal((16, 2, 4, 4, 3)).astype(np.float32),
             labels=np.arange(16) % 5,
             logits=rng.standard_normal((16, 5)).astype(np.float32),
             w=np.full((4, 4), 0.5, np.float32))
    outs = run_group("mix", tmp_path, timeout_s=120)
    for cls, shape in ((SeededDropout, (16, 5)), (DropPath, (16, 3, 2))):
        m = cls(0.5).train()
        m.reseed(1234)
        want = m(torch.ones(shape)).numpy()
        got = [o["dropout"][cls.__name__] for o in outs]
        assert not np.array_equal(got[0], got[1])
        np.testing.assert_array_equal(np.concatenate(got), want)
    want = tube_mask_indices(torch.Generator().manual_seed(7), 16, 2, 4, 4, 0.75)
    for key, w in zip(("tube_keep", "tube_masked"), want):
        got = [o["dropout"][key] for o in outs]
        assert not np.array_equal(got[0], got[1])
        np.testing.assert_array_equal(np.concatenate(got), w.numpy())
