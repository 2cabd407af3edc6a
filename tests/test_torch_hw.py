"""The port's MFU reporting (`utils/hw.py`, the Trainer's FLOP count)
against the JAX package's, on the CPU.

- `resolve_peak`'s labels in the same three situations on both sides: a
  card with a data-sheet peak, a device without one (the measured matmul
  probe), and a failed probe ("none");
- the port Trainer on `slowfast_t` reports the JAX Trainer's epoch keys
  (`tflops_per_sec_per_chip`, `mfu`, `mfu_source`, `mfu_peak_source`) and
  its `flops_per_step`, and that count is within 10% of the count the JAX
  Trainer backs its own `mfu` with for the same step: its
  `_capture_step_flops` (XLA's cost model, `mfu_source` "costmodel") on
  the JAX `make_train_step` of the same config, batch and optimizer on a
  one-device mesh. Measured on this config: port / JAX = 0.922 (the port
  counts matmuls and convolutions by their valid taps, as XLA does, plus
  elementwise arithmetic, reductions and the update; the rest is the two
  autodiff engines' different elementwise backward of the batch norms).
"""

import types

import numpy as np
import pytest
import torch

from pytorchvideo_accelerate_tpu.utils import hw as jhw
from pytorchvideo_accelerate_tpu_torch.config import parse_cli
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer
from pytorchvideo_accelerate_tpu_torch.utils import hw
from pytorchvideo_accelerate_tpu_torch.utils.hw import count_step_flops


@pytest.fixture(autouse=True)
def _fresh_probe_cache():
    saved = dict(hw._MEASURED), dict(jhw._MEASURED)
    yield
    hw._MEASURED.clear()
    hw._MEASURED.update(saved[0])
    jhw._MEASURED.clear()
    jhw._MEASURED.update(saved[1])


def test_resolve_peak_labels_equal_jax(monkeypatch):
    import jax

    # a data-sheet part
    monkeypatch.setattr(hw, "_name", lambda d: "NVIDIA H100 80GB HBM3")
    tpu = types.SimpleNamespace(platform="tpu", device_kind="TPU v5 lite")
    got, want = hw.resolve_peak("cuda:0"), jhw.resolve_peak(tpu)
    assert got == (989.4, "datasheet") and want[1] == got[1]
    for name, peak in (("NVIDIA H100 PCIe", 756.0), ("NVIDIA A100-SXM4-80GB", 312.0),
                       ("NVIDIA L4", None)):
        monkeypatch.setattr(hw, "_name", lambda d, n=name: n)
        assert hw.peak_tflops("cuda:0") == peak
    monkeypatch.undo()
    # no data sheet (the CPU): the measured probe, once per process
    got = hw.resolve_peak(torch.device("cpu"))
    want = jhw.resolve_peak(jax.devices()[0])
    assert got[1] == want[1] == "measured" and got[0] > 0
    assert hw.peak_tflops("cpu") is None
    # a failed probe: no peak, and the caller leaves mfu out
    monkeypatch.setattr(hw, "measured_peak_tflops", lambda d: None)
    monkeypatch.setattr(jhw, "measured_peak_tflops", lambda d: None)
    assert hw.resolve_peak("cpu") == jhw.resolve_peak(jax.devices()[0]) == (None, "none")


def _jax_step_flops(batch):
    """The JAX Trainer's own count for one step of this config:
    `Trainer._capture_step_flops` on the same `make_train_step`."""
    import jax
    import jax.numpy as jnp

    from pytorchvideo_accelerate_tpu import models as jmodels
    from pytorchvideo_accelerate_tpu.config import MeshConfig, ModelConfig, OptimConfig
    from pytorchvideo_accelerate_tpu.parallel.mesh import make_mesh
    from pytorchvideo_accelerate_tpu.parallel.sharding import shard_batch
    from pytorchvideo_accelerate_tpu.trainer import optim as joptim
    from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
    from pytorchvideo_accelerate_tpu.trainer.loop import Trainer as JTrainer
    from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState

    jm = jmodels.create_model(ModelConfig(name="slowfast_t", num_classes=5), "fp32")
    tree = jax.eval_shape(lambda x: jm.init(jax.random.key(0), x, train=False),
                          (batch["slow"][:1], batch["fast"][:1]))
    tree = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), tree)
    ocfg = OptimConfig()
    tx = joptim.build_optimizer(ocfg, 10)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    fake = types.SimpleNamespace(
        train_step=jsteps.make_train_step(
            jm, tx, mesh, lr_schedule=joptim.build_lr_schedule(ocfg, 10)),
        state=TrainState.create(tree["params"], tree["batch_stats"], tx),
        rng=types.SimpleNamespace(step_key=lambda g: jax.random.key(g)))
    JTrainer._capture_step_flops(fake, shard_batch(mesh, batch), 0)
    return fake._flops_per_step


def test_trainer_mfu_keys_and_flop_count_against_jax(tmp_path):
    argv = ["--cpu", "--synthetic", "--model.name", "slowfast_t",
            "--num_frames", "4", "--data.crop_size", "32",
            "--data.min_short_side_scale", "32", "--data.max_short_side_scale", "40",
            "--num_epochs", "1", "--data.synthetic_num_videos", "8",
            "--data.limit_val_batches", "1", "--batch_size", "8",
            "--mixed_precision", "fp32", "--obs.enabled", "false",
            "--output_dir", str(tmp_path / "out")]
    tr = Trainer(parse_cli(argv))
    res = tr.fit()
    assert res["mfu_source"] == "flop_counter"
    assert res["mfu_peak_source"] == "measured"  # the CPU has no data sheet
    assert res["tflops_per_sec_per_chip"] > 0 and 0 < res["mfu"]
    assert res["flops_per_step"] > 0 and res["analytic_flops_per_step"] is None
    # the count is the config's, not this run's kernels': the same number
    # from the batch shapes alone
    rng = np.random.default_rng(0)
    batch = {"slow": rng.standard_normal((8, 1, 32, 32, 3)).astype(np.float32),
             "fast": rng.standard_normal((8, 4, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 5, (8,)).astype(np.int32)}
    cfg = parse_cli(argv)
    cfg.model.num_classes = tr.cfg.model.num_classes
    again = count_step_flops(cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                             pretraining=False)
    assert again == res["flops_per_step"]
    cfg.model.fused_kernels = "pallas"  # counted through the plain route
    assert count_step_flops(cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                            pretraining=False) > 0
    cfg.model.num_classes = 5
    cfg.model.fused_kernels = "off"
    port = count_step_flops(cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                            pretraining=False)
    ratio = port / _jax_step_flops(batch)
    assert abs(ratio - 1.0) <= 0.10, ratio


def test_a_failed_count_leaves_the_keys_out(tmp_path, monkeypatch):
    import pytorchvideo_accelerate_tpu_torch.trainer.loop as loop

    def broken(*a, **k):
        raise RuntimeError("no count")

    monkeypatch.setattr(loop, "count_step_flops", broken)
    res = Trainer(parse_cli([
        "--cpu", "--synthetic", "--model.name", "tiny3d", "--num_frames", "4",
        "--data.crop_size", "32", "--data.min_short_side_scale", "32",
        "--data.max_short_side_scale", "40", "--num_epochs", "1",
        "--data.synthetic_num_videos", "8", "--batch_size", "4",
        "--mixed_precision", "fp32", "--obs.enabled", "false",
        "--output_dir", str(tmp_path / "out")])).fit()
    assert res["steps"] == 2 and res["flops_per_step"] == 0.0
    assert not {"mfu", "tflops_per_sec_per_chip", "mfu_source"} & set(res)


def test_context_parallel_attention_counts_as_dense():
    """A ring or Ulysses model counts the whole attention (every token) on
    the dense route: the count runs no context-parallel code (no ring
    block counted) and equals the dense model's."""
    from pytorchvideo_accelerate_tpu_torch.parallel import ring_attention

    rng = np.random.default_rng(1)
    batch = {"video": torch.from_numpy(
        rng.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)),
        "label": torch.zeros(2, dtype=torch.int64)}
    counts = {}
    for attention in ("dense", "ring", "ulysses", "pallas"):
        cfg = parse_cli(["--cpu", "--model.name", "videomae_t", "--num_frames", "4",
                         "--data.crop_size", "32", "--mixed_precision", "fp32",
                         "--model.attention", attention])
        cfg.model.num_classes = 5
        before = ring_attention.RING_BLOCKS[0]
        counts[attention] = count_step_flops(cfg, batch, pretraining=False)
        assert ring_attention.RING_BLOCKS[0] == before
    assert counts["ring"] == counts["ulysses"] == counts["dense"] > 0
    assert counts["pallas"] > 0
