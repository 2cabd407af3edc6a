"""The port's mixup and cutmix (`trainer/steps.py`) against the JAX
package's, on the CPU in float32.

Both packages' train steps run on one tiny linear model over pooled clip
channels (the same numpy-seeded weight on both sides), so the mixed clips,
the loss and the reported accuracy are compared directly. The JAX step
draws its lambda, coin and box from `jax.random` streams that numpy cannot
reproduce: the test replaces `jax.random.beta`, `bernoulli` and `uniform`
(monkeypatch) with the injected draw, runs the JAX step with `jit`
disabled so the model sees concrete clips, and hands the port the same
draw through `steps.mix_draw`.

Tolerances: mixed clips, loss and accuracy within 1e-5 (f32 arithmetic of
the same formula); invariance on identical clips rtol 1e-5 (the JAX
package's own test). The host draws are checked statistically over 2000
draws, each bound four standard errors wide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pytorchvideo_accelerate_tpu.config import MeshConfig
from pytorchvideo_accelerate_tpu.config import OptimConfig as JOptimConfig
from pytorchvideo_accelerate_tpu.parallel.mesh import make_mesh
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu.trainer.optim import build_optimizer as jbuild_optimizer
from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState as JTrainState
from pytorchvideo_accelerate_tpu_torch.config import OptimConfig
from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps
from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

B, T, S, K = 4, 2, 8, 3


def _pool(inputs, xp):
    """(B, 3) per pathway: the channel means, concatenated over pathways."""
    parts = inputs if isinstance(inputs, tuple) else (inputs,)
    return xp.concatenate([p.mean(axis=(1, 2, 3)) for p in parts], -1)


class _JaxPooled:
    """A JAX "model" (the `apply` the JAX step calls) that records its
    inputs: logits = pooled channels @ w."""

    def __init__(self):
        self.seen = []

    def apply(self, variables, inputs, train=False, rngs=None, mutable=None):
        self.seen.append(inputs)
        logits = _pool(inputs, jnp) @ variables["params"]["w"]
        return (logits, {"batch_stats": {}}) if mutable else logits


class _TorchPooled(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w))
        self.seen = []

    def forward(self, inputs):
        self.seen.append(inputs)
        parts = inputs if isinstance(inputs, tuple) else (inputs,)
        pooled = torch.cat([p.mean(dim=(1, 2, 3)) for p in parts], -1)
        return pooled @ self.w


def _batch(slowfast, identical=False, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ({"slow": (B, T, S, S, 3), "fast": (B, 2 * T, S, S, 3)}
              if slowfast else {"video": (B, T, S, S, 3)})
    batch = {}
    for k, shape in shapes.items():
        x = rng.standard_normal((1 if identical else B,) + shape[1:])
        batch[k] = np.broadcast_to(x, shape).astype(np.float32).copy()
    batch["label"] = (np.full(B, 1, np.int32) if identical
                      else rng.integers(0, K, B).astype(np.int32))
    return batch


def _weight(slowfast, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (6 if slowfast else 3, K)).astype(np.float32)


def _port_step(batch, w, mixup=0.0, cutmix=0.0):
    model = _TorchPooled(w)
    opt = build_optimizer(OptimConfig(lr=0.0, weight_decay=0.0), 4,
                          model.named_parameters())
    state = TrainState.create(model, opt)
    step = tsteps.make_train_step(model, opt, mixup_alpha=mixup,
                                  cutmix_alpha=cutmix, dropout_seed=3)
    m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return model.seen[0], m


def _jax_step(batch, w, mixup=0.0, cutmix=0.0):
    model = _JaxPooled()
    tx = jbuild_optimizer(JOptimConfig(lr=0.0, weight_decay=0.0),
                          total_steps=4)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    state = JTrainState.create({"w": jnp.asarray(w)}, {}, tx)
    step = jsteps.make_train_step(model, tx, mesh, mixup_alpha=mixup,
                                  cutmix_alpha=cutmix)
    with jax.disable_jit():
        _, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.key(5))
    return model.seen[0], m


def _inject(monkeypatch, draw: tsteps.MixDraw):
    """The same draw on both sides: `mix_draw` for the port, `jax.random`'s
    beta (both lambdas), bernoulli (the coin) and uniform (the box centre,
    y then x) for the JAX step."""
    monkeypatch.setattr(tsteps, "mix_draw", lambda *a: draw)
    monkeypatch.setattr(jax.random, "beta",
                        lambda *a, **k: jnp.float32(draw.lam))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda *a, **k: jnp.bool_(draw.use_cutmix))
    centre = iter([draw.cy, draw.cx])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.float32(next(centre)))


def _as_np(inputs):
    parts = inputs if isinstance(inputs, tuple) else (inputs,)
    return [np.asarray(p) for p in parts]


@pytest.mark.parametrize("slowfast", [False, True])
@pytest.mark.parametrize("mixup,cutmix", [(0.8, 0.0), (0.0, 1.0), (0.8, 1.0)])
def test_identical_clips_mix_to_the_plain_loss(slowfast, mixup, cutmix):
    """Mixing identical clips and labels changes nothing, in both
    packages: the mixed step's loss is the plain step's, for the draws the
    seeds give."""
    batch, w = _batch(slowfast, identical=True), _weight(slowfast)
    for run in (_port_step, _jax_step):
        _, plain = run(batch, w)
        _, mixed = run(batch, w, mixup, cutmix)
        np.testing.assert_allclose(float(mixed["loss"]), float(plain["loss"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("slowfast", [False, True])
@pytest.mark.parametrize("mixup,cutmix,draw", [
    (0.8, 0.0, tsteps.MixDraw(False, 0.3)),
    (0.8, 0.0, tsteps.MixDraw(False, 0.7)),
    (0.0, 1.0, tsteps.MixDraw(True, 0.35, 0.4, 0.7)),
    (0.0, 1.0, tsteps.MixDraw(True, 0.8, 0.95, 0.05)),
    (0.8, 1.0, tsteps.MixDraw(True, 0.6, 0.5, 0.5)),
    (0.8, 1.0, tsteps.MixDraw(False, 0.45))])
def test_injected_mix_matches_jax(slowfast, mixup, cutmix, draw, monkeypatch):
    """With lambda, the coin and the box injected, the mixed clips (every
    pathway), the loss and the dominant-label accuracy equal the JAX
    step's within 1e-5."""
    _inject(monkeypatch, draw)
    batch, w = _batch(slowfast, seed=2), _weight(slowfast)
    t_in, t_m = _port_step(batch, w, mixup, cutmix)
    j_in, j_m = _jax_step(batch, w, mixup, cutmix)
    raw = _as_np(tuple(batch[k] for k in ("slow", "fast")) if slowfast
                 else batch["video"])
    for got, want, x in zip(_as_np(t_in), _as_np(j_in), raw):
        assert not np.allclose(want, x)  # the mix fired
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(t_m["accuracy"]), float(j_m["accuracy"]),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("lam,cy,cx", [(0.6, 0.5, 0.5), (0.3, 0.45, 0.55),
                                       (0.9, 0.3, 0.6)])
def test_box_keeps_about_lam(lam, cy, cx):
    """A box inside the grid: its weight is 0 in a box of area about
    (1 - lam) of the grid and 1 elsewhere, so mean(w) is about lam (within
    the pixel rounding of the box's four edges)."""
    hh, ww = 64, 48
    w_hw = tsteps.mix_weight(tsteps.MixDraw(True, lam, cy, cx), hh, ww, "cpu")
    assert w_hw.shape == (hh, ww)
    assert set(w_hw.unique().tolist()) <= {0.0, 1.0}
    side = np.sqrt(1 - lam)
    edges = 2 * (side * hh + side * ww) + 4  # pixels the rounding can move
    assert abs(w_hw.mean().item() - lam) <= edges / (hh * ww)
    mixup = tsteps.mix_weight(tsteps.MixDraw(False, lam), hh, ww, "cpu")
    assert torch.all(mixup == torch.tensor(lam, dtype=torch.float32))


def test_host_draws_follow_their_distributions():
    """2000 micro-step draws: Beta means 0.5 (symmetric alphas), a fair
    coin, and the mean cut area of a box of side sqrt(1 - lam) (in units of
    the grid) centred uniformly and clipped by the grid. With both alphas
    on, that area is E[(s - s^2 / 4)^2] over s^2 = 1 - lam, lam ~ Beta(1, 1):
    1/2 - 1/5 + 1/48 = 0.3208. Bounds: four standard errors."""
    n = 2000
    mix = [tsteps.mix_draw(0, s, m, 0.8, 0.0) for s in range(n // 2)
           for m in range(2)]
    assert not any(d.use_cutmix for d in mix)
    lam = np.array([d.lam for d in mix])
    # Beta(0.8, 0.8): std 0.3101
    assert abs(lam.mean() - 0.5) <= 4 * 0.3101 / np.sqrt(n)
    both = [tsteps.mix_draw(1, s, 0, 0.8, 1.0) for s in range(n)]
    coin = np.mean([d.use_cutmix for d in both])
    assert abs(coin - 0.5) <= 4 * 0.5 / np.sqrt(n)
    cut = [d for d in both if d.use_cutmix]
    lam_cut = np.array([d.lam for d in cut])
    assert abs(lam_cut.mean() - 0.5) <= 4 * np.sqrt(1 / 12) / np.sqrt(len(cut))
    area = np.array([1 - tsteps.mix_weight(d, 64, 64, "cpu").mean().item()
                     for d in cut])
    assert abs(area.mean() - 0.3208) <= 4 * area.std() / np.sqrt(len(cut)) + 2 / 64
    # one seed, one draw; another micro-step, another draw
    assert tsteps.mix_draw(1, 5, 1, 0.8, 1.0) == tsteps.mix_draw(1, 5, 1, 0.8, 1.0)
    assert tsteps.mix_draw(1, 5, 1, 0.8, 1.0) != tsteps.mix_draw(1, 5, 0, 0.8, 1.0)


def test_batch_mask_raises_the_jax_error():
    batch, w = _batch(False), _weight(False)
    batch["mask"] = np.ones(B, np.float32)
    with pytest.raises(ValueError) as got:
        _port_step(batch, w, mixup=0.8)
    with pytest.raises(ValueError) as want:
        _jax_step(batch, w, mixup=0.8)
    assert str(got.value) == str(want.value)
    assert "explicit batch mask" in str(got.value)
