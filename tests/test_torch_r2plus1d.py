"""The port's R(2+1)D against the JAX package's, on the CPU in float32.

A tiny twin built by both frameworks' constructors, `R2Plus1D(depths=(1,
1, 1, 1), stem_features=8)`, at B=2, 4 frames at 32x32 (res5 sees 1x1x1
per clip). Weights are drawn once with numpy in the flax layout (He-scaled
kernels, BN statistics away from identity) and carried into the port by
`state_dict_from_jax`. The JAX side runs `fused_kernels pallas` (the Pallas
kernels in interpret mode, their custom VJPs) or `off`; the port runs
`auto` (its custom autograd Functions with the plain versions inside),
`xla` or `off`. Dropout is 0 on both sides.

Tolerances, those of `tests/test_torch_x3d_csn.py`: eval logits atol 1e-4
(two f32 conv stacks summing in other orders); one training forward +
backward: loss and the new BN running averages atol 1e-5, every gradient
within 1e-4 * (1 + max|g|) of its leaf. Training runs at batch 8, not 2,
for the reason CSN does there: res5's batch statistics over 2 values
amplify either framework's f32 rounding (at batch 2 the JAX package's own
`off` and `pallas` gradients differ by 1.2e-3 to 1.5e-2 of a leaf's scale).
The training clips come from seed 2: at seeds 1 and 5 a block's
pre-activation lies within 1e-6 of the ReLU kink and flips sign between
lowerings, which reroutes that element's gradient, and the JAX package's
own two lowerings differ by 2.9e-3 and 3.5e-2. The reference's lowerings
are held to each other on these clips first
(`test_train_reference_lowerings_agree`), so a failure of the port's
comparison is never a flip of that kind.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.config import DataConfig as JDataConfig
from pytorchvideo_accelerate_tpu.config import ModelConfig as JModelConfig
from pytorchvideo_accelerate_tpu.models.r2plus1d import R2Plus1D as JR2Plus1D
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu_torch import models as tmodels
from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig
from pytorchvideo_accelerate_tpu_torch.models.common import ConvBNAct
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    jax_tree_from_state_dict,
    state_dict_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.models.r2plus1d import R2Plus1D
from pytorchvideo_accelerate_tpu_torch.ops import fused as tf
from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps

NUM_CLASSES = 5
BATCH, FRAMES, CROP = 2, 4, 32
TWIN = dict(depths=(1, 1, 1, 1), stem_features=8)


def _jax_model(fused="off"):
    return JR2Plus1D(num_classes=NUM_CLASSES, dropout_rate=0.0, fused=fused,
                     **TWIN)


def _port_model(fused="off"):
    model = R2Plus1D(NUM_CLASSES, dropout_rate=0.0, fused=fused, **TWIN)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           state_dict_from_jax(_seeded_flat()).items()})
    return model


def _clips(seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, FRAMES, CROP, CROP, 3), np.float32)


def _labels(seed=0, batch=BATCH):
    return np.random.default_rng(seed + 100).integers(
        0, NUM_CLASSES, batch).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _seeded_flat():
    spec = jax.ShapeDtypeStruct((1, FRAMES, CROP, CROP, 3), jnp.float32)
    tree = jax.eval_shape(lambda x: _jax_model().init(
        jax.random.PRNGKey(0), x, train=False), spec)
    rng = np.random.default_rng(13)
    flat = {}
    for key, leaf in flatten_tree(tree).items():
        shape = leaf.shape
        if key.endswith("kernel") and len(shape) == 5:
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:4]))
        elif key.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif key.endswith("scale") or key.endswith("var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # biases, means
            v = rng.standard_normal(shape) * 0.1
        flat[key] = v.astype(np.float32)
    return flat


@functools.lru_cache(maxsize=None)
def _jax_logits(fused):
    model = _jax_model(fused)
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        unflatten_tree(_seeded_flat()), jnp.asarray(_clips()))
    return np.asarray(out)


@pytest.mark.parametrize("port_fused", ["off", "xla", "auto"])
@pytest.mark.parametrize("jax_fused", ["off", "pallas"])
def test_eval_logits_match_jax(jax_fused, port_fused):
    model = _port_model(port_fused).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(_clips())).numpy()
    want = _jax_logits(jax_fused)
    assert got.shape == want.shape == (BATCH, NUM_CLASSES)
    assert np.abs(want).max() > 0.1  # the weights make the comparison mean something
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _close_per_leaf(got: dict, want: dict, rel: float):
    """Each leaf within rel * (1 + max|want|)."""
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        tol = rel * (1.0 + np.abs(w).max())
        assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max(), tol)


TRAIN_BATCH, TRAIN_SEED = 8, 2


@functools.lru_cache(maxsize=None)
def _jax_train(fused):
    """(loss, grads, new batch stats) of one JAX train-mode forward +
    backward, the grads and stats as port state_dict keys."""
    x = _clips(TRAIN_SEED, TRAIN_BATCH)
    labels = _labels(TRAIN_SEED, TRAIN_BATCH)
    tree = unflatten_tree(_seeded_flat())
    jm = _jax_model(fused)

    def jloss(params):
        logits, upd = jm.apply(
            {"params": params, "batch_stats": tree["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        loss, _, _ = jsteps._loss_and_metrics(
            logits, jnp.asarray(labels), jnp.ones(TRAIN_BATCH, jnp.float32), 0.1)
        return loss, upd["batch_stats"]

    (jl, jstats), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        tree["params"])
    return (float(jl), state_dict_from_jax({"params": jax.device_get(jgrads)}),
            state_dict_from_jax({"batch_stats": jax.device_get(jstats)}))


def test_train_reference_lowerings_agree():
    """The JAX package's `off` and `pallas` lowerings agree with each other
    on the training clips to the bounds the port is held to."""
    (ol, og, os_), (pl, pg, ps) = _jax_train("off"), _jax_train("pallas")
    np.testing.assert_allclose(pl, ol, atol=1e-5)
    _close_per_leaf(pg, og, 1e-4)
    _close_per_leaf(ps, os_, 1e-5)


@pytest.mark.parametrize("jax_fused,port_fused", [
    ("pallas", "auto"),  # both custom backwards, rows 1 and 2
    ("off", "xla"),      # fused train tail, plain autograd
    ("off", "off"),
])
def test_train_forward_backward_matches_jax(jax_fused, port_fused):
    x = _clips(TRAIN_SEED, TRAIN_BATCH)
    labels = _labels(TRAIN_SEED, TRAIN_BATCH)
    want_l, want_g, want_s = _jax_train(jax_fused)
    tm = _port_model(port_fused).train()
    loss, _, _ = tsteps._loss_and_metrics(
        tm(torch.from_numpy(x)), torch.from_numpy(labels),
        torch.ones(TRAIN_BATCH), 0.1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_l, atol=1e-5)
    _close_per_leaf({n: p.grad.numpy() for n, p in tm.named_parameters()},
                    want_g, 1e-4)
    _close_per_leaf({k: v.numpy() for k, v in tm.state_dict().items()
                     if k in want_s}, want_s, 1e-5)


def test_auto_on_cpu_runs_the_plain_versions():
    """`fused_kernels auto` on CPU tensors: the custom backwards of rows 1
    and 2 with the plain versions inside, and no kernel launch."""
    model = _port_model("auto").train()
    before = dict(tf.LAUNCHES)
    model(torch.from_numpy(_clips())).sum().backward()
    assert tf.LAUNCHES == before


@functools.lru_cache(maxsize=None)
def _full_port_model():
    """The full-width port model, built once (its init draws 28M weights)."""
    return tmodels.create_model(ModelConfig(name="r2plus1d_r50",
                                            num_classes=400,
                                            fused_kernels="auto"), "bf16")


@functools.lru_cache(maxsize=None)
def _full_tree(num_classes=400):
    model = jmodels.create_model(
        JModelConfig(name="r2plus1d_r50", num_classes=num_classes), "fp32")
    spec = jax.ShapeDtypeStruct((1, 16, 224, 224, 3), jnp.float32)
    return jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False), spec)


def test_full_width_parameter_count_equals_jax():
    """`create_model(r2plus1d_r50)` builds the 28.1M-parameter model that the
    JAX tree has (the published hub figure, 28.11M)."""
    jparams = sum(int(np.prod(v.shape)) for k, v in
                  flatten_tree(_full_tree()["params"]).items())
    model = _full_port_model()
    got = sum(p.numel() for p in model.parameters())
    assert got == jparams
    assert 28.0e6 < got < 28.2e6


def test_full_width_state_dict_round_trips_jax_port_jax():
    """Every leaf of the full-width flax tree maps to one port key of the
    right shape, and the port's state_dict maps back to the same tree."""
    flat = {k: np.zeros(v.shape, np.float32)
            for k, v in flatten_tree(_full_tree()).items()}
    mapped = state_dict_from_jax(flat)
    want = _full_port_model().state_dict()
    assert sorted(mapped) == sorted(want) and len(mapped) == len(flat)
    for k, v in want.items():
        assert tuple(mapped[k].shape) == tuple(v.shape), k
    back = flatten_tree(jax_tree_from_state_dict(want))
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].shape == flat[k].shape, k


def test_twin_round_trips_bitwise():
    flat = _seeded_flat()
    model = _port_model("auto")
    back = flatten_tree(jax_tree_from_state_dict(model.state_dict()))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("frames,crop", [(16, 224), (8, 32)])
def test_model_input_spec_matches_jax(frames, crop):
    d = dict(num_frames=frames, crop_size=crop)
    assert (tmodels.model_input_spec(ModelConfig(name="r2plus1d_r50"),
                                     DataConfig(**d))
            == jmodels.model_input_spec(JModelConfig(name="r2plus1d_r50"),
                                        JDataConfig(**d)))


def test_fused_site_counts():
    """One forward under `fused_kernels auto`: 32 pointwise sites (every
    block's conv_a and conv_c), 26 odd-tap conv sites (the stride-1 conv_b_s
    of the 12 non-entry blocks and the stride-1 conv_b_t of the 14 blocks
    but the res4 and res5 entries), 11 unfused (stem, 4 strided conv_b_s, 2
    strided conv_b_t, 4 branch1)."""
    model = _full_port_model()
    sites = {n: m for n, m in model.named_modules() if isinstance(m, ConvBNAct)}
    fused = {n for n, m in sites.items() if m.fuse}
    pw = {n for n in fused if sites[n].kernel == (1, 1, 1)}
    assert (len(pw), len(fused - pw), len(sites) - len(fused)) == (32, 26, 11)
    unfused = sorted(set(sites) - fused)
    assert unfused == sorted(
        ["stem"] + [f"res{s}_block0.{c}" for s in (2, 3, 4, 5)
                    for c in ("conv_b_s", "branch1")]
        + ["res4_block0.conv_b_t", "res5_block0.conv_b_t"])


def test_full_width_geometry():
    """16x224^2 -> res5 sees 4x7x7 with 2048 channels (a bf16 forward of the
    trunk is too slow here: the shape is traced through the strides)."""
    model = _full_port_model()
    t, h = 16, 224
    h = (h + 2 * 3 - 7) // 2 + 1  # stem (1,7,7) stride 2, pad 3
    for s in (2, 3, 4, 5):
        block = getattr(model, f"res{s}_block0")
        ss, ts = block.conv_b_s.stride[1], block.conv_b_t.stride[0]
        h = (h + 2 - 3) // ss + 1
        t = (t + 2 - 3) // ts + 1
    assert (t, h, h) == (4, 7, 7)
    assert model.head.proj.in_features == 2048


def test_backbone_param_filter_matches_jax():
    model = _port_model()
    for name, _ in model.named_parameters():
        path = tuple(name.split("."))
        assert (R2Plus1D.backbone_param_filter(path)
                == JR2Plus1D.backbone_param_filter(path)), name
    assert not R2Plus1D.backbone_param_filter(("head", "proj", "weight"))
