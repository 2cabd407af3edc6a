"""The port's models against the JAX package's, on the CPU in float32.

Weights are made once with numpy from a seed in the flax layout (He-scaled
kernels, BN statistics away from identity, head std 1/sqrt(in) so logits
are O(1)), carried into the port by `state_dict_from_jax`, and both sides
run the same numpy clips. Logits agree to atol 1e-4 (two f32 conv stacks
that sum in different orders).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.config import ModelConfig as JModelConfig
from pytorchvideo_accelerate_tpu.config import DataConfig as JDataConfig
from pytorchvideo_accelerate_tpu_torch import models as tmodels
from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig
from pytorchvideo_accelerate_tpu_torch.models.common import ConvBNAct
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    jax_tree_from_state_dict,
    state_dict_from_jax,
    unflatten_tree,
)

ATOL = 1e-4
NUM_CLASSES = 7


def _inputs(name, batch=2, frames=8, crop=32, seed=0):
    rng = np.random.default_rng(seed)
    if name.startswith("slowfast"):
        return (rng.standard_normal((batch, frames // 4, crop, crop, 3), np.float32),
                rng.standard_normal((batch, frames, crop, crop, 3), np.float32))
    return rng.standard_normal((batch, frames, crop, crop, 3), np.float32)


def _jax_model(name, fused):
    return jmodels.create_model(
        JModelConfig(name=name, num_classes=NUM_CLASSES, fused_kernels=fused),
        "fp32")


def _torch_model(name, fused):
    return tmodels.create_model(
        ModelConfig(name=name, num_classes=NUM_CLASSES, fused_kernels=fused),
        "fp32")


def _abstract_tree(name, num_classes=NUM_CLASSES):
    model = jmodels.create_model(
        JModelConfig(name=name, num_classes=num_classes), "fp32")
    x = _inputs(name, batch=1)
    spec = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), x)
    return jax.eval_shape(
        lambda inp: model.init(jax.random.PRNGKey(0), inp, train=False), spec)


@functools.lru_cache(maxsize=None)
def _seeded_tree(name):
    rng = np.random.default_rng(1)
    flat = {}
    for key, leaf in flatten_tree(_abstract_tree(name)).items():
        shape = leaf.shape
        if key.endswith("kernel") and len(shape) == 5:
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:4]))
        elif key.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif key.endswith("scale") or key.endswith("var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = rng.standard_normal(shape) * 0.1
        flat[key] = v.astype(np.float32)
    return flat


@functools.lru_cache(maxsize=None)
def _jax_logits(name, fused):
    model = _jax_model(name, fused)
    fwd = jax.jit(lambda v, x: model.apply(v, x, train=False))
    out = fwd(unflatten_tree(_seeded_tree(name)), jax.tree.map(jnp.asarray, _inputs(name)))
    return np.asarray(out)


@pytest.mark.parametrize("name", ["slowfast_r50", "slow_r50", "c2d_r50",
                                  "slowfast_t", "tiny3d", "x3d_m", "csn_r101",
                                  "mvit_b", "videomae_b"])
def test_state_dict_maps_jax_tree_one_to_one(name):
    """Every leaf of the (full-width) flax tree maps to exactly one port key
    with the right shape, and no port key is left over (MViT's pos_embed
    sized to the same 8x32x32 clips)."""
    tree = _abstract_tree(name, num_classes=700)
    zeros = {k: np.broadcast_to(np.float32(0), v.shape)
             for k, v in flatten_tree(tree).items()}
    mapped = state_dict_from_jax(zeros)
    want = tmodels.create_model(
        ModelConfig(name=name, num_classes=700), "bf16",
        data_cfg=DataConfig(num_frames=8, crop_size=32)).state_dict()
    assert len(mapped) == len(zeros)
    assert sorted(mapped) == sorted(want)
    for k, v in want.items():
        assert tuple(mapped[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("port_fused", ["auto", "off"])
@pytest.mark.parametrize("jax_fused", ["xla", "off"])
@pytest.mark.parametrize("name", ["slowfast_t", "tiny3d"])
def test_eval_logits_match_jax(name, jax_fused, port_fused):
    model = _torch_model(name, port_fused).eval()
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           state_dict_from_jax(_seeded_tree(name)).items()})
    x = _inputs(name)
    x = tuple(map(torch.from_numpy, x)) if isinstance(x, tuple) else torch.from_numpy(x)
    with torch.inference_mode():
        got = model(x).numpy()
    want = _jax_logits(name, jax_fused)
    assert got.shape == want.shape == (2, NUM_CLASSES)
    assert np.abs(want).max() > 0.1  # the weights make the comparison mean something
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_jax_tree_round_trips_through_state_dict():
    flat = _seeded_tree("slowfast_t")
    back = flatten_tree(jax_tree_from_state_dict(state_dict_from_jax(flat)))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("name", ["x3d_m", "csn_r101"])
def test_depthwise_families_round_trip_jax_port_jax(name):
    """JAX tree -> the port's model (a strict load) -> its state_dict -> the
    JAX tree, bitwise: the depthwise kernels (kt,kh,kw,1,C) cross as the
    grouped (C,1,kt,kh,kw) weight under the converter's usual transpose."""
    flat = _seeded_tree(name)
    model = _torch_model(name, "auto")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_jax(flat).items()}, strict=True)
    dw = [k for k in flat if k.endswith("conv_b/kernel") or k.endswith("conv_b/conv/kernel")]
    assert dw and all(flat[k].shape[3] == 1 for k in dw)
    back = flatten_tree(jax_tree_from_state_dict(model.state_dict()))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_slowfast_r50_fused_site_counts():
    """41 pointwise + 51 odd-tap conv sites take the fused kernels; the 18
    strided or (7,1,1)-lateral sites keep the unfused path."""
    model = _torch_model("slowfast_r50", "auto")
    sites = [m for m in model.modules() if isinstance(m, ConvBNAct)]
    fused = [m for m in sites if m.fuse]
    pw = [m for m in fused if m.kernel == (1, 1, 1)]
    assert (len(pw), len(fused) - len(pw), len(sites) - len(fused)) == (41, 51, 18)


@pytest.mark.parametrize("name", ["slowfast_r50", "slow_r50", "x3d_s", "x3d_m",
                                  "csn_r101", "mvit_b", "videomae_b"])
def test_model_input_spec_matches_jax(name):
    d = dict(num_frames=32, crop_size=224)
    assert (tmodels.model_input_spec(ModelConfig(name=name), DataConfig(**d))
            == jmodels.model_input_spec(JModelConfig(name=name), JDataConfig(**d)))


@pytest.mark.parametrize("name,err,extra", [
    # MViT is ported; its context-parallel attention (several GPUs) is not
    ("mvit_b", NotImplementedError, {"attention": "ring"}),
    ("no_such_net", ValueError, {})],
    ids=["mvit_b-NotImplementedError", "no_such_net-ValueError"])
def test_unported_or_unknown_model_raises(name, err, extra):
    with pytest.raises(err):
        tmodels.create_model(ModelConfig(name=name, num_classes=3, **extra))


def test_bad_fused_mode_raises():
    with pytest.raises(ValueError, match="fused_kernels"):
        tmodels.create_model(ModelConfig(name="tiny3d", num_classes=3,
                                         fused_kernels="cuda"))


def test_train_mode_is_the_next_slice():
    """Train mode, the slice after serving, runs now: it normalises with
    batch statistics and moves every BN running average by flax's momentum
    (0.9 old + 0.1 batch); `create_model` leaves the mode to the caller."""
    model = _torch_model("tiny3d", "auto")
    assert model.training
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    x = torch.from_numpy(_inputs("tiny3d"))
    train_logits = model(x)
    after = model.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items())
    stem = model.stem
    with torch.no_grad():
        raw = torch.nn.functional.conv3d(
            x.permute(0, 4, 1, 2, 3), stem.conv.weight, None, stem.stride,
            stem.conv.padding).permute(0, 2, 3, 4, 1)
    mean = raw.mean(dim=(0, 1, 2, 3))
    np.testing.assert_allclose(
        after["stem.norm.running_mean"].numpy(),
        0.9 * before["stem.norm.running_mean"].numpy() + 0.1 * mean.numpy(),
        atol=1e-5)
    with torch.no_grad():
        eval_logits = model.eval()(x)
    assert not torch.allclose(train_logits, eval_logits)
