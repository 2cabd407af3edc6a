"""The port's X3D and CSN against the JAX package's, on the CPU in float32.

Tiny twins of both families (B=2, 4 frames at 32x32), built by both
frameworks' constructors: X3D with depths (3, 2), so stride-1 blocks with
and without squeeze-excite both exist, and CSN with depths (2, 2, 1, 1).
Weights are drawn once with numpy in the flax layout (He-scaled kernels, BN
statistics away from identity) and carried into the port by
`state_dict_from_jax`. The JAX side runs `fused_kernels pallas` (the Pallas
kernels in interpret mode, their custom VJPs) or `off`; the port runs
`auto` (its custom autograd Functions with the plain versions inside),
`xla` or `off`. Dropout is 0 on both sides.

Tolerances: eval logits atol 1e-4 (two f32 conv stacks summing in other
orders); one training forward + backward as `tests/test_torch_train.py`
holds tiny3d: loss and the new BN running averages atol 1e-5, every
gradient within 1e-4 * (1 + max|g|) of its leaf. CSN trains at batch 8, not
2: its res5 sees 1x1x1 per clip at this size, and batch statistics over 2
values amplify either framework's f32 rounding past those bounds (at batch
2 the loss differs by 4e-5 even between the two unfused graphs), as
slowfast_t does in `tests/test_torch_train.py`.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu.models.csn import CSN as JCSN
from pytorchvideo_accelerate_tpu.models.x3d import X3D as JX3D
from pytorchvideo_accelerate_tpu.models.x3d import _round_width as j_round_width
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    state_dict_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.models.csn import CSN
from pytorchvideo_accelerate_tpu_torch.models.x3d import X3D, X3DBlock, _round_width
from pytorchvideo_accelerate_tpu_torch.ops import fused as tf
from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps

NUM_CLASSES = 5
BATCH, FRAMES, CROP = 2, 4, 32
TWINS = {
    "x3d": dict(depths=(3, 2), stem_features=8, stage_features=(8, 16),
                head_features=32),
    "csn": dict(depths=(2, 2, 1, 1), stem_features=8),
}


def _jax_model(family, fused="off", impl="conv"):
    cls = JX3D if family == "x3d" else JCSN
    return cls(num_classes=NUM_CLASSES, dropout_rate=0.0, fused=fused,
               depthwise_impl=impl, **TWINS[family])


def _port_model(family, fused="off", impl="conv"):
    cls = X3D if family == "x3d" else CSN
    model = cls(NUM_CLASSES, dropout_rate=0.0, fused=fused,
                depthwise_impl=impl, **TWINS[family])
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           state_dict_from_jax(_seeded_flat(family)).items()})
    return model


def _clips(seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, FRAMES, CROP, CROP, 3), np.float32)


def _labels(seed=0, batch=BATCH):
    return np.random.default_rng(seed + 100).integers(
        0, NUM_CLASSES, batch).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _seeded_flat(family):
    spec = jax.ShapeDtypeStruct((1, FRAMES, CROP, CROP, 3), jnp.float32)
    tree = jax.eval_shape(lambda x: _jax_model(family).init(
        jax.random.PRNGKey(0), x, train=False), spec)
    rng = np.random.default_rng(11)
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
def _jax_logits(family, fused):
    model = _jax_model(family, fused)
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        unflatten_tree(_seeded_flat(family)), jnp.asarray(_clips()))
    return np.asarray(out)


def test_round_width_matches_jax():
    for c in (24, 54, 108, 216, 432, 18, 36):
        assert _round_width(c, 0.0625) == j_round_width(c, 0.0625)


@pytest.mark.parametrize("port_fused", ["off", "xla", "auto"])
@pytest.mark.parametrize("jax_fused", ["off", "pallas"])
@pytest.mark.parametrize("family", ["x3d", "csn"])
def test_eval_logits_match_jax(family, jax_fused, port_fused):
    model = _port_model(family, port_fused).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(_clips())).numpy()
    want = _jax_logits(family, jax_fused)
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


def _train_both(family, jax_fused, port_fused, impl, batch):
    """One train-mode forward + backward on both sides: (loss, grads, new
    batch stats) of each, the grads and stats as port state_dict keys."""
    x, labels = _clips(1, batch), _labels(1, batch)
    tree = unflatten_tree(_seeded_flat(family))
    jm = _jax_model(family, jax_fused, impl)

    def jloss(params):
        logits, upd = jm.apply(
            {"params": params, "batch_stats": tree["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        loss, _, _ = jsteps._loss_and_metrics(
            logits, jnp.asarray(labels), jnp.ones(batch, jnp.float32), 0.1)
        return loss, upd["batch_stats"]

    (jl, jstats), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        tree["params"])
    tm = _port_model(family, port_fused, impl).train()
    loss, _, _ = tsteps._loss_and_metrics(
        tm(torch.from_numpy(x)), torch.from_numpy(labels), torch.ones(batch), 0.1)
    loss.backward()
    want_s = state_dict_from_jax({"batch_stats": jax.device_get(jstats)})
    return ((loss.item(), {n: p.grad.numpy() for n, p in tm.named_parameters()},
             {k: v.numpy() for k, v in tm.state_dict().items() if k in want_s}),
            (float(jl), state_dict_from_jax({"params": jax.device_get(jgrads)}),
             want_s))


@pytest.mark.parametrize("family,jax_fused,port_fused,impl,batch", [
    ("x3d", "pallas", "auto", "conv", 2),  # both custom backwards, rows 1 and 3
    ("x3d", "off", "xla", "conv", 2),      # fused train tail, plain autograd
    ("x3d", "off", "off", "pallas", 2),    # row 4: Depthwise3dS1 vs the Pallas VJP
    ("csn", "pallas", "auto", "conv", 8),
    ("csn", "off", "off", "shift", 8),
])
def test_train_forward_backward_matches_jax(family, jax_fused, port_fused, impl,
                                            batch):
    (gl, gg, gs), (wl, wg, ws) = _train_both(family, jax_fused, port_fused,
                                             impl, batch)
    np.testing.assert_allclose(gl, wl, atol=1e-5)
    _close_per_leaf(gg, wg, 1e-4)
    _close_per_leaf(gs, ws, 1e-5)


def test_x3d_pallas_impl_runs_the_port_backward():
    """`--model.depthwise_impl pallas`: the stride-1 depthwise sites go
    through `Depthwise3dS1` (its plain version on a CPU tensor), the strided
    stage entries through the grouped conv; no kernel launches on the CPU."""
    model = _port_model("x3d", "off", "pallas").train()
    seen = []

    def node(y):  # the autograd node under the NDHWC -> NCDHW permute
        fn = y.grad_fn
        return type(fn.next_functions[0][0] if "Permute" in type(fn).__name__
                    else fn).__name__

    for name, m in model.named_modules():
        if type(m).__name__ == "DepthwiseConv3D":
            m.register_forward_hook(
                lambda mod, a, y, n=name: seen.append((n, node(y))))
    before = dict(tf.LAUNCHES)
    model(torch.from_numpy(_clips())).sum().backward()
    assert tf.LAUNCHES == before
    kinds = dict(seen)
    # stem_t and the stride-1 blocks' conv_b; block0 of each stage is strided
    s1 = [n for n in kinds if not n.endswith("block0.conv_b")]
    assert len(kinds) == 1 + 3 + 2 and len(s1) == 1 + (3 - 1) + (2 - 1)
    assert all(kinds[n] == "Depthwise3dS1Backward" for n in s1), kinds
    assert all("Convolution" in kinds[n] for n in kinds if n not in s1), kinds


def test_x3d_fused_epilogues_follow_se():
    """With SE after conv_b the fused epilogue stops at the affine; without
    it swish fuses in, as the JAX block does (x3d.py:117-143)."""
    model = _port_model("x3d", "auto").eval()
    blocks = [m for m in model.modules() if isinstance(m, X3DBlock)]
    assert [b.fuse_b for b in blocks] == [False, True, True, False, True]
    assert [b.se is not None for b in blocks] == [True, False, True, True, False]
    # branch1: stride or width change; its BN only on a width change
    assert [(b.branch1 is not None, b.branch1 is not None and b.branch1.norm
             is not None) for b in blocks] == [
        (True, False), (False, False), (False, False), (True, True),
        (False, False)]
