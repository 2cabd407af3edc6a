"""The port's fused conv + BN + act ops against the JAX package's.

The port's plain versions (what a CPU tensor runs, and what the CUDA
kernels are held against on the card) must equal the JAX package's Pallas
kernels run in interpret mode on the same numpy inputs, in float32:
atol 1e-4, rtol 1e-5 (two f32 implementations that sum in different
orders). The gradients of all four operands (x, w, scale, bias) through the
port's autograd Functions (`PwBnAct`/`ConvBnAct`, their plain versions
inside on a CPU tensor) must equal `jax.grad` through the JAX package's
custom VJPs (`_pw_pallas`/`_conv_pallas`, interpret mode) within the same
atol 1e-4, rtol 1e-5. The CUDA kernels themselves are tested on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu.ops import pallas_fused as jf
from pytorchvideo_accelerate_tpu_torch.ops import fused as tf

ATOL, RTOL = 1e-4, 1e-5


def _case(seed, shape, cin, cout, taps):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (cin,)).astype(np.float32)
    w = (rng.standard_normal(taps + (cin, cout)) * 0.2).astype(np.float32)
    gamma = rng.standard_normal(cout).astype(np.float32) * 0.1 + 1.0
    var = np.abs(rng.standard_normal(cout)).astype(np.float32) + 1.0
    scale = gamma / np.sqrt(var + 1e-5)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, scale, bias


def _both(fn_j, fn_t, x, w, scale, bias, act, **kw_t):
    want = np.asarray(fn_j(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                           jnp.asarray(bias), act=act, mode="pallas"))
    got = fn_t(torch.from_numpy(x), torch.from_numpy(w),
               torch.from_numpy(scale), torch.from_numpy(bias), act=act,
               **kw_t).numpy()
    return got, want


@pytest.mark.parametrize("cin", [8, 16])
@pytest.mark.parametrize("taps", [(1, 1, 1), (3, 1, 1), (1, 3, 3)])
@pytest.mark.parametrize("act", ["identity", "relu", "silu"])
def test_plain_matches_jax_pallas_interpret(act, taps, cin):
    # ragged M, T and H: no dimension is a multiple of a kernel tile
    x, w, scale, bias = _case(cin + sum(taps), (2, 5, 7, 6), cin, 12, taps)
    got, want = _both(jf.fused_conv3d_bn_act, tf.fused_conv3d_bn_act,
                      x, w, scale, bias, act, mode="auto")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("w_rank", [2, 5])
def test_pointwise_entry_matches_jax(w_rank):
    x, w, scale, bias = _case(3, (1, 3, 5, 4), 8, 24, (1, 1, 1))
    if w_rank == 2:
        w = w.reshape(8, 24)
    got, want = _both(jf.fused_pointwise_bn_act, tf.fused_pointwise_bn_act,
                      x, w, scale, bias, "relu", mode="xla")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_even_taps_take_the_plain_version_like_jax():
    x, w, scale, bias = _case(4, (1, 4, 5, 5), 8, 8, (2, 1, 1))
    want = np.asarray(jf.fused_conv3d_bn_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
        act="relu", mode="xla"))
    got = tf.fused_conv3d_bn_act(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), act="relu", mode="auto").numpy()
    assert got.shape == want.shape == (1, 5, 5, 5, 8)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_bf16_folds_scale_then_rounds_like_jax():
    """Fold in f32, round the folded weight to x's dtype, one bf16 store."""
    x, w, scale, bias = _case(5, (1, 2, 3, 4), 16, 8, (1, 3, 3))
    want = np.asarray(jf.fused_conv3d_bn_act(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(bias), act="silu", mode="pallas"
    ).astype(jnp.float32))
    got = tf.fused_conv3d_bn_act(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(bias), act="silu",
        mode="auto")
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the same f32 sum, up to summation order
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-2, rtol=1e-2)


def test_pallas_mode_on_a_cpu_tensor_raises():
    x, w, scale, bias = _case(6, (1, 2, 3, 3), 8, 8, (3, 1, 1))
    args = [torch.from_numpy(a) for a in (x, w, scale, bias)]
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.fused_conv3d_bn_act(*args, mode="pallas")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.fused_pointwise_bn_act(args[0], args[1][:1, :1, :1], args[2],
                                  args[3], mode="pallas")


def test_cpu_tensor_launches_no_kernel():
    before = dict(tf.LAUNCHES)
    x, w, scale, bias = _case(7, (1, 2, 3, 3), 8, 8, (1, 3, 3))
    tf.fused_conv3d_bn_act(*(torch.from_numpy(a) for a in (x, w, scale, bias)),
                           mode="auto")
    assert tf.LAUNCHES == before


@pytest.mark.parametrize("bad", [{"mode": "cuda"}, {"act": "gelu"}])
def test_bad_mode_or_act_raises(bad):
    x, w, scale, bias = _case(8, (1, 2, 3, 3), 8, 8, (1, 1, 1))
    kw = {"mode": "auto", "act": "relu", **bad}
    with pytest.raises(ValueError):
        tf.fused_conv3d_bn_act(*(torch.from_numpy(a) for a in (x, w, scale, bias)),
                               **kw)


def _grads_both(x, w, scale, bias, act, ct, mode_t):
    def jloss(*args):
        y = jf.fused_conv3d_bn_act(*args, act=act, mode="pallas")
        return jnp.sum(y * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w, scale, bias)))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, scale, bias)]
    y = tf.fused_conv3d_bn_act(*args, act=act, mode=mode_t)
    (y * torch.from_numpy(ct)).sum().backward()
    return y, [a.grad.numpy() for a in args], [np.asarray(g) for g in want]


@pytest.mark.parametrize("taps", [(1, 1, 1), (3, 1, 1), (1, 3, 3)])
@pytest.mark.parametrize("act", ["identity", "relu", "silu"])
def test_custom_backward_matches_jax_vjp(act, taps):
    # ragged M, T, H, W and channel counts that are not multiples of 8
    x, w, scale, bias = _case(11 + sum(taps), (2, 5, 7, 6), 12, 10, taps)
    ct = np.random.default_rng(3).standard_normal(
        (2, 5, 7, 6, 10)).astype(np.float32)
    y, got, want = _grads_both(x, w, scale, bias, act, ct, "auto")
    # the CPU tensor went through the port's custom backward, not autograd
    # of the plain version
    fn = "PwBnAct" if taps == (1, 1, 1) else "ConvBnAct"
    assert fn in type(_grad_fn_of(y)).__name__
    for g, want_g, name in zip(got, want, ("x", "w", "scale", "bias")):
        assert g.shape == want_g.shape, name
        np.testing.assert_allclose(g, want_g, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def _grad_fn_of(y):
    """The autograd node of the fused call under the pointwise reshape."""
    node = y.grad_fn
    while "BnAct" not in type(node).__name__:
        node = node.next_functions[0][0]
    return node


@pytest.mark.parametrize("mode", ["xla", "auto"])
def test_plain_autograd_and_custom_backward_agree(mode):
    """`xla` (plain autograd through the plain version) and `auto` (the
    custom backward) give the JAX gradients alike."""
    x, w, scale, bias = _case(21, (1, 4, 5, 3), 8, 16, (3, 1, 1))
    ct = np.random.default_rng(4).standard_normal(
        (1, 4, 5, 3, 16)).astype(np.float32)
    _, got, want = _grads_both(x, w, scale, bias, "relu", ct, mode)
    for g, want_g in zip(got, want):
        np.testing.assert_allclose(g, want_g, atol=ATOL, rtol=RTOL)


def test_backward_honours_needs_input_grad():
    """No dx when x needs none (and so no dx launch on the card), no dw or
    db when the weights and the folded bias need none."""
    x, w, scale, bias = _case(22, (1, 3, 4, 4), 8, 8, (1, 3, 3))
    xt = torch.from_numpy(x).requires_grad_()
    y = tf.fused_conv3d_bn_act(xt, torch.from_numpy(w), torch.from_numpy(scale),
                               torch.from_numpy(bias), act="relu", mode="auto")
    y.sum().backward()
    assert xt.grad is not None and xt.grad.shape == x.shape
    wt = torch.from_numpy(w).requires_grad_()
    y = tf.fused_conv3d_bn_act(torch.from_numpy(x), wt, torch.from_numpy(scale),
                               torch.from_numpy(bias), act="relu", mode="auto")
    y.sum().backward()
    assert wt.grad is not None and wt.grad.shape == w.shape
