"""The port's depthwise ops against the JAX package's, on the CPU in float32.

Row 3 of the TPU kernels (`pallas_fused.py` `_dw_bn_act_kernel`, its custom
VJP `_dw_bwd`) and row 4 (`pallas_depthwise.py` `_dw_kernel`,
`pallas_depthwise3d_s1` and its VJP) run in interpret mode on the JAX side.
The port's plain versions and its autograd Functions (`DwBnAct`,
`Depthwise3dS1`, the plain versions inside on a CPU tensor) must give the
same forward and gradients within atol 1e-4, rtol 1e-5 (two f32
implementations that sum in different orders). The CUDA kernel itself is
held against the plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu.ops import depthwise as jdw
from pytorchvideo_accelerate_tpu.ops import pallas_fused as jf
from pytorchvideo_accelerate_tpu.ops.pallas_depthwise import pallas_depthwise3d_s1
from pytorchvideo_accelerate_tpu_torch.ops import depthwise as tdw
from pytorchvideo_accelerate_tpu_torch.ops import fused as tf

ATOL, RTOL = 1e-4, 1e-5
SHAPE = (2, 5, 6, 7)  # ragged T, H, W: no dimension is a multiple of a tile


def _case(seed, c, taps, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (c,)).astype(np.float32)
    k = (rng.standard_normal(taps + (1, c)) * 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ct = rng.standard_normal(shape + (c,)).astype(np.float32)
    return x, k, scale, bias, ct


def _jax_dw_bn_act(x, k, scale, bias, ct, act, mode="pallas"):
    """Forward and the gradients of (x, k, scale, bias) of sum(y * ct)."""
    fn = lambda *a: jf.fused_depthwise_bn_act(*a, act=act, mode=mode)  # noqa: E731
    y, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, k, scale, bias)))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _port_dw_bn_act(x, k, scale, bias, ct, act, mode):
    args = [torch.from_numpy(a).requires_grad_() for a in (x, k, scale, bias)]
    y = tf.fused_depthwise_bn_act(*args, act=act, mode=mode)
    (y * torch.from_numpy(ct)).sum().backward()
    return y, [a.grad.numpy() for a in args]


def _grad_fn_name(y):
    node, seen = y.grad_fn, []
    while node is not None:
        seen.append(type(node).__name__)
        node = node.next_functions[0][0] if node.next_functions else None
    return seen


# --- row 3: fused depthwise + affine + act ----------------------------------


@pytest.mark.parametrize("c", [8, 18])
@pytest.mark.parametrize("taps", [(3, 3, 3), (5, 1, 1)])
@pytest.mark.parametrize("act", ["identity", "relu", "silu"])
def test_dw_bn_act_matches_jax_pallas_interpret(act, taps, c):
    """Forward and all four gradients, `auto` (the custom backward, DwBnAct)
    and `xla` (plain autograd) against the Pallas kernel's custom VJP."""
    x, k, scale, bias, ct = _case(c + sum(taps), c, taps)
    want_y, want_g = _jax_dw_bn_act(x, k, scale, bias, ct, act)
    for mode in ("auto", "xla"):
        y, got_g = _port_dw_bn_act(x, k, scale, bias, ct, act, mode)
        np.testing.assert_allclose(y.detach().numpy(), want_y, atol=ATOL,
                                   rtol=RTOL, err_msg=mode)
        assert ("DwBnActBackward" in _grad_fn_name(y)) == (mode == "auto")
        for g, w, name in zip(got_g, want_g, ("x", "k", "scale", "bias")):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{mode} d{name}")


def test_even_taps_take_the_plain_version_like_jax():
    # SAME k//2 padding on both sides: an even tap count adds one frame
    x, k, scale, bias, _ = _case(4, 8, (2, 3, 3), shape=(1, 4, 5, 5))
    ct = np.random.default_rng(9).standard_normal((1, 5, 5, 5, 8)).astype(np.float32)
    want_y, want_g = _jax_dw_bn_act(x, k, scale, bias, ct, "relu")
    y, got_g = _port_dw_bn_act(x, k, scale, bias, ct, "relu", "auto")
    assert y.shape == want_y.shape == (1, 5, 5, 5, 8)
    assert "DwBnActBackward" not in _grad_fn_name(y)
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=ATOL, rtol=RTOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_bf16_folds_scale_then_rounds_like_jax():
    """Fold in f32, round the folded taps to x's dtype, one bf16 store."""
    x, k, scale, bias, _ = _case(5, 18, (3, 3, 3))
    want = np.asarray(jf.fused_depthwise_bn_act(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(bias), act="silu", mode="pallas"
    ).astype(jnp.float32))
    got = tf.fused_depthwise_bn_act(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(bias), act="silu",
        mode="auto")
    assert got.dtype == torch.bfloat16
    # the folded taps are the same bf16 values on both sides
    kf = (torch.from_numpy(k).bfloat16().float() * torch.from_numpy(scale)).bfloat16()
    want_kf = (jnp.asarray(k, jnp.bfloat16).astype(jnp.float32)
               * jnp.asarray(scale)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(kf.float().numpy(),
                                  np.asarray(want_kf.astype(jnp.float32)))
    # one bf16 rounding of the same f32 sum, up to summation order
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


def test_pallas_mode_on_a_cpu_tensor_raises_and_auto_launches_nothing():
    x, k, scale, bias, _ = _case(6, 8, (3, 3, 3))
    args = [torch.from_numpy(a) for a in (x, k, scale, bias)]
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.fused_depthwise_bn_act(*args, mode="pallas")
    with pytest.raises(ValueError):
        tf.fused_depthwise_bn_act(*args, act="gelu")
    before = dict(tf.LAUNCHES)
    tf.fused_depthwise_bn_act(*args, mode="auto")
    layer = tdw.DepthwiseConv3D(8, (3, 3, 3), impl="pallas")
    layer(args[0].permute(0, 4, 1, 2, 3))
    assert tf.LAUNCHES == before


def test_dw_backward_honours_needs_input_grad():
    x, k, scale, bias, _ = _case(7, 8, (3, 3, 3))
    xt = torch.from_numpy(x).requires_grad_()
    tf.fused_depthwise_bn_act(xt, torch.from_numpy(k), torch.from_numpy(scale),
                              torch.from_numpy(bias), act="relu").sum().backward()
    assert xt.grad is not None and xt.grad.shape == x.shape
    kt = torch.from_numpy(k).requires_grad_()
    tf.fused_depthwise_bn_act(torch.from_numpy(x), kt, torch.from_numpy(scale),
                              torch.from_numpy(bias), act="relu").sum().backward()
    assert kt.grad is not None and kt.grad.shape == k.shape


# --- row 4: depthwise conv with a selectable lowering -----------------------


def _jax_module_and_grads(impl, x, k, ct, stride=(1, 1, 1)):
    """JAX DepthwiseConv3D(impl) forward and the (x, kernel) gradients of
    sum(y * ct)."""
    c = x.shape[-1]
    m = jdw.DepthwiseConv3D(c, k.shape[:3], stride=stride, impl=impl)

    def fn(xj, kj):
        return m.apply({"params": {"kernel": kj}}, xj)

    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(k))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _port_module_and_grads(impl, x, k, ct, stride=(1, 1, 1)):
    c = x.shape[-1]
    m = tdw.DepthwiseConv3D(c, k.shape[:3], stride=stride, impl=impl)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(k).permute(4, 3, 0, 1, 2))
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    (y * torch.from_numpy(ct)).sum().backward()
    dk = m.weight.grad.permute(2, 3, 4, 1, 0).numpy()
    return y, [xt.grad.numpy(), dk]


@pytest.mark.parametrize("taps", [(3, 3, 3), (5, 1, 1)])
@pytest.mark.parametrize("impl", ["conv", "shift", "pallas"])
def test_depthwise_module_matches_jax_pallas_kernel(impl, taps):
    """Each lowering of the port's module against the Pallas kernel
    `pallas_depthwise3d_s1` (interpret mode, its custom VJP) and against
    the JAX module under the same impl: forward, dx and dk."""
    x, k, _, _, ct = _case(20 + sum(taps), 18, taps)
    y_k, vjp = jax.vjp(lambda a, b: pallas_depthwise3d_s1(a, b),
                       jnp.asarray(x), jnp.asarray(k))
    g_k = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    y_m, g_m = _jax_module_and_grads(impl, x, k, ct)
    y, got = _port_module_and_grads(impl, x, k, ct)
    if impl == "pallas":
        assert "Depthwise3dS1Backward" in _grad_fn_name(y)
    for want_y, want_g in ((np.asarray(y_k), g_k), (y_m, g_m)):
        np.testing.assert_allclose(y.detach().numpy(), want_y, atol=ATOL,
                                   rtol=RTOL)
        for g, w, name in zip(got, want_g, ("x", "kernel")):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{impl} d{name}")


@pytest.mark.parametrize("taps,stride", [((3, 3, 3), (1, 2, 2)),
                                         ((3, 3, 3), (2, 2, 2)),
                                         ((2, 3, 3), (1, 1, 1))])
def test_strided_or_even_pallas_takes_the_grouped_conv(taps, stride):
    """Strided and even-tap `pallas` calls run the grouped conv, as the JAX
    module does: the same forward and gradients as `conv` on both sides;
    `shift` agrees under the stride too."""
    x, k, _, _, _ = _case(30, 8, taps, shape=(1, 5, 8, 8))
    out_shape = jdw.DepthwiseConv3D(8, taps, stride=stride).apply(
        {"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x)).shape
    ct =np.random.default_rng(31).standard_normal(out_shape).astype(np.float32)
    y_c, g_c = _jax_module_and_grads("conv", x, k, ct, stride)
    impls = ("pallas", "conv") + (("shift",) if taps[0] % 2 else ())
    for impl in impls:
        y, got = _port_module_and_grads(impl, x, k, ct, stride)
        assert "Depthwise3dS1Backward" not in _grad_fn_name(y)
        np.testing.assert_allclose(y.detach().numpy(), y_c, atol=ATOL,
                                   rtol=RTOL, err_msg=impl)
        for g, w in zip(got, g_c):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=impl)


def test_shift_matches_jax_shift_under_bf16():
    x, k, _, _, _ = _case(40, 18, (3, 3, 3))
    want = np.asarray(jdw.depthwise_conv3d_shift(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        (1, 2, 2)).astype(jnp.float32))
    got = tdw.depthwise_conv3d_shift(torch.from_numpy(x).bfloat16(),
                                     torch.from_numpy(k).bfloat16(), (1, 2, 2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


def test_bad_impl_raises():
    with pytest.raises(ValueError, match="conv|shift|pallas"):
        tdw.DepthwiseConv3D(8, (3, 3, 3), impl="halo")
