"""The port's attention (ops/flash_attention.py, ops/attention.py) against
the JAX package's, on the CPU in float32.

- `flash_fwd_plain` / `flash_bwd_plain` and the autograd Function
  `FlashAttention` (its custom backward, the plain versions inside on a CPU
  tensor) against the JAX `flash_attention`: the Pallas kernels in
  interpret mode and `jax.grad` through their custom VJP. Shapes: one
  block, several blocks, ragged Nq != Nk, D in {8, 16, 64}, and the
  large-logit case of tests/test_pallas_attention.py. Tolerance 1e-5: in
  f32 the plain versions' casts do nothing, so the two sides differ by f32
  rounding (summation order and the running max of the online softmax).
- The router: `dense` against the JAX `dense_attention`, with and without a
  `temporal_band_mask`; `pallas` + mask, `ring`, `ulysses` and an unknown
  backend raise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu.ops import attention as jattn
from pytorchvideo_accelerate_tpu.ops.pallas_attention import (
    flash_attention as jflash,
)
from pytorchvideo_accelerate_tpu_torch.ops import attention as tattn
from pytorchvideo_accelerate_tpu_torch.ops import flash_attention as tflash
from pytorchvideo_accelerate_tpu_torch.ops import fused as tfused

TOL = 1e-5

# (B, Nq, Nk, H, D): one block, several blocks with ragged tails, Nq != Nk
SHAPES = [(1, 16, 16, 1, 8), (2, 40, 72, 2, 16), (1, 130, 260, 2, 64),
          (2, 72, 40, 1, 16)]


def _qkv(b, nq, nk, h, d, seed=0, q_scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, nq, h, d), np.float32) * q_scale,
            rng.standard_normal((b, nk, h, d), np.float32),
            rng.standard_normal((b, nk, h, d), np.float32),
            rng.standard_normal((b, nq, h, d), np.float32))


def _jax_fwd_bwd(q, k, v, g):
    out, vjp = jax.vjp(jflash, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("b,nq,nk,h,d", SHAPES)
def test_plain_versions_match_pallas_interpret(b, nq, nk, h, d):
    q, k, v, g = _qkv(b, nq, nk, h, d)
    want_out, want_grads = _jax_fwd_bwd(q, k, v, g)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    scale = d ** -0.5
    out, lse = tflash.flash_fwd_plain(tq, tk, tv, scale)
    np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=0)
    # lse = logsumexp of the scaled logits, one value per (b, h, query)
    want_lse = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", tq, tk) * scale, -1)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=TOL, rtol=0)
    grads = tflash.flash_bwd_plain(tq, tk, tv, out, lse, tg, scale)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("b,nq,nk,h,d", SHAPES)
def test_autograd_function_matches_jax_grad(b, nq, nk, h, d):
    q, k, v, g = _qkv(b, nq, nk, h, d, seed=1)
    want_out, want_grads = _jax_fwd_bwd(q, k, v, g)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = dict(tfused.LAUNCHES)
    out = tflash.flash_attention(*leaves)
    assert out.grad_fn.name() == "FlashAttentionBackward"
    out.backward(torch.from_numpy(g))
    assert tfused.LAUNCHES == before  # CPU tensors: plain versions, no launch
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=TOL, rtol=0)
    for t, want in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), want, atol=TOL, rtol=0)


def test_large_logits_stay_finite():
    """q scaled by 30 (the stability case of tests/test_pallas_attention.py,
    logits of order 100): the online softmax subtracts the running max, so
    nothing overflows. The gradients scale with q, so their bound is
    relative to their size."""
    q, k, v, g = _qkv(1, 32, 96, 1, 16, seed=2, q_scale=30.0)
    want_out, want_grads = _jax_fwd_bwd(q, k, v, g)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tflash.flash_attention(*leaves)
    out.backward(torch.from_numpy(g))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=TOL, rtol=0)
    for t, want in zip(leaves, want_grads):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), want,
                                   atol=TOL * (1 + np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("window", [None, 4, 2])
def test_dense_router_matches_jax_dense(window):
    t, hw = 4, 6
    q, k, v, _ = _qkv(2, t * hw, t * hw, 2, 16, seed=3)
    jmask = tmask = None
    if window is not None:
        jmask = jattn.temporal_band_mask(t, hw, window)[None, None]
        tmask = tattn.temporal_band_mask(t, hw, window)[None, None]
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    want = np.asarray(jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), mask=jmask))
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                      backend="dense", mask=tmask)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_pallas_router_is_flash():
    q, k, v, _ = _qkv(1, 24, 40, 2, 16, seed=4)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tattn.dot_product_attention(tq, tk, tv, backend="pallas")
    np.testing.assert_array_equal(got.numpy(),
                                  tflash.flash_attention(tq, tk, tv).numpy())
    np.testing.assert_allclose(
        got.numpy(), tattn.dense_attention(tq, tk, tv).numpy(), atol=TOL, rtol=0)


def test_banded_time_mask_matches_jax():
    qi = np.array([[3, 4, 5]], np.int32)
    ki = np.array([[0, 1, 2, 3, 4, 5]], np.int32)
    np.testing.assert_array_equal(
        tattn.banded_time_mask(torch.from_numpy(qi), torch.from_numpy(ki), 3).numpy(),
        np.asarray(jattn.banded_time_mask(jnp.asarray(qi), jnp.asarray(ki), 3)))


@pytest.mark.parametrize("backend,mask,err", [
    ("pallas", True, NotImplementedError),   # no masked lowering
    ("ring", False, NotImplementedError),    # multi-GPU, not ported
    ("ulysses", False, NotImplementedError),
    ("ring", True, NotImplementedError),
    ("nope", False, ValueError),
])
def test_router_refuses(backend, mask, err):
    q, k, v, _ = _qkv(1, 8, 8, 1, 16, seed=5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    m = tattn.temporal_band_mask(2, 4, 1)[None, None] if mask else None
    with pytest.raises(err):
        tattn.dot_product_attention(tq, tk, tv, backend=backend, mask=m)
