"""The arithmetic of the port's flash forward kernel
(`csrc/flash_attention.cu` `pva_flash_fwd`), on the CPU.

The kernel cannot run here, so a plain torch emulation of what it does
(kept in this file, not in the package) is held against the port's
`flash_fwd_plain` and against the JAX package's `flash_attention`. The
emulation walks the keys in the kernel's tiles (64 keys a step, 32 at
D = 80 and 96: `fwd_bc` in the source):

- s = q k^T unscaled in f32 over the valid keys of a tile; the running row
  max m is taken on the unscaled s (scale >= 0), so the base-2 exponent is
  one FMA:
  p = exp2(s * scale log2(e) - m * scale log2(e));
- p rounded to the operand dtype against the running max before P V, l
  summed from the unrounded p; alpha = exp2((m_old - m_new) scale log2(e))
  rescales l and O;
- out = O * (1 / l), lse = m * scale + log(max(l, 1e-30)): back in the
  natural log, with m * scale the reference's max(s * scale).

Tolerances: in float32 the casts do nothing and only the summation order
and exp2 against exp differ, 1e-5 of the output's scale, and lse within
1e-5 absolute; in bfloat16 the card's kernel tolerance 1e-2 * (1 + |plain|)
(p is rounded against the running max, the plain version against the
global one). Against the JAX Pallas kernel in interpret mode (f32) at ragged
shapes: Nq != Nk, Nk = 1, Nk = 392 at D = 96, Nq = 5; 1e-5.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorchvideo_accelerate_tpu.ops.pallas_attention import (
    flash_attention as jflash,
)
from pytorchvideo_accelerate_tpu_torch.ops import flash_attention as tflash

TOL = 1e-5


def _keys_per_step(d):
    """The kernel's `fwd_bc`: 32 where a warp's two row tiles of O take D
    registers a lane (D 80, 96), else 64."""
    return 32 if 64 < d <= 96 else 64


def _qkv(b, nq, nk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d))]


def _kernel_fwd(q, k, v, scale):
    """(out in q's dtype, lse f32 (B, H, Nq)) as the kernel forms them."""
    sl = scale * math.log2(math.e)
    q32, k32, v32 = q.float(), k.float(), v.float()
    b, nq, h, d = q.shape
    m = torch.full((b, h, nq), -1e30)
    l = torch.zeros((b, h, nq))
    o = torch.zeros((b, h, nq, d))
    bc = _keys_per_step(d)
    for k0 in range(0, k.shape[1], bc):
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k32[:, k0:k0 + bc])
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * sl)
        p = torch.exp2(s * sl - (m_new * sl)[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                          v32[:, k0:k0 + bc])
        o = o * alpha[..., None] + pv
        m = m_new
    out = (o * (1.0 / l)[..., None]).permute(0, 2, 1, 3)
    lse = m * scale + torch.log(torch.clamp_min(l, 1e-30))
    return out.to(q.dtype), lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,h,d", [
    (2, 200, 72, 2, 96), (1, 100, 300, 2, 64), (2, 5, 1, 3, 64),
    (1, 70, 129, 1, 32)])
def test_kernel_emulation_matches_plain(dtype, b, nq, nk, h, d):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(b, nq, nk, h, d, 11))
    scale = d ** -0.5
    out, lse = _kernel_fwd(q, k, v, scale)
    want, want_lse = tflash.flash_fwd_plain(q, k, v, scale)
    out, want = out.float(), want.float()
    if dtype == torch.float32:
        assert (out - want).abs().max() <= TOL * (1 + want.abs().max())
        assert (lse - want_lse).abs().max() <= TOL
    else:
        assert ((out - want).abs() <= 1e-2 * (1 + want.abs())).all()
        assert (lse - want_lse).abs().max() <= 1e-4


@pytest.mark.parametrize("b,nq,nk,h,d", [
    (1, 200, 72, 2, 64),   # Nq != Nk, Nk inside one ragged tile
    (2, 37, 1, 1, 64),     # a single key
    (1, 100, 392, 1, 96),  # MViT-B's pooled K/V length, D 96
    (2, 5, 130, 2, 32),    # Nq < 16, three key tiles
])
def test_kernel_emulation_matches_jax_interpret(b, nq, nk, h, d):
    q, k, v = _qkv(b, nq, nk, h, d, 12)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v))))
    out, _ = _kernel_fwd(*map(torch.from_numpy, (q, k, v)), d ** -0.5)
    np.testing.assert_allclose(out.numpy(), want,
                               atol=TOL * (1 + np.abs(want).max()), rtol=0)


def test_a_negative_scale_reaches_the_kernel_as_a_flipped_q(monkeypatch):
    """The kernel takes its row max on q k^T unscaled, which needs scale >=
    0: `_fwd_cuda` hands it -q and -scale instead, which give the same s =
    q k^T * scale exactly (the launch itself is recorded, not run)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 20, 30, 2, 16, 13))
    seen = []
    monkeypatch.setattr(tflash, "_call", lambda name, ptrs, dims, views, scale,
                        device: seen.append((ptrs[0], scale)))
    tflash._fwd_cuda(q, k, v, -0.3)
    tflash._fwd_cuda(q, k, v, 0.3)
    assert torch.equal(seen[0][0], -q) and seen[0][1] == 0.3
    assert seen[1][0] is q and seen[1][1] == 0.3
    out, lse = tflash.flash_fwd_plain(q.float(), k.float(), v.float(), -0.3)
    flip, flip_lse = tflash.flash_fwd_plain(-q.float(), k.float(), v.float(), 0.3)
    assert torch.equal(out, flip) and torch.equal(lse, flip_lse)
