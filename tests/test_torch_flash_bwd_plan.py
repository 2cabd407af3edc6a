"""The dk/dv launch plan of the port's flash backward (ops/flash_attention.py
`dkv_splits`, `dkv_split_rows`), on the CPU.

Where one block per 64 keys and (b, h) leaves the card short, the dk/dv
kernel (`csrc/flash_attention_bwd.cu`) cuts its query loop into ranges of
whole 64-row tiles, sums each range into an f32 workspace and then sums the
ranges in order. Here:

- `dkv_splits` at the attention sites of the path on a 132-SM H100: no split
  for VideoMAE-B and MAE, a split for every MViT-B site with Nk = 392; the
  ranges are whole 64-row tiles, non-empty, and cover [0, Nq) in order.
- A plain emulation of the split (each range's dk/dv with p and ds rounded
  to the operands' dtype, the ranges summed in the kernel's order) against
  `flash_bwd_plain`: in float32 to f32 rounding (1e-5 of the gradient's
  scale: the casts do nothing and only the summation order differs); in
  bfloat16 within the card's kernel tolerance 1e-2 * (1 + |plain|) (one
  bf16 ulp of the final cast plus the f32 order).
- The same emulation at a ragged shape where the split fires, against the
  JAX package's `flash_attention` gradients (the Pallas kernels in interpret
  mode, `jax.vjp` through the custom VJP), 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu.ops.pallas_attention import (
    flash_attention as jflash,
)
from pytorchvideo_accelerate_tpu_torch.ops import flash_attention as tflash

H100_SMS = 132
TOL = 1e-5


def _qkv(b, nq, nk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d), (b, nq, h, d))]


def _split_dkv(q, k, v, out, lse, dout, scale, splits):
    """dk, dv as the split kernel forms them: per query range, p = exp(s -
    lse) and ds = p (dO v^T - delta) scale, p and ds rounded to the
    operands' dtype, f32 partial sums; the partials summed in range order
    and cast once."""
    delta = tflash.attention_delta(out, dout)
    k32, v32 = k.float(), v.float()
    parts = []
    for start, stop in tflash.dkv_split_rows(q.shape[1], splits):
        qs, dos = q[:, start:stop].float(), dout[:, start:stop].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qs, k32) * scale
        p = torch.exp(s - lse[:, :, start:stop, None])
        dp = torch.einsum("bqhd,bkhd->bhqk", dos, v32)
        ds = (p * (dp - delta[:, :, start:stop, None]) * scale).to(q.dtype).float()
        parts.append((torch.einsum("bhqk,bqhd->bkhd", ds, qs),
                      torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dos)))
    dk, dv = parts[0]
    for pk, pv in parts[1:]:
        dk, dv = dk + pk, dv + pv
    return dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("b,h,nq,nk,want", [
    (8, 12, 1568, 1568, 1),   # VideoMAE-B classifier
    (8, 12, 160, 160, 1),     # MAE encoder (10% of 1568 tokens kept)
    (8, 6, 1568, 1568, 1),    # MAE decoder
    (8, 8, 392, 392, 1),      # MViT-B last stage
    (8, 1, 25088, 392, 5),    # MViT-B block 0: 56 blocks -> 280
    (8, 2, 6272, 392, 3),     # MViT-B block 2: 112 -> 336
    (8, 4, 1568, 392, 2),     # MViT-B blocks 4-13: 224 -> 448
])
def test_dkv_splits_at_the_path_sites(b, h, nq, nk, want):
    splits = tflash.dkv_splits(b, h, nq, nk, H100_SMS)
    assert splits == want
    blocks = -(-nk // tflash.DKV_ROWS) * b * h * splits
    assert splits == 1 or blocks >= tflash.DKV_BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("b,h,nq,nk,sms", [
    (8, 1, 25088, 392, 132), (8, 4, 1568, 392, 132), (1, 1, 300, 24, 132),
    (1, 1, 130, 24, 132), (1, 1, 64 * 17 + 5, 64, 132), (1, 1, 64 * 9, 1, 78),
    (2, 3, 5, 1, 132),
])
def test_dkv_split_rows_are_whole_tiles_covering_nq(b, h, nq, nk, sms):
    splits = tflash.dkv_splits(b, h, nq, nk, sms)
    assert 1 <= splits <= tflash.MAX_DKV_SPLITS
    rows = tflash.dkv_split_rows(nq, splits)
    assert len(rows) == splits
    assert rows[0][0] == 0 and rows[-1][1] == nq
    for (start, stop), (nxt, _) in zip(rows, rows[1:] + [(nq, None)]):
        assert start < stop == nxt
        assert start % tflash.DKV_ROWS == 0
        assert stop % tflash.DKV_ROWS == 0 or stop == nq


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_emulation_matches_plain(dtype):
    b, nq, nk, h, d = 2, 200, 40, 2, 32
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _qkv(b, nq, nk, h, d, 7))
    scale = d ** -0.5
    out, lse = tflash.flash_fwd_plain(q, k, v, scale)
    _, want_dk, want_dv = tflash.flash_bwd_plain(q, k, v, out, lse, g, scale)
    splits = tflash.dkv_splits(b, h, nq, nk, H100_SMS)
    assert splits == 4
    for got, want in zip(_split_dkv(q, k, v, out, lse, g, scale, splits),
                         (want_dk, want_dv)):
        got, want = got.float(), want.float()
        if dtype == torch.float32:
            bound = TOL * (1 + want.abs().max())
        else:
            bound = 1e-2 * (1 + want.abs())
        assert ((got - want).abs() <= bound).all()


def test_split_emulation_matches_jax_interpret():
    b, nq, nk, h, d = 1, 300, 24, 1, 96
    q, k, v, g = _qkv(b, nq, nk, h, d, 8)
    _, vjp = jax.vjp(jflash, *map(jnp.asarray, (q, k, v)))
    _, want_dk, want_dv = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    scale = d ** -0.5
    out, lse = tflash.flash_fwd_plain(tq, tk, tv, scale)
    splits = tflash.dkv_splits(b, h, nq, nk, H100_SMS)
    assert splits == 5
    for got, want in zip(_split_dkv(tq, tk, tv, out, lse, tg, scale, splits),
                         (want_dk, want_dv)):
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=TOL * (1 + np.abs(want).max()), rtol=0)
