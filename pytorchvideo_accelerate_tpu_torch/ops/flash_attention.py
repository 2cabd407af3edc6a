"""Flash attention, forward and backward: the counterpart of the JAX
package's `ops/pallas_attention.py`.

- `flash_attention(q, k, v, scale=None)`: q (B, Nq, H, D), k/v (B, Nk, H, D)
  -> (B, Nq, H, D), the JAX layout; Nq and Nk need not match or be tile
  multiples. Differentiable through `FlashAttention`.
- `FlashAttention` is the `torch.autograd.Function` counterpart of the
  custom VJP `_flash_bhnd`: its forward saves (q, k, v, out, lse); its
  backward computes delta = rowsum(f32(dO) * f32(out)) with plain torch (a
  jnp precompute in the reference) and then dq and dk/dv.
- On a CUDA tensor each pass launches its hand kernel
  (`csrc/flash_attention.cu`: `pva_flash_fwd`;
  `csrc/flash_attention_bwd.cu`: `pva_flash_bwd_dq`, `pva_flash_bwd_dkv`)
  or raises; on a CPU tensor it runs the plain versions `flash_fwd_plain`
  / `flash_bwd_plain`. Nothing falls back.
- The forward (`pva_flash_fwd`) keeps Q, S, P and the running O of each
  warp's 32 query rows in registers (mma.sync, cp.async K/V stages); it
  takes its row max on q k^T unscaled, so `_fwd_cuda` hands it -q and
  -scale for a negative scale. `kernel_attrs` reports each kernel's
  registers, spills, shared memory and blocks per SM.
- dk/dv runs one block per 64 keys and (b, h). Where that leaves the card
  short, `dkv_splits` cuts the query loop into ranges of whole 64-row
  tiles (`dkv_split_rows`): each block sums its range into an f32
  workspace and the same entry point sums the ranges in order, so the
  result stays deterministic.

The plain versions take one pass over all keys and round where the kernels
round: the unnormalised p to q's dtype before P V, then / l; delta from the
stored `out`; p and ds to q's dtype before their products. The kernels and
the plain versions then differ in summation order and in the running max
that p is rounded against. In float32 the casts do nothing, so on the CPU
the plain versions equal the Pallas kernels in interpret mode to f32
rounding.

The kernels take bf16 q/k/v/dO with a contiguous last dim of D, a multiple
of 16 up to 128; any other D or dtype on the card raises. q/k/v may be
strided views (the qkv projection's split): the kernels read them through
their (b, n, h) element strides. Launches count in the fused ops'
`LAUNCHES` under "flash_attention", "flash_attention.bwd_dq" and
"flash_attention.bwd_dkv".
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from pytorchvideo_accelerate_tpu_torch.ops.fused import LAUNCHES
from pytorchvideo_accelerate_tpu_torch.precision import end_island, f32_island

MAX_HEAD_DIM = 128
# rows a dk/dv block owns (keys), and the unit its query ranges are cut in
DKV_ROWS = 64
# blocks per SM the dk/dv grid should reach before the query loop is split
DKV_BLOCKS_PER_SM = 2
MAX_DKV_SPLITS = 16


# --- plain PyTorch versions (CPU tensors, tests, the card's reference) -------


def _scores(q, k, scale: float):
    """s = q k^T * scale in f32, (B, H, Nq, Nk)."""
    return torch.einsum("bqhd,bkhd->bhqk", f32_island(q), f32_island(k)) * scale


def attention_delta(out, dout):
    """delta = rowsum(f32(dO) * f32(out)) over D, (B, H, Nq) f32."""
    return (f32_island(dout) * f32_island(out)).sum(-1).permute(0, 2, 1).contiguous()


def flash_fwd_plain(q, k, v, scale: float):
    """(out (B, Nq, H, D) in q's dtype, lse (B, H, Nq) f32): softmax(s) v
    with the unnormalised p rounded to v's dtype before the product and
    the sum l taken in f32, then out = (p v) / l; lse = m + log(max(l,
    1e-30))."""
    s = _scores(q, k, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", f32_island(p.to(v.dtype)), f32_island(v))
    out = pv / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(torch.clamp_min(l, 1e-30))).squeeze(-1)
    return end_island(out, q.dtype), lse


def flash_bwd_plain(q, k, v, out, lse, dout, scale: float):
    """(dq, dk, dv) of `flash_fwd_plain` from its saved (out, lse): p =
    exp(s - lse) recomputed, delta from `out`, ds = p (dO v^T - delta) *
    scale; p and ds rounded to the operands' dtype before their products,
    sums in f32, each gradient cast once."""
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    do32 = f32_island(dout)
    dv = torch.einsum("bhqk,bqhd->bkhd", f32_island(p.to(dout.dtype)), do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, f32_island(v))
    ds = f32_island((p * (dp - attention_delta(out, dout)[..., None]) * scale)
                    .to(q.dtype))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, f32_island(k))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, f32_island(q))
    return end_island(dq, q.dtype), end_island(dk, k.dtype), end_island(dv, v.dtype)


# --- the dk/dv launch plan ---------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dkv_splits(b: int, h: int, nq: int, nk: int, sm_count: int) -> int:
    """How many query ranges the dk/dv kernel cuts its loop into: 1 where
    ceil(nk / 64) * b * h blocks already give every SM DKV_BLOCKS_PER_SM
    blocks, else enough ranges to reach that (at most one per 64-row query
    tile and MAX_DKV_SPLITS), reduced so that no range is empty."""
    blocks = _cdiv(nk, DKV_ROWS) * b * h
    tiles = _cdiv(nq, DKV_ROWS)
    if blocks == 0 or blocks >= DKV_BLOCKS_PER_SM * sm_count or tiles < 2:
        return 1
    splits = min(_cdiv(DKV_BLOCKS_PER_SM * sm_count, blocks), tiles,
                 MAX_DKV_SPLITS)
    return _cdiv(tiles, _cdiv(tiles, splits))


def dkv_split_rows(nq: int, splits: int):
    """[(start, stop)] query rows of each split, as the kernel cuts them:
    ceil(tiles / splits) whole 64-row tiles each, the last one ragged."""
    per = _cdiv(_cdiv(nq, DKV_ROWS), splits) * DKV_ROWS
    return [(min(nq, s * per), min(nq, (s + 1) * per)) for s in range(splits)]


# --- CUDA kernel wrappers ----------------------------------------------------


def _operand(x: torch.Tensor, what: str) -> torch.Tensor:
    """A (B, N, H, D) kernel operand with its last dim contiguous, 16-byte
    aligned rows (copied to contiguous otherwise) and int32 offsets."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash attention kernels take bfloat16, got {what} "
                        f"{x.dtype}; run --mixed_precision bf16, or "
                        "--model.attention dense for float32")
    if x.dim() != 4:
        raise ValueError(f"flash attention {what} must be (B, N, H, D), got "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take a head dim that is a "
                         f"multiple of 16 up to {MAX_HEAD_DIM}, got {d}")
    if x.stride(-1) != 1:
        raise ValueError(f"flash attention {what} needs a contiguous last dim, "
                         f"got strides {x.stride()}")
    if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        x = x.contiguous()
    if sum((n - 1) * s for n, s in zip(x.shape, x.stride())) >= 2 ** 31:
        raise ValueError(f"flash attention {what} spans >= 2**31 elements")
    return x


def _view(x: torch.Tensor):
    return (x.stride(0), x.stride(1), x.stride(2))


def _call(name: str, ptrs, dims, views, scale: float, device) -> None:
    from pytorchvideo_accelerate_tpu_torch.ops import _build

    fn = _build.entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), *dims,
                *(s for v in views for s in _view(v)), ctypes.c_float(scale),
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _check_shapes(q, k, v, dout=None):
    b, nq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash attention q {tuple(q.shape)} with k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError("flash attention needs at least one key")
    if dout is not None and dout.shape != q.shape:
        raise ValueError(f"flash attention dO {tuple(dout.shape)} for q "
                         f"{tuple(q.shape)}")
    if len({t.device for t in (q, k, v, dout) if t is not None}) != 1:
        raise ValueError("flash attention operands must share one CUDA device")


def _fwd_cuda(q, k, v, scale: float):
    _check_shapes(q, k, v)
    if scale < 0:  # the kernel takes its row max on q k^T unscaled
        q, scale = -q, -scale
    q, k, v = _operand(q, "q"), _operand(k, "k"), _operand(v, "v")
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    if nq:
        _call("flash_attention", (q, k, v, out, lse), (b, h, nq, k.shape[1], d),
              (q, k, v), scale, q.device)
    return out, lse


def launch_dq(q, k, v, dout, lse, delta, dq, scale: float) -> None:
    """One `pva_flash_bwd_dq` launch into `dq` (B, Nq, H, D) from checked
    operands (`_operand`), lse and delta (B, H, Nq) f32 contiguous."""
    b, nq, h, d = q.shape
    _call("flash_attention.bwd_dq", (q, k, v, dout, lse, delta, dq),
          (b, h, nq, k.shape[1], d), (q, k, v, dout), scale, q.device)


def launch_dkv(q, k, v, dout, lse, delta, dk, dv, scale: float) -> int:
    """One `pva_flash_bwd_dkv` call into `dk`, `dv` (B, Nk, H, D): it picks
    the query splits for this card (`dkv_splits`) and allocates their f32
    workspace (2, splits, B, H, Nk, D). Returns the splits."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = dkv_splits(b, h, nq, nk, sms)
    ws = torch.empty((2 * splits * b * h * nk * d if splits > 1 else 0,),
                     dtype=torch.float32, device=q.device)
    _call("flash_attention.bwd_dkv", (q, k, v, dout, lse, delta, dk, dv, ws),
          (b, h, nq, nk, d, splits), (q, k, v, dout), scale, q.device)
    return splits


def kernel_attrs(which: str, d: int) -> dict:
    """Build facts of the flash kernel `which` ("fwd", "dq" or "dkv") at
    head dim `d` on the current card: registers and local memory (spill)
    bytes a thread, dynamic shared memory a block, resident blocks per SM."""
    from pytorchvideo_accelerate_tpu_torch.ops import _build

    out = (ctypes.c_int * 4)()
    if which == "fwd":
        rc = _build.entry("flash_attention.fwd_attrs")(d, out)
    else:
        rc = _build.entry("flash_attention.bwd_attrs")(
            {"dq": 0, "dkv": 1}[which], d, out)
    if rc != 0:
        raise RuntimeError(f"flash {which} attributes: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), out))


def _bwd_cuda(q, k, v, out, lse, dout, scale: float, need_q: bool,
              need_kv: bool):
    _check_shapes(q, k, v, dout)
    q, k, v = _operand(q, "q"), _operand(k, "k"), _operand(v, "v")
    dout = _operand(dout, "dO")
    b, _, h, d = q.shape
    nk = k.shape[1]
    delta = attention_delta(out, dout)
    lse = lse.contiguous()
    dq = dk = dv = None
    if need_q:
        dq = torch.empty_like(q, memory_format=torch.contiguous_format)
        launch_dq(q, k, v, dout, lse, delta, dq, scale)
    if need_kv:
        dk = torch.empty((b, nk, h, d), dtype=k.dtype, device=k.device)
        dv = torch.empty((b, nk, h, d), dtype=v.dtype, device=v.device)
        launch_dkv(q, k, v, dout, lse, delta, dk, dv, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T * scale) v over (B, N, H, D) operands: the kernels on
    a CUDA tensor, the plain versions on a CPU tensor; the backward is the
    reference's FlashAttention-2 split (dq over K tiles, dk/dv over Q
    tiles) from the saved (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        if q.is_cuda:
            out, lse = _fwd_cuda(q, k, v, scale)
        else:
            out, lse = flash_fwd_plain(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        need_q = ctx.needs_input_grad[0]
        need_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        if q.is_cuda:
            dq, dk, dv = _bwd_cuda(q, k, v, out, lse, dout, ctx.scale, need_q,
                                   need_kv)
        else:
            dq, dk, dv = flash_bwd_plain(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None):
    """Flash attention over q (B, Nq, H, D), k/v (B, Nk, H, D) -> (B, Nq, H,
    D), scale defaulting to D**-0.5; differentiable (`FlashAttention`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, float(scale))
