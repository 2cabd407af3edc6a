"""Fused conv -> norm-affine -> activation for the 3D-CNN hot paths.

The counterpart of the JAX package's `ops/pallas_fused.py`, same public
functions, same NDHWC layout, same `mode` vocabulary:

- `fused_pointwise_bn_act`: (1,1,1) conv + per-channel affine + act, a GEMM
  over (B*T*H*W, Cin) rows; on the card `csrc/fused_pw_bn_act.cu`.
- `fused_conv3d_bn_act`: dense stride-1 SAME conv with odd taps + affine +
  act; on the card `csrc/fused_conv_bn_act.cu` (implicit GEMM). A (1,1,1)
  weight routes to the pointwise kernel, even taps to the plain version.
  Both kernels run on the tile engine of `csrc/fused_gemm.cuh`; `gemm_plan`
  picks its tile configuration and copy path per call from (M, K, N) and the
  operands' alignment, and `gemm_attrs` reports a configuration's build
  facts on the card.
- `fused_depthwise_bn_act`: depthwise stride-1 SAME conv with odd taps +
  affine + act (X3D `conv_b`/`stem_t`, CSN `conv_b`); on the card
  `csrc/depthwise3d.cu` (`pva_fused_dw_bn_act`), even taps take the plain
  version. The same source's `pva_depthwise3d_s1` (no bias, no act) serves
  `ops/depthwise.py`, whose plain tap sum lives here too
  (`depthwise_taps_f32`). `dw_plan` picks the stencil's tile, copy path
  and T chunk per call, and `dw_attrs` reports a configuration's build
  facts on the card.

Norm-affine contract: callers pass the resolved per-channel (scale, bias).
The scale folds into the weights in f32 and the folded weight is rounded to
x's dtype, so the kernels carry only a bias + act epilogue.

Lowering (`mode`): "auto" launches the CUDA kernel for a CUDA tensor and runs
the plain PyTorch version for a CPU tensor; "pallas" always launches the
hand kernel (the name is kept so configs round-trip with the JAX package) and
raises on a CPU tensor; "xla" runs the plain version. Nothing falls back: a
kernel that fails to build or launch raises.

Gradients: "auto" and "pallas" go through `PwBnAct` / `ConvBnAct` /
`DwBnAct`, the `torch.autograd.Function` counterparts of the JAX package's
custom VJPs (`_pw_pallas`, `_conv_pallas`, `_dw_pallas`). Their forward is
the kernel (its plain version for a CPU tensor) and their backward
computes dx with the same kernel against the transposed (conv:
tap-flipped, channel-transposed; depthwise: tap-flipped) weights, dwf and
db as f32 contractions in PyTorch, as the JAX package leaves them to XLA.
On the card those contractions are float32 matmuls
(`torch.backends.cuda.matmul.allow_tf32` stays False). "xla" is plain
autograd through the plain versions. The scale fold stays outside the
Functions, so autograd carries dw and dscale through it.

The kernels take bf16 only; a float32 tensor on the card raises (use
`--model.fused_kernels off` or `xla` for `--mixed_precision fp32`).

Each kernel wrapper counts its launches in `LAUNCHES` (a plain int per
key, bumped only where a kernel is launched) so a run can show that the
main path went through the kernels: the forward launches under the
kernel's name, the backward's dx launches under "<name>.bwd_dx". The
depthwise (`ops/depthwise.py`) and attention (`ops/flash_attention.py`)
wrappers count here too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pytorchvideo_accelerate_tpu_torch.precision import end_island, f32_island

FUSED_ACTS = ("identity", "relu", "silu")
_ACT_CODE = {"identity": 0, "relu": 1, "silu": 2}

# launches per key since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {
    "fused_pw_bn_act": 0, "fused_conv_bn_act": 0,
    "fused_pw_bn_act.bwd_dx": 0, "fused_conv_bn_act.bwd_dx": 0,
    "fused_dw_bn_act": 0, "fused_dw_bn_act.bwd_dx": 0,
    "depthwise3d_s1": 0, "depthwise3d_s1.bwd_dx": 0,
    "flash_attention": 0, "flash_attention.bwd_dq": 0,
    "flash_attention.bwd_dkv": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def apply_act(x: torch.Tensor, act: str) -> torch.Tensor:
    """Epilogue activation on the f32 accumulator."""
    if act == "relu":
        return torch.clamp_min(x, 0.0)
    if act == "silu":
        return F.silu(x)
    if act == "identity":
        return x
    raise ValueError(f"fused act must be one of {FUSED_ACTS}, got {act!r}")


def act_grad(z32: torch.Tensor, act: str) -> torch.Tensor:
    """d act/dz at the f32 pre-activation z."""
    if act == "relu":
        return (z32 > 0).to(z32.dtype)
    if act == "silu":
        s = torch.sigmoid(z32)
        return s * (1.0 + z32 * (1.0 - s))
    return torch.ones_like(z32)


def _use_kernel(mode: str, x: torch.Tensor) -> bool:
    if mode == "pallas":
        if not x.is_cuda:
            raise RuntimeError(
                "fused mode 'pallas' launches the CUDA kernel and needs a CUDA "
                f"tensor, got one on {x.device} (use 'auto' or 'xla')")
        return True
    if mode == "xla":
        return False
    if mode != "auto":
        raise ValueError(f"fused mode must be auto|pallas|xla, got {mode!r}")
    return x.is_cuda


# --- plain PyTorch versions (CPU tensors, tests, the card's reference) -------


def pw_bn_act_plain(x2d, wf, bias32, act: str):
    """act(x2d @ wf + bias) in f32, one cast to x's dtype."""
    y = f32_island(x2d) @ f32_island(wf) + bias32
    return end_island(apply_act(y, act), x2d.dtype)


def conv_bn_act_plain(x, wf, bias32, act: str):
    """act(conv3d_s1(x, wf) + bias) in f32, one cast to x's dtype.
    x NDHWC, wf DHWIO; SAME padding k//2 per dim. On the card cuDNN runs
    f32 convolutions in TF32 unless `torch.backends.cudnn.allow_tf32` is
    False; a caller that holds a kernel against this version sets it."""
    pads = tuple(k // 2 for k in wf.shape[:3])
    xc = f32_island(x).permute(0, 4, 1, 2, 3)
    wc = f32_island(wf).permute(4, 3, 0, 1, 2)
    y = F.conv3d(xc, wc, padding=pads)
    y = y.permute(0, 2, 3, 4, 1) + bias32
    return end_island(apply_act(y, act), x.dtype).contiguous()


def depthwise_taps_f32(x, k, stride=(1, 1, 1), padding=None):
    """The f32 sum of a depthwise conv's taps, in tap order (dt, dh, dw): the
    shift decomposition of the JAX package's `depthwise_conv3d_shift`
    without its final cast. x (B,T,H,W,C); k (kt,kh,kw,1,C); padding
    defaults to k//2 per dim. x is cast to f32 once, before the taps, so
    autograd of this version also sums dx over the taps in f32 and rounds
    it to x's dtype once."""
    kt, kh, kw, one, c = k.shape
    if one != 1 or x.shape[-1] != c:
        raise ValueError(f"depthwise taps (kt,kh,kw,1,C) for x {tuple(x.shape)}, "
                         f"got {tuple(k.shape)}")
    pt, ph, pw = (kt // 2, kh // 2, kw // 2) if padding is None else padding
    st, sh, sw = stride
    xp = F.pad(f32_island(x), (0, 0, pw, pw, ph, ph, pt, pt))
    t, h, w = x.shape[1:4]
    ot = (t + 2 * pt - kt) // st + 1
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    k32 = f32_island(k)
    out = None
    for it in range(kt):
        for ih in range(kh):
            for iw in range(kw):
                tap = xp[:, it:it + (ot - 1) * st + 1:st,
                         ih:ih + (oh - 1) * sh + 1:sh,
                         iw:iw + (ow - 1) * sw + 1:sw, :]
                term = tap * k32[it, ih, iw, 0]
                out = term if out is None else out + term
    return out


def depthwise_tap_grads_f32(x, dy32, taps):
    """d(stride-1 SAME depthwise conv)/d(taps) in f32: per tap, the sum over
    (B, T, H, W) of the shifted padded input times the f32 output gradient
    `dy32`. Returns (kt, kh, kw, 1, C) f32."""
    kt, kh, kw = taps
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2, kt // 2, kt // 2))
    t, h, w = x.shape[1:4]
    rows = [(f32_island(xp[:, dt:dt + t, dh:dh + h, dw:dw + w, :]) * dy32)
            .sum(dim=(0, 1, 2, 3))
            for dt in range(kt) for dh in range(kh) for dw in range(kw)]
    return torch.stack(rows).reshape(kt, kh, kw, 1, -1)


def dw_bn_act_plain(x, kf, bias32, act: str):
    """act(depthwise_conv3d_s1(x, kf) + bias) in f32, one cast to x's dtype.
    x NDHWC, kf (kt,kh,kw,1,C); SAME padding k//2 per dim."""
    y = depthwise_taps_f32(x, kf) + bias32
    return end_island(apply_act(y, act), x.dtype)


# --- CUDA kernel wrappers ----------------------------------------------------


def _check_operands(x, wf, bias32=None):
    if x.dtype != torch.bfloat16 or wf.dtype != torch.bfloat16:
        raise TypeError(
            "the fused CUDA kernels take bfloat16 activations and weights, "
            f"got {x.dtype}/{wf.dtype}; run --mixed_precision bf16, or "
            "--model.fused_kernels off|xla for float32")
    if bias32 is not None and bias32.dtype != torch.float32:
        raise TypeError(f"fused bias must be float32, got {bias32.dtype}")
    if len({t.device for t in (x, wf, bias32) if t is not None}) != 1:
        raise ValueError("fused kernel operands must share one CUDA device")
    if max(x.numel(), wf.numel()) >= 2 ** 31:
        raise ValueError("fused kernel operands must hold < 2**31 elements")


# --- the GEMM kernels' tile plan (csrc/fused_gemm.cuh) ------------------------

# (name, BM, BN, BK) of the tiles of csrc/fused_gemm.cuh, in the order of its
# `TileOf` table (the rest of each tile, its warps, stages and launch bounds,
# lives there only)
GEMM_TILES = (
    ("wide", 128, 128, 32),
    ("n64", 128, 64, 32),
    ("n32", 256, 32, 32),
    ("n16", 256, 16, 32),
    ("n8", 256, 8, 32),
    ("k16", 256, 32, 16),
    ("deep", 128, 128, 32),
)
# how the operands reach shared memory, by config id % 3, with the multiple
# K and N must be of and the byte alignment every operand needs: 16-byte
# cp.async, 4-byte cp.async, plain loads
GEMM_PATHS = (("cp16", 8, 16), ("cp4", 2, 4), ("scalar", 1, 1))
GEMM_CONFIGS = len(GEMM_TILES) * len(GEMM_PATHS)
H100_SMS = 132
DEEP_K = 1536  # K from which the plan takes the 4-warp 128 x 128 tile


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_tile(config: int):
    """(name, BM, BN, BK) of a config id."""
    return GEMM_TILES[config // len(GEMM_PATHS)]


def gemm_path(config: int) -> str:
    return GEMM_PATHS[config % len(GEMM_PATHS)][0]


def gemm_config(tile: str, path: str) -> int:
    """The config id (tile * 3 + path) of a tile and a path by name."""
    names = [t[0] for t in GEMM_TILES]
    return names.index(tile) * len(GEMM_PATHS) + [p[0] for p in GEMM_PATHS].index(path)


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, k: int, n: int, sms: int = H100_SMS, align: int = 16) -> int:
    """The config id the GEMM kernels compute out[m, n] = act(a[m, k] @
    w[k, n] + b) with, on a card of `sms` SMs; `align` is the largest power
    of two up to 16 that divides every operand's byte address.

    - Path: 16-byte cp.async where k and n are multiples of 8 (every
      SlowFast and CSN site), 4-byte where both are even (X3D's 54 and 108
      channels), plain loads otherwise.
    - Tile by n: up to 32, the narrowest of the 8-, 16- and 32-wide tiles
      (BM 256) that covers n, with a 16-deep K step where k <= 16; the 128
      x 64 tile up to 64; above, a 128 x 128 tile (on the H100 it beat the
      narrower tiles even where they pad n less: 80, 96, 216 columns): 4
      warps of 64 x 64 ("deep") from k = 1536, where the products dominate
      and each fragment it loads feeds more of them, else 8 warps of 64 x
      32 ("wide"), which hide the copies of a short K better. The 128 x 64
      tile instead where a 128 x 128 grid would leave SMs without a block
      (res5, CSN's res4/res5)."""
    path = next(i for i, (_, mult, need) in enumerate(GEMM_PATHS)
                if k % mult == 0 and n % mult == 0 and align % need == 0)
    if n <= 8:
        tile = "n8"
    elif n <= 16:
        tile = "n16"
    elif n <= 32:
        tile = "k16" if k <= 16 else "n32"
    elif n <= 64 or _cdiv(m, 128) * _cdiv(n, 128) < sms:
        tile = "n64"
    else:
        tile = "deep" if k >= DEEP_K else "wide"
    return gemm_config(tile, GEMM_PATHS[path][0])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _align(*tensors) -> int:
    """The largest power of two up to 16 dividing every tensor's address."""
    a = 16
    for t in tensors:
        while t.data_ptr() % a:
            a //= 2
    return a


def _gemm_config(config, m: int, k: int, n: int, *operands) -> int:
    """`config`, or the plan's when None, checked against the shape and the
    operands' alignment (a forced config must suit them)."""
    align = _align(*operands)
    if config is None:
        config = gemm_plan(m, k, n, _sm_count(operands[0].device.index or 0), align)
    if not 0 <= config < GEMM_CONFIGS:
        raise ValueError(f"GEMM config {config} is not one of fused_gemm.cuh's")
    _, mult, need = GEMM_PATHS[config % len(GEMM_PATHS)]
    if k % mult or n % mult or align % need:
        raise ValueError(f"GEMM config {config} ({gemm_path(config)}) needs K and N "
                         f"multiples of {mult} and {need}-byte aligned operands, "
                         f"got K {k}, N {n}, alignment {align}")
    return config


def gemm_attrs(kernel: str, config: int) -> dict:
    """Build facts of `kernel` ("fused_pw_bn_act" or "fused_conv_bn_act") in
    GEMM configuration `config` on the current card: registers and local
    memory (spill) bytes a thread, dynamic shared memory a block, resident
    blocks per SM."""
    from pytorchvideo_accelerate_tpu_torch.ops import _build

    which = {"fused_pw_bn_act": 0, "fused_conv_bn_act": 1}[kernel]
    out = (ctypes.c_int * 4)()
    rc = _build.entry(f"{kernel}.attrs")(which, config, out)
    if rc != 0:
        raise RuntimeError(f"{kernel} config {config} attributes: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), out))


def _launch(name: str, operands, out_shape, dims, count: str):
    """Launch entry point `name` on the current stream: (*operands, out,
    *dims, stream) -> CUDA error code, the output in operands[0]'s dtype.
    Counts the launch under `LAUNCHES[count]`."""
    from pytorchvideo_accelerate_tpu_torch.ops import _build

    operands = [t.contiguous() for t in operands]
    x = operands[0]
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in operands), out.data_ptr(), *dims,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[count] += 1
    return out


def _pw_cuda(x2d, wf, bias32, act: str, count: str = "fused_pw_bn_act",
             config=None):
    """The pointwise kernel; `config` forces a GEMM configuration (else
    `gemm_plan`'s)."""
    _check_operands(x2d, wf, bias32)
    x2d, wf = x2d.contiguous(), wf.contiguous()
    m, cin = x2d.shape
    cout = wf.shape[1]
    config = _gemm_config(config, m, cin, cout, x2d, wf)
    return _launch("fused_pw_bn_act", (x2d, wf, bias32), (m, cout),
                   (m, cin, cout, _ACT_CODE[act], config), count)


def _conv_cuda(x, wf, bias32, act: str, count: str = "fused_conv_bn_act",
               config=None):
    """The implicit-GEMM conv kernel; `config` forces a GEMM configuration
    (else `gemm_plan`'s over M = B*T*H*W, K = taps*Cin, N = Cout)."""
    _check_operands(x, wf, bias32)
    x, wf = x.contiguous(), wf.contiguous()
    b, t, h, w, cin = x.shape
    kt, kh, kw, _, cout = wf.shape
    config = _gemm_config(config, b * t * h * w, kt * kh * kw * cin, cout, x, wf)
    return _launch("fused_conv_bn_act", (x, wf, bias32), (b, t, h, w, cout),
                   (b, t, h, w, cin, cout, kt, kh, kw, _ACT_CODE[act], config),
                   count)


# --- the depthwise stencil's plan (csrc/depthwise3d.cu) -----------------------

# (name, CC, HB, WB, blocks per SM) of the tiles of csrc/depthwise3d.cu, in
# the order of its `DwTileOf` table: channels, output rows and columns of a
# block, and the blocks an SM holds (its launch bounds). The rest of each
# tile, its register strips and planes in flight, lives there only.
DW_TILES = (
    ("h7", 64, 7, 7, 2),
    ("n24", 24, 8, 14, 3),
)
# how the input planes reach shared memory, by config id % 4, with the
# multiple C must be of and the byte alignment x needs: 16-, 8- and 4-byte
# cp.async, plain loads
DW_PATHS = (("cp16", 8, 16), ("cp8", 4, 8), ("cp4", 2, 4), ("plain", 1, 1))
DW_CONFIGS = len(DW_TILES) * len(DW_PATHS)
# the plan's cost of copying one T-halo plane, in planes of products
DW_HALO_COST = 0.5


def dw_tile(config: int):
    """(name, CC, HB, WB, blocks per SM) of a depthwise config id."""
    return DW_TILES[config // len(DW_PATHS)]


def dw_path(config: int) -> str:
    return DW_PATHS[config % len(DW_PATHS)][0]


def dw_config(tile: str, path: str) -> int:
    """The config id (tile * 4 + path) of a tile and a path by name."""
    names = [t[0] for t in DW_TILES]
    return names.index(tile) * len(DW_PATHS) + [p[0] for p in DW_PATHS].index(path)


def dw_grid(b: int, t: int, h: int, w: int, c: int, config: int, tchunk: int) -> int:
    """Blocks of a launch: T chunks x W tiles x H tiles x channel chunks x B
    (the kernel decodes blockIdx in that order, T chunk fastest)."""
    _, cc, hb, wb, _ = dw_tile(config)
    return _cdiv(t, tchunk) * _cdiv(w, wb) * _cdiv(h, hb) * _cdiv(c, cc) * b


def dw_tchunk(b: int, t: int, h: int, w: int, c: int, kt: int, config: int,
              sms: int = H100_SMS) -> int:
    """The output planes a block walks in `config`: of the chunks that give
    at least two blocks per SM (all of T where B x tiles already do), the one
    that costs least as waves of resident blocks x (planes of products + the
    T halo's kt - 1 copies at DW_HALO_COST each); 1 where none does."""
    resident = sms * dw_tile(config)[4]

    def cost(n):
        waves = _cdiv(dw_grid(b, t, h, w, c, config, n), resident)
        return waves * (n + DW_HALO_COST * (kt - 1)), -n

    enough = [n for n in range(1, t + 1)
              if dw_grid(b, t, h, w, c, config, n) >= 2 * sms]
    return min(enough, key=cost) if enough else 1


@functools.lru_cache(maxsize=None)
def dw_plan(b: int, t: int, h: int, w: int, c: int, kt: int, kh: int, kw: int,
            sms: int = H100_SMS, align: int = 16):
    """(config id, T chunk) the depthwise stencil runs x (b, t, h, w, c) with
    odd (kt, kh, kw) taps in, on a card of `sms` SMs; `align` is the largest
    power of two up to 16 dividing x's byte address.

    - Path: 16-byte cp.async where C % 8 == 0 (X3D's 24, 216, 432, every CSN
      and MViT width), 8-byte where C % 4 == 0 (108), 4-byte where C is even
      (54), plain loads otherwise.
    - Tile: n24 for C <= 24 (X3D's stem), h7 otherwise (7 x 7 outputs: every
      site's H and W is a multiple of 7).
    - T chunk: `dw_tchunk`. kh and kw choose nothing: the kernel sizes each
      plane's halo from them at launch."""
    path = next(i for i, (_, mult, need) in enumerate(DW_PATHS)
                if c % mult == 0 and align % need == 0)
    tile = "n24" if c <= 24 else "h7"
    config = dw_config(tile, DW_PATHS[path][0])
    return config, dw_tchunk(b, t, h, w, c, kt, config, sms)


def dw_attrs(config: int, taps) -> dict:
    """Build facts of the depthwise kernel that a launch in `config` with
    `taps` (kt, kh, kw) runs, on the current card: registers and local
    memory (spill) bytes a thread, dynamic shared memory a block, resident
    blocks per SM, and the taps it is compiled for ((0, 0, 0): generic)."""
    from pytorchvideo_accelerate_tpu_torch.ops import _build

    out = (ctypes.c_int * 5)()
    rc = _build.entry("depthwise3d.attrs")(config, *taps, out)
    if rc != 0:
        raise RuntimeError(f"depthwise config {config} taps {taps} attributes: CUDA error {rc}")
    facts = dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), out))
    facts["compiled_taps"] = (out[4] // 100, out[4] // 10 % 10, out[4] % 10)
    return facts


def _dw_cuda(x, k, bias32, act: str, count: str, config=None, tchunk=None):
    """The depthwise stencil (csrc/depthwise3d.cu) on NDHWC x and
    (kt,kh,kw,1,C) odd taps: `fused_dw_bn_act` with the f32 bias and act, or
    `depthwise3d_s1` (no bias, no act) when `bias32` is None. `config` and
    `tchunk` force a configuration and T chunk (else `dw_plan`'s; a forced
    config alone takes `dw_tchunk`'s)."""
    _check_operands(x, k, bias32)
    x = x.contiguous()
    b, t, h, w, c = x.shape
    kt, kh, kw, one, kc = k.shape
    if one != 1 or kc != c or not all(d % 2 for d in (kt, kh, kw)):
        raise ValueError(f"depthwise kernel takes odd (kt,kh,kw,1,C) taps for "
                         f"x {tuple(x.shape)}, got {tuple(k.shape)}")
    align = _align(x)
    sms = _sm_count(x.device.index or 0)
    if config is None:
        config, planned = dw_plan(b, t, h, w, c, kt, kh, kw, sms, align)
    elif not 0 <= config < DW_CONFIGS:
        raise ValueError(f"depthwise config {config} is not one of depthwise3d.cu's")
    else:
        planned = dw_tchunk(b, t, h, w, c, kt, config, sms)
    _, mult, need = DW_PATHS[config % len(DW_PATHS)]
    if c % mult or align % need:
        raise ValueError(f"depthwise config {config} ({dw_path(config)}) needs C a "
                         f"multiple of {mult} and x {need}-byte aligned, got C {c}, "
                         f"alignment {align}")
    tchunk = planned if tchunk is None else tchunk
    if tchunk < 1:
        raise ValueError(f"depthwise T chunk must be >= 1, got {tchunk}")
    k2d = k.reshape(kt * kh * kw, c)
    dims = (b, t, h, w, c, kt, kh, kw)
    plan = (config, tchunk)
    if bias32 is None:
        return _launch("depthwise3d_s1", (x, k2d), x.shape, dims + plan, count)
    return _launch("fused_dw_bn_act", (x, k2d, bias32), x.shape,
                   dims + (_ACT_CODE[act],) + plan, count)


# --- custom autograd (the JAX package's _pw_pallas / _conv_pallas VJPs) -----


def _pw_apply(x2d, wf, bias32, act, kernel: bool, count="fused_pw_bn_act"):
    if kernel:
        return _pw_cuda(x2d, wf, bias32, act, count)
    return pw_bn_act_plain(x2d, wf, bias32, act)


def _conv_apply(x, wf, bias32, act, kernel: bool, count="fused_conv_bn_act"):
    if kernel:
        return _conv_cuda(x, wf, bias32, act, count)
    return conv_bn_act_plain(x, wf, bias32, act)


def _dw_apply(x, kf, bias32, act, kernel: bool, count="fused_dw_bn_act"):
    if kernel:
        return _dw_cuda(x, kf, bias32, act, count)
    return dw_bn_act_plain(x, kf, bias32, act)


def _dz(g, z_fn, act: str):
    """dz32 = g * act'(z) in f32. The pre-activation z is recomputed by
    `z_fn` (remat, as the JAX VJP does), except for "identity", whose act'
    is 1 (every training call)."""
    dz32 = f32_island(g)
    if act != "identity":
        dz32 = dz32 * act_grad(f32_island(z_fn()), act)
    return dz32


class PwBnAct(torch.autograd.Function):
    """act(x2d @ wf + bias32) over (M, Cin) rows, wf scale-folded, with the
    backward of `_pw_bwd` (pallas_fused.py): dx = dz @ wf^T through the same
    kernel, dwf = x2d^T @ dz32 and db = sum(dz32) in f32."""

    @staticmethod
    def forward(ctx, x2d, wf, bias32, act: str, kernel: bool):
        ctx.act, ctx.kernel = act, kernel
        ctx.save_for_backward(x2d, wf, bias32)
        return _pw_apply(x2d, wf, bias32, act, kernel)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x2d, wf, bias32 = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dz32 = _dz(g, lambda: _pw_apply(x2d, wf, bias32, "identity",
                                        ctx.kernel), ctx.act)
        dx = dwf = db = None
        if need_x:
            dz = end_island(dz32, x2d.dtype)
            zeros = torch.zeros(wf.shape[0], dtype=torch.float32,
                                device=wf.device)
            dx = _pw_apply(dz, wf.t().contiguous(), zeros, "identity",
                           ctx.kernel, "fused_pw_bn_act.bwd_dx")
        if need_w:
            dwf = end_island(f32_island(x2d).t() @ dz32, wf.dtype)
        if need_b:
            db = dz32.sum(dim=0)
        return dx, dwf, db, None, None


class ConvBnAct(torch.autograd.Function):
    """act(conv3d_s1(x, wf) + bias32), SAME k//2 padding, wf scale-folded,
    with the backward of `_conv_bwd` (pallas_fused.py): dx by the same kernel
    against the tap-flipped, channel-transposed weights (the stride-1
    transpose conv is the same stencil), dwf by per-tap f32 contractions
    over the padded input, db = sum(dz32)."""

    @staticmethod
    def forward(ctx, x, wf, bias32, act: str, kernel: bool):
        ctx.act, ctx.kernel = act, kernel
        ctx.save_for_backward(x, wf, bias32)
        return _conv_apply(x, wf, bias32, act, kernel)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, wf, bias32 = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        kt, kh, kw, cin, cout = wf.shape
        dz32 = _dz(g, lambda: _conv_apply(x, wf, bias32, "identity",
                                          ctx.kernel), ctx.act)
        dx = dwf = db = None
        if need_x:
            dz = end_island(dz32, x.dtype).contiguous()
            wt = wf.flip(0, 1, 2).transpose(3, 4).contiguous()
            zeros = torch.zeros(cin, dtype=torch.float32, device=wf.device)
            dx = _conv_apply(dz, wt, zeros, "identity", ctx.kernel,
                             "fused_conv_bn_act.bwd_dx")
        if need_w:
            xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2,
                           kt // 2, kt // 2))
            t, h, w = x.shape[1:4]
            dz2d = dz32.reshape(-1, cout)
            taps = [f32_island(xp[:, dt:dt + t, dh:dh + h, dw:dw + w, :])
                    .reshape(-1, cin).t() @ dz2d
                    for dt in range(kt) for dh in range(kh) for dw in range(kw)]
            dwf = end_island(torch.stack(taps).reshape(kt, kh, kw, cin, cout),
                             wf.dtype)
        if need_b:
            db = dz32.sum(dim=(0, 1, 2, 3))
        return dx, dwf, db, None, None


class DwBnAct(torch.autograd.Function):
    """act(depthwise_conv3d_s1(x, kf) + bias32), SAME k//2 padding, kf
    (kt,kh,kw,1,C) scale-folded, with the backward of `_dw_bwd`
    (pallas_fused.py): dx by the same kernel on bf16 dz against the
    tap-flipped taps (zero bias, identity), dkf by per-tap f32 reductions
    over the padded input, db = sum(dz32)."""

    @staticmethod
    def forward(ctx, x, kf, bias32, act: str, kernel: bool):
        ctx.act, ctx.kernel = act, kernel
        ctx.save_for_backward(x, kf, bias32)
        return _dw_apply(x, kf, bias32, act, kernel)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, kf, bias32 = ctx.saved_tensors
        need_x, need_k, need_b = ctx.needs_input_grad[:3]
        dz32 = _dz(g, lambda: _dw_apply(x, kf, bias32, "identity",
                                        ctx.kernel), ctx.act)
        dx = dkf = db = None
        if need_x:
            dz = end_island(dz32, x.dtype).contiguous()
            zeros = torch.zeros(kf.shape[-1], dtype=torch.float32,
                                device=kf.device)
            dx = _dw_apply(dz, kf.flip(0, 1, 2), zeros, "identity",
                           ctx.kernel, "fused_dw_bn_act.bwd_dx")
        if need_k:
            dkf = end_island(depthwise_tap_grads_f32(x, dz32, kf.shape[:3]),
                             kf.dtype)
        if need_b:
            db = dz32.sum(dim=(0, 1, 2, 3))
        return dx, dkf, db, None, None


# --- public dispatchers ------------------------------------------------------


def fused_pointwise_bn_act(x, w, scale, bias, *, act: str = "identity",
                           mode: str = "auto"):
    """(1,1,1) conv + resolved norm affine + act. x: (B,T,H,W,Cin);
    w: (1,1,1,Cin,Cout) or (Cin,Cout); scale/bias: (Cout,) f32."""
    if act not in _ACT_CODE:
        raise ValueError(f"fused act must be one of {FUSED_ACTS}, got {act!r}")
    if w.dim() == 5:
        w = w.reshape(w.shape[-2], w.shape[-1])
    cin, cout = w.shape
    scale32, bias32 = f32_island(scale), f32_island(bias)
    wf = end_island(f32_island(w) * scale32, x.dtype)
    x2d = x.reshape(-1, cin)
    if mode == "xla":
        y = pw_bn_act_plain(x2d, wf, bias32, act)
    else:
        y = PwBnAct.apply(x2d, wf, bias32, act, _use_kernel(mode, x))
    return y.reshape(*x.shape[:-1], cout)


def fused_conv3d_bn_act(x, w, scale, bias, *, act: str = "identity",
                        mode: str = "auto"):
    """Dense stride-1 SAME conv + resolved norm affine + act.
    x: (B,T,H,W,Cin); w: (kt,kh,kw,Cin,Cout); scale/bias: (Cout,) f32.
    (1,1,1) weights route to the pointwise kernel; even taps run the plain
    version (the kernel hard-codes odd SAME geometry)."""
    if act not in _ACT_CODE:
        raise ValueError(f"fused act must be one of {FUSED_ACTS}, got {act!r}")
    kt, kh, kw = w.shape[:3]
    if (kt, kh, kw) == (1, 1, 1):
        return fused_pointwise_bn_act(x, w, scale, bias, act=act, mode=mode)
    scale32, bias32 = f32_island(scale), f32_island(bias)
    wf = end_island(f32_island(w) * scale32, x.dtype)
    kernel = _use_kernel(mode, x)
    if mode == "xla" or not all(k % 2 for k in (kt, kh, kw)):
        return conv_bn_act_plain(x, wf, bias32, act)
    return ConvBnAct.apply(x, wf, bias32, act, kernel)


def fused_depthwise_bn_act(x, k, scale, bias, *, act: str = "identity",
                           mode: str = "auto"):
    """Depthwise stride-1 SAME conv + resolved norm affine + act.
    x: (B,T,H,W,C); k: (kt,kh,kw,1,C); scale/bias: (C,) f32. The scale folds
    into the per-channel taps in f32, rounded to x's dtype; even taps run the
    plain version (the kernel hard-codes odd SAME geometry)."""
    if act not in _ACT_CODE:
        raise ValueError(f"fused act must be one of {FUSED_ACTS}, got {act!r}")
    scale32, bias32 = f32_island(scale), f32_island(bias)
    kf = end_island(f32_island(k) * scale32, x.dtype)
    kernel = _use_kernel(mode, x)
    if mode == "xla" or not all(d % 2 for d in k.shape[:3]):
        return dw_bn_act_plain(x, kf, bias32, act)
    return DwBnAct.apply(x, kf, bias32, act, kernel)
