"""Fused conv -> norm-affine -> activation for the 3D-CNN hot paths.

The counterpart of the JAX package's `ops/pallas_fused.py`, same public
functions, same NDHWC layout, same `mode` vocabulary:

- `fused_pointwise_bn_act`: (1,1,1) conv + per-channel affine + act, a GEMM
  over (B*T*H*W, Cin) rows; on the card `csrc/fused_pw_bn_act.cu`.
- `fused_conv3d_bn_act`: dense stride-1 SAME conv with odd taps + affine +
  act; on the card `csrc/fused_conv_bn_act.cu` (implicit GEMM). A (1,1,1)
  weight routes to the pointwise kernel, even taps to the plain version.

Norm-affine contract: callers pass the resolved per-channel (scale, bias).
The scale folds into the weights in f32 and the folded weight is rounded to
x's dtype, so the kernels carry only a bias + act epilogue.

Lowering (`mode`): "auto" launches the CUDA kernel for a CUDA tensor and runs
the plain PyTorch version for a CPU tensor; "pallas" always launches the
hand kernel (the name is kept so configs round-trip with the JAX package) and
raises on a CPU tensor; "xla" runs the plain version. Nothing falls back: a
kernel that fails to build or launch raises.

The kernels take bf16 only; a float32 tensor on the card raises (use
`--model.fused_kernels off` or `xla` for `--mixed_precision fp32`).

Each kernel wrapper counts its launches in `LAUNCHES` (a plain int per
kernel, bumped only where the kernel is launched) so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from pytorchvideo_accelerate_tpu_torch.precision import end_island, f32_island

FUSED_ACTS = ("identity", "relu", "silu")
_ACT_CODE = {"identity": 0, "relu": 1, "silu": 2}

# launches per kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {"fused_pw_bn_act": 0, "fused_conv_bn_act": 0}


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


# --- CUDA kernel wrappers ----------------------------------------------------


def _check_operands(x, wf, bias32):
    if x.dtype != torch.bfloat16 or wf.dtype != torch.bfloat16:
        raise TypeError(
            "the fused CUDA kernels take bfloat16 activations and weights, "
            f"got {x.dtype}/{wf.dtype}; run --mixed_precision bf16, or "
            "--model.fused_kernels off|xla for float32")
    if bias32.dtype != torch.float32:
        raise TypeError(f"fused bias must be float32, got {bias32.dtype}")
    if not (x.device == wf.device == bias32.device):
        raise ValueError("fused kernel operands must share one CUDA device")
    if max(x.numel(), wf.numel()) >= 2 ** 31:
        raise ValueError("fused kernel operands must hold < 2**31 elements")


def _launch(name: str, x, wf, bias32, out_shape, dims, act: str):
    """Launch kernel `name` on the current stream: (x, wf, bias32, out,
    *dims, act code, stream) -> CUDA error code. Counts the launch."""
    from pytorchvideo_accelerate_tpu_torch.ops import _build

    _check_operands(x, wf, bias32)
    x, wf, bias32 = x.contiguous(), wf.contiguous(), bias32.contiguous()
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), wf.data_ptr(), bias32.data_ptr(),
                out.data_ptr(), *dims, _ACT_CODE[act], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def _pw_cuda(x2d, wf, bias32, act: str):
    m, cin = x2d.shape
    cout = wf.shape[1]
    return _launch("fused_pw_bn_act", x2d, wf, bias32, (m, cout),
                   (m, cin, cout), act)


def _conv_cuda(x, wf, bias32, act: str):
    b, t, h, w, cin = x.shape
    kt, kh, kw, _, cout = wf.shape
    return _launch("fused_conv_bn_act", x, wf, bias32, (b, t, h, w, cout),
                   (b, t, h, w, cin, cout, kt, kh, kw), act)


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
    if _use_kernel(mode, x):
        y = _pw_cuda(x2d, wf, bias32, act)
    else:
        y = pw_bn_act_plain(x2d, wf, bias32, act)
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
    if not _use_kernel(mode, x) or not all(k % 2 for k in (kt, kh, kw)):
        return conv_bn_act_plain(x, wf, bias32, act)
    return _conv_cuda(x, wf, bias32, act)
