"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and is marked `cuda`; on a
host without a card each one skips. This file imports torch and the port
only (no JAX), so it also runs on the card's machine, without the repo's
JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: both versions multiply bf16 operands exactly, accumulate in f32
and round once to bf16, so they differ by about one bf16 ulp plus the f32
summation order: elementwise |kernel - plain| <= 1e-2 * (1 + |plain|). The
backward's dx launch is held to the same bound against the plain dx on the
same bf16 dz; dw and db are f32 contractions that the kernel path and the
plain path compute alike (2e-3 relative). The GEMM engine under both
(`csrc/fused_gemm.cuh`) is held in every tile configuration x copy path,
forced past `gemm_plan`, forward and dx, a second launch bitwise equal;
each configuration spills nothing and fits a block's 227 KB of shared
memory and at least one block per SM; and a res5-shaped site (K 6144, N
512) through the plan.
The flash attention kernels
(`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`) are held the
same way: the forward's out and lse, and dq, dk, dv from the same (out,
lse), against `flash_fwd_plain` / `flash_bwd_plain` at a ragged MViT shape
(Nq != Nk, D 96), a ViT one (D 64), shapes where dk/dv splits its query
loop, D 16, 32 and 128, and Nq < 16 against one key, lse also within 1e-4
absolute (f32 all through); two forward and two backward launches are
bitwise equal; the forward spills nothing at D 64 and 96 and fits two
blocks on an SM. The depthwise kernel
(`csrc/depthwise3d.cu`) is held the same way through both of its entry
points: `fused_depthwise_bn_act` (forward and the `DwBnAct` dx; its dk
and dscale, which pass through bf16-rounded folded taps, within one bf16
ulp, 1e-2 relative) and `Depthwise3dS1` (forward and dx); in every tile x
copy path forced past `dw_plan`, with both fixed tap instantiations and
the generic one, at T chunks of 1, 2, all of T and the plan's, a second
launch bitwise equal; no configuration spills; launch counts through both
autograd Functions. A tiny3d and a
tiny X3D training micro-step through the kernels against the plain
lowering (`xla`, TF32 off): loss within 5e-2 * (1 + |loss|), the whole
gradient within 5e-2 relative (every layer rounds to bf16 in another
summation order). An int8 tiny3d engine (baked, or quantized on the fly:
bitwise the same logits) holds int8 weights on the card and launches the
fp engine's kernels, launch for launch, keeping its top-1; `build_server`
with no scheduler flag serves through the EDF scheduler on the card, sheds
a request whose deadline is half the measured service time, counts both
in /metrics and drains. Two spawned ranks over gloo share the card for a
tiny3d data-parallel step through the kernels (`tests/_torch_dp_worker.py`,
which imports no JAX either): bitwise equal to each other, every fused
site launched forward and dx on each, the global loss within 5e-2 * (1 +
|loss|) of one process on the whole batch. The same two ranks run
full-width MViT-B 16x4's forward tensor-parallel at (data, model) = (1, 2)
(the smoke's model_axis_train arm (a)): their logits equal, within 5e-2 *
(1 + |logit|) of one process's, each rank launching the flash and
stride-1 depthwise kernels once per block and pool on its local heads.
Streaming sessions on the card: slowfast_t's dual rings (the fused
kernels) and videomae_t's token ring (the flash forward) advance through a
wraparound, each launch within 5e-2 * (1 + |logit|) of `full_recompute` of
the client's window, the kernels launched on every step. The fleet: two
slowfast_t replicas behind a router, hot-swapped blue to green under an
open-loop load with zero failures, each response within 5e-2 * (1 +
|oracle|) of blue's or green's plain-path logits, green's after the swap.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pytorchvideo_accelerate_tpu_torch.ops import depthwise, flash_attention, fused

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels compile with nvcc on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, cin, cout, taps, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape + (cin,), np.float32))
    fan_in = cin * int(np.prod(taps))
    w = torch.from_numpy(rng.standard_normal(taps + (cin, cout), np.float32)
                         / np.sqrt(fan_in))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1)
    return (x.to(device, torch.bfloat16), w.to(device, torch.bfloat16),
            scale.to(device), bias.to(device))


def _check(got, want):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    excess = (got - want).abs() - 1e-2 * (1 + want.abs())
    assert excess.max().item() <= 0, f"max excess {excess.max().item()}"


@pytest.mark.parametrize("act", ["identity", "relu", "silu"])
@pytest.mark.parametrize("shape,cin,cout,taps", [
    ((2, 3, 5, 7), 8, 24, (1, 1, 1)),      # Cin 8, ragged M
    ((1, 4, 9, 11), 80, 64, (1, 1, 1)),    # slow res2 entry width
    ((1, 2, 3, 5), 12, 10, (1, 1, 1)),     # Cin, Cout not multiples of 8
    ((2, 5, 6, 7), 8, 8, (3, 1, 1)),       # fast conv_a
    ((1, 3, 9, 10), 64, 64, (1, 3, 3)),    # conv_b
    ((1, 5, 7, 6), 12, 20, (3, 3, 3)),     # odd taps, 4-byte gather path
    ((1, 6, 4, 4), 32, 16, (5, 1, 1)),
])
def test_kernel_matches_plain(cuda, shape, cin, cout, taps, act):
    x, w, s, b = _inputs(shape, cin, cout, taps, 0, cuda)
    before = dict(fused.LAUNCHES)
    got = fused.fused_conv3d_bn_act(x, w, s, b, act=act, mode="pallas")
    want = fused.fused_conv3d_bn_act(x, w, s, b, act=act, mode="xla")
    torch.cuda.synchronize()
    _check(got, want)
    name = "fused_pw_bn_act" if taps == (1, 1, 1) else "fused_conv_bn_act"
    assert fused.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("shape,cin,cout,taps", [
    ((2, 3, 5, 7), 8, 24, (1, 1, 1)),      # Cin 8, ragged M
    ((1, 2, 3, 5), 12, 10, (1, 1, 1)),     # Cin, Cout not multiples of 8
    ((2, 5, 6, 7), 8, 8, (3, 1, 1)),       # fast conv_a: dx Cout' = 8
    ((1, 3, 9, 10), 64, 32, (1, 3, 3)),    # conv_b
    ((1, 5, 7, 6), 12, 20, (3, 3, 3)),     # 4-byte gather path both ways
])
def test_backward_dx_kernel_matches_plain(cuda, shape, cin, cout, taps, act):
    x, w, s, b = _inputs(shape, cin, cout, taps, 1, cuda)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        shape + (cout,), np.float32)).to(cuda, torch.bfloat16)
    grads = {}
    for mode in ("pallas", "xla"):
        xr = x.clone().requires_grad_()
        wr = w.float().requires_grad_()
        sr, br = s.clone().requires_grad_(), b.clone().requires_grad_()
        y = fused.fused_conv3d_bn_act(xr, wr.bfloat16(), sr, br, act=act,
                                      mode=mode)
        key = ("fused_pw_bn_act" if taps == (1, 1, 1)
               else "fused_conv_bn_act") + ".bwd_dx"
        before = fused.LAUNCHES[key]
        y.backward(g)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == before + (mode == "pallas")
        grads[mode] = [t.grad for t in (xr, wr, sr, br)]
    _check(grads["pallas"][0], grads["xla"][0])
    for got, want in zip(grads["pallas"][1:], grads["xla"][1:]):
        err = (got - want).abs().max().item()
        assert err <= 2e-3 * (1 + want.abs().max().item()), err


# per copy path of the GEMM engine (csrc/fused_gemm.cuh): a pointwise (M,
# Cin, Cout) and a conv (x spatial shape, Cin, Cout, taps) whose K and N suit
# the path both ways (forward, and dx with K and N swapped), none a tile
# multiple: M ragged against every BM, K ragged against BK (taps straddled
# by a step at Cin 16 and 12), N over one 128-wide tile
GEMM_CASES = {
    "cp16": ((1000, 200, 136), ((2, 5, 7, 9), 16, 40, (3, 3, 3))),
    "cp4": ((777, 54, 108), ((1, 5, 7, 6), 12, 20, (3, 3, 3))),
    "scalar": ((333, 13, 21), ((1, 4, 5, 6), 5, 7, (3, 1, 3))),
}


def _gemm_launches(kernel, config, case, act, seed, device):
    """(kernel, plain) outputs of the forward and the dx launch (the same
    kernel on a bf16 dz against the transposed, for a conv tap-flipped,
    weights with a zero bias) in one forced GEMM configuration."""
    rng = np.random.default_rng(seed)
    if kernel == "fused_pw_bn_act":
        m, cin, cout = case
        x, w, _, b = _inputs((m,), cin, cout, (), seed, device)
        dz = torch.from_numpy(rng.standard_normal((m, cout), np.float32)).to(
            device, torch.bfloat16)
        wt, zeros = w.t().contiguous(), torch.zeros(cin, device=device)
        return [(fused._pw_cuda(x, w, b, act, config=config),
                 fused.pw_bn_act_plain(x, w, b, act)),
                (fused._pw_cuda(dz, wt, zeros, "identity", config=config),
                 fused.pw_bn_act_plain(dz, wt, zeros, "identity"))]
    shape, cin, cout, taps = case
    x, w, _, b = _inputs(shape, cin, cout, taps, seed, device)
    dz = torch.from_numpy(rng.standard_normal(shape + (cout,), np.float32)).to(
        device, torch.bfloat16)
    wt = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    zeros = torch.zeros(cin, device=device)
    return [(fused._conv_cuda(x, w, b, act, config=config),
             fused.conv_bn_act_plain(x, w, b, act)),
            (fused._conv_cuda(dz, wt, zeros, "identity", config=config),
             fused.conv_bn_act_plain(dz, wt, zeros, "identity"))]


@pytest.mark.parametrize("kernel", ["fused_pw_bn_act", "fused_conv_bn_act"])
@pytest.mark.parametrize("config", range(fused.GEMM_CONFIGS))
def test_gemm_every_config_matches_plain(cuda, config, kernel):
    """Every tile configuration x copy path, forced through the plan, forward
    (silu) and dx against the plain versions; a second launch bitwise
    equal to the first (each output is one block's sum in a fixed order)."""
    case = GEMM_CASES[fused.gemm_path(config)][kernel == "fused_conv_bn_act"]
    first = _gemm_launches(kernel, config, case, "silu", config, cuda)
    again = _gemm_launches(kernel, config, case, "silu", config, cuda)
    torch.cuda.synchronize()
    for (got, want), (got2, _) in zip(first, again):
        _check(got, want)
        assert torch.equal(got, got2)


@pytest.mark.parametrize("kernel", ["fused_pw_bn_act", "fused_conv_bn_act"])
@pytest.mark.parametrize("config", range(fused.GEMM_CONFIGS))
def test_gemm_attributes(cuda, config, kernel):
    """No configuration spills; each fits a block's 227 KB of shared memory
    and at least one block per SM."""
    attrs = fused.gemm_attrs(kernel, config)
    assert attrs["local_bytes"] == 0, attrs
    assert 0 < attrs["smem_bytes"] <= 227 * 1024, attrs
    assert attrs["blocks_per_sm"] >= 1, attrs


def test_gemm_res5_site(cuda):
    """A SlowFast res5 conv_a shape ((3,1,1), Cin 2048 -> 512: K = 6144, N =
    512) at a small M through the plan, forward and dx (K 1536, N 2048)."""
    launches = _gemm_launches("fused_conv_bn_act", None,
                              ((1, 4, 7, 7), 2048, 512, (3, 1, 1)), "relu", 11, cuda)
    torch.cuda.synchronize()
    for got, want in launches:
        _check(got, want)


DW_CASES = [
    ((2, 4, 9, 11), 54, (3, 3, 3)),   # X3D res2 width: a ragged channel tail
    ((1, 6, 7, 5), 24, (5, 1, 1)),    # X3D stem_t
    ((1, 3, 5, 6), 18, (3, 3, 3)),
    ((2, 4, 7, 7), 64, (3, 3, 3)),    # CSN res2 width
    ((1, 5, 6, 4), 8, (1, 3, 3)),     # taps sized at run time
]


def _dw_inputs(shape, c, taps, seed, device):
    x, w, s, b = _inputs(shape, 1, c, taps, seed, device)
    x = torch.from_numpy(np.random.default_rng(seed + 7).standard_normal(
        shape + (c,), np.float32)).to(device, torch.bfloat16)
    return x, w, s, b


@pytest.mark.parametrize("act", ["identity", "relu", "silu"])
@pytest.mark.parametrize("shape,c,taps", DW_CASES)
def test_dw_bn_act_kernel_matches_plain(cuda, shape, c, taps, act):
    x, k, s, b = _dw_inputs(shape, c, taps, 4, cuda)
    before = fused.LAUNCHES["fused_dw_bn_act"]
    got = fused.fused_depthwise_bn_act(x, k, s, b, act=act, mode="pallas")
    want = fused.fused_depthwise_bn_act(x, k, s, b, act=act, mode="xla")
    torch.cuda.synchronize()
    _check(got, want)
    assert fused.LAUNCHES["fused_dw_bn_act"] == before + 1


@pytest.mark.parametrize("act", ["identity", "silu"])
@pytest.mark.parametrize("shape,c,taps", DW_CASES)
def test_dw_bn_act_backward_dx_kernel_matches_plain(cuda, shape, c, taps, act):
    x, k, s, b = _dw_inputs(shape, c, taps, 5, cuda)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        shape + (c,), np.float32)).to(cuda, torch.bfloat16)
    grads = {}
    for mode in ("pallas", "xla"):
        xr = x.clone().requires_grad_()
        kr = k.float().requires_grad_()
        sr, br = s.clone().requires_grad_(), b.clone().requires_grad_()
        y = fused.fused_depthwise_bn_act(xr, kr.bfloat16(), sr, br, act=act,
                                         mode=mode)
        before = fused.LAUNCHES["fused_dw_bn_act.bwd_dx"]
        y.backward(g)
        torch.cuda.synchronize()
        assert fused.LAUNCHES["fused_dw_bn_act.bwd_dx"] == before + (mode == "pallas")
        grads[mode] = [t.grad for t in (xr, kr, sr, br)]
    _check(grads["pallas"][0], grads["xla"][0])
    # dk and dscale pass through dkf rounded to bf16 (kf's dtype, as
    # `_dw_bwd` does) on both sides; with silu the custom backward takes
    # act' at the bf16-rounded recomputed z, so a sum may round to the
    # neighbouring bf16 value: one ulp, 2^-7 relative
    for got, want in zip(grads["pallas"][1:], grads["xla"][1:]):
        err = (got - want).abs().max().item()
        assert err <= 1e-2 * (1 + want.abs().max().item()), err


@pytest.mark.parametrize("shape,c,taps", DW_CASES)
def test_depthwise3d_s1_kernel_matches_plain(cuda, shape, c, taps):
    """Forward and dx of `Depthwise3dS1` through the kernel against the same
    Function's plain version; dk is the same f32 reduction on both sides."""
    x, k, _, _ = _dw_inputs(shape, c, taps, 8, cuda)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        shape + (c,), np.float32)).to(cuda, torch.bfloat16)
    out = {}
    for kernel in (True, False):
        xr, kr = x.clone().requires_grad_(), k.clone().requires_grad_()
        before = dict(fused.LAUNCHES)
        y = depthwise.Depthwise3dS1.apply(xr, kr, kernel)
        y.backward(g)
        torch.cuda.synchronize()
        for key in ("depthwise3d_s1", "depthwise3d_s1.bwd_dx"):
            assert fused.LAUNCHES[key] == before[key] + kernel
        out[kernel] = (y, xr.grad, kr.grad)
    for got, want in zip(out[True][:2], out[False][:2]):
        _check(got, want)
    torch.testing.assert_close(out[True][2], out[False][2], rtol=2e-2, atol=2e-2)


# a small twin of each depthwise site class per copy path, (shape, C): the
# X3D stem's C 24 (the n24 tile), CSN's 64 and X3D's 432 (seven channel
# chunks, the last ragged), 108 and 54 (the 8- and 4-byte paths), an odd C
# (plain loads); H 16, 14 and 7 against the tiles' 8 and 7 rows, ragged W
DW_SITE_TWINS = {
    "cp16": [((2, 6, 16, 28), 24), ((2, 5, 14, 14), 64), ((1, 4, 7, 7), 432)],
    "cp8": [((2, 5, 14, 15), 108)],
    "cp4": [((2, 4, 14, 11), 54)],
    "plain": [((1, 3, 7, 9), 5)],
}
DW_TAP_VARIANTS = [(3, 3, 3), (5, 1, 1), (3, 5, 5)]


def _dw_launches(x, k, b, act, config, tchunk):
    """Forward (bias + act) and dx (the tap-flipped taps, no bias) through
    both entry points, in a forced configuration and T chunk."""
    kflip, c = k.flip(0, 1, 2).contiguous(), x.shape[-1]
    zeros = torch.zeros(c, device=x.device)
    return [
        (fused._dw_cuda(x, k, b, act, "fused_dw_bn_act", config, tchunk),
         fused.dw_bn_act_plain(x, k, b, act)),
        (fused._dw_cuda(x, kflip, zeros, "identity", "fused_dw_bn_act.bwd_dx", config, tchunk),
         fused.dw_bn_act_plain(x, kflip, zeros, "identity")),
        (fused._dw_cuda(x, k, None, "identity", "depthwise3d_s1", config, tchunk),
         depthwise.depthwise_conv3d_shift(x, k)),
    ]


@pytest.mark.parametrize("taps", DW_TAP_VARIANTS)
@pytest.mark.parametrize("config", range(fused.DW_CONFIGS))
def test_dw_every_config_matches_plain(cuda, config, taps):
    """Every depthwise tile x copy path, forced past `dw_plan`, with the two
    fixed tap instantiations and the generic one, at the site twins of its
    path, at T chunks of 1, 2, all of T and the plan's: forward (silu), dx
    and the unfused entry point against the plain versions, a second launch
    bitwise equal to the first."""
    for shape, c in DW_SITE_TWINS[fused.dw_path(config)]:
        x, k, _, b = _dw_inputs(shape, c, taps, config, cuda)
        for tchunk in (1, 2, shape[1], None):
            first = _dw_launches(x, k, b, "silu", config, tchunk)
            again = _dw_launches(x, k, b, "silu", config, tchunk)
            torch.cuda.synchronize()
            for (got, want), (got2, _) in zip(first, again):
                _check(got, want)
                assert torch.equal(got, got2), (shape, c, tchunk)


@pytest.mark.parametrize("taps", DW_TAP_VARIANTS)
@pytest.mark.parametrize("config", range(fused.DW_CONFIGS))
def test_dw_attributes(cuda, config, taps):
    """No depthwise configuration spills in any tap instantiation; each fits
    a block's 227 KB of shared memory and, with fixed taps, the blocks per
    SM `dw_plan` counts on."""
    attrs = fused.dw_attrs(config, taps)
    assert attrs["local_bytes"] == 0, attrs
    assert 0 < attrs["smem_bytes"] <= 227 * 1024, attrs
    assert attrs["blocks_per_sm"] >= (fused.dw_tile(config)[4] if taps != (3, 5, 5) else 1), attrs


@pytest.mark.parametrize("act", ["identity", "silu"])
def test_dw_autograd_launch_counts(cuda, act):
    """`DwBnAct`: one forward launch, one more to recompute z for a non-identity
    act, one dx launch; `Depthwise3dS1`: one forward, one dx."""
    x, k, s, b = _dw_inputs((2, 4, 14, 14), 64, (3, 3, 3), 11, cuda)
    xr = x.clone().requires_grad_()
    before = dict(fused.LAUNCHES)
    fused.fused_depthwise_bn_act(xr, k, s, b, act=act, mode="pallas").float().sum().backward()
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_dw_bn_act"] - before["fused_dw_bn_act"] == 1 + (act != "identity")
    assert fused.LAUNCHES["fused_dw_bn_act.bwd_dx"] - before["fused_dw_bn_act.bwd_dx"] == 1
    xr = x.clone().requires_grad_()
    before = dict(fused.LAUNCHES)
    depthwise.Depthwise3dS1.apply(xr, k, True).float().sum().backward()
    torch.cuda.synchronize()
    for key in ("depthwise3d_s1", "depthwise3d_s1.bwd_dx"):
        assert fused.LAUNCHES[key] - before[key] == 1


def test_tiny_x3d_train_micro_step_kernels_match_plain(cuda):
    from pytorchvideo_accelerate_tpu_torch.models import init_like_jax
    from pytorchvideo_accelerate_tpu_torch.models.x3d import X3D
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
        _loss_and_metrics,
    )

    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((4, 8, 64, 64, 3), np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 5, 4)).to(cuda)
    out = {}
    for mode in ("auto", "xla"):
        model = X3D(5, depths=(3, 2), stem_features=8, stage_features=(8, 16),
                    head_features=32, dropout_rate=0.0, fused=mode,
                    dtype=torch.bfloat16)
        init_like_jax(model, torch.Generator().manual_seed(1))
        model = model.to(cuda).train()
        before = dict(fused.LAUNCHES)
        loss, _, _ = _loss_and_metrics(model(x), labels,
                                       torch.ones(4, device=cuda), 0.0)
        loss.backward()
        torch.cuda.synchronize()
        launched = {k: fused.LAUNCHES[k] - before[k] for k in before}
        out[mode] = (loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()]),
                     launched)
    (lk, gk, nk), (lp, gp, np_) = out["auto"], out["xla"]
    assert abs(lk - lp) <= 5e-2 * (1 + abs(lp))
    assert ((gk - gp).norm() / gp.norm()).item() <= 5e-2
    # stem_t and the 3 stride-1 conv_b: one forward and one dx launch each
    assert nk["fused_dw_bn_act"] == nk["fused_dw_bn_act.bwd_dx"] == 4
    assert nk["fused_pw_bn_act"] == nk["fused_pw_bn_act.bwd_dx"] == 2 * 5 + 1
    assert not any(np_.values())


def test_tiny3d_train_micro_step_kernels_match_plain(cuda):
    from pytorchvideo_accelerate_tpu_torch.config import ModelConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
        _loss_and_metrics,
    )

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 8, 64, 64, 3), np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 5, 4)).to(cuda)
    out = {}
    for mode in ("auto", "xla"):
        model = create_model(ModelConfig(name="tiny3d", num_classes=5,
                                         fused_kernels=mode, dropout_rate=0.0),
                             "bf16", seed=1).to(cuda).train()
        before = dict(fused.LAUNCHES)
        loss, _, _ = _loss_and_metrics(model(x), labels,
                                       torch.ones(4, device=cuda), 0.0)
        loss.backward()
        torch.cuda.synchronize()
        launched = {k: fused.LAUNCHES[k] - before[k] for k in before}
        out[mode] = (loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()]),
                     launched)
    (lk, gk, nk), (lp, gp, np_) = out["auto"], out["xla"]
    assert abs(lk - lp) <= 5e-2 * (1 + abs(lp))
    assert ((gk - gp).norm() / gp.norm()).item() <= 5e-2
    # every fused site launched its kernel once forward and once for dx
    assert nk["fused_pw_bn_act"] == nk["fused_pw_bn_act.bwd_dx"] > 0
    assert nk["fused_conv_bn_act"] == nk["fused_conv_bn_act.bwd_dx"] > 0
    assert not any(np_.values())


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_mixed_guarded_step_syncs_nothing_and_skips_bitwise(cuda, optimizer):
    """A tiny3d train step through the kernels with mixup + cutmix and the
    guard's skip armed (AdamW capturable on the card) runs under
    `set_sync_debug_mode("error")`: no host round trip. A NaN batch then
    leaves the parameters, the BN running averages, the optimizer's state
    and the EMA bitwise as they were, and reports `skipped` 1."""
    from pytorchvideo_accelerate_tpu_torch.config import ModelConfig, OptimConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.reliability.guard import poison_batch
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import make_train_step
    from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

    model = create_model(ModelConfig(name="tiny3d", num_classes=5,
                                     fused_kernels="auto", dropout_rate=0.0),
                         "bf16", seed=1).to(cuda)
    opt = build_optimizer(OptimConfig(optimizer=optimizer, lr=0.01),
                          8, model.named_parameters())
    state = TrainState.create(model, opt, ema_decay=0.9)
    step = make_train_step(model, opt, accum_steps=2, ema_decay=0.9,
                           dropout_seed=0, mixup_alpha=0.8, cutmix_alpha=1.0,
                           guard_skip=True)
    rng = np.random.default_rng(4)

    def batch():
        x = rng.standard_normal((2, 4, 8, 64, 64, 3), np.float32)
        return {"video": torch.from_numpy(x).to(cuda),
                "label": torch.from_numpy(rng.integers(0, 5, (2, 4))).to(cuda)}

    def leaves():
        out = {f"m.{k}": v.clone() for k, v in model.state_dict().items()}
        out.update({f"ema.{k}": v.clone() for k, v in state.ema.items()})
        for i, p in enumerate(opt.trained):
            out.update({f"opt.{i}.{k}": v.clone()
                        for k, v in opt.opt.state[p].items()})
        return out

    step(state, batch())  # makes the optimizer's state
    clean, poisoned = batch(), poison_batch(batch())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = step(state, clean)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert m["skipped"].item() == 0.0 and torch.isfinite(m["loss"]).item()
    before = leaves()
    m = step(state, poisoned)
    assert m["skipped"].item() == 1.0 and state.step == 3
    after = leaves()
    assert sorted(after) == sorted(before)
    assert [k for k in before if not torch.equal(after[k], before[k])] == []


def test_float32_training_raises_on_the_card(cuda):
    """The kernels are bf16-only in the backward too: an f32 training step
    with the fused lowering raises TypeError before any launch."""
    from pytorchvideo_accelerate_tpu_torch.config import ModelConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model

    model = create_model(ModelConfig(name="tiny3d", num_classes=5,
                                     fused_kernels="auto"), "fp32").to(cuda)
    x = torch.zeros((2, 4, 32, 32, 3), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        model(x).sum().backward()


def test_float32_raises_on_the_card(cuda):
    x, w, s, b = _inputs((1, 2, 3, 4), 8, 8, (1, 1, 1), 0, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fused.fused_pointwise_bn_act(x.float(), w.float(), s, b, mode="auto")
    x, k, s, b = _dw_inputs((1, 3, 4, 4), 8, (3, 3, 3), 0, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fused.fused_depthwise_bn_act(x.float(), k.float(), s, b, mode="auto")
    with pytest.raises(TypeError, match="bfloat16"):
        depthwise.Depthwise3dS1.apply(x.float(), k.float(), True)


# (B, Nq, Nk, H, D): a ragged MViT-like site (q pooled grid against a
# strided K/V pool, D 96) and a ViT one (D 64); neither length a tile
# multiple. Then shapes where dk/dv splits its query loop (Nq >> Nk, small
# B*H: `dkv_splits` gives 16 and 10 on an H100), the other head dims the
# backward instantiates (16, 32, 128), and Nq < 16 against a single key.
FLASH_CASES = [(2, 200, 72, 2, 96), (1, 160, 160, 3, 64),
               (1, 1000, 72, 2, 64), (2, 600, 100, 1, 96),
               (1, 100, 90, 2, 16), (2, 77, 130, 1, 32), (1, 150, 200, 2, 128),
               (2, 5, 1, 3, 64)]


def _flash_inputs(b, nq, nk, h, d, seed, device):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device, torch.bfloat16)
    return t(b, nq, h, d), t(b, nk, h, d), t(b, nk, h, d), t(b, nq, h, d)


@pytest.mark.parametrize("b,nq,nk,h,d", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, b, nq, nk, h, d):
    q, k, v, dout = _flash_inputs(b, nq, nk, h, d, 0, cuda)
    scale = d ** -0.5
    before = dict(fused.LAUNCHES)
    out, lse = flash_attention._fwd_cuda(q, k, v, scale)
    want_out, want_lse = flash_attention.flash_fwd_plain(q, k, v, scale)
    torch.cuda.synchronize()
    _check(out, want_out)
    _check(lse, want_lse)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    dq, dk, dv = flash_attention._bwd_cuda(q, k, v, want_out, want_lse, dout,
                                           scale, True, True)
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv), flash_attention.flash_bwd_plain(
            q, k, v, want_out, want_lse, dout, scale)):
        _check(got, want)
    for key in ("flash_attention", "flash_attention.bwd_dq",
                "flash_attention.bwd_dkv"):
        assert fused.LAUNCHES[key] == before[key] + 1


@pytest.mark.parametrize("b,nq,nk,h,d", [(1, 1000, 72, 2, 64), (1, 160, 160, 3, 64)])
def test_flash_backward_is_bitwise_deterministic(cuda, b, nq, nk, h, d):
    """No atomics: dq, dk and dv of two launches on the same inputs are
    equal bit for bit, with the dk/dv query split (first shape) and
    without."""
    q, k, v, dout = _flash_inputs(b, nq, nk, h, d, 3, cuda)
    scale = d ** -0.5
    out, lse = flash_attention._fwd_cuda(q, k, v, scale)
    first = flash_attention._bwd_cuda(q, k, v, out, lse, dout, scale, True, True)
    second = flash_attention._bwd_cuda(q, k, v, out, lse, dout, scale, True, True)
    torch.cuda.synchronize()
    for got, want in zip(first, second):
        assert torch.equal(got, want)


@pytest.mark.parametrize("b,nq,nk,h,d", FLASH_CASES)
def test_flash_forward_is_bitwise_deterministic(cuda, b, nq, nk, h, d):
    q, k, v, _ = _flash_inputs(b, nq, nk, h, d, 7, cuda)
    first = flash_attention._fwd_cuda(q, k, v, d ** -0.5)
    second = flash_attention._fwd_cuda(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    for got, want in zip(first, second):
        assert torch.equal(got, want)


@pytest.mark.parametrize("d", [64, 96])
def test_flash_forward_attributes(cuda, d):
    """The register-resident forward does not spill at the path's head dims
    and leaves room for at least two blocks on an SM."""
    attrs = flash_attention.kernel_attrs("fwd", d)
    assert attrs["local_bytes"] == 0, attrs
    assert attrs["blocks_per_sm"] >= 2, attrs


def test_flash_strided_qkv_views_match_contiguous(cuda):
    """q/k/v as the split views of one qkv projection: read through their
    strides, the same result as contiguous copies."""
    b, n, h, d = 2, 130, 2, 64
    qkv = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (b, n, 3 * h * d), np.float32)).to(cuda, torch.bfloat16)
    q, k, v = (t.reshape(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    got = flash_attention.flash_attention(q, k, v)
    want = flash_attention.flash_attention(q.contiguous(), k.contiguous(),
                                           v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_flash_autograd_launches_all_three(cuda):
    q, k, v, dout = _flash_inputs(1, 96, 200, 2, 64, 5, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fused.LAUNCHES)
    flash_attention.flash_attention(*leaves).backward(dout)
    torch.cuda.synchronize()
    launched = {k_: fused.LAUNCHES[k_] - before[k_] for k_ in before}
    assert launched["flash_attention"] == 1
    assert launched["flash_attention.bwd_dq"] == 1
    assert launched["flash_attention.bwd_dkv"] == 1
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    out = flash_attention.flash_fwd_plain(*ref, 64 ** -0.5)[0]
    out.backward(dout.float())
    for got, want in zip(leaves, ref):
        assert ((got.grad.float() - want.grad).norm() / want.grad.norm()).item() <= 2e-2


def test_flash_refuses_what_the_kernels_do_not_take(cuda):
    q, k, v, _ = _flash_inputs(1, 32, 32, 1, 64, 6, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention.flash_attention(q.float(), k.float(), v.float())
    for d in (8, 24, 144):
        q, k, v, _ = _flash_inputs(1, 32, 32, 1, d, 6, cuda)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention.flash_attention(q, k, v)
    q, k, v, _ = _flash_inputs(1, 32, 32, 1, 128, 6, cuda)
    with pytest.raises(ValueError, match="last dim"):
        flash_attention.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])


def _tiny3d_artifact(tmp_path, quantization="off", frames=8, crop=64):
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import export_inference

    cfg = parse_cli(["--model.name", "tiny3d", "--model.num_classes", "5",
                     "--num_frames", str(frames), "--data.crop_size", str(crop),
                     "--model.fused_kernels", "auto", "--serve.max_batch_size", "4"])
    model = create_model(cfg.model, "bf16", seed=2)
    with torch.no_grad():  # logits O(1): the head's init draw is 0.01
        model.head.proj.weight.mul_(100.0)
    return export_inference(str(tmp_path / f"tiny3d_{quantization}_{frames}x{crop}"),
                            model, cfg,
                            meta={"num_classes": 5, "model": "tiny3d"},
                            quantization=quantization)


def test_int8_forward_makes_the_fp_launches(cuda, tmp_path):
    """An int8 engine (baked or quantized on the fly) holds int8 weights on
    the card, reaches the same kernels as the fp engine, launch for launch,
    and keeps its top-1 (the JAX package's gate: agreement >= 0.75)."""
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine

    fp_art = _tiny3d_artifact(tmp_path)
    q_art = _tiny3d_artifact(tmp_path, "int8")
    rng = np.random.default_rng(4)
    batch = {"video": rng.standard_normal((4, 8, 64, 64, 3)).astype(np.float32)}
    out = {}
    for label, art, q in (("fp", fp_art, None), ("baked", q_art, None),
                          ("fly", fp_art, "int8")):
        eng = InferenceEngine.from_artifact(art, quantization=q)
        before = dict(fused.LAUNCHES)
        logits = eng.predict(batch)
        torch.cuda.synchronize()
        launched = {k: fused.LAUNCHES[k] - before[k] for k in before}
        dtypes = {p.dtype for p in eng.model.parameters()}
        out[label] = (logits, launched, dtypes)
    (lf, nf, df), (lb, nb, db), (lq, nq, dq) = out["fp"], out["baked"], out["fly"]
    assert nf == nb == nq and nf["fused_pw_bn_act"] > 0 and nf["fused_conv_bn_act"] > 0
    assert torch.int8 not in df and torch.int8 in db and db == dq
    np.testing.assert_array_equal(lb, lq)
    assert np.isfinite(lb).all()
    assert float((lf.argmax(1) == lb.argmax(1)).mean()) >= 0.75


def test_default_server_serves_sheds_and_drains_on_the_card(cuda, tmp_path):
    """`build_server` with no `--serve.scheduler` flag (EDF) on the card:
    a realtime request answers, one whose deadline is under the measured
    service time is shed with 503, /metrics counts both, /drain turns
    /healthz to 503."""
    import json
    import urllib.error
    import urllib.request

    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
    from pytorchvideo_accelerate_tpu_torch.serving.server import build_server

    # 16 x 112^2: a bucket-1 forward of milliseconds, so half of it is a
    # deadline above the 1 ms floor
    art = _tiny3d_artifact(tmp_path, "int8", frames=16, crop=112)
    srv = build_server(parse_cli(["--serve.checkpoint", art, "--serve.port", "0"]))
    assert isinstance(srv.batcher, Scheduler) and srv.engine.device.type == "cuda"
    srv.start()

    def call(path, body=None):
        host, port = srv.address
        req = urllib.request.Request(f"http://{host}:{port}{path}",
                                     data=None if body is None else json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    try:
        clip = np.random.default_rng(5).standard_normal((16, 112, 112, 3)).round(3)
        body = {"video": clip.tolist()}
        code, data = call("/predict", dict(body, priority="realtime"))
        assert code == 200 and np.isfinite(json.loads(data)["logits"]).all()
        svc_ms = srv.batcher._estimate_s(1) * 1e3
        assert svc_ms > 2.0, svc_ms
        assert call("/predict", dict(body, deadline_ms=svc_ms / 2))[0] == 503
        text = call("/metrics")[1].decode()
        assert 'pva_serving_shed_total{state="deadline"} 1' in text
        assert "pva_serving_requests_total 1" in text
        assert call("/drain", {})[0] == 200 and call("/healthz")[0] == 503
    finally:
        srv.close()


def test_two_ranks_over_gloo_share_the_card(cuda, tmp_path):
    """Data parallelism on one card: two spawned ranks over gloo (CUDA
    tensors through the host), each a tiny3d step on half of a B=8 batch
    through the kernels, against one process on the whole batch. The ranks
    end bitwise equal, each launched every fused site's kernel forward and
    dx, and the global loss is within 5e-2 * (1 + |loss|) of one process's
    (sync BatchNorm over 4 + 4 clips against 8: bf16 rounding in another
    order)."""
    from _torch_dp_worker import _tiny3d_card_step, run_group

    rng = np.random.default_rng(5)
    np.savez(tmp_path / "cuda.npz",
             x=rng.standard_normal((8, 8, 64, 64, 3)).astype(np.float32),
             labels=rng.integers(0, 5, 8))
    one = _tiny3d_card_step(str(tmp_path / "cuda.npz"), 0, 1)
    r0, r1 = run_group("cuda_step", tmp_path, timeout_s=300)
    assert abs(r0["loss"] - one["loss"]) <= 5e-2 * (1 + abs(one["loss"]))
    assert r0["loss"] == r1["loss"]
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k], err_msg=k)
    for out in (r0, r1):
        n = out["launches"]
        assert n["fused_pw_bn_act"] == n["fused_pw_bn_act.bwd_dx"] > 0
        assert n["fused_conv_bn_act"] == n["fused_conv_bn_act.bwd_dx"] > 0



def test_mvit_b_tensor_parallel_forward_over_gloo_on_the_card(cuda, tmp_path):
    """Arm (a)'s forward: two ranks at (1, 2) over gloo on one card against
    one process, full-width MViT-B 16x4 at B=1."""
    from _torch_dp_worker import mvit_tp_forward, run_group

    rng = np.random.default_rng(9)
    np.savez(tmp_path / "mvit.npz",
             x=rng.standard_normal((1, 16, 224, 224, 3)).astype(np.float32))
    one = mvit_tp_forward(0, 1, str(tmp_path), model_count=1)
    r0, r1 = run_group("mvit_tp_forward", tmp_path, timeout_s=300)
    assert r0["mode"] == "tensor-parallel" and r0["params"] < one["params"]
    np.testing.assert_array_equal(r0["logits"], r1["logits"])
    excess = np.abs(r0["logits"] - one["logits"]) - 5e-2 * (1 + np.abs(one["logits"]))
    assert excess.max() <= 0, excess.max()
    for out in (r0, r1):
        assert out["launches"]["flash_attention"] == one["launches"]["flash_attention"] == 16
        assert out["launches"]["depthwise3d_s1"] == one["launches"]["depthwise3d_s1"] == 4


def test_hub_pth_load_equals_npz_load_on_the_card(cuda, tmp_path):
    """Fine-tuning's two routes into a model on the card: a hub-layout
    `.pth` converted on the fly and its `pva-torch-convert` artifact give
    one state, bitwise the source's (the transposes cancel)."""
    from pytorchvideo_accelerate_tpu_torch import models
    from pytorchvideo_accelerate_tpu_torch.config import ModelConfig
    from pytorchvideo_accelerate_tpu_torch.models import convert

    cfg = ModelConfig(name="slowfast_t", num_classes=5)
    src = models.create_model(cfg, "bf16", seed=3)
    tree = convert.jax_tree_from_state_dict(src.state_dict())
    hub = {}
    for coll in ("params", "batch_stats"):
        for key, arr in convert.flatten_tree(tree[coll]).items():
            path = tuple(key.split("/"))
            hub[convert.torch_key_for(coll, path, "slowfast_r50")] = torch.from_numpy(
                convert.export_tensor(path, arr))
    pth, npz = str(tmp_path / "hub.pth"), str(tmp_path / "hub.npz")
    torch.save({"model_state": hub}, pth)
    convert.main([pth, npz])
    direct = models.create_model(cfg, "bf16", seed=0).to(cuda)
    via_npz = models.create_model(cfg, "bf16", seed=1).to(cuda)
    report = convert.load_pretrained(pth, direct)
    assert convert.load_pretrained(npz, via_npz) == report
    assert report["kept"] == report["mismatched"] == report["interpolated"] == []
    want = src.state_dict()
    for k, v in direct.state_dict().items():
        assert v.is_cuda and torch.equal(v, via_npz.state_dict()[k]), k
        assert torch.equal(v.cpu(), want[k]), k


@pytest.mark.parametrize("name,stride", [("slowfast_t", 4), ("videomae_t", 2)])
def test_stream_ring_advances_match_full_recompute_on_the_card(cuda, name, stride):
    """A streaming engine on the card (bf16, u8 frames): 2 sessions
    established, then advanced through one ring wraparound; each launch
    against `full_recompute` of the windows the client holds, and the
    ring's kernels (rows 1-2 for the dual rings, row 5 for the token ring)
    launched by every step."""
    from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine
    from pytorchvideo_accelerate_tpu_torch.streaming import StreamingEngine

    frames, crop, n = 8, 32, 2
    model = create_model(ModelConfig(name=name, num_classes=5, dropout_rate=0.0,
                                     fused_kernels="auto", attention="pallas"),
                         "bf16", data_cfg=DataConfig(num_frames=frames, crop_size=crop))
    eng = InferenceEngine(model, num_classes=5, max_batch_size=n, model_name=name,
                          device_normalize=((0.45,) * 3, (0.225,) * 3),
                          input_dtype="uint8")
    se = StreamingEngine(eng, session_budget_mb=16.0, name=f"card-{name}")
    assert se.kind == ("dual" if name == "slowfast_t" else "tokens")
    kernels = (("fused_pw_bn_act", "fused_conv_bn_act") if se.kind == "dual"
               else ("flash_attention",))
    rng = np.random.default_rng(20)
    wins = rng.integers(0, 256, (n, frames, crop, crop, 3), np.uint8)
    items = [{"sid": f"c{i}", "window": wins[i], "stride": stride} for i in range(n)]
    for step in range(frames // stride + 1):
        before = dict(fused.LAUNCHES)
        got = np.stack(se.advance_batch(items))
        torch.cuda.synchronize()
        assert all(fused.LAUNCHES[k] > before[k] for k in kernels), step
        want = se.full_recompute(wins)
        assert np.isfinite(got).all()
        assert (np.abs(got - want) <= 5e-2 * (1 + np.abs(want))).all(), step
        new = rng.integers(0, 256, (n, stride, crop, crop, 3), np.uint8)
        wins = np.concatenate([wins[:, stride:], new], axis=1)
        items = [{"sid": f"c{i}", "frames": new[i]} for i in range(n)]


def test_fleet_hot_swap_under_load_on_the_card(cuda, tmp_path):
    """The smoke's fleet_serve arm (b) on slowfast_t: two EDF replicas on
    the card behind a `ReplicaPool` and a `Router`, both hot-swapped from a
    blue artifact to a green one while an open-loop `LoadGen` runs; zero
    failed requests, every response within 5e-2 * (1 + |oracle|) of blue's
    or green's plain-path logits with that oracle's top-1, and every
    request after the swap green's."""
    import dataclasses

    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.fleet.hotswap import hot_swap
    from pytorchvideo_accelerate_tpu_torch.fleet.loadgen import (
        LoadGen,
        heavy_tail_clip_factory,
    )
    from pytorchvideo_accelerate_tpu_torch.fleet.pool import LocalReplica, ReplicaPool
    from pytorchvideo_accelerate_tpu_torch.fleet.router import Router
    from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.obs.registry import Registry
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine
    from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import export_inference

    frames, crop = 8, 32
    cfg = parse_cli(["--model.name", "slowfast_t", "--model.num_classes", "5",
                     "--num_frames", str(frames), "--data.crop_size", str(crop),
                     "--model.fused_kernels", "auto", "--serve.max_batch_size", "4"])
    arts, oracle = {}, {}
    rng = np.random.default_rng(21)
    clip = {"slow": rng.standard_normal((frames // 4, crop, crop, 3)).astype(np.float32),
            "fast": rng.standard_normal((frames, crop, crop, 3)).astype(np.float32)}
    for color, seed in (("blue", 3), ("green", 4)):
        model = create_model(cfg.model, "bf16", seed=seed)
        with torch.no_grad():  # logits O(1): the head's init draw is 0.01
            model.head.proj.weight.mul_(100.0)
        arts[color] = export_inference(str(tmp_path / color), model, cfg,
                                       meta={"num_classes": 5, "model": "slowfast_t"})
        xla = dataclasses.replace(cfg.model, fused_kernels="xla")
        plain = InferenceEngine(create_model(xla, "bf16"), model.state_dict(),
                                num_classes=5, max_batch_size=1)
        oracle[color] = plain.predict({k: v[None] for k, v in clip.items()})[0]
        del plain
    replicas = []
    for i in range(2):
        stats = ServingStats()
        eng = InferenceEngine.from_artifact(arts["blue"], stats=stats)
        eng.warmup(clip)
        replicas.append(LocalReplica(f"r{i}", Scheduler(eng, stats=stats,
                                                        realtime_deadline_ms=30000)))
    pool = ReplicaPool(replicas, health_interval_s=0.5, registry=Registry())
    router = Router(pool, registry=Registry())
    sent = []

    def submit(c, **kw):
        sent.append((time.perf_counter(), router.submit(c, **kw)))
        return sent[-1][1]

    box = {}

    def swapper():
        time.sleep(0.5)
        box["swap"] = hot_swap(replicas, arts["green"])
        box["t"] = time.perf_counter()

    try:
        t = threading.Thread(target=swapper, daemon=True)
        t.start()
        rep = LoadGen(submit, rate_rps=30.0, duration_s=3.0, seed=5, grace_s=60.0,
                      clip_factory=heavy_tail_clip_factory(clip)).run()
        t.join(timeout=120)
        got = [(ts, np.asarray(f.result(timeout=60))) for ts, f in sent]
        post = [np.asarray(router.submit(clip).result(timeout=60)) for _ in range(3)]
    finally:
        router.close()
    assert rep["failed"] == 0 and "swap" in box, rep

    def near(x, ref):
        return bool((np.abs(x - ref) <= 5e-2 * (1 + np.abs(ref))).all())

    assert not near(oracle["blue"], oracle["green"])
    for ts, x in got:
        kind = "blue" if near(x, oracle["blue"]) else "green"
        assert near(x, oracle[kind]) and x.argmax() == oracle[kind].argmax()
        if ts > box["t"]:
            assert kind == "green"
    assert all(near(x, oracle["green"]) for x in post)
