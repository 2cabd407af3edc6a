"""The tile plan and the arithmetic of the port's GEMM kernels
(`csrc/fused_gemm.cuh` under `csrc/fused_pw_bn_act.cu` and
`csrc/fused_conv_bn_act.cu`), on the CPU.

(a) `ops/fused.py` `gemm_plan` at every fused site of the three CNN paths
the smoke serves, forward (M, K = taps*Cin, N = Cout) and dx (M, K =
taps*Cout, N = Cin). The sites, recorded from the port's own models with a
pre-hook on every fused `ConvBNAct` (the smoke's `record_sites`), as (M,
taps, Cin, Cout, how many):

- SlowFast-R50, bucket 8 of 32x256^2 + 8x256^2 (alpha 4): 41 pointwise +
  51 conv sites, e.g. conv 16384 x (3,1,1) 1024->256 x5, 262144 x (1,3,3)
  64->64 x3, 4096 x (3,1,1) 2048->512 x2 and (1,3,3) 512->512 x2, the fast
  pathway's 1048576 x (1,3,3) 8->8 x3; pointwise 16384 x 256->1024 x6,
  1048576 x 8->32 x4 (Cin 8), 4096 x 512->2048 x3.
- X3D-M, bucket 8 of 16x224^2: 53 pointwise sites, widths 24 to 432, 16
  of them with K or N = 54 or 108 (even, not a multiple of 8).
- CSN-R101, bucket 4 of 32x224^2: 67 pointwise sites, M from 401408 down
  to 784 (res5).

At each: the configuration's shared memory fits the 227 KB a block may
have; its N tiles compute at most 1.6x the columns the site needs (the
most: 80 columns in the 128-wide tile, which the H100 ran faster than the
narrower tiles that pad less); the
copy path is 16-byte cp.async wherever K % 8 == N % 8 == 0 and 4-byte at
X3D-M's 54/108 sites; and the grid's blocks cover [0, M) x [0, N) once.

(b) A plain emulation, kept here, of the conv kernel's K walk: BK-deep steps
over the tap-major k = tap*Cin + c, each thread's 8-column group with its
(channel, tap) state advanced by BK a step (and by the path's chunk width
inside the group) as `ConvRows::advance` does, rows past M and taps outside
the volume zero-filled, the products of each step accumulated in f32, then
bias + act. Held against `conv_bn_act_plain` and against the JAX package's
`fused_conv3d_bn_act` (Pallas, interpret mode) at 1e-5 * (1 + |ref|) in
float32: two f32 sums over the same products in different orders. Shapes:
Cin 8 and 16 (steps straddle taps), Cin 54 (the 4-byte path), an odd Cin
(plain loads), (3,3,3), (5,1,1) and (1,3,3) taps, M no multiple of any BM,
every configuration whose path the shape allows, and the dx launch (the
same walk over the tap-flipped, channel-transposed weights).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorchvideo_accelerate_tpu.ops import pallas_fused as jf
from pytorchvideo_accelerate_tpu_torch.ops import fused

SMEM_LIMIT = 227 * 1024  # bytes of shared memory a block may use on an H100
H100_SMS = 132
TOL = 1e-5
CSRC = Path(fused.__file__).parent / "csrc"
KERNELS = ("fused_pw_bn_act", "fused_conv_bn_act")


def _source_tiles():
    """[(BM, BN, BK, warps_m, warps_n, min_blocks, stages)] of the `TileOf`
    table of csrc/fused_gemm.cuh, by tile index."""
    rows = re.findall(r"struct TileOf<(\d+)> \{ using type = TileShape<([\d, ]+)>; \}",
                      (CSRC / "fused_gemm.cuh").read_text())
    return [tuple(int(v) for v in shape.split(","))
            for _, shape in sorted(rows, key=lambda r: int(r[0]))]


def _persistent(kernel):
    """The `PERSISTENT` constant of csrc/<kernel>.cu."""
    m = re.search(r"constexpr bool PERSISTENT = (true|false);",
                  (CSRC / f"{kernel}.cu").read_text())
    return m.group(1) == "true"


def smem_bytes(config, kernel):
    """Dynamic shared memory a block of `kernel` in `config` launches with, as
    `TileShape::smem_bytes` counts it from the source's table: the ring's
    stages of the A (BM x BK) and W (BK x BN) tiles and the bf16 C tile (BM
    x BN), rows padded by 8 bf16 (an 8-wide row is not); a persistent block
    keeps its C tile beside the ring, a one-tile block's reuses it."""
    bm, bn, bk, _, _, _, stages = _source_tiles()[config // len(fused.GEMM_PATHS)]

    def pad(width):
        return width if width == 8 else width + 8

    ring, c_tile = stages * (bm * pad(bk) + bk * pad(bn)) * 2, bm * pad(bn) * 2
    return ring + c_tile if _persistent(kernel) else max(ring, c_tile)

# (M, (kt, kh, kw), Cin, Cout, sites)
SLOWFAST_R50 = [
    (262144, (1, 1, 1), 80, 64, 1), (262144, (1, 3, 3), 64, 64, 3),
    (262144, (1, 1, 1), 64, 256, 3), (262144, (1, 1, 1), 80, 256, 1),
    (262144, (1, 1, 1), 256, 64, 2), (1048576, (3, 1, 1), 8, 8, 1),
    (1048576, (1, 3, 3), 8, 8, 3), (1048576, (1, 1, 1), 8, 32, 4),
    (1048576, (3, 1, 1), 32, 8, 2), (262144, (1, 1, 1), 320, 128, 1),
    (65536, (1, 1, 1), 128, 512, 4), (65536, (1, 1, 1), 512, 128, 3),
    (65536, (1, 3, 3), 128, 128, 3), (1048576, (3, 1, 1), 32, 16, 1),
    (262144, (1, 1, 1), 16, 64, 4), (262144, (3, 1, 1), 64, 16, 3),
    (262144, (1, 3, 3), 16, 16, 3), (65536, (3, 1, 1), 640, 256, 1),
    (16384, (1, 1, 1), 256, 1024, 6), (16384, (3, 1, 1), 1024, 256, 5),
    (16384, (1, 3, 3), 256, 256, 5), (262144, (3, 1, 1), 64, 32, 1),
    (65536, (1, 1, 1), 32, 128, 6), (65536, (3, 1, 1), 128, 32, 5),
    (65536, (1, 3, 3), 32, 32, 5), (16384, (3, 1, 1), 1280, 512, 1),
    (4096, (1, 1, 1), 512, 2048, 3), (4096, (3, 1, 1), 2048, 512, 2),
    (4096, (1, 3, 3), 512, 512, 2), (65536, (3, 1, 1), 128, 64, 1),
    (16384, (1, 1, 1), 64, 256, 3), (16384, (3, 1, 1), 256, 64, 2),
    (16384, (1, 3, 3), 64, 64, 2),
]
X3D_M = [
    (1605632, (1, 1, 1), 24, 54, 1), (401408, (1, 1, 1), 54, 24, 3),
    (401408, (1, 1, 1), 24, 54, 2), (401408, (1, 1, 1), 24, 108, 1),
    (100352, (1, 1, 1), 108, 48, 5), (100352, (1, 1, 1), 48, 108, 4),
    (100352, (1, 1, 1), 48, 216, 1), (25088, (1, 1, 1), 216, 96, 11),
    (25088, (1, 1, 1), 96, 216, 10), (25088, (1, 1, 1), 96, 432, 1),
    (6272, (1, 1, 1), 432, 192, 7), (6272, (1, 1, 1), 192, 432, 7),
]
CSN_R101 = [
    (401408, (1, 1, 1), 64, 64, 1), (401408, (1, 1, 1), 64, 256, 4),
    (401408, (1, 1, 1), 256, 64, 2), (401408, (1, 1, 1), 256, 128, 1),
    (50176, (1, 1, 1), 128, 512, 4), (50176, (1, 1, 1), 512, 128, 3),
    (50176, (1, 1, 1), 512, 256, 1), (6272, (1, 1, 1), 256, 1024, 23),
    (6272, (1, 1, 1), 1024, 256, 22), (6272, (1, 1, 1), 1024, 512, 1),
    (784, (1, 1, 1), 512, 2048, 3), (784, (1, 1, 1), 2048, 512, 2),
]
MODELS = {"slowfast_r50": SLOWFAST_R50, "x3d_m": X3D_M, "csn_r101": CSN_R101}


def _gemms(sites):
    """(M, K, N, label) of each site's forward and dx launch."""
    for m, taps, cin, cout, _ in sites:
        t = int(np.prod(taps))
        yield m, t * cin, cout, f"{m} x {taps} {cin}->{cout} fwd"
        yield m, t * cout, cin, f"{m} x {taps} {cin}->{cout} dx"


def test_site_counts_match_the_smoke():
    """41 pointwise + 51 conv sites per SlowFast-R50 forward, 53 pointwise
    per X3D-M, 67 per CSN-R101 (`chip_smoke.py` checks the same counts)."""
    def count(sites, pw):
        return sum(n for _, taps, _, _, n in sites if (taps == (1, 1, 1)) == pw)
    assert (count(SLOWFAST_R50, True), count(SLOWFAST_R50, False)) == (41, 51)
    assert (count(X3D_M, True), count(X3D_M, False)) == (53, 0)
    assert (count(CSN_R101, True), count(CSN_R101, False)) == (67, 0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_plan_at_every_site(model):
    for m, k, n, label in _gemms(MODELS[model]):
        config = fused.gemm_plan(m, k, n, H100_SMS)
        name, bm, bn, bk = fused.gemm_tile(config)
        assert max(smem_bytes(config, kernel) for kernel in KERNELS) <= SMEM_LIMIT, label
        assert -(-n // bn) * bn * 5 <= 8 * n, f"{label}: {name} wastes N"
        if k % 8 == 0 and n % 8 == 0:
            assert fused.gemm_path(config) == "cp16", label
        if model == "x3d_m" and {k, n} & {54, 108}:
            assert fused.gemm_path(config) == "cp4", label
        if k <= 16 and 16 < n <= 32:
            assert bk == 16, label
        # the grid: one block per tile, N tiles fastest (csrc `block_origin`)
        n_tiles, blocks = -(-n // bn), -(-m // bm) * -(-n // bn)
        assert blocks < 2 ** 31, label
        origins = {((i // n_tiles) * bm, (i % n_tiles) * bn)
                   for i in (0, blocks - 1)}
        assert origins == {(0, 0), ((-(-m // bm) - 1) * bm, (n_tiles - 1) * bn)}, label
        assert (-(-m // bm) - 1) * bm < m <= -(-m // bm) * bm, label
        # a short 128 x 128 grid moves to the 128 x 64 tile
        if bn == 128:
            assert blocks >= H100_SMS, label


def test_tiles_match_the_source():
    """The plan's tiles are the source's: BM, BN, BK of csrc/fused_gemm.cuh's
    `TileOf` table in its order, one config id per (tile, path) of its
    `with_config` switch; every configuration fits a block's shared memory
    in both kernels."""
    tiles = _source_tiles()
    assert [t[:3] for t in tiles] == [t[1:] for t in fused.GEMM_TILES]
    switch = re.findall(r"PVA_CONFIG\((\d+)\)", (CSRC / "fused_gemm.cuh").read_text())
    assert sorted({int(i) for i in switch}) == list(range(fused.GEMM_CONFIGS))
    for config in range(fused.GEMM_CONFIGS):
        for kernel in KERNELS:
            assert smem_bytes(config, kernel) <= SMEM_LIMIT, (config, kernel)
    assert (_persistent("fused_pw_bn_act"), _persistent("fused_conv_bn_act")) == (True, False)


def test_plan_paths_and_tiles():
    cfg = fused.gemm_plan
    assert fused.gemm_tile(cfg(16384, 2304, 256))[0] == "deep"
    assert fused.gemm_tile(cfg(65536, 1152, 128))[0] == "wide"
    assert fused.gemm_tile(cfg(4096, 4608, 512))[0] == "n64"  # 128 blocks of 128 x 128
    assert fused.gemm_tile(cfg(262144, 576, 64))[0] == "n64"
    assert fused.gemm_tile(cfg(1048576, 72, 8))[0] == "n8"
    assert fused.gemm_tile(cfg(262144, 144, 16))[0] == "n16"
    assert fused.gemm_tile(cfg(65536, 288, 32))[0] == "n32"
    assert fused.gemm_tile(cfg(1048576, 8, 32))[0] == "k16"
    assert fused.gemm_path(cfg(100, 54, 108)) == "cp4"
    assert fused.gemm_path(cfg(100, 12, 10)) == "cp4"
    assert fused.gemm_path(cfg(100, 13, 21)) == "scalar"
    assert fused.gemm_path(cfg(100, 64, 64, align=8)) == "cp4"
    assert fused.gemm_path(cfg(100, 64, 64, align=2)) == "scalar"
    for config in range(fused.GEMM_CONFIGS):
        tile, path = fused.gemm_tile(config)[0], fused.gemm_path(config)
        assert fused.gemm_config(tile, path) == config


def test_forced_config_must_suit_the_shape():
    x = torch.zeros(10, 12, dtype=torch.bfloat16)
    w = torch.zeros(12, 10, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused._gemm_config(fused.gemm_config("wide", "cp16"), 10, 12, 10, x, w)
    with pytest.raises(ValueError, match="not one of"):
        fused._gemm_config(99, 10, 12, 10, x, w)
    assert fused._gemm_config(fused.gemm_config("n8", "cp4"), 10, 12, 10, x, w) == 13
    with pytest.raises(ValueError, match="4-byte aligned"):
        fused._gemm_config(13, 10, 12, 10, torch.zeros(121, dtype=torch.bfloat16)[1:], w)


# --- (b) the conv kernel's K walk -------------------------------------------


def _advance(state, by, cin, kh, kw):
    """`ConvRows::advance`: (c, dt, dh, dw) moved `by` columns along
    k = tap * Cin + c."""
    c, dt, dh, dw = state
    c += by
    while c >= cin:
        c -= cin
        dw += 1
        if dw == kw:
            dw, dh = 0, dh + 1
            if dh == kh:
                dh, dt = 0, dt + 1
    return c, dt, dh, dw


def emulate_conv(x, wf, bias, act, config):
    """act(conv3d_s1(x, wf) + bias) the way the conv kernel forms it in
    `config`: the A tile of each BK step gathered chunk by chunk from the
    incremental (channel, tap) state of its 8-column group, zeros for rows
    past M and taps outside the volume, f32 products summed step by step."""
    _, bm, bn, bk = fused.gemm_tile(config)
    v = {"cp16": 8, "cp4": 2, "scalar": 1}[fused.gemm_path(config)]
    b, t, h, w, cin = x.shape
    kt, kh, kw, _, n = wf.shape
    k_total, m = kt * kh * kw * cin, b * t * h * w
    rows = -(-m // bm) * bm
    mi = torch.arange(rows)
    valid = mi < m
    mm = torch.where(valid, mi, torch.zeros_like(mi))
    ww, q = mm % w, mm // w
    hh, q = q % h, q // h
    tt = torch.where(valid, q % t, torch.full_like(q, -(1 << 28)))
    row_off = mm * cin
    xflat = x.reshape(-1).float()
    w2 = wf.reshape(k_total, n).float()
    acc = torch.zeros(rows, n)
    states = [_advance((0, 0, 0, 0), 8 * g, cin, kh, kw) for g in range(bk // 8)]
    for step in range(-(-k_total // bk)):
        a = torch.zeros(rows, bk)
        for g, state in enumerate(states):
            s = state
            for j in range(0, 8, v):
                if j:
                    s = _advance(s, v, cin, kh, kw)
                c, dt, dh, dw = s
                ot, oh, ow = dt - kt // 2, dh - kh // 2, dw - kw // 2
                ok = ((dt < kt) & (tt + ot >= 0) & (tt + ot < t) & (hh + oh >= 0)
                      & (hh + oh < h) & (ww + ow >= 0) & (ww + ow < w))
                shift = ((ot * h + oh) * w + ow) * cin + c
                for e in range(v):
                    src = torch.where(ok, row_off + shift + e, torch.zeros_like(mi))
                    a[:, g * 8 + j + e] = torch.where(ok, xflat[src], 0.0)
            states[g] = _advance(state, bk, cin, kh, kw)
        k0 = step * bk
        wt = torch.zeros(bk, n)
        wt[:max(0, min(bk, k_total - k0))] = w2[k0:k0 + bk]
        acc += a @ wt
    y = acc[:m] + bias
    return fused.apply_act(y, act).reshape(b, t, h, w, n)


# (x spatial shape, Cin, Cout, taps): M = 210, 120, 90, 140, 60, 315 — no
# multiple of 128 or 256
WALK_CASES = [
    ((2, 3, 5, 7), 8, 8, (3, 3, 3)),      # Cin 8: a 32-deep step spans 4 taps
    ((1, 4, 6, 5), 16, 24, (1, 3, 3)),    # Cin 16: 2 taps a step
    ((1, 3, 5, 6), 54, 12, (3, 3, 3)),    # X3D's width: 4-byte path
    ((1, 7, 4, 5), 8, 20, (5, 1, 1)),
    ((1, 3, 4, 5), 5, 7, (3, 1, 3)),      # odd Cin: plain loads
    ((1, 5, 7, 9), 32, 40, (1, 1, 1)),    # one tap: the pointwise GEMM
]


def _walk_inputs(shape, cin, cout, taps, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (cin,)).astype(np.float32)
    w = (rng.standard_normal(taps + (cin, cout)) / np.sqrt(cin * np.prod(taps))).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, bias


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    excess = np.abs(got - want) - TOL * (1 + np.abs(want))
    assert excess.max() <= 0, f"max excess {excess.max()}"


def _suits(config, k, n):
    _, mult, _ = fused.GEMM_PATHS[config % len(fused.GEMM_PATHS)]
    return k % mult == 0 and n % mult == 0


WALK_PARAMS = [(i, config) for i, (_, cin, cout, taps) in enumerate(WALK_CASES)
               for config in range(fused.GEMM_CONFIGS)
               if _suits(config, int(np.prod(taps)) * cin, cout)
               and _suits(config, int(np.prod(taps)) * cout, cin)]


@pytest.mark.parametrize("case,config", WALK_PARAMS)
def test_k_walk_matches_plain_forward_and_dx(case, config):
    shape, cin, cout, taps = WALK_CASES[case]
    x, w, bias = _walk_inputs(shape, cin, cout, taps, case)
    xt, wt_, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias)
    _close(emulate_conv(xt, wt_, bt, "silu", config),
           fused.conv_bn_act_plain(xt, wt_, bt, "silu"))
    dz = torch.from_numpy(np.random.default_rng(case + 50).standard_normal(
        shape + (cout,)).astype(np.float32))
    w_dx = wt_.flip(0, 1, 2).transpose(3, 4).contiguous()
    zeros = torch.zeros(cin)
    _close(emulate_conv(dz, w_dx, zeros, "identity", config),
           fused.conv_bn_act_plain(dz, w_dx, zeros, "identity"))


@pytest.mark.parametrize("case", range(len(WALK_CASES)))
@pytest.mark.parametrize("act", ["relu", "silu"])
def test_k_walk_matches_jax_pallas_interpret(case, act):
    """The walk in the plan's configuration against the JAX package's fused
    conv (its Pallas kernel in interpret mode; the pointwise kernel for the
    one-tap case), scale 1 so both fold to the same weights."""
    shape, cin, cout, taps = WALK_CASES[case]
    x, w, bias = _walk_inputs(shape, cin, cout, taps, case + 10)
    m = int(np.prod(shape))
    config = fused.gemm_plan(m, int(np.prod(taps)) * cin, cout)
    want = jf.fused_conv3d_bn_act(jnp.asarray(x), jnp.asarray(w),
                                  jnp.ones((cout,), jnp.float32), jnp.asarray(bias),
                                  act=act, mode="pallas")
    got = emulate_conv(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(bias), act, config)
    _close(got.numpy(), want)
