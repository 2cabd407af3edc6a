"""The plan and the walk of the port's depthwise stencil
(`csrc/depthwise3d.cu`, rows 3 and 4 of the TPU kernels), on the CPU.

(a) `ops/fused.py` `dw_plan` at every depthwise site the smoke runs through
the kernel, forward and dx (the dx launch is the same stencil on a tensor of
the same shape), as (B, T, H, W, C, taps, launches per forward):

- X3D-M, bucket 8 of 16x224^2: the (5,1,1) stem at 112^2 x 24, then (3,3,3)
  at 56^2 x 54, 28^2 x 108, 14^2 x 216 and 7^2 x 432 (2, 4, 10, 6 sites);
- CSN-R101, bucket 4 of 32x224^2: (3,3,3) at 32x56^2 x 64, 16x28^2 x 128,
  8x14^2 x 256 and 4x7^2 x 512 (3, 3, 22, 2 sites);
- MViT-B, bucket 8 of 16x224^2: its 4 stride-1 K/V pools, (3,3,3) at 8x14^2
  and 8x7^2 x 768 (the last stage's two blocks, before and after the first
  block's query pool halves the grid).

At each: the blocks' T chunks, spatial tiles and channel chunks cover every
output once; the block's shared memory (kt + PF planes of the tile with its
halo, from the source's table) fits the 227 KB a block may have and, with 1
KB the SM keeps per block, the 228 KB of an SM at the planned blocks per SM;
the grid has at least two blocks per SM wherever the site has that many
plane tiles; the copy path is the widest the channels allow.

(b) A plain emulation, kept here, of the kernel's walk: each block's ring of
kt + PF input-plane slots filled in the kernel's order (the prologue's kt +
PF - 1 planes, then plane t + kt//2 + PF at step t into the slot of plane t -
kt//2 - 1), rows and columns outside the volume zero-filled, channels past C
and slots never filled holding NaN (the kernel leaves them unwritten), the
planes outside [0, T) skipped, each thread's strip of S outputs summed in
f32 as the kernel sums it (the sliding window of the fixed-tap kernels, the
direct taps of the generic one), then bias + act and the store of the lanes
inside the volume. Held bitwise (`torch.equal`) against `dw_bn_act_plain`
and `depthwise_conv3d_shift` in float32: both add the same products in the
same (dt, dh, dw) order. And within atol 1e-4, rtol 1e-5 (the tolerance of
tests/test_torch_depthwise.py) against the JAX package's `_dw_call`
(`pallas_fused.py`) and `pallas_depthwise3d_s1`, whose Pallas kernels run in
interpret mode. Shapes: taps (3,3,3) (fixed in h7, generic in n24), (5,1,1)
(fixed), (1,3,3), (3,1,1), (3,5,5) (generic); C 8, 12, 6 and 5 (the 16-, 8-, 4-byte and plain paths);
T smaller than kt; each act; every tile, at the plan's T chunk, at 2 and
at all of T.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorchvideo_accelerate_tpu.ops import pallas_fused as jf
from pytorchvideo_accelerate_tpu.ops.pallas_depthwise import pallas_depthwise3d_s1
from pytorchvideo_accelerate_tpu_torch.ops import depthwise, fused

H100_SMS = 132
SMEM_BLOCK = 227 * 1024  # bytes of shared memory a block may use on an H100
SMEM_SM = 228 * 1024  # an SM's shared memory, 1 KB of it kept per resident block
CSRC = Path(fused.__file__).parent / "csrc"
VEC = {"cp16": 8, "cp8": 4, "cp4": 2, "plain": 1}
ATOL, RTOL = 1e-4, 1e-5

# (B, T, H, W, C, taps, launches per forward)
SITES = {
    "x3d_m": [(8, 16, 112, 112, 24, (5, 1, 1), 1), (8, 16, 56, 56, 54, (3, 3, 3), 2),
              (8, 16, 28, 28, 108, (3, 3, 3), 4), (8, 16, 14, 14, 216, (3, 3, 3), 10),
              (8, 16, 7, 7, 432, (3, 3, 3), 6)],
    "csn_r101": [(4, 32, 56, 56, 64, (3, 3, 3), 3), (4, 16, 28, 28, 128, (3, 3, 3), 3),
                 (4, 8, 14, 14, 256, (3, 3, 3), 22), (4, 4, 7, 7, 512, (3, 3, 3), 2)],
    "mvit_b": [(8, 8, 14, 14, 768, (3, 3, 3), 2), (8, 8, 7, 7, 768, (3, 3, 3), 2)],
}
SITE_PARAMS = [pytest.param(model, i, id=f"{model}-{i}")
               for model in SITES for i in range(len(SITES[model]))]


def _source_tiles():
    """[(CC, HB, WB, S, PF, MIN_BLOCKS, FIXED333)] of the `DwTileOf` table of
    csrc/depthwise3d.cu, by tile index."""
    rows = re.findall(r"struct DwTileOf<(\d+)> \{ using type = DwTile<([\d, ]+)>; \}",
                      (CSRC / "depthwise3d.cu").read_text())
    return [tuple(int(v) for v in shape.split(","))
            for _, shape in sorted(rows, key=lambda r: int(r[0]))]


def smem_bytes(config, taps):
    """Dynamic shared memory of a block, as `DwTile::smem_bytes` counts it:
    kt + PF bf16 planes of (HB + kh - 1) x (WB + kw - 1) x CC."""
    cc, hb, wb, _, pf, _, _ = _source_tiles()[config // len(fused.DW_PATHS)]
    kt, kh, kw = taps
    return (kt + pf) * (hb + kh - 1) * (wb + kw - 1) * cc * 2


def decode(bid, geo):
    """The kernel's block position: (T chunk, W tile, H tile, channel chunk,
    b), T chunk fastest."""
    out = []
    for n in geo:
        out.append(bid % n)
        bid //= n
    return (*out, bid)


def _geo(t, h, w, c, config, tchunk):
    _, cc, hb, wb, _ = fused.dw_tile(config)
    return (-(-t // tchunk), -(-w // wb), -(-h // hb), -(-c // cc))


def _partition(n, size):
    """[start, stop) of each chunk of `size` over [0, n)."""
    return [(i * size, min(n, (i + 1) * size)) for i in range(-(-n // size))]


def test_site_counts_match_the_smoke():
    """23 depthwise sites per X3D-M forward, 30 per CSN-R101, 4 stride-1 pools
    per MViT-B (`chip_smoke.py` checks the same counts)."""
    assert [sum(s[-1] for s in SITES[m]) for m in SITES] == [23, 30, 4]


@pytest.mark.parametrize("model,i", SITE_PARAMS)
def test_plan_at_every_site(model, i):
    b, t, h, w, c, taps, _ = SITES[model][i]
    for launch in ("forward", "dx"):
        config, tchunk = fused.dw_plan(b, t, h, w, c, *taps, H100_SMS)
        name, cc, hb, wb, per_sm = fused.dw_tile(config)
        label = f"{model} site {i} {launch}: {name} {fused.dw_path(config)} T chunk {tchunk}"
        # every output once: the grid decodes onto distinct block positions,
        # whose T chunks, tiles and channel chunks partition each dimension
        geo = _geo(t, h, w, c, config, tchunk)
        blocks = fused.dw_grid(b, t, h, w, c, config, tchunk)
        assert blocks == int(np.prod(geo)) * b < 2 ** 31, label
        assert len({decode(bid, geo) for bid in range(blocks)}) == blocks, label
        assert decode(blocks - 1, geo) == tuple(n - 1 for n in geo) + (b - 1,), label
        for n, size in ((t, tchunk), (w, wb), (h, hb), (c, cc)):
            spans = _partition(n, size)
            assert spans[0][0] == 0 and spans[-1][1] == n, label
            assert all(a[1] == z[0] for a, z in zip(spans, spans[1:])), label
        # shared memory within a block's and, at the planned blocks, an SM's
        smem = smem_bytes(config, taps)
        assert smem <= SMEM_BLOCK and per_sm * (smem + 1024) <= SMEM_SM, label
        # two blocks per SM wherever one-plane chunks would give that many
        if fused.dw_grid(b, t, h, w, c, config, 1) >= 2 * H100_SMS:
            assert blocks >= 2 * H100_SMS, label
        # the widest copy the channels allow
        want = "cp16" if c % 8 == 0 else "cp8" if c % 4 == 0 else "cp4"
        assert fused.dw_path(config) == want, label
        assert name == ("n24" if c <= 24 else "h7"), label


def test_tiles_match_the_source():
    """The plan's tiles are the source's: CC, HB, WB and blocks per SM of
    csrc/depthwise3d.cu's `DwTileOf` table in its order; one config id per
    (tile, path) of its `with_config` switch; at most 1024 threads a block."""
    tiles = _source_tiles()
    assert [(cc, hb, wb, mb) for cc, hb, wb, _, _, mb, _ in tiles] == \
        [t[1:] for t in fused.DW_TILES]
    src = (CSRC / "depthwise3d.cu").read_text()
    switch = re.findall(r"PVA_DW_CONFIG\((\d+)\)", src)
    assert sorted({int(i) for i in switch}) == list(range(fused.DW_CONFIGS))
    for cc, hb, wb, s, pf, _, _ in tiles:
        assert wb % s == 0 and cc % 8 == 0 and pf >= 1
        assert cc // 2 * hb * (wb // s) <= 1024
    for config in range(fused.DW_CONFIGS):
        tile, path = fused.dw_tile(config)[0], fused.dw_path(config)
        assert fused.dw_config(tile, path) == config


def test_plan_paths_tiles_and_chunks():
    plan = fused.dw_plan
    assert fused.dw_path(plan(1, 4, 8, 8, 12, 3, 3, 3)[0]) == "cp8"
    assert fused.dw_path(plan(1, 4, 8, 8, 6, 3, 3, 3)[0]) == "cp4"
    assert fused.dw_path(plan(1, 4, 8, 8, 5, 3, 3, 3)[0]) == "plain"
    assert fused.dw_path(plan(1, 4, 8, 8, 64, 3, 3, 3, align=8)[0]) == "cp8"
    assert fused.dw_path(plan(1, 4, 8, 8, 64, 3, 3, 3, align=2)[0]) == "plain"
    # all of T where B x tiles give two blocks per SM and a chunk saves no
    # wave; one plane where even that leaves SMs idle (CSN res5: 128 blocks)
    assert plan(8, 16, 56, 56, 54, 3, 3, 3)[1] == 16
    assert plan(8, 16, 14, 14, 216, 3, 3, 3)[1] == 4
    assert plan(4, 4, 7, 7, 512, 3, 3, 3)[1] == 1
    for config in range(fused.DW_CONFIGS):
        assert 1 <= fused.dw_tchunk(2, 5, 9, 11, 8, 3, config) <= 5


def test_forced_config_must_suit_the_shape(monkeypatch):
    monkeypatch.setattr(fused, "_sm_count", lambda index: H100_SMS)
    x = torch.zeros(1, 3, 4, 4, 6, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 3, 1, 6, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused._dw_cuda(x, k, None, "identity", "depthwise3d_s1",
                       config=fused.dw_config("h7", "cp16"))
    with pytest.raises(ValueError, match="not one of"):
        fused._dw_cuda(x, k, None, "identity", "depthwise3d_s1", config=99)
    with pytest.raises(ValueError, match="T chunk"):
        fused._dw_cuda(x, k, None, "identity", "depthwise3d_s1",
                       config=fused.dw_config("h7", "cp4"), tchunk=0)


# --- (b) the kernel's walk ----------------------------------------------------


def emulate_dw(x, k, bias, act, config, tchunk):
    """act(depthwise_conv3d_s1(x, k) + bias) (no bias, no act when `bias` is
    None) the way the kernel forms it in `config`, block by block; see the
    module docstring. x (B,T,H,W,C) f32, k (kt,kh,kw,1,C)."""
    b_, t_, h_, w_, c_ = x.shape
    kt, kh, kw = k.shape[:3]
    pt, ph, pw = kt // 2, kh // 2, kw // 2
    cc, hb, wb, s, pf, _, fixed333 = _source_tiles()[config // len(fused.DW_PATHS)]
    fixed = (kt, kh, kw) == (5, 1, 1) or (fixed333 and (kt, kh, kw) == (3, 3, 3))
    rows, cols, nslot = hb + kh - 1, wb + kw - 1, kt + pf
    nan = float("nan")
    out = torch.full_like(x, nan)
    geo = _geo(t_, h_, w_, c_, config, tchunk)
    for bid in range(fused.dw_grid(b_, t_, h_, w_, c_, config, tchunk)):
        tci, twi, thi, cci, b = decode(bid, geo)
        t_begin, h0, w0, c0 = tci * tchunk, thi * hb, twi * wb, cci * cc
        t_end = min(t_, t_begin + tchunk)
        live = min(cc, c_ - c0)  # channels of the chunk inside C
        taps = torch.zeros(kt * kh * kw, cc)
        taps[:, :live] = k.reshape(kt * kh * kw, c_)[:, c0:c0 + live]
        ring = [torch.full((rows, cols, cc), nan) for _ in range(nslot)]

        def slot_of(p):
            return (p - t_begin + pt) % nslot

        def copy_plane(p):
            plane = torch.full((rows, cols, cc), nan)
            plane[:, :, :live] = 0.0
            hs, ws = max(0, h0 - ph), max(0, w0 - pw)
            he, we = min(h_, h0 - ph + rows), min(w_, w0 - pw + cols)
            plane[hs - (h0 - ph):he - (h0 - ph), ws - (w0 - pw):we - (w0 - pw), :live] = \
                x[b, p, hs:he, ws:we, c0:c0 + live]
            ring[slot_of(p)] = plane

        p_last = min(t_, t_end + pt) - 1
        for i in range(kt + pf - 1):
            p = t_begin - pt + i
            if 0 <= p <= p_last:
                copy_plane(p)
        sx = torch.arange(wb // s) * s  # each strip's first column
        for t in range(t_begin, t_end):
            if t + pt + pf <= p_last:
                copy_plane(t + pt + pf)
            # acc[so]: (HB, WB/S, CC) over the threads' (row, strip, lane)
            acc = [torch.zeros(hb, wb // s, cc) for _ in range(s)]
            for dt in range(kt):
                p = t - pt + dt
                if not 0 <= p < t_:
                    continue
                plane = ring[slot_of(p)]

                def at(dh, j):
                    return plane[dh:dh + hb][:, sx + j]

                if fixed:  # the sliding window: each word read once per tap row
                    for dh in range(kh):
                        for j in range(s + kw - 1):
                            v = at(dh, j)
                            for so in range(s):
                                dw = j - so
                                if 0 <= dw < kw:
                                    acc[so] = acc[so] + v * taps[(dt * kh + dh) * kw + dw]
                else:  # the generic kernel: taps in order, then the strip
                    for dh in range(kh):
                        for dw in range(kw):
                            tap = taps[(dt * kh + dh) * kw + dw]
                            for so in range(s):
                                acc[so] = acc[so] + at(dh, so + dw) * tap
            tile = torch.empty(hb, wb, cc)
            for so in range(s):
                tile[:, sx + so] = acc[so]
            if bias is not None:
                tile = fused.apply_act(tile + torch.nn.functional.pad(
                    bias[c0:c0 + live], (0, cc - live)), act)
            hn, wn = min(hb, h_ - h0), min(wb, w_ - w0)
            out[b, t, h0:h0 + hn, w0:w0 + wn, c0:c0 + live] = tile[:hn, :wn, :live]
    return out


# (shape (B, T, H, W), C, taps, act): C 8 / 12 / 6 / 5 take the 16- / 8- /
# 4-byte / plain path; T 2 < kt 5 and T 1 < kt 3; ragged H and W
WALK_CASES = [
    ((2, 5, 9, 11), 8, (3, 3, 3), "silu"),
    ((1, 6, 7, 5), 6, (5, 1, 1), "relu"),
    ((1, 4, 10, 9), 5, (1, 3, 3), "identity"),
    ((2, 3, 8, 16), 12, (3, 1, 1), "silu"),
    ((1, 3, 6, 7), 8, (3, 5, 5), "relu"),
    ((1, 2, 5, 6), 6, (5, 1, 1), "silu"),
    ((1, 1, 15, 8), 5, (3, 3, 3), "relu"),
]
WALK_PARAMS = [pytest.param(i, tile, id=f"{i}-{tile}")
               for i in range(len(WALK_CASES)) for tile in [t[0] for t in fused.DW_TILES]]


def _walk_case(i):
    shape, c, taps, act = WALK_CASES[i]
    rng = np.random.default_rng(40 + i)
    x = torch.from_numpy(rng.standard_normal(shape + (c,)).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal(taps + (1, c)) * 0.3).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
    return x, k, bias, act


@pytest.mark.parametrize("i,tile", WALK_PARAMS)
def test_walk_matches_plain_bitwise(i, tile):
    """Both entry points' walk in `tile`, at the plan's T chunk, at 2 and at
    all of T (the ring's slots reused), bitwise equal to the plain versions (the dx launch is the same walk over
    the tap-flipped taps: held with them too)."""
    x, k, bias, act = _walk_case(i)
    b, t, h, w, c = x.shape
    path = fused.dw_path(fused.dw_plan(b, t, h, w, c, *k.shape[:3])[0])
    config = fused.dw_config(tile, path)
    for tchunk in sorted({fused.dw_tchunk(b, t, h, w, c, k.shape[0], config), 2, t}):
        for taps in (k, k.flip(0, 1, 2)):
            got = emulate_dw(x, taps, bias, act, config, tchunk)
            assert torch.equal(got, fused.dw_bn_act_plain(x, taps, bias, act)), tchunk
            got = emulate_dw(x, taps, None, "identity", config, tchunk)
            assert torch.equal(got, depthwise.depthwise_conv3d_shift(x, taps)), tchunk


@pytest.mark.parametrize("i", range(len(WALK_CASES)))
def test_walk_matches_jax_pallas_interpret(i):
    """The walk in the plan's configuration against the JAX package's Pallas
    kernels, interpret mode: `_dw_call` (row 3, bias + act) and
    `pallas_depthwise3d_s1` (row 4)."""
    x, k, bias, act = _walk_case(i)
    config, tchunk = fused.dw_plan(*x.shape, *k.shape[:3])
    want = np.asarray(jf._dw_call(jnp.asarray(x.numpy()), jnp.asarray(k.numpy()),
                                  jnp.asarray(bias.numpy())[None], act, True))
    np.testing.assert_allclose(emulate_dw(x, k, bias, act, config, tchunk).numpy(),
                               want, atol=ATOL, rtol=RTOL)
    want = np.asarray(pallas_depthwise3d_s1(jnp.asarray(x.numpy()),
                                            jnp.asarray(k.numpy())))
    np.testing.assert_allclose(emulate_dw(x, k, None, "identity", config, tchunk).numpy(),
                               want, atol=ATOL, rtol=RTOL)
