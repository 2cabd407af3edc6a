"""The port's data path against the JAX package's, on the CPU.

Both sides draw from the same `np.random.Generator` calls in the same order,
so clips are byte-equal wherever no resize runs (uint8, float32, and the
bf16 host cast compared as raw 16-bit words). After a bilinear resize the
port's `F.interpolate` and the JAX package's cv2 compute the same
half-pixel bilinear with differently rounded f32 weights: float32 clips
within atol 1e-4 after normalisation (|x| <= 2.4, i.e. ~4e-5 relative;
measured 3.3e-5), uint8 clips by at most 1 (the rounding of a value near
.5 may go either way). Loader epoch order, batch geometry and
`LoaderState` must be equal.
"""

import numpy as np
import pytest
import torch

from pytorchvideo_accelerate_tpu.data import pipeline as jpipe
from pytorchvideo_accelerate_tpu.data import samplers as jsamp
from pytorchvideo_accelerate_tpu.data import transforms as jtf
from pytorchvideo_accelerate_tpu_torch.data import pipeline as tpipe
from pytorchvideo_accelerate_tpu_torch.data import samplers as tsamp
from pytorchvideo_accelerate_tpu_torch.data import transforms as ttf
from pytorchvideo_accelerate_tpu_torch.data.device_prefetch import DevicePrefetcher


def _frames(seed, t=24, h=72, w=96):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), np.uint8)


def _raw(a):
    """Bytes of a clip: bf16 tensors as their 16-bit words."""
    if torch.is_tensor(a):
        assert a.dtype == torch.bfloat16
        return a.view(torch.int16).numpy()
    return np.asarray(a)


# no resize: the short side already equals the scale (72), crops <= 72
NO_RESIZE = dict(num_frames=8, min_short_side_scale=72,
                 max_short_side_scale=72, crop_size=64)


@pytest.mark.parametrize("output_dtype", ["float32", "uint8", "bfloat16"])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("slowfast", [True, False])
def test_transform_byte_equal_without_resize(output_dtype, training, slowfast):
    kw = dict(NO_RESIZE, training=training, is_slowfast=slowfast,
              output_dtype=output_dtype)
    jt, tt = jtf.make_transform(**kw), ttf.make_transform(**kw)
    frames = _frames(1)
    want = jt(frames, np.random.default_rng(5))
    got = tt(frames, np.random.default_rng(5))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = _raw(got[k])
        if output_dtype == "bfloat16":
            w = w.view(np.int16)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert tt.device_normalize == jt.device_normalize


@pytest.mark.parametrize("output_dtype,atol", [("float32", 1e-4), ("uint8", 1)])
@pytest.mark.parametrize("training", [True, False])
def test_transform_after_resize_close(output_dtype, atol, training):
    kw = dict(num_frames=8, training=training, min_short_side_scale=100,
              max_short_side_scale=130, crop_size=96, output_dtype=output_dtype)
    jt, tt = jtf.make_transform(**kw), ttf.make_transform(**kw)
    frames = _frames(2)
    want = jt(frames, np.random.default_rng(6))["video"]
    got = tt(frames, np.random.default_rng(6))["video"]
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got.astype(np.float32) - want.astype(np.float32)).max()
    assert err <= atol, err


def test_short_side_scale_downscale_and_portrait_close():
    x = np.random.default_rng(3).random((3, 90, 50, 3)).astype(np.float32)
    for size in (30, 64):
        got, want = ttf.short_side_scale(x, size), jtf.short_side_scale(x, size)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_multicrop_eval_views_equal():
    kw = dict(NO_RESIZE, training=False, num_spatial_crops=3,
              output_dtype="float32", crop_size=48)
    jt, tt = jtf.make_transform(**kw), ttf.make_transform(**kw)
    frames = _frames(4)
    for j, t in zip(jt.spatial_views(frames), tt.spatial_views(frames)):
        np.testing.assert_array_equal(t["video"], j["video"])


def test_samplers_equal():
    for dur, clip in [(10.0, 2.0), (1.0, 2.0)]:
        r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
        a, b = tsamp.random_clip(dur, clip, r1), jsamp.random_clip(dur, clip, r2)
        assert (a.start, a.end) == (b.start, b.end)
        for n in (1, 3):
            a = [(s.start, s.end) for s in tsamp.uniform_clips(dur, clip, n)]
            b = [(s.start, s.end) for s in jsamp.uniform_clips(dur, clip, n)]
            assert a == b


def _sources(training, output_dtype, num_clips=1):
    kw = dict(NO_RESIZE, training=training, is_slowfast=True,
              output_dtype=output_dtype)
    src_kw = dict(num_videos=10, num_classes=3, seed=11, num_clips=num_clips)
    return (jpipe.SyntheticClipSource(jtf.make_transform(**kw), **src_kw),
            tpipe.SyntheticClipSource(ttf.make_transform(**kw), **src_kw))


@pytest.mark.parametrize("num_clips", [1, 2])
def test_synthetic_source_byte_equal(num_clips):
    js, ts = _sources(num_clips == 1, "bfloat16", num_clips)
    for index, epoch in [(0, 0), (7, 3)]:
        want, got = js.get(index, epoch), ts.get(index, epoch)
        assert int(got["label"]) == int(want["label"])
        for k in ("slow", "fast"):
            np.testing.assert_array_equal(_raw(got[k]),
                                          np.asarray(want[k]).view(np.int16))


@pytest.mark.parametrize("accum,shuffle,drop_last", [(2, True, True),
                                                    (1, False, False)])
def test_loader_epochs_equal(accum, shuffle, drop_last):
    js, ts = _sources(True, "float32")
    kw = dict(accum_steps=accum, shuffle=shuffle, drop_last=drop_last,
              seed=3, num_workers=2)
    jl = jpipe.ClipLoader(js, 2, transport="thread", **kw)
    tl = tpipe.ClipLoader(ts, 2, **kw)
    try:
        assert tl.steps_per_epoch() == jl.steps_per_epoch()
        for epoch in (0, 1):
            np.testing.assert_array_equal(tl._epoch_indices(epoch),
                                          jl._epoch_indices(epoch))
            jb = list(jl.epoch(epoch))
            tb = list(tl.epoch(epoch))
            assert len(tb) == len(jb) > 0
            for a, b in zip(tb, jb):
                assert sorted(a) == sorted(b)
                for k in b:
                    np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=k)
            assert tl.state.to_dict() == jl.state.to_dict()
    finally:
        jl.close()
        tl.close()


def test_loader_state_resume_mid_epoch():
    _, ts = _sources(True, "float32")
    tl = tpipe.ClipLoader(ts, 2, shuffle=True, seed=1, num_workers=2)
    try:
        full = list(tl.epoch(0))
        tl.state = tpipe.LoaderState(epoch=0, position=0)
        it = tl.epoch(0)
        next(it)
        it.close()
        assert tl.state.to_dict() == {"epoch": 0, "position": 1}
        resumed = list(tl.epoch())
        assert len(resumed) == len(full) - 1
        np.testing.assert_array_equal(resumed[0]["fast"], full[1]["fast"])
        assert tpipe.LoaderState.from_dict(tl.state.to_dict()) == tl.state
        assert tl.state.to_dict() == {"epoch": 1, "position": 0}
    finally:
        tl.close()


def test_val_tail_is_padded_and_masked():
    _, ts = _sources(False, "bfloat16")
    tl = tpipe.ClipLoader(ts, 4, shuffle=False, drop_last=False, num_workers=2)
    try:
        batches = list(tl.epoch(0))
        assert [b["fast"].shape[0] for b in batches] == [4, 4, 4]
        tail = batches[-1]
        np.testing.assert_array_equal(tail["mask"], [1, 1, 0, 0])
        assert tail["fast"].dtype == torch.bfloat16
        assert not tail["fast"][2:].any()
    finally:
        tl.close()


@pytest.mark.parametrize("depth", [0, 2])
def test_device_prefetcher_order_state_and_early_break(depth):
    _, ts = _sources(True, "float32")
    tl = tpipe.ClipLoader(ts, 2, accum_steps=1, shuffle=True, seed=2,
                          num_workers=2)
    pf = DevicePrefetcher(tl, torch.device("cpu"), depth=depth)
    try:
        want = list(tpipe.ClipLoader(ts, 2, shuffle=True, seed=2,
                                     num_workers=2).epoch(0))
        tl.state = tpipe.LoaderState()
        got = []
        for b in pf.epoch(0):
            assert all(torch.is_tensor(v) for v in b.values())
            got.append(b)
            assert tl.state.position == len(got)  # the consumed position
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["fast"].numpy(), b["fast"])
        assert tl.state.to_dict() == {"epoch": 1, "position": 0}
        for i, _ in enumerate(pf.epoch(1)):
            break
        assert tl.state.to_dict() == {"epoch": 1, "position": 1}
        assert pf.pop_wait() >= 0.0 and pf.wait_s == 0.0
    finally:
        tl.close()
