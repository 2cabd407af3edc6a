"""The port's real-video data path against the JAX package's, on the CPU.

One tree of mp4s written with cv2 from seeded numpy frames (48x64, 30 fps,
24 to 40 frames) goes through both packages: the manifest (`scan_directory`,
`from_list`), decode (`probe`, `decode_span`), the frame cache
(`build_cache`, `FrameCache`, `CachedClipSource`), `VideoClipSource` with
its substitution of unreadable files, the verify doctor and its CLI, and
the Trainer's three data branches. Both sides decode with the same cv2 and
draw from the same `np.random.Generator` streams, so frames, caches and
clips are byte-equal; where a transform resizes, the port's `F.interpolate`
and the JAX package's cv2 compute the same bilinear with differently
rounded f32 weights, and clips agree to the bounds of
`tests/test_torch_data.py`: float32 within atol 1e-4, uint8 within 1.
"""

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from pytorchvideo_accelerate_tpu.config import parse_cli as jparse_cli  # noqa: E402
from pytorchvideo_accelerate_tpu.data import cache as jcache  # noqa: E402
from pytorchvideo_accelerate_tpu.data import decode as jdecode  # noqa: E402
from pytorchvideo_accelerate_tpu.data import manifest as jman  # noqa: E402
from pytorchvideo_accelerate_tpu.data import pipeline as jpipe  # noqa: E402
from pytorchvideo_accelerate_tpu.data import transforms as jtf  # noqa: E402
from pytorchvideo_accelerate_tpu.data import verify as jverify  # noqa: E402
from pytorchvideo_accelerate_tpu.reliability import retry as jretry  # noqa: E402
from pytorchvideo_accelerate_tpu_torch import run as trun  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.config import parse_cli  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.data import cache as tcache  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.data import decode as tdecode  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.data import manifest as tman  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.data import pipeline as tpipe  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.data import transforms as ttf  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.data import verify as tverify  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.reliability import retry as tretry  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer  # noqa: E402

FPS, H, W = 30.0, 48, 64
CLASSES = ("ant", "bee", "cat")
# videos per class in each split of the good tree: 8 train, 3 val
TRAIN_PER_CLASS, VAL_PER_CLASS = (3, 3, 2), (1, 1, 1)
# no resize anywhere: the short side is the videos' (48), crops <= 48
NO_RESIZE = dict(num_frames=4, min_short_side_scale=48,
                 max_short_side_scale=48, crop_size=32)
CLIP_S = 0.3


def _write_video(path, seed, frames):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    assert w.isOpened()
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 216, (1, 1, 3))
    for _ in range(frames):
        w.write(np.clip(base + rng.integers(-40, 40, (H, W, 3)), 0, 255)
                .astype(np.uint8))
    w.release()


def _corrupt(path):
    path.write_bytes(b"this is not a video container" * 8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """data_dir/{train,val}/{class}/*.mp4, every file readable."""
    root = tmp_path_factory.mktemp("videos")
    seed = 0
    for split, counts in (("train", TRAIN_PER_CLASS), ("val", VAL_PER_CLASS)):
        for cls, n in zip(CLASSES, counts):
            (root / split / cls).mkdir(parents=True)
            for v in range(n):
                seed += 1
                _write_video(root / split / cls / f"v{v}.mp4", seed,
                             24 + 8 * (v % 3))
    return root


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """A split with unreadable files among readable ones, and a split of
    unreadable files only."""
    root = tmp_path_factory.mktemp("mixed")
    for cls in CLASSES[:2]:
        (root / "mixed" / cls).mkdir(parents=True)
        (root / "bad" / cls).mkdir(parents=True)
        _corrupt(root / "bad" / cls / "x.mp4")
    _write_video(root / "mixed" / "ant" / "a0.mp4", 101, 30)
    _corrupt(root / "mixed" / "ant" / "a1.mp4")
    _corrupt(root / "mixed" / "bee" / "b0.mp4")
    _write_video(root / "mixed" / "bee" / "b1.mp4", 102, 36)
    _corrupt(root / "mixed" / "bee" / "b2.mp4")
    return root


def _raw(a):
    """Bytes of a clip: bf16 tensors as their 16-bit words."""
    if torch.is_tensor(a):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_sample(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _raw(got[k]), _raw(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _same_error(port_fn, jax_fn):
    """Both raise, the same exception type name and message."""
    with pytest.raises(Exception) as te:
        port_fn()
    with pytest.raises(Exception) as je:
        jax_fn()
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)


def _entries(m):
    return [(e.path, e.label, e.label_name) for e in m.entries], m.class_names


# --- manifest ---------------------------------------------------------------

def test_scan_directory_equal(tree):
    for split in ("train", "val"):
        t = tman.scan_directory(str(tree / split))
        j = jman.scan_directory(str(tree / split))
        assert _entries(t) == _entries(j)
        assert (t.num_classes, t.num_videos, len(t)) == (3, len(j), len(j))


@pytest.mark.parametrize("case", ["missing", "no_classes", "no_videos"])
def test_scan_directory_errors_equal(tmp_path, case):
    split = tmp_path / "split"
    if case != "missing":
        split.mkdir()
    if case == "no_videos":
        (split / "cls").mkdir()
        (split / "cls" / "notes.txt").write_text("x")
    _same_error(lambda: tman.scan_directory(str(split)),
                lambda: jman.scan_directory(str(split)))


LISTS = {
    "space": "train/ant/v0.mp4 0\ntrain/bee/v0.mp4 1\n# comment\n\ntrain/cat/v1.mp4 4\n",
    "comma": "train/ant/v0.mp4,2\n/abs/path with space.mp4, 0\n",
    "spaces_in_path": "dir with space/v.mp4 3\n",
}


@pytest.mark.parametrize("name", sorted(LISTS))
@pytest.mark.parametrize("root", ["", "ROOT"])
def test_from_list_equal(tmp_path, name, root):
    path = tmp_path / "list.txt"
    path.write_text(LISTS[name])
    r = str(tmp_path) if root else ""
    assert _entries(tman.from_list(str(path), r)) == _entries(
        jman.from_list(str(path), r))


@pytest.mark.parametrize("body", ["", "only_one_field\n", "a.mp4 x\n",
                                  "a.mp4 -1\n", None])
def test_from_list_errors_equal(tmp_path, body):
    path = tmp_path / "list.txt"
    if body is not None:
        path.write_text(body)
    _same_error(lambda: tman.from_list(str(path)),
                lambda: jman.from_list(str(path)))


# --- decode ---------------------------------------------------------------

def _videos(tree):
    return sorted(str(p) for p in (tree / "train").rglob("*.mp4"))


def test_probe_equal(tree):
    for path in _videos(tree):
        t, j = tdecode.probe(path), jdecode.probe(path)
        assert (t.fps, t.frame_count, t.duration) == (j.fps, j.frame_count,
                                                       j.duration)


@pytest.mark.parametrize("span", [(0.0, 0.3, None), (0.4, 0.6, None),
                                  (0.7, 9.0, None), (0.2, 1.0, 5),
                                  (0.01, 0.02, None)],
                         ids=["head", "seek", "clamp_past_end", "max_frames",
                              "one_frame"])
def test_decode_span_byte_equal(tree, span):
    for path in _videos(tree):
        got, want = tdecode.decode_span(path, *span), jdecode.decode_span(path, *span)
        assert got.dtype == np.uint8 and got.shape[1:] == (H, W, 3)
        np.testing.assert_array_equal(got, want)


def test_unreadable_file_raises_the_same(mixed):
    path = str(mixed / "mixed" / "ant" / "a1.mp4")
    _same_error(lambda: tdecode.probe(path), lambda: jdecode.probe(path))
    _same_error(lambda: tdecode.decode_span(path, 0, 1),
                lambda: jdecode.decode_span(path, 0, 1))
    with pytest.raises(tdecode.DECODE_ERRORS):
        tdecode.decode_span(path, 0, 1)
    assert issubclass(tdecode.CorruptVideoError, IOError)


def test_without_cv2_decode_names_the_cache_route(tree, monkeypatch):
    """With cv2 hidden, every decode entry point raises the one error that
    names the frame-cache route; it is no DECODE_ERROR, so no caller takes
    it for an unreadable file and substitutes."""
    monkeypatch.setattr(tdecode, "cv2", None)
    path = _videos(tree)[0]
    calls = [lambda: tdecode.probe(path),
             lambda: tdecode.decode_span(path, 0, 1),
             lambda: tverify.verify_tree(str(tree / "train")),
             lambda: tcache.build_cache(str(tree / "train"),
                                        str(tree / "never")),
             lambda: tpipe.VideoClipSource(
                 tman.scan_directory(str(tree / "train")),
                 ttf.make_transform(training=True, **NO_RESIZE), CLIP_S, True)]
    for call in calls:
        with pytest.raises(tdecode.NoVideoDecoderError) as e:
            call()
        msg = str(e.value)
        assert "no cv2" in msg and "data.cache build" in msg
        assert "--data.cache_dir" in msg
        assert not isinstance(e.value, tdecode.DECODE_ERRORS)
    assert not (tree / "never").exists()


# --- frame cache ------------------------------------------------------------

def _build_both(tmp_path, data_dir, short_side, manifest=None):
    out = {}
    for tag, mod, man in (("port", tcache, tman), ("jax", jcache, jman)):
        m = None if manifest is None else man.from_list(manifest, root=str(data_dir))
        d = tmp_path / tag
        out[tag] = (mod.build_cache(str(data_dir), str(d), short_side=short_side,
                                    num_workers=2, manifest=m), d)
    return out


@pytest.mark.parametrize("short_side", [320, 32], ids=["no_resize", "resize"])
def test_build_cache_byte_equal(tmp_path, tree, short_side):
    built = _build_both(tmp_path, tree / "train", short_side)
    (ti, td), (ji, jd) = built["port"], built["jax"]
    assert ti == ji
    for name in ("index.json", "data.bin"):
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    assert ti["num_classes"] == 3 and len(ti["videos"]) == sum(TRAIN_PER_CLASS)
    if short_side == 32:
        assert {(v["height"], v["width"]) for v in ti["videos"]} == {(32, 43)}


def test_build_cache_skips_corrupt_videos(tmp_path, mixed):
    built = _build_both(tmp_path, mixed / "mixed", 320)
    (ti, td), (ji, jd) = built["port"], built["jax"]
    assert ti == ji and [os.path.basename(v["path"]) for v in ti["videos"]] == [
        "a0.mp4", "b1.mp4"]
    assert (td / "data.bin").read_bytes() == (jd / "data.bin").read_bytes()


def test_cache_cli_build_from_list_equal(tmp_path, tree, capsys):
    lst = tmp_path / "train.txt"
    lst.write_text("ant/v1.mp4 0\ncat/v0.mp4 2\n")
    argv = ["build", "--data_dir", str(tree / "train"), "--list", str(lst),
            "--short_side", "40", "--num_workers", "2"]
    tcache.main(argv + ["--out", str(tmp_path / "port")])
    jcache.main(argv + ["--out", str(tmp_path / "jax")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split("->")[0] == out[1].split("->")[0]
    for name in ("index.json", "data.bin"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    assert json.loads((tmp_path / "port" / "index.json").read_text())[
        "num_classes"] == 3


@pytest.fixture(scope="module")
def cache_dir(tree, tmp_path_factory):
    """A frame cache of the good tree, built by the port: train/ and val/."""
    root = tmp_path_factory.mktemp("cache")
    for split in ("train", "val"):
        tcache.build_cache(str(tree / split), str(root / split), num_workers=2)
    return root


@pytest.mark.parametrize("span", [(0.0, 0.3), (0.5, 0.9), (1.2, 5.0), (9.0, 9.5)])
def test_frame_cache_read_equal(cache_dir, span):
    t = tcache.FrameCache(str(cache_dir / "train"))
    j = jcache.FrameCache(str(cache_dir / "train"))
    assert (len(t), t.fps, t.num_classes) == (len(j), j.fps, j.num_classes)
    for i in range(len(t)):
        assert t.byte_range(i, *span) == j.byte_range(i, *span)
        assert (t.duration(i), t.label(i)) == (j.duration(i), j.label(i))
        np.testing.assert_array_equal(t.read(i, *span), j.read(i, *span))
    t.close()
    j.close()


def _transforms(training, output_dtype, resize=False, **kw):
    geo = (dict(num_frames=4, min_short_side_scale=56, max_short_side_scale=72,
                crop_size=40) if resize else NO_RESIZE)
    args = dict(geo, training=training, output_dtype=output_dtype, **kw)
    return ttf.make_transform(**args), jtf.make_transform(**args)


def _close_sample(got, want, output_dtype):
    atol = 1 if output_dtype == "uint8" else 1e-4
    for k in want:
        g = np.asarray(got[k]).astype(np.float32)
        w = np.asarray(want[k]).astype(np.float32)
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= atol, (k, np.abs(g - w).max())


@pytest.mark.parametrize("output_dtype", ["uint8", "float32", "bfloat16"])
@pytest.mark.parametrize("training,num_clips", [(True, 1), (False, 1), (False, 3)])
def test_cached_clip_source_byte_equal(cache_dir, training, num_clips,
                                       output_dtype):
    tt, jt = _transforms(training, output_dtype)
    split = str(cache_dir / ("train" if training else "val"))
    ts = tcache.CachedClipSource(split, tt, CLIP_S, training, seed=5,
                                 num_clips=num_clips)
    js = jcache.CachedClipSource(split, jt, CLIP_S, training, seed=5,
                                 num_clips=num_clips)
    assert (len(ts), ts.num_classes) == (len(js), js.num_classes)
    for index, epoch in [(0, 0), (2, 1), (len(ts) - 1, 3)]:
        _same_sample(ts.get(index, epoch), js.get(index, epoch))


@pytest.mark.parametrize("output_dtype", ["uint8", "float32"])
def test_cached_clip_source_after_resize_close(cache_dir, output_dtype):
    tt, jt = _transforms(True, output_dtype, resize=True)
    split = str(cache_dir / "train")
    ts = tcache.CachedClipSource(split, tt, CLIP_S, True, seed=6)
    js = jcache.CachedClipSource(split, jt, CLIP_S, True, seed=6)
    for index in range(3):
        got, want = ts.get(index, 1), js.get(index, 1)
        assert int(got["label"]) == int(want["label"])
        _close_sample(got, want, output_dtype)


# --- VideoClipSource ---------------------------------------------------------

def _video_sources(split_dir, training, output_dtype="float32", num_clips=1,
                   resize=False, slowfast=False, seed=7, **kw):
    tt, jt = _transforms(training, output_dtype, resize, is_slowfast=slowfast)
    tm, jm = tman.scan_directory(str(split_dir)), jman.scan_directory(str(split_dir))
    src = dict(clip_duration=CLIP_S, training=training, seed=seed,
               num_clips=num_clips, retry_base_delay_s=0.0, **kw)
    return (tpipe.VideoClipSource(tm, tt, **src),
            jpipe.VideoClipSource(jm, jt, **src))


@pytest.mark.parametrize("output_dtype", ["uint8", "float32", "bfloat16"])
@pytest.mark.parametrize("training,num_clips,slowfast", [
    (True, 1, False), (True, 1, True), (False, 1, False), (False, 2, True)])
def test_video_clip_source_byte_equal(tree, training, num_clips, slowfast,
                                      output_dtype):
    split = tree / ("train" if training else "val")
    ts, js = _video_sources(split, training, output_dtype, num_clips,
                            slowfast=slowfast)
    assert (len(ts), ts.num_classes) == (len(js), js.num_classes)
    for index, epoch in [(0, 0), (1, 2), (len(ts) - 1, 1)]:
        _same_sample(ts.get(index, epoch), js.get(index, epoch))


@pytest.mark.parametrize("output_dtype", ["uint8", "float32"])
def test_video_clip_source_after_resize_close(tree, output_dtype):
    ts, js = _video_sources(tree / "train", True, output_dtype, resize=True)
    for index in range(3):
        got, want = ts.get(index, 0), js.get(index, 0)
        assert int(got["label"]) == int(want["label"])
        _close_sample(got, want, output_dtype)


def _recording(monkeypatch, module):
    """Record the path of every decode_span call through `module`."""
    seen = []
    real = module.decode_span

    def rec(path, *a, **k):
        seen.append(os.path.basename(os.path.dirname(path)) + "/"
                    + os.path.basename(path))
        return real(path, *a, **k)

    monkeypatch.setattr(module, "decode_span", rec)
    return seen


def test_substitution_draws_the_same_indices_as_jax(mixed, monkeypatch):
    """Unreadable files are replaced by the same attempt-keyed draws on both
    sides: the same decoded paths in the same order, byte-equal samples, and
    a fresh source repeats them (deterministic)."""
    t_seen = _recording(monkeypatch, tdecode)
    j_seen = _recording(monkeypatch, jdecode)
    ts, js = _video_sources(mixed / "mixed", True, decode_retries=1)
    assert len(ts) == 5
    got = [ts.get(i, e) for e in (0, 1) for i in range(len(ts))]
    want = [js.get(i, e) for e in (0, 1) for i in range(len(js))]
    for g, w in zip(got, want):
        _same_sample(g, w)
    assert t_seen == j_seen and len(t_seen) >= len(got)
    assert {p for p in t_seen} <= {"ant/a0.mp4", "bee/b1.mp4"}
    first = list(t_seen)
    t_seen.clear()
    again, _ = _video_sources(mixed / "mixed", True, decode_retries=1)
    for i, g in enumerate(got[:len(again)]):
        _same_sample(again.get(i, 0), g)
    assert t_seen == first[:len(t_seen)]
    assert ts._failed == js._failed


@pytest.mark.parametrize("retries,substituted", [(3, False), (2, True)])
def test_decode_retries_go_through_retry_call(tree, monkeypatch, retries,
                                              substituted):
    """A read of one file that fails twice with an OSError (flaky storage)
    is tried again through `retry_call`: with 3 attempts it recovers and the clip is
    the one a clean read gives; with 2 the file is substituted, as in the
    JAX package."""
    clean_t, clean_j = _video_sources(tree / "val", True)
    want = clean_j.get(0, 0)
    flaky_path = clean_j.manifest.entries[0].path
    counts = {}
    for tag, module in (("port", tdecode), ("jax", jdecode)):
        real = module.decode_span

        def flaky(path, *a, _tag=tag, _real=real, **k):
            n = counts[_tag, path] = counts.get((_tag, path), 0) + 1
            if path == flaky_path and n <= 2:
                raise OSError(f"transient read error {n}")
            return _real(path, *a, **k)

        monkeypatch.setattr(module, "decode_span", flaky)
    ts, js = _video_sources(tree / "val", True, decode_retries=retries)
    got = ts.get(0, 0)
    _same_sample(got, js.get(0, 0))
    assert (int(got["label"]) != int(want["label"])) == substituted
    if not substituted:
        _same_sample(got, want)
    per_side = {tag: sorted(n for (t, _), n in counts.items() if t == tag)
                for tag in ("port", "jax")}
    assert per_side["port"] == per_side["jax"]
    assert (ts._failed == set()) != substituted


def test_all_unreadable_raises_the_same(mixed):
    ts, js = _video_sources(mixed / "bad", True, decode_retries=1)
    _same_error(lambda: ts.get(0, 0), lambda: js.get(0, 0))
    with pytest.raises(IOError, match="10 consecutive unreadable videos"):
        ts.get(1, 0)


def test_transform_errors_propagate(tree):
    """A transform's own ValueError is not a decode failure: it propagates
    and marks no file bad."""
    def broken(frames, rng):
        raise ValueError("transform bug")

    tm, jm = tman.scan_directory(str(tree / "val")), jman.scan_directory(str(tree / "val"))
    ts = tpipe.VideoClipSource(tm, broken, CLIP_S, True)
    js = jpipe.VideoClipSource(jm, broken, CLIP_S, True)
    _same_error(lambda: ts.get(0, 0), lambda: js.get(0, 0))
    assert not ts._failed and not js._failed


def test_quarantine_is_refused(tree, tmp_path, monkeypatch):
    """A quarantined clip is refused by the source: one sidecar, read by
    both packages' `Quarantine`, excludes the same manifest index, get() of
    it never decodes the file and substitutes the same clip as the JAX
    source."""
    bad = tman.scan_directory(str(tree / "val")).entries[1].path
    sidecar = str(tmp_path / "quarantine.json")
    tman.Quarantine(sidecar, budget=1).record(bad, IOError("corrupt"))
    t_seen = _recording(monkeypatch, tdecode)
    j_seen = _recording(monkeypatch, jdecode)
    tt, jt = _transforms(True, "float32")
    ts = tpipe.VideoClipSource(tman.scan_directory(str(tree / "val")), tt,
                               CLIP_S, True,
                               quarantine=tman.Quarantine(sidecar, budget=1))
    js = jpipe.VideoClipSource(jman.scan_directory(str(tree / "val")), jt,
                               CLIP_S, True,
                               quarantine=jman.Quarantine(sidecar, budget=1))
    assert ts.quarantined_indices() == js.quarantined_indices() == {1}
    _same_sample(ts.get(1, 0), js.get(1, 0))
    bad_rel = os.path.basename(os.path.dirname(bad)) + "/" + os.path.basename(bad)
    assert t_seen == j_seen and len(t_seen) == 1 and bad_rel not in t_seen


def test_loader_batches_of_video_source_equal(tree):
    ts, js = _video_sources(tree / "train", True, "uint8")
    kw = dict(shuffle=True, drop_last=True, seed=3, num_workers=2)
    tl = tpipe.ClipLoader(ts, 4, **kw)
    jl = jpipe.ClipLoader(js, 4, transport="thread", **kw)
    try:
        tb, jb = list(tl.epoch(0)), list(jl.epoch(0))
        assert len(tb) == len(jb) == 2
        for a, b in zip(tb, jb):
            _same_sample(a, b)
    finally:
        tl.close()
        jl.close()


# --- retry ------------------------------------------------------------------

@pytest.mark.parametrize("fails,attempts,retry_on,deadline", [
    (0, 3, (OSError,), 30.0), (2, 3, (OSError,), 30.0),
    (3, 3, (OSError,), 30.0), (1, 3, (KeyError,), 30.0),
    (2, 5, (OSError,), 0.0), (1, 1, (OSError,), 30.0)],
    ids=["first_try", "recovers", "exhausts", "not_retryable", "deadline",
         "one_attempt"])
def test_retry_call_equal(fails, attempts, retry_on, deadline):
    def run(retry_call, **name):
        calls, sleeps = [0], []

        def fn():
            calls[0] += 1
            if calls[0] <= fails:
                raise OSError(f"fail {calls[0]}")
            return "ok"

        try:
            out = retry_call(fn, attempts=attempts, retry_on=retry_on,
                             base_delay_s=0.01, deadline_s=deadline,
                             sleep=sleeps.append, **name)
        except OSError as e:
            out = f"raised {e}"
        return out, calls[0], len(sleeps), all(
            0.01 * 2 ** i * 0.5 <= s <= 0.01 * 2 ** i * 1.5
            for i, s in enumerate(sleeps))

    assert run(tretry.retry_call) == run(jretry.retry_call, name="t")


def test_retry_call_rejects_zero_attempts():
    _same_error(lambda: tretry.retry_call(lambda: 1, attempts=0),
                lambda: jretry.retry_call(lambda: 1, name="t", attempts=0))


# --- verify -----------------------------------------------------------------

@pytest.mark.parametrize("deep,clip", [(False, 0.0), (True, 1.0)])
def test_verify_tree_reports_equal(tree, mixed, deep, clip):
    for split in (tree / "train", mixed / "mixed"):
        t = tverify.verify_tree(str(split), clip, num_workers=2, deep=deep)
        j = jverify.verify_tree(str(split), clip, num_workers=2, deep=deep)
        assert t == j
    assert t["unreadable"] == 3 and t["readable"] == 2


def test_check_one_equal(tree, mixed):
    for path in [_videos(tree)[0], str(mixed / "mixed" / "bee" / "b0.mp4")]:
        for deep in (False, True):
            assert tverify.check_one(path, deep) == jverify.check_one(path, deep)


@pytest.mark.parametrize("case,code", [("good", 0), ("unreadable", 1),
                                       ("empty_class", 2), ("list", 0)])
def test_verify_cli_exit_codes_equal(tree, mixed, tmp_path, capsys, case, code):
    if case == "good":
        argv = [str(tree / "val")]
    elif case == "unreadable":
        argv = [str(mixed / "mixed"), "--deep"]
    elif case == "empty_class":
        split = tmp_path / "split"
        (split / "empty").mkdir(parents=True)
        (split / "full").mkdir()
        _write_video(split / "full" / "v.mp4", 5, 24)
        argv = [str(split), "--clip_duration", "2"]
    else:
        lst = tmp_path / "val.txt"
        lst.write_text("ant/v0.mp4 0\nbee/v0.mp4 1\n")
        argv = [str(tree / "val"), "--list", str(lst)]
    argv += ["--num_workers", "2"]
    got = tverify.main(argv)
    t_out = capsys.readouterr().out
    want = jverify.main(argv)
    j_out = capsys.readouterr().out
    assert got == want == code
    assert json.loads(t_out) == json.loads(j_out)


# --- the Trainer's data branches -------------------------------------------

_TRAIN = ["--cpu", "--model.name", "tiny3d", "--num_frames", "4",
          "--sampling_rate", "2", "--data.crop_size", "32",
          "--data.min_short_side_scale", "48", "--data.max_short_side_scale",
          "48", "--batch_size", "4", "--num_epochs", "1", "--num_workers", "2",
          "--model.fused_kernels", "auto", "--data.eval_num_clips", "2"]


def _list_files(tree, tmp_path, val_labels=None):
    lines = {}
    for split in ("train", "val"):
        m = tman.scan_directory(str(tree / split))
        labels = val_labels if split == "val" and val_labels else None
        lines[split] = tmp_path / f"{split}.txt"
        lines[split].write_text("".join(
            f"{os.path.relpath(e.path, tree)} "
            f"{labels[i] if labels else e.label}\n"
            for i, e in enumerate(m.entries)))
    return str(lines["train"]), str(lines["val"])


@pytest.mark.parametrize("route", ["data_dir", "lists", "cache_dir"])
def test_trainer_fits_from_real_videos(tree, cache_dir, tmp_path, route):
    """`--cpu` tiny3d trains 2 steps and evaluates (2 views) from each
    real-data route; num_classes comes from the source (3), and the export
    carries it."""
    if route == "data_dir":
        argv = ["--data_dir", str(tree)]
    elif route == "lists":
        train, val = _list_files(tree, tmp_path)
        argv = ["--data_dir", str(tree), "--data.train_list", train,
                "--data.val_list", val]
    else:
        argv = ["--data.cache_dir", str(cache_dir)]
    out = str(tmp_path / "run")
    res = trun.main(_TRAIN + argv + ["--output_dir", out,
                                     "--checkpointing_steps", "2"])
    assert res["steps"] == 2 and np.isfinite(res["train_loss"])
    assert 0.0 <= res["val_accuracy"] <= 1.0
    art = str(tmp_path / "art")
    trun.main(_TRAIN + argv + ["--output_dir", out, "--resume_from_checkpoint",
                               "auto", "--export_inference", art])
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    assert meta["num_classes"] == 3


@pytest.mark.parametrize("output", ["u8", "auto"])
@pytest.mark.parametrize("route", ["data_dir", "cache_dir"])
def test_first_train_batch_equals_jax_trainer(tree, cache_dir, tmp_path, route,
                                              output):
    """The first train batch of the port's Trainer equals the JAX Trainer's,
    byte for byte (no resize runs): the JAX run's batch 1 on each of the
    test harness's 8 CPU devices is the port's batch 8."""
    from pytorchvideo_accelerate_tpu.trainer.loop import Trainer as JTrainer

    src = (["--data_dir", str(tree)] if route == "data_dir"
           else ["--data.cache_dir", str(cache_dir)])
    i = _TRAIN.index("--batch_size")
    common = _TRAIN[:i] + _TRAIN[i + 2:] + src + [
        "--data.host_cast", output, "--output_dir", str(tmp_path / "o")]
    tr = Trainer(parse_cli(common + ["--batch_size", "8"]))
    jt = JTrainer(jparse_cli(common + ["--batch_size", "1"]))
    try:
        assert tr.num_classes == jt.num_classes == 3
        got = next(iter(tr.train_loader.epoch(0)))
        want = next(iter(jt.train_loader.epoch(0)))
        assert got["video"].shape[0] == 8
        _same_sample(got, want)
    finally:
        tr.close()
        jt.close()


@pytest.mark.parametrize("extra,match", [
    (["--data.train_list", "T"], "must be set together"),
    (["--data.val_list", "V"], "must be set together"),
    ("bad_val_label", "outside the train list's class space")])
def test_list_manifest_errors_equal(tree, tmp_path, extra, match):
    from pytorchvideo_accelerate_tpu.trainer.loop import Trainer as JTrainer

    if extra == "bad_val_label":
        train, val = _list_files(tree, tmp_path, val_labels=[0, 1, 7])
        extra = ["--data.train_list", train, "--data.val_list", val]
    argv = _TRAIN + ["--data_dir", str(tree), "--output_dir",
                     str(tmp_path / "o")] + extra
    _same_error(lambda: Trainer(parse_cli(argv)),
                lambda: JTrainer(jparse_cli(argv)))
    with pytest.raises(ValueError, match=match):
        Trainer(parse_cli(argv))


def test_trainer_without_cv2_names_the_cache_route(tree, monkeypatch):
    monkeypatch.setattr(tdecode, "cv2", None)
    with pytest.raises(tdecode.NoVideoDecoderError, match="--data.cache_dir"):
        Trainer(parse_cli(_TRAIN + ["--data_dir", str(tree)]))
