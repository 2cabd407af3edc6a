"""The port's native loader runtime (`pytorchvideo_accelerate_tpu_torch/
native/`) against the JAX package's: the slot format byte for byte (every
dtype, bf16 through `torch.bfloat16` against `ml_dtypes`), slots crossing
packages, the shm ring in one process and across a fork, the forked worker
pool (order, in-band errors with the worker's traceback, a SIGKILLed worker
reported within 2 s, no child wedged by a lock a parent thread held at the
fork), and the loader's process transport: batches byte-equal to the
thread transport's (after the parent used torch's thread pool, with a
resize large enough to run in parallel on the parent's default thread
count, which the decode threads do not use), a mid-epoch resume, the JAX
loader's geometry, and the fallback to threads without a compiler.

Every test that forks runs under a deadline of its own: the pool's
`timeout_ms` and a `signal.alarm` guard (`deadline`)."""

import json
import logging
import os
import signal
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import pytorchvideo_accelerate_tpu.native as jnative
from pytorchvideo_accelerate_tpu.data import pipeline as jpipe
from pytorchvideo_accelerate_tpu.data.transforms import make_transform as jmake_transform
from pytorchvideo_accelerate_tpu.native import ringbuf as jring
from pytorchvideo_accelerate_tpu_torch import native, obs
from pytorchvideo_accelerate_tpu_torch.data import pipeline as tpipe
from pytorchvideo_accelerate_tpu_torch.data.transforms import make_transform
from pytorchvideo_accelerate_tpu_torch.native import ringbuf, shm_loader
from pytorchvideo_accelerate_tpu_torch.native.shm_loader import ShmWorkerPool

DEADLINE_S = 30
POOL_TIMEOUT_MS = 20_000


@pytest.fixture
def deadline():
    """SIGALRM after DEADLINE_S: a wedged fork test fails, never hangs."""
    def on_alarm(signum, frame):
        raise TimeoutError(f"fork test over its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _tf(**kw):
    args = dict(training=False, num_frames=4, crop_size=16,
                min_short_side_scale=18, max_short_side_scale=18)
    args.update(kw)
    return make_transform(**args)


def _source(n=12, classes=3, **kw):
    return tpipe.SyntheticClipSource(_tf(**kw), num_videos=n, num_classes=classes,
                                     raw_frames=8, raw_size=(24, 32))


def _equal(a, b) -> bool:
    if torch.is_tensor(a) or torch.is_tensor(b):
        return (torch.is_tensor(a) and torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape
                and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                                b.view(torch.int16) if b.dtype == torch.bfloat16 else b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_library_builds_into_ops_build():
    """g++ at first use into `ops/_build/`, named by the source's hash; the
    package imports nothing of the JAX package."""
    assert native.load() is not None
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "ops"
    assert path.name.startswith("libpva_native-") and path.suffix == ".so"
    for mod in (native, ringbuf, shm_loader):
        src = open(mod.__file__).read()
        assert "pytorchvideo_accelerate_tpu." not in src.replace(
            "pytorchvideo_accelerate_tpu_torch", "")


# --- the slot format ----------------------------------------------------------

_BITS = np.random.default_rng(0).integers(0, 2 ** 16, (3, 5)).astype(np.uint16)
_BITS[_BITS & 0x7F80 == 0x7F80] = 0  # no NaN / inf words (NaN payloads vary)


def _leaf(kind):
    rng = np.random.default_rng(1)
    if kind == "bfloat16":
        return (torch.from_numpy(_BITS.view(np.int16)).view(torch.bfloat16),
                _BITS.view(ml_dtypes.bfloat16))
    arr = {"float32": rng.standard_normal((2, 3, 4)).astype(np.float32),
           "int32": rng.integers(-9, 9, (7,)).astype(np.int32),
           "uint8": rng.integers(0, 255, (2, 2, 3)).astype(np.uint8),
           "float16": rng.standard_normal((5,)).astype(np.float16),
           "int64": rng.integers(-2 ** 40, 2 ** 40, (3,)).astype(np.int64),
           "bool": rng.random((4,)) > 0.5,
           "scalar": np.int32(5)}[kind]
    return arr, arr


@pytest.mark.parametrize("kind", ["float32", "int32", "uint8", "float16", "int64",
                                  "bool", "scalar", "bfloat16"])
def test_pack_sample_byte_equal_to_jax_and_slots_cross(kind):
    mine, theirs = _leaf(kind)
    sample_t = {"x": mine, "label": np.int32(3)}
    sample_j = {"x": theirs, "label": np.int32(3)}
    n_bytes = ringbuf.sample_nbytes(sample_t)
    assert n_bytes == jring.sample_nbytes(sample_j)
    buf_t = memoryview(bytearray(n_bytes + 64))
    buf_j = memoryview(bytearray(n_bytes + 64))
    n = ringbuf.pack_sample(sample_t, buf_t)
    assert n == jring.pack_sample(sample_j, buf_j) <= n_bytes
    assert bytes(buf_t[:n]) == bytes(buf_j[:n])
    # a slot written by the JAX package reads back in the port, and back
    got = ringbuf.unpack_sample(buf_j[:n])
    assert _equal(got["x"], mine) and _equal(got["label"], np.int32(3))
    back = jring.unpack_sample(buf_t[:n])
    assert back["x"].dtype == np.asarray(theirs).dtype
    assert np.asarray(back["x"]).tobytes() == np.asarray(theirs).tobytes()


def test_bf16_unpacks_as_a_view_without_copy():
    mine, _ = _leaf("bfloat16")
    buf = memoryview(bytearray(ringbuf.sample_nbytes({"x": mine}) + 8))
    n = ringbuf.pack_sample({"x": mine}, buf)
    view = ringbuf.unpack_sample(buf[:n])["x"]
    assert view.dtype == torch.bfloat16
    view[0, 0] = 1.0  # writes through to the slot
    assert ringbuf.unpack_sample(buf[:n])["x"][0, 0].item() == 1.0
    copied = ringbuf.unpack_sample(buf[:n], copy=True)["x"]
    copied[0, 0] = 2.0
    assert ringbuf.unpack_sample(buf[:n])["x"][0, 0].item() == 1.0


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, "bfloat16"])
def test_gather_copy_and_stack_samples_match_stack(dtype):
    rng = np.random.default_rng(0)
    parts = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(9)]
    if dtype == "bfloat16":
        parts = [torch.from_numpy(p).to(torch.bfloat16) for p in parts]
        assert torch.equal(tpipe.stack_samples(parts).view(torch.int16),
                           torch.stack(parts).view(torch.int16))
        return
    parts = [p.astype(dtype) for p in parts]
    dst = np.empty((9, 5, 7), dtype)
    ringbuf.gather_copy(dst, parts, n_threads=3)
    np.testing.assert_array_equal(dst, np.stack(parts))
    assert _equal(tpipe.stack_samples(parts), np.stack(parts))
    assert _equal(tpipe.stack_samples([np.int32(1), np.int32(2)]),
                  np.stack([np.int32(1), np.int32(2)]))


# --- the ring -----------------------------------------------------------------

def _sample(seed=0):
    rng = np.random.default_rng(seed)
    return {"video": rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
            "bf16": torch.from_numpy(rng.standard_normal((2, 3)).astype(
                np.float32)).to(torch.bfloat16),
            "label": np.int32(seed % 7)}


def _same_sample(got, want):
    return all(_equal(got[k], want[k]) for k in want) and set(got) == set(want)


def test_ring_single_process_wraps_and_blocks():
    ring = ringbuf.ShmRing(n_slots=2, slot_bytes=1 << 16)
    for i in range(7):  # wraps the ring repeatedly
        assert ring.put_sample(_sample(i), tag=i)
        slot, nbytes, tag = ring.pop()
        assert slot >= 0 and tag == i
        assert _same_sample(ringbuf.unpack_sample(ring.slot_view(slot)[:nbytes]),
                            _sample(i))
        ring.release(slot)
    assert ring.put_sample(_sample(0), 0) and ring.put_sample(_sample(1), 1)
    assert ring.acquire(timeout_ms=50) == -1  # full: a timeout
    assert ring.ready_count() == 2
    drainer = threading.Thread(target=lambda: ring.release(ring.pop()[0]))
    drainer.start()
    assert ring.acquire(timeout_ms=5000) >= 0  # freed by the consumer
    drainer.join(timeout=5)
    assert not drainer.is_alive()
    ring.close()
    assert ring.pop(timeout_ms=10)[0] in (-2, 0, 1)  # drained, then -2


def test_ring_across_a_fork(deadline):
    ring = ringbuf.ShmRing(n_slots=4, slot_bytes=1 << 16)
    pid = os.fork()
    if pid == 0:  # the child produces 8 samples, the port's packing
        try:
            for i in range(8):
                ring.put_sample(_sample(i), tag=i, timeout_ms=POOL_TIMEOUT_MS)
        finally:
            os._exit(0)
    got = []
    for _ in range(8):
        slot, nbytes, tag = ring.pop(timeout_ms=POOL_TIMEOUT_MS)
        assert slot >= 0
        got.append((tag, ringbuf.unpack_sample(ring.slot_view(slot)[:nbytes],
                                               copy=True)))
        ring.release(slot)
    os.waitpid(pid, 0)
    assert [t for t, _ in got] == list(range(8))
    assert all(_same_sample(s, _sample(t)) for t, s in got)
    ring.close()


# --- the worker pool ----------------------------------------------------------

def _drain(pool, indices, epoch, start=0):
    out = []
    for sample, done in pool.map_epoch(indices, epoch, start=start):
        out.append({k: (v.clone() if torch.is_tensor(v) else np.array(v))
                    for k, v in sample.items()})
        done()
    return out


@pytest.mark.parametrize("output_dtype", ["float32", "bfloat16"])
def test_pool_delivers_in_order(output_dtype, deadline):
    source = _source(12, output_dtype=output_dtype)
    pool = ShmWorkerPool(source, num_workers=3, timeout_ms=POOL_TIMEOUT_MS)
    indices = np.arange(12)[::-1].copy()  # a non-trivial order
    try:
        got = _drain(pool, indices, epoch=1)
        assert len(got) == 12 and pool.forks == 3
        for pos, sample in enumerate(got):
            assert _same_sample(sample, source.get(int(indices[pos]), 1))
        tail = _drain(pool, np.arange(8), epoch=0, start=5)
        assert [int(s["label"]) for s in tail] == [
            int(source.get(i, 0)["label"]) for i in range(5, 8)]
    finally:
        pool.close()


class _FailingSource:
    """Raises at one index: `kind` "value" a ValueError; "cuda" touches
    CUDA, which a forked child may not."""

    num_classes = 2

    def __init__(self, kind, bad=3):
        self.kind, self.bad = kind, bad

    def __len__(self):
        return 8

    def get(self, index, epoch):
        if index == self.bad:
            if self.kind == "cuda":
                torch.cuda.init()
            else:
                raise ValueError(f"boom at {index}")
        return {"video": np.full((2, 2), index, np.float32),
                "label": np.int32(index % 2)}


@pytest.mark.parametrize("kind", ["value", "cuda"])
def test_worker_error_arrives_in_band_with_its_traceback(kind, deadline):
    if kind == "cuda" and torch.cuda.is_available():
        torch.cuda.init()  # the parent's CUDA: a child's touch then raises
    pool = ShmWorkerPool(_FailingSource(kind), num_workers=2,
                         timeout_ms=POOL_TIMEOUT_MS)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="shm worker failed") as e:
        _drain(pool, np.arange(8), epoch=0)
    assert time.monotonic() - t0 < 10
    text = str(e.value)
    assert "Traceback (most recent call last)" in text and "in get" in text
    if kind == "value":
        assert "ValueError: boom at 3" in text
    else:
        assert ("Cannot re-initialize CUDA in forked subprocess" in text
                or "not compiled with CUDA" in text)
    assert pool._pids == []  # reaped


class _SlowSource(_FailingSource):
    def get(self, index, epoch):
        if index % 2 == 1:  # worker 1's samples
            time.sleep(60)
        return super().get(index, epoch)


def test_sigkilled_worker_reported_within_2s(deadline):
    pool = ShmWorkerPool(_SlowSource("none", bad=-1), num_workers=2,
                         timeout_ms=POOL_TIMEOUT_MS)
    gen = pool.map_epoch(np.arange(8), epoch=0)
    sample, done = next(gen)  # position 0, from worker 0
    done()
    os.kill(pool._pids[1], signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"worker 1 \(pid \d+\) died"):
        next(gen)
    assert time.monotonic() - t0 < 2.0
    assert pool._pids == []


class _LockTouchingSource(_FailingSource):
    """Each sample takes the locks a parent thread may hold at the fork: the
    flight recorder's, the process registry's and its counter's, and a lock
    of the source's own (a quarantine's)."""

    def __init__(self):
        super().__init__("none", bad=-1)
        self._lock = threading.Lock()

    def get(self, index, epoch):
        with self._lock:
            pass
        obs.get_recorder().record("test", "child-sample", index=index)
        obs.get_registry().counter("pva_test_child_samples_total").inc()
        return super().get(index, epoch)


def test_child_not_wedged_by_a_lock_held_at_the_fork(deadline):
    source = _LockTouchingSource()
    counter = obs.get_registry().counter("pva_test_child_samples_total")
    held, release = threading.Event(), threading.Event()

    def holder():
        with obs.get_recorder()._lock, obs.get_registry()._lock, \
                counter._lock, source._lock:
            held.set()
            release.wait(DEADLINE_S)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert held.wait(5)
    try:
        pool = ShmWorkerPool(source, num_workers=2, slot_bytes=4096,
                             timeout_ms=POOL_TIMEOUT_MS)
        got = _drain(pool, np.arange(6), epoch=0)
    finally:
        release.set()
        t.join(timeout=5)
    assert [int(s["video"][0, 0]) for s in got] == list(range(6))
    # as in the JAX package, what a child counts stays in the child
    assert counter.value() == 0


# --- the loader's process transport -------------------------------------------

def test_decode_threads_run_torch_on_one_thread():
    """The thread transport's decode threads run torch on one intra-op
    thread, as the forked workers do (`F.interpolate` gives other bytes on
    another thread count: 1.8e-7 apart at this shape on AVX-512); the
    constructing thread and threads started later keep the default."""
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, 4))
    try:
        pool = tpipe._decode_pool(3)
        try:
            counts = {pool.submit(torch.get_num_threads).result(timeout=10)
                      for _ in range(12)}
            later = []
            t = threading.Thread(target=lambda: later.append(torch.get_num_threads()))
            t.start()
            t.join(timeout=10)
            x = torch.rand(8, 3, 72, 96)
            resize = lambda: F.interpolate(x, size=(100, 133), mode="bilinear",  # noqa: E731
                                           align_corners=False)
            in_worker = pool.submit(resize).result(timeout=10)
        finally:
            pool.shutdown()
        assert counts == {1}
        assert torch.get_num_threads() == max(threads, 4) == later[0]
        torch.set_num_threads(1)
        assert torch.equal(in_worker, resize())
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("output_dtype", ["float32", "bfloat16"])
def test_process_transport_byte_equal_to_threads(output_dtype, deadline):
    """After the parent ran torch's thread pool, forked workers (torch on
    one thread) whose transforms resize 72x96 frames to a short side of
    100-130 give the thread transport's batches byte for byte."""
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, 4))
    try:
        F.interpolate(torch.rand(2, 3, 96, 96), size=(131, 131),
                      mode="bilinear")  # a parallel region in the parent
        tf = make_transform(training=True, num_frames=8, crop_size=96,
                            min_short_side_scale=100, max_short_side_scale=130,
                            output_dtype=output_dtype, is_slowfast=True,
                            slowfast_alpha=2)
        src = tpipe.SyntheticClipSource(tf, num_videos=10, num_classes=3,
                                        raw_frames=8, raw_size=(72, 96))
        kw = dict(shuffle=True, drop_last=False, seed=7, num_workers=3)
        a = tpipe.ClipLoader(src, 4, transport="thread", **kw)
        b = tpipe.ClipLoader(src, 4, transport="process", **kw)
        assert b.transport == "process"
        try:
            batches_a, batches_b = list(a.epoch(0)), list(b.epoch(0))
        finally:
            a.close()
            b.close()
    finally:
        torch.set_num_threads(threads)
    assert len(batches_a) == len(batches_b) == 3  # 10 clips, the tail padded
    for ba, bb in zip(batches_a, batches_b):
        assert set(ba) == set(bb) and all(_equal(ba[k], bb[k]) for k in ba)
    assert "mask" in batches_b[-1]
    assert b._shm_pool is None  # close() tore the pool down


def test_process_transport_resumes_mid_epoch(deadline):
    kw = dict(shuffle=True, drop_last=True, seed=7, transport="process",
              num_workers=2)
    loader = tpipe.ClipLoader(_source(8), 2, **kw)
    try:
        full = list(loader.epoch(1))
        assert loader.state == tpipe.LoaderState(epoch=2, position=0)
        loader.state = tpipe.LoaderState(epoch=1, position=2)
        tail = list(loader.epoch())
    finally:
        loader.close()
    assert len(full) == 4 and len(tail) == 2
    for ba, bb in zip(full[2:], tail):
        assert all(_equal(ba[k], bb[k]) for k in ba)


@pytest.fixture
def private_jax_native(monkeypatch, tmp_path):
    """The JAX package's library built into this test's own directory: its
    build writes one shared path, which races other processes building it."""
    monkeypatch.setattr(jnative, "_LIB_DIR", str(tmp_path / "jax_native"))
    monkeypatch.setattr(jnative, "_LIB",
                        str(tmp_path / "jax_native" / "libpva_native.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_failed", False)
    assert jnative.load() is not None


def test_process_transport_geometry_equals_jax(private_jax_native, deadline):
    """Order, loader positions and batch count of the JAX ClipLoader's
    process transport, and its bytes where no resize runs (short side 16 =
    the crop); accumulation 2, a padded eval tail."""
    common = dict(num_frames=4, crop_size=16, min_short_side_scale=16,
                  max_short_side_scale=16)
    for training, drop_last, accum in ((True, True, 2), (False, False, 1)):
        mine = tpipe.ClipLoader(
            tpipe.SyntheticClipSource(make_transform(training=training, **common),
                                      num_videos=11, num_classes=3,
                                      raw_frames=8, raw_size=(16, 20)),
            2, accum_steps=accum, shuffle=training, drop_last=drop_last,
            seed=3, num_workers=3, transport="process")
        theirs = jpipe.ClipLoader(
            jpipe.SyntheticClipSource(jmake_transform(training=training, **common),
                                      num_videos=11, num_classes=3,
                                      raw_frames=8, raw_size=(16, 20)),
            2, accum_steps=accum, shuffle=training, drop_last=drop_last,
            seed=3, num_workers=3, transport="process")
        assert theirs.transport == "process"
        try:
            got = list(mine.epoch_items(0))
            want = list(theirs.epoch_items(0))
        finally:
            mine.close()
            theirs.close()
        assert [s for _, s in got] == [
            tpipe.LoaderState(**s.to_dict()) for _, s in want]
        assert len(got) == len(want) == (3 if training else 7)
        for (bm, _), (bj, _) in zip(got[:-1], want[:-1]):
            assert set(bm) == set(bj)
            for k in bm:
                assert _equal(bm[k], np.asarray(bj[k])), k


def test_fallback_to_threads_without_a_compiler(monkeypatch, tmp_path, caplog):
    """No g++: the loader warns (the log once, the flight recorder) and
    runs threads; `transport` says so, and its batches are the thread
    transport's."""
    monkeypatch.setattr(native, "GXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    def warned():
        return sum("process transport unavailable" in json.dumps(e)
                   for e in obs.get_recorder().snapshot())

    before = warned()
    with caplog.at_level(logging.WARNING, logger="pva_tpu_torch"):
        loader = tpipe.ClipLoader(_source(4), 2, transport="process",
                                  num_workers=2)
        again = tpipe.ClipLoader(_source(4), 2, transport="process",
                                 num_workers=2)
    assert loader.transport == again.transport == "thread"
    assert native.load() is None and "no-such-g++" in native.load_error()
    assert sum("falls back to threads" in r.getMessage()
               for r in caplog.records) == 1
    assert warned() - before == 2
    want = list(tpipe.ClipLoader(_source(4), 2, transport="thread").epoch(0))
    got = list(loader.epoch(0))
    assert all(_equal(a[k], b[k]) for a, b in zip(got, want) for k in a)
    loader.close()
    again.close()
