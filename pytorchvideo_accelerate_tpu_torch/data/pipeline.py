"""Host-side clip pipeline: sources, batching, prefetch, state (the port's
copy of the JAX package's `data/pipeline.py`: the real-video and synthetic
sources with the bad-sample quarantine, and both transports; the
frame-cache source is in `data/cache.py`).

- a `ClipSource` maps (epoch, index) to one sample dict, deterministically;
- per-epoch shuffling from the shared seed, `(seed, 0xDA7A, epoch)`, with
  quarantined indices remapped onto clean ones (`substitute_indices`);
- a thread pool decodes and transforms samples, one batch-assembly lane
  keeps `prefetch_batches` batches in flight (`transport="thread"`, and
  "auto"); each decode thread runs torch on one intra-op thread, as the
  process transport's forked workers must (`_decode_pool`); or, with `transport="process"`, forked workers write samples
  into per-worker shared-memory rings (`native/shm_loader.py`), batches
  byte-equal to the thread transport's. Where the native library cannot
  be built the loader warns (the log and the flight recorder) and runs
  threads, and `transport` says "thread";
- batches are stacked by the native multithreaded gather-copy where the
  library loads (`stack_samples`), else by numpy / torch;
- the iterator position {epoch, position} is checkpointable (`LoaderState`),
  and resume fast-forwards it in O(1).

Batches are the JAX package's byte for byte for the same seed wherever no
resize runs (tests/test_torch_data.py).
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from queue import Empty, Queue
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from pytorchvideo_accelerate_tpu_torch import native, obs
from pytorchvideo_accelerate_tpu_torch.data import decode as decode_mod
from pytorchvideo_accelerate_tpu_torch.data.manifest import Manifest, Quarantine
from pytorchvideo_accelerate_tpu_torch.data.samplers import (
    random_clip,
    substitute_indices,
    uniform_clips,
)
from pytorchvideo_accelerate_tpu_torch.native.ringbuf import gather_copy
from pytorchvideo_accelerate_tpu_torch.reliability.retry import retry_call

logger = logging.getLogger(__name__)


class _DecodeFailure(Exception):
    """Tag for decode-layer failures crossing the transform boundary: keeps
    VideoClipSource's substitution from swallowing transform bugs."""


class ClipSource:
    """A deterministic map (epoch, index) -> sample dict of arrays."""

    num_classes: int

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def get(self, index: int, epoch: int) -> Dict[str, np.ndarray]:  # pragma: no cover
        raise NotImplementedError


def sample_views(read_span: Callable, transform: Callable, duration: float,
                 clip_duration: float, training: bool,
                 rng: np.random.Generator, num_clips: int) -> Dict[str, np.ndarray]:
    """Span selection + multi-view stacking for every clip source.

    Train: ONE random span. Eval: `num_clips` evenly spaced spans, times the
    transform's `num_spatial_crops` when it declares one, each transformed
    and stacked on one leading view axis, temporal-major.
    `read_span(start_sec, end_sec) -> (T, H, W, 3) uint8`."""
    n_spatial = max(getattr(transform, "num_spatial_crops", 1), 1)
    if training:
        spans = [random_clip(duration, clip_duration, rng)]
    else:
        spans = uniform_clips(duration, clip_duration, num_clips)
    if n_spatial > 1:
        views = []
        for s in spans:
            views.extend(transform.spatial_views(read_span(s.start, s.end)))
    else:
        views = [transform(read_span(s.start, s.end), rng) for s in spans]
    if len(views) == 1:  # no view axis for the single-view case
        return views[0]
    return {k: stack_samples([v[k] for v in views]) for k in views[0]}


class VideoClipSource(ClipSource):
    """Real videos: manifest entry -> clip span -> cv2 decode -> transform.

    `training=True` samples a random span with an RNG derived from (seed,
    epoch, index): reproducible across restarts, distinct across epochs.
    Eval takes `num_clips` evenly spaced views (`sample_views`).

    Unreadable videos are substituted, not fatal: up to
    `_MAX_CONSECUTIVE_FAILURES` replacement indices, each drawn from its own
    attempt-keyed stream `(seed, 0xBAD, epoch, index, attempt)`, and each
    attempt samples its span from `(seed, epoch, index, attempt)` (the
    first from `(seed, epoch, index)`), so the substitution does not depend
    on how many draws a failed decode consumed or on which paths this
    process already knows to be bad. Failed paths are remembered and logged
    once. The label comes from the video actually decoded. Decode reads
    retry transient failures (`retry_call`, `decode_retries` attempts)
    first. Only decode failures substitute: transform errors propagate.

    With a `quarantine` (`data/manifest.Quarantine`), every failure that
    survives the retries also counts against the clip's persisted budget;
    past it the path is quarantined: skipped without a decode attempt, and
    excluded at the sampler (`quarantined_indices()` feeds
    `samplers.substitute_indices`), this run and the next. Without cv2 the
    constructor raises `decode.NoVideoDecoderError`, which names the
    frame-cache route."""

    _MAX_CONSECUTIVE_FAILURES = 10  # pytorchvideo LabeledVideoDataset parity

    def __init__(self, manifest: Manifest, transform: Callable,
                 clip_duration: float, training: bool, seed: int = 42,
                 num_clips: int = 1, decode_retries: int = 2,
                 retry_base_delay_s: float = 0.05,
                 quarantine: Optional[Quarantine] = None):
        decode_mod.require_decoder()
        self.manifest = manifest
        self.transform = transform
        self.clip_duration = clip_duration
        self.training = training
        self.seed = seed
        self.decode_retries = max(int(decode_retries), 1)
        self.retry_base_delay_s = retry_base_delay_s
        self.num_clips = max(num_clips, 1) if not training else 1
        self.num_classes = manifest.num_classes
        self.quarantine = quarantine
        self._meta_cache: Dict[str, decode_mod.VideoMeta] = {}
        self._meta_lock = threading.Lock()
        self._failed: set = set()

    def __len__(self) -> int:
        return len(self.manifest)

    def quarantined_indices(self) -> set:
        """Manifest indices of quarantined paths (the sampler's exclusion
        input); empty without a quarantine."""
        if self.quarantine is None or len(self.quarantine) == 0:
            return set()
        bad = self.quarantine.paths()
        return {i for i, e in enumerate(self.manifest.entries) if e.path in bad}

    def _meta(self, path: str) -> decode_mod.VideoMeta:
        with self._meta_lock:
            meta = self._meta_cache.get(path)
        if meta is None:
            meta = decode_mod.probe(path)
            with self._meta_lock:
                self._meta_cache[path] = meta
        return meta

    def _read_span(self, path: str, a: float, b: float) -> np.ndarray:
        """decode_span with transient failures retried; a decode failure
        that survives the retries is tagged `_DecodeFailure`."""
        try:
            return retry_call(
                lambda: decode_mod.decode_span(path, a, b),
                attempts=self.decode_retries, retry_on=decode_mod.DECODE_ERRORS,
                base_delay_s=self.retry_base_delay_s, deadline_s=5.0)
        except decode_mod.DECODE_ERRORS as e:
            raise _DecodeFailure(str(e)) from e

    def _mark_failed(self, path: str, e: BaseException) -> None:
        with self._meta_lock:
            self._failed.add(path)
        if self.quarantine is not None:
            self.quarantine.record(path, e)
        logger.warning("skipping unreadable video %s (%s: %s); substituting",
                       path, type(e).__name__, e)

    def get(self, index: int, epoch: int) -> Dict[str, np.ndarray]:
        idx = index
        for attempt in range(self._MAX_CONSECUTIVE_FAILURES):
            rng = (np.random.default_rng((self.seed, epoch, index))
                   if attempt == 0
                   else np.random.default_rng(
                       (self.seed, epoch, index, attempt)))
            entry = self.manifest.entries[idx]
            with self._meta_lock:
                known_bad = entry.path in self._failed
            if not known_bad and self.quarantine is not None:
                # normally the sampler already excluded it; this covers
                # direct get() callers and paths quarantined mid-epoch
                known_bad = self.quarantine.contains(entry.path)
            if not known_bad:
                try:
                    meta = self._meta(entry.path)
                except decode_mod.DECODE_ERRORS as e:
                    self._mark_failed(entry.path, e)
                else:
                    # only the tagged decode failures substitute: a
                    # transform's own ValueError must propagate
                    try:
                        out = sample_views(
                            lambda a, b, p=entry.path: self._read_span(p, a, b),
                            self.transform, meta.duration, self.clip_duration,
                            self.training, rng, self.num_clips)
                    except _DecodeFailure as e:
                        self._mark_failed(entry.path, e)
                    else:
                        out["label"] = np.int32(entry.label)
                        return out
            # deterministic replacement, also attempt-keyed
            idx = int(np.random.default_rng(
                (self.seed, 0xBAD, epoch, index, attempt)
            ).integers(0, len(self.manifest)))
        raise IOError(
            f"{self._MAX_CONSECUTIVE_FAILURES} consecutive unreadable videos "
            f"starting at index {index} (see warnings for paths)")


class SyntheticClipSource(ClipSource):
    """Label-coded synthetic clips (no video files; the full transform stack
    still runs): the same `default_rng((seed, epoch, index))` stream as the
    JAX package's."""

    def __init__(self, transform: Callable, num_videos: int = 64,
                 num_classes: int = 4, raw_frames: int = 24,
                 raw_size: tuple = (72, 96), seed: int = 42,
                 num_clips: int = 1):
        self.transform = transform
        self.num_videos = num_videos
        self.num_classes = num_classes
        self.raw_frames = raw_frames
        self.raw_size = raw_size
        self.seed = seed
        self.num_clips = max(num_clips, 1)

    def __len__(self) -> int:
        return self.num_videos

    def get(self, index: int, epoch: int) -> Dict[str, np.ndarray]:
        label = index % self.num_classes
        rng = np.random.default_rng((self.seed, epoch, index))
        h, w = self.raw_size

        def synth_span(a, b):  # label-coded random frames, span-independent
            frames = (rng.random((self.raw_frames, h, w, 3)) * 60).astype(np.uint8)
            frames += np.uint8(label * (160 // max(self.num_classes - 1, 1)))
            return frames

        out = sample_views(synth_span, self.transform, 1.0, 1.0,
                           training=self.num_clips == 1, rng=rng,
                           num_clips=self.num_clips)
        out["label"] = np.int32(label)
        return out


def _decode_pool(n: int) -> ThreadPoolExecutor:
    """`n` decode threads, each running torch on one intra-op thread, as the
    process transport's forked workers do (`native/shm_loader.py`): the
    transforms' `F.interpolate` gives other bytes on another thread count
    (up to 3.6e-7 apart at full width on AVX-512), and the two transports'
    batches must be byte-equal. With torch's OpenMP backend
    `torch.set_num_threads` sets the calling thread's count and the default
    of threads not yet started: each worker sets 1 as it starts (after
    torch's lazy per-thread initialisation, which would reset it), and once
    all have started the constructing thread restores the default (its own
    count is unchanged)."""
    threads = torch.get_num_threads()
    started = threading.Barrier(n + 1)

    def one_thread():
        torch.get_num_threads()
        torch.set_num_threads(1)
        started.wait(timeout=60)

    pool = ThreadPoolExecutor(max_workers=n, initializer=one_thread)
    for _ in range(n):  # a worker waiting in its initializer is not idle:
        pool.submit(int)  # each submit starts another
    started.wait(timeout=60)
    torch.set_num_threads(threads)
    return pool


def stack_samples(arrs: List):
    """Stack numpy arrays (or torch tensors: bf16 clips) on a new axis 0,
    through the native gather-copy (`native/ringbuf.gather_copy`) where the
    library loads: the one batch-assembly path of both transports."""
    first = arrs[0]
    lib = native.load() if np.ndim(first) > 0 else None
    if torch.is_tensor(first):
        if lib is None or first.dtype != torch.bfloat16:
            return torch.stack(arrs)
        out = torch.empty((len(arrs), *first.shape), dtype=first.dtype)
        gather_copy(out.view(torch.int16).numpy(),
                    [a.contiguous().view(torch.int16).numpy() for a in arrs])
        return out
    if lib is None:
        return np.stack(arrs)
    first = np.asarray(first)
    out = np.empty((len(arrs), *first.shape), first.dtype)
    gather_copy(out, arrs)
    return out


def _pad_rows(x, n: int):
    """Append `n` zero rows along axis 0."""
    if torch.is_tensor(x):
        return torch.cat([x, x.new_zeros((n, *x.shape[1:]))])
    return np.concatenate([x, np.zeros((n, *x.shape[1:]), x.dtype)])


def assemble_batch(samples: List[Dict[str, np.ndarray]], pad_to: int,
                   accum_steps: int = 1) -> dict:
    """Stack per-sample dicts into one batch dict: padded + masked tail
    (val only) below `pad_to`, reshaped to (accum, pad_to // accum, ...)
    when `accum_steps > 1`."""
    n = len(samples)
    batch = {k: stack_samples([s[k] for s in samples]) for k in samples[0]}
    if n < pad_to:  # padded tail (val only): mask marks real samples
        mask = np.zeros(pad_to, np.float32)
        mask[:n] = 1.0
        batch = {k: _pad_rows(v, pad_to - n) for k, v in batch.items()}
        batch["mask"] = mask
    if accum_steps > 1:
        batch = {k: v.reshape(accum_steps, pad_to // accum_steps, *v.shape[1:])
                 for k, v in batch.items()}
    return batch


@dataclass
class LoaderState:
    """Checkpointable iterator position."""

    epoch: int = 0
    position: int = 0  # batches already yielded this epoch

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "position": self.position}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LoaderState":
        d = d or {}
        return cls(epoch=int(d.get("epoch", 0)), position=int(d.get("position", 0)))


class ClipLoader:
    """Batches a ClipSource for one process (one card) of a data-parallel
    job. Yields batch dicts shaped (B_local, ...), or (accum, B_local, ...)
    when `accum_steps > 1`: `global_batch_size` is the whole job's batch,
    B_local = global_batch_size / process_count this process's share.
    Process i takes every process_count-th clip of the epoch's order from
    the i-th, and every process yields `len(source) // process_count`
    clips' worth of batches (the JAX package's geometry: the same batch
    count on every rank, so no rank waits in a collective for a batch its
    peer never has).

    `transport`: "thread" (and "auto", as in the JAX package) decodes on a
    thread pool; "process" on forked workers through shared-memory rings,
    falling back to threads where the native library cannot be built
    (`self.transport` then reads "thread")."""

    def __init__(self, source: ClipSource, global_batch_size: int,
                 accum_steps: int = 1, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 42, num_workers: int = 8,
                 process_index: int = 0, process_count: int = 1,
                 prefetch_batches: int = 2, transport: str = "thread"):
        if global_batch_size % process_count:
            raise ValueError(
                f"global_batch_size {global_batch_size} not divisible by "
                f"process_count {process_count}")
        if transport not in ("auto", "thread", "process"):
            raise ValueError(
                f"transport must be auto|thread|process, got {transport!r}")
        self.source = source
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // process_count
        self.process_index = process_index
        self.process_count = process_count
        self.accum_steps = max(accum_steps, 1)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.prefetch_batches = prefetch_batches
        self.state = LoaderState()
        self._pool = _decode_pool(self.num_workers)
        self.transport = "thread" if transport == "auto" else transport
        self._shm_pool = None
        if self.transport == "process" and native.load() is None:
            self.transport = "thread"
            obs.get_recorder().warn(
                "process transport unavailable: the native library did not "
                "build; running threads", error=native.load_error())

    # --- epoch geometry ---------------------------------------------------

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.source))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, 0xDA7A, epoch))
            rng.shuffle(idx)
        idx = idx[self.process_index::self.process_count]
        # a sidelined clip never reaches the decode pool, and the epoch's
        # geometry (batch count, loader positions) stays the same
        quarantined = getattr(self.source, "quarantined_indices", None)
        if quarantined is not None:
            bad = quarantined()
            if bad:
                idx = substitute_indices(idx, bad, len(self.source),
                                         self.seed, epoch)
        return idx

    @property
    def samples_per_yield(self) -> int:
        return self.local_batch_size * self.accum_steps

    def steps_per_epoch(self) -> int:
        """Optimizer steps per epoch (one per yielded super-batch), the same
        on every process."""
        n = len(self.source) // self.process_count
        if self.drop_last:
            return n // self.samples_per_yield
        return -(-n // self.samples_per_yield)

    # --- iteration --------------------------------------------------------

    def epoch(self, epoch: Optional[int] = None,
              from_start: bool = False) -> Iterator[dict]:
        """Iterate one epoch, honouring and updating `self.state`.
        `from_start=True` ignores a stored mid-epoch position (eval)."""
        for batch, state in self.epoch_items(epoch, from_start):
            self.state = state
            if batch is not None:
                yield batch

    def epoch_items(self, epoch: Optional[int] = None,
                    from_start: bool = False) -> Iterator[tuple]:
        """Like `epoch()`, but yields `(batch, LoaderState)` pairs and never
        mutates `self.state`; a final `(None, rollover_state)` pair marks
        exhaustion. The device prefetcher advances this from its own thread
        and assigns the state when the trainer takes the batch, so a
        checkpoint records the consumed position."""
        start_state = self._start_state(epoch, from_start)
        epoch = start_state.epoch
        indices = self._epoch_indices(epoch)
        spy = self.samples_per_yield
        n_batches = self.steps_per_epoch()
        if self.transport == "process":
            yield from self._epoch_process_items(
                epoch, start_state.position, indices, n_batches)
            return

        def fetch_one(i) -> dict:
            # the "decode" span: one sample's decode and transform on a
            # worker thread (background: it overlaps the step loop)
            with obs.span("decode"):
                return self.source.get(int(i), epoch)

        def fetch_batch(b: int) -> dict:
            chunk = indices[b * spy:(b + 1) * spy]
            samples = list(self._pool.map(fetch_one, chunk))
            return assemble_batch(samples, spy, accum_steps=self.accum_steps)

        pending: "Queue[tuple]" = Queue()
        next_submit = start_state.position
        executor = ThreadPoolExecutor(max_workers=1)  # batch-assembly lane
        try:
            for _ in range(max(self.prefetch_batches, 1)):
                if next_submit < n_batches:
                    pending.put((next_submit, executor.submit(fetch_batch, next_submit)))
                    next_submit += 1
            while not pending.empty():
                b, fut = pending.get()
                batch = fut.result()
                if next_submit < n_batches:
                    pending.put((next_submit, executor.submit(fetch_batch, next_submit)))
                    next_submit += 1
                yield batch, LoaderState(epoch=epoch, position=b + 1)
            yield None, LoaderState(epoch=epoch + 1, position=0)
        finally:
            # an early exit must not leave queued batches decoding
            while not pending.empty():
                try:
                    pending.get_nowait()[1].cancel()
                except Empty:  # pragma: no cover - single-consumer queue
                    break
            executor.shutdown(wait=False, cancel_futures=True)

    def _start_state(self, epoch: Optional[int],
                     from_start: bool) -> LoaderState:
        if from_start:
            return LoaderState(
                epoch=self.state.epoch if epoch is None else epoch, position=0)
        if epoch is not None and epoch != self.state.epoch:
            return LoaderState(epoch=epoch, position=0)
        return self.state

    def _epoch_process_items(self, epoch: int, start: int,
                             indices: np.ndarray,
                             n_batches: int) -> Iterator[tuple]:
        """Forked shm workers; batches byte-equal to the thread transport's.
        The rings' capacity is the prefetch (workers run ahead of
        assembly)."""
        from pytorchvideo_accelerate_tpu_torch.native.shm_loader import (
            ShmWorkerPool,
        )

        spy = self.samples_per_yield
        if self._shm_pool is None:
            # a batch's slots are released once it is assembled; worker w
            # holds ceil(spy / W) samples of a batch, so its ring holds
            # that many slots in flight plus prefetch headroom
            self._shm_pool = ShmWorkerPool(
                self.source, num_workers=self.num_workers,
                slots_per_worker=-(-spy // self.num_workers) + 2)
        usable = indices[:n_batches * spy] if self.drop_last else indices
        samples, dones = [], []
        b = start

        def flush():
            nonlocal samples, dones
            batch = assemble_batch(samples, spy, accum_steps=self.accum_steps)
            for done in dones:
                done()
            samples, dones = [], []
            return batch

        for sample, done in self._shm_pool.map_epoch(usable, epoch,
                                                     start=start * spy):
            samples.append(sample)
            dones.append(done)
            if len(samples) == spy:
                yield flush(), LoaderState(epoch=epoch, position=b + 1)
                b += 1
        if samples:  # non-drop_last tail, padded + masked
            yield flush(), LoaderState(epoch=epoch, position=b + 1)
        yield None, LoaderState(epoch=epoch + 1, position=0)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        if self._shm_pool is not None:
            self._shm_pool.close()
            self._shm_pool = None
