"""The training application: epoch loop, eval, checkpoint and resume
(a lean counterpart of the JAX package's `trainer/loop.py`).

`Trainer(cfg)` builds the data (synthetic clips, a frame cache under
`data.cache_dir`, or real videos from `data.train_list`/`data.val_list` or
`<data_dir>/{train,val}/{class}/`, each through the full transform stack),
the model, the optimizer and the checkpointer; `fit()` runs the
epochs: train steps (gradient accumulation inside the step), checkpoints
every `checkpointing_steps` optimizer steps or every epoch plus a final
one, an eval pass at each epoch end, and returns the JAX trainer's result
keys with its throughput numbers (`clips_per_sec`, `steps_per_sec`,
`input_wait_frac`) and `preempted`. `evaluate()`, `export_inference()` and
`_maybe_resume()`
serve `run.py`'s `--eval_only`, `--export_inference` and
`--resume_from_checkpoint`. Mixup/cutmix (`--optim.mixup_alpha`,
`--optim.cutmix_alpha`) run inside the train step. `--guard.enabled` arms
the `TrainGuard` (reliability/guard.py): the step skips a nonfinite update
on the device, the guard observes each step one step late, rolls back to
its last-known-good ring and fast-forwards the loader, and on the
real-video route a `Quarantine` sidelines clips that keep failing to
decode. `--tracking.with_tracking` logs through the trackers
(trainer/tracking.py): the config at start, the step metrics every
`tracking.log_every` steps one step late, the epoch metrics, `evaluate()`'s
result. A `*_pretrain` model (VideoMAE) trains
self-supervised (`make_pretrain_step`, `make_pretrain_eval_step`): no
labels, float32 clips (`data.host_cast u8` is refused: the MAE target is
computed from the raw clip), one eval view, and `val_recon_loss` in place
of the accuracies. With `reliability.graceful_shutdown` (the default) the
process-default `PreemptionGuard` (reliability/preemption.py) holds
SIGTERM and SIGINT during `fit()`: the step loop polls it after each
optimizer step, and on a request it flushes the pending step log, saves a
checkpoint of kind "preempt" at the consumed loader position, writes
`<output_dir>/emergency_checkpoint.json`, skips eval and the final save and
returns `preempted: True` (run.py then exits 0); `--resume_from_checkpoint
auto` continues from that step. Checkpoint writes retry on OSError
(`reliability.ckpt_retries` attempts).

It runs on the CUDA card unless the config asks for the CPU (`--cpu`); on a
host without CUDA it raises. Real videos need cv2 to decode; where it is
missing the real-video branch raises `NoVideoDecoderError`, which names
the frame-cache route (build the cache where cv2 is, train with
`--data.cache_dir`). Options whose effect this slice lacks raise
NotImplementedError naming their ROADMAP item; telemetry and debug options
(`obs.*`, `debug_nans`, `debug_asserts`, `profile`), a `model.pretrained`
without a path and a `model.pretrained_path` without `model.pretrained`
print one line each and train on.

Fine-tuning: with `--model.pretrained --model.pretrained_path P` the fresh
model loads the converted weights of P (models/convert.py
`load_pretrained`: an `.npz` artifact, or a torch-hub / safetensors file
converted on the fly) before the optimizer, the EMA copy and the
broadcast of rank 0's parameters are made, so all three start from the
loaded weights; a head of another class count keeps its fresh init, and
`--model.freeze_backbone` trains the head alone.

Data parallelism (`parallel/`, one process per card, started by
`launch.py`): the Trainer joins the process group that the config or the
launcher's `PVA_*` env names (`initialize_distributed`), trains on card
`rank % card count`, and takes the data-parallel path whenever a group is
up, world size 1 included: each rank loads its 1/world share of every
global batch (`--batch_size` is per card), the step keeps the global view
(trainer/steps.py), rank 0's parameters are broadcast after init and after
every restore, the resume step is rank 0's, rank 0 alone writes
checkpoints, trackers and logs, a preemption seen by one rank stops every
rank at the same step (one scalar all-reduce a step), eval sums are added
across ranks, and `--debug_desync` compares the parameters' norm across
ranks at each epoch's end. `mesh.data` must be -1 or the world size.
Without a group it runs as a single process, launch for launch as before.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from pytorchvideo_accelerate_tpu_torch.config import TrainConfig
from pytorchvideo_accelerate_tpu_torch.data.cache import CachedClipSource
from pytorchvideo_accelerate_tpu_torch.data.device_prefetch import DevicePrefetcher
from pytorchvideo_accelerate_tpu_torch.data.manifest import (
    Quarantine,
    from_list,
    scan_directory,
)
from pytorchvideo_accelerate_tpu_torch.data.pipeline import (
    ClipLoader,
    LoaderState,
    SyntheticClipSource,
    VideoClipSource,
)
from pytorchvideo_accelerate_tpu_torch.data.transforms import make_transform
from pytorchvideo_accelerate_tpu_torch.models import create_model
from pytorchvideo_accelerate_tpu_torch.models.convert import load_pretrained
from pytorchvideo_accelerate_tpu_torch.parallel.collectives import (
    broadcast_,
    host_broadcast,
    host_reduce_sum,
)
from pytorchvideo_accelerate_tpu_torch.parallel.distributed import (
    any_process,
    check_desync,
    initialize_distributed,
    is_distributed,
    is_main_process,
    local_device_index,
    main_print,
    process_count,
    process_index,
    sync_global_devices,
)
from pytorchvideo_accelerate_tpu_torch.parallel.mesh import resolve_train_mesh_shape
from pytorchvideo_accelerate_tpu_torch.reliability.guard import TrainGuard
from pytorchvideo_accelerate_tpu_torch.reliability.preemption import (
    get_guard,
    record_emergency,
)
from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import (
    Checkpointer,
    export_inference,
    resolve_resume_path,
)
from pytorchvideo_accelerate_tpu_torch.trainer.metrics import MeanLoss, SumMetrics
from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer, global_norm
from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
    make_eval_step,
    make_pretrain_eval_step,
    make_pretrain_step,
    make_train_step,
)
from pytorchvideo_accelerate_tpu_torch.trainer.tracking import (
    DeferredStepLogger,
    TrackerHub,
)
from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

logger = logging.getLogger(__name__)


def _parse_checkpointing_steps(value: str):
    """"" -> None, "epoch" -> "epoch", digits -> int ("0" -> None)."""
    if not value:
        return None
    if value == "epoch":
        return "epoch"
    if value.isdigit():
        return int(value) or None
    raise ValueError(
        f"checkpointing_steps must be a number or 'epoch', got {value!r}")


def _say(line: str) -> None:
    main_print(f"pytorchvideo_accelerate_tpu_torch: {line}", flush=True)


def refuse_unported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for options that would change what is
    computed and that this slice of the port lacks; print one line for each
    telemetry or debug option, for a `model.pretrained` without a path and
    for a `model.pretrained_path` without `model.pretrained`."""
    d, m, mesh = cfg.data, cfg.model, cfg.mesh
    refused = [
        (mesh.model > 1, f"mesh.model={mesh.model} (the model axis: tensor "
                         "parallelism; Multi-GPU, ROADMAP.md A.1)"),
        (any(v > 1 for v in (mesh.fsdp, mesh.tensor, mesh.context)),
         f"the legacy mesh axes (fsdp={mesh.fsdp}, tensor={mesh.tensor}, "
         f"context={mesh.context}; FSDP and the library mesh; Multi-GPU, "
         "ROADMAP.md A.1)"),
        (cfg.parallel.pipeline_stages > 1,
         f"parallel.pipeline_stages={cfg.parallel.pipeline_stages} "
         "(parallel/pipeline.py; Multi-GPU, ROADMAP.md A.1)"),
        (d.dataplane_workers > 0,
         "data.dataplane_workers (the dataplane, ROADMAP.md A.4)"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} is not ported to PyTorch yet")
    if cfg.obs.enabled:
        _say("obs.* telemetry is not ported yet (ROADMAP.md); training runs "
             "without it")
    for on, flag in ((cfg.debug_nans, "debug_nans"),
                     (cfg.debug_asserts, "debug_asserts"),
                     (cfg.profile, "profile")):
        if on:
            _say(f"{flag} is not ported yet (ROADMAP.md); training runs "
                 "without it")
    if m.pretrained and not m.pretrained_path:
        _say("--model.pretrained set but --model.pretrained_path empty: "
             "training from scratch. Convert a checkpoint first and pass "
             "its path.")
    if m.pretrained_path and not m.pretrained:
        _say("--model.pretrained_path set without --model.pretrained: the "
             "path is ignored and training starts from the model's init. "
             "Pass both to load it.")


def resolve_train_device(cfg: TrainConfig) -> torch.device:
    """The CPU with `--cpu`; else the card, this rank's own (made current)
    when a process group is up."""
    if cfg.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the PyTorch port trains on the GPU unless asked "
            "for the CPU (--cpu)")
    if is_distributed():
        device = torch.device("cuda", local_device_index())
        torch.cuda.set_device(device)
        return device
    return torch.device("cuda")


class Trainer:
    """Builds the whole stack from a TrainConfig and runs fit()."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        # self-supervised objective (VideoMAE): no labels, the model
        # computes its own loss
        self.is_pretraining = cfg.model.name.endswith("_pretrain")
        resolve_train_device(cfg)  # no card and no --cpu: raise before joining
        initialize_distributed(cfg.coordinator_address, cfg.num_processes,
                               cfg.process_id, cpu=cfg.cpu)
        # after joining: every rank refuses alike, and rank 0 alone prints
        refuse_unported(cfg)
        self.distributed = is_distributed()
        self.rank, self.world = process_index(), process_count()
        self.mesh_shape = resolve_train_mesh_shape(cfg.mesh, self.world)
        self.device = resolve_train_device(cfg)
        if self.distributed:
            main_print(f"mesh: (data, model) = {self.mesh_shape} over "
                       f"{self.world} process(es), one {self.device.type} "
                       "device each", flush=True)
        self.checkpointing_steps = _parse_checkpointing_steps(
            cfg.checkpoint.checkpointing_steps)
        torch.manual_seed(cfg.seed)
        self.quarantine: Optional[Quarantine] = None
        self._build_data()
        self._build_model_and_steps()
        self.checkpointer: Optional[Checkpointer] = None
        if (self.checkpointing_steps is not None
                or cfg.checkpoint.resume_from_checkpoint):
            ckpt_dir = os.path.join(cfg.checkpoint.output_dir, "checkpoints")
            resume_dir = resolve_resume_path(
                cfg.checkpoint.resume_from_checkpoint, ckpt_dir)
            self.checkpointer = self._make_checkpointer(resume_dir or ckpt_dir)
        # None when disarmed: the step loop then does one `is None` check
        self.train_guard: Optional[TrainGuard] = None
        if cfg.guard.enabled:
            self.train_guard = TrainGuard(
                cfg.guard, output_dir=cfg.checkpoint.output_dir,
                config_dict=cfg.to_dict(), seed=cfg.seed,
                reliability=cfg.reliability)
            self.train_guard.quarantine = self.quarantine
        self.trackers: Optional[TrackerHub] = None
        if cfg.tracking.with_tracking and is_main_process():
            # the reference's run name (run.py:229)
            run_name = (str(cfg.tracking.logging_dir)
                        .replace(".", "").replace("/", "").replace("\\", ""))
            self.trackers = TrackerHub(cfg.tracking.trackers,
                                       cfg.tracking.logging_dir,
                                       retries=cfg.reliability.tracker_retries)
            self.trackers.start(run_name, cfg.to_dict())

    # --- construction -----------------------------------------------------

    def _build_data(self) -> None:
        cfg, d = self.cfg, self.cfg.data
        if d.host_cast not in ("auto", "fp32", "u8"):
            raise ValueError(f"data.host_cast must be 'auto', 'fp32' or "
                             f"'u8', got {d.host_cast!r}")
        if d.host_cast == "u8" and self.is_pretraining:
            raise ValueError(
                "data.host_cast='u8' is supervised-only: the MAE target is "
                "computed from the raw clip in fp32 (models/videomae.py patchify)")
        u8 = d.host_cast == "u8"
        # the MAE target is the raw clip: no host cast to bf16 either
        bf16 = (cfg.mixed_precision in ("bf16", "fp16")
                and d.host_cast == "auto" and not self.is_pretraining)
        common = dict(
            num_frames=d.num_frames,
            is_slowfast=cfg.model.name.startswith("slowfast"),
            slowfast_alpha=cfg.model.slowfast_alpha,
            min_short_side_scale=d.min_short_side_scale,
            max_short_side_scale=d.max_short_side_scale,
            crop_size=d.crop_size, mean=d.mean, std=d.std,
            horizontal_flip_p=d.horizontal_flip_p,
            output_dtype="uint8" if u8 else "bfloat16" if bf16 else "float32",
        )
        train_tf = make_transform(training=True, **common)
        self._device_normalize = train_tf.device_normalize
        # multi-view eval is supervised-only: the pretrain eval step scores
        # reconstructions clip by clip
        eval_clips = 1 if self.is_pretraining else d.eval_num_clips
        eval_spatial = 1 if self.is_pretraining else d.eval_num_spatial_crops
        if self.is_pretraining and (d.eval_num_clips > 1
                                    or d.eval_num_spatial_crops > 1):
            main_print("multi-view eval options ignored for self-supervised "
                       "pretraining", flush=True)
        val_tf = make_transform(training=False, num_spatial_crops=eval_spatial,
                                **common)
        self._build_sources(train_tf, val_tf, eval_clips)
        # the batch size is per card (a data shard), as in the JAX package
        global_batch = d.batch_size * self.mesh_shape[0]
        loader_kw = dict(seed=cfg.seed, num_workers=d.num_workers,
                         process_index=self.rank, process_count=self.world,
                         prefetch_batches=d.prefetch_batches,
                         transport=d.transport)
        self.train_loader = ClipLoader(
            self.train_source, global_batch,
            accum_steps=cfg.optim.gradient_accumulation_steps,
            shuffle=True, drop_last=True, **loader_kw)
        self.val_loader = ClipLoader(self.val_source, global_batch,
                                     shuffle=False, drop_last=False,
                                     **loader_kw)
        self.train_prefetch = DevicePrefetcher(
            self.train_loader, self.device, depth=d.device_prefetch_depth)
        self.val_prefetch = DevicePrefetcher(
            self.val_loader, self.device, depth=d.device_prefetch_depth)

    def _build_sources(self, train_tf, val_tf, eval_clips: int) -> None:
        """The train and val clip sources, and `num_classes`: synthetic
        clips (`cfg.model.num_classes`, default 4), a frame cache's
        `<cache_dir>/{train,val}`, or real videos from the list manifests
        (both or neither) or `<data_dir>/{train,val}`; the last two take
        `num_classes` from the train source."""
        cfg, d = self.cfg, self.cfg.data
        if d.synthetic:
            self.num_classes = cfg.model.num_classes or 4
            self.train_source = SyntheticClipSource(
                train_tf, num_videos=d.synthetic_num_videos,
                num_classes=self.num_classes, seed=cfg.seed)
            self.val_source = SyntheticClipSource(
                val_tf, num_videos=max(d.synthetic_num_videos // 4, 4),
                num_classes=self.num_classes, seed=cfg.seed + 1,
                num_clips=eval_clips)
            return
        if d.cache_dir:
            self.train_source = CachedClipSource(
                os.path.join(d.cache_dir, "train"), train_tf,
                cfg.clip_duration, training=True, seed=cfg.seed)
            self.val_source = CachedClipSource(
                os.path.join(d.cache_dir, "val"), val_tf, cfg.clip_duration,
                training=False, seed=cfg.seed, num_clips=eval_clips)
            self.num_classes = self.train_source.num_classes
            return
        if d.train_list or d.val_list:
            if not (d.train_list and d.val_list):
                raise ValueError(
                    "train_list and val_list must be set together "
                    "(mixing a list split with a scanned split would "
                    "give the two splits different label id spaces)")
            train_manifest = from_list(d.train_list, root=d.data_dir)
            val_manifest = from_list(d.val_list, root=d.data_dir)
            val_max = max(e.label for e in val_manifest.entries)
            if val_max >= train_manifest.num_classes:
                raise ValueError(
                    f"val_list label {val_max} is outside the train "
                    f"list's class space (num_classes="
                    f"{train_manifest.num_classes}): out-of-range "
                    "labels would silently corrupt eval metrics")
        else:
            train_manifest = scan_directory(os.path.join(d.data_dir, "train"))
            val_manifest = scan_directory(os.path.join(d.data_dir, "val"))
        if cfg.guard.enabled and cfg.guard.quarantine_budget > 0:
            # each rank decodes its own clips: a sidecar each, so that no
            # rank's write replaces another's
            sidecar = ("quarantine.json" if self.rank == 0
                       else f"quarantine.rank{self.rank}.json")
            self.quarantine = Quarantine(
                os.path.join(cfg.checkpoint.output_dir, sidecar),
                budget=cfg.guard.quarantine_budget)
        retry_kw = dict(decode_retries=cfg.reliability.decode_retries,
                        retry_base_delay_s=cfg.reliability.retry_base_delay_s)
        self.train_source = VideoClipSource(
            train_manifest, train_tf, cfg.clip_duration, training=True,
            seed=cfg.seed, quarantine=self.quarantine, **retry_kw)
        self.val_source = VideoClipSource(
            val_manifest, val_tf, cfg.clip_duration, training=False,
            seed=cfg.seed, num_clips=eval_clips, **retry_kw)
        self.num_classes = train_manifest.num_classes

    def _build_model_and_steps(self) -> None:
        cfg = self.cfg
        if not cfg.model.num_classes:
            cfg.model.num_classes = self.num_classes
        self.model = create_model(cfg.model, cfg.mixed_precision,
                                  seed=cfg.seed, data_cfg=cfg.data).to(self.device)
        self.pretrained_report: Optional[dict] = None
        if cfg.model.pretrained and cfg.model.pretrained_path:
            self._load_pretrained()
        self._replicate()
        steps_per_epoch = self.train_loader.steps_per_epoch()
        self.total_steps = max(steps_per_epoch * cfg.optim.num_epochs, 1)
        optimizer = build_optimizer(
            cfg.optim, self.total_steps, self.model.named_parameters(),
            backbone_filter=getattr(type(self.model), "backbone_param_filter",
                                    None),
            freeze_backbone=cfg.model.freeze_backbone)
        self.lr_schedule = optimizer.schedule
        self.state = TrainState.create(self.model, optimizer,
                                       ema_decay=cfg.optim.ema_decay)
        if self.is_pretraining:
            self.train_step = make_pretrain_step(
                self.model, optimizer,
                accum_steps=cfg.optim.gradient_accumulation_steps,
                ema_decay=cfg.optim.ema_decay, seed=cfg.seed,
                guard_skip=cfg.guard.enabled)
            self.eval_step = make_pretrain_eval_step(self.model)
            return
        self.train_step = make_train_step(
            self.model, optimizer,
            accum_steps=cfg.optim.gradient_accumulation_steps,
            label_smoothing=cfg.optim.label_smoothing,
            device_normalize=self._device_normalize,
            ema_decay=cfg.optim.ema_decay, dropout_seed=cfg.seed,
            mixup_alpha=cfg.optim.mixup_alpha,
            cutmix_alpha=cfg.optim.cutmix_alpha,
            guard_skip=cfg.guard.enabled)
        self.eval_step = make_eval_step(
            self.model, label_smoothing=cfg.optim.label_smoothing,
            device_normalize=self._device_normalize)

    def _load_pretrained(self) -> None:
        """Merge `--model.pretrained_path` into the fresh model and print
        the JAX Trainer's report lines. Every rank reads the file;
        `_replicate()` then makes rank 0's copy every rank's."""
        report = load_pretrained(self.cfg.model.pretrained_path, self.model,
                                 self.cfg.model.name)
        self.pretrained_report = report
        main_print(f"pretrained: loaded {len(report['loaded'])} tensors, "
                   f"kept {len(report['kept'])} fresh", flush=True)
        if report["interpolated"]:
            main_print("pretrained: pos-embed grid interpolated to this run's "
                       "geometry: " + ", ".join(report["interpolated"]),
                       flush=True)
        mism = report["mismatched"]
        # the head by family: .../head/... (ResNets, SlowFast, MViT,
        # VideoMAE) or X3D's top-level proj; exact anchors, so an MViT
        # block's attn/proj is no head
        nonhead = [p for p in mism if "/head/" not in p
                   and p not in ("params/proj/kernel", "params/proj/bias")]
        if mism:
            main_print(f"pretrained: {len(mism)} shape-mismatched leaves kept "
                       "fresh (expected for a swapped head): "
                       + ", ".join(mism[:4]) + ("..." if len(mism) > 4 else ""),
                       flush=True)
        if nonhead and is_main_process():
            logger.warning(
                "pretrained artifact has %d NON-head shape mismatches (stale "
                "artifact from an older layout? regenerate it with "
                "models/convert.py): %s", len(nonhead), ", ".join(nonhead[:8]))

    def _replicate(self) -> None:
        """Rank 0's parameters and floating buffers (the BN running
        averages) on every rank: one broadcast per dtype, after init and
        after a restore (a no-op without a group)."""
        if self.distributed:
            broadcast_([p.data for p in self.model.parameters()]
                       + [b for b in self.model.buffers() if b.is_floating_point()])

    # --- resume / export --------------------------------------------------

    def _maybe_resume(self) -> int:
        """Restore the latest checkpoint and the data position; returns the
        starting epoch. Under data parallelism rank 0's latest step is
        every rank's (a directory scan could race a landing checkpoint)."""
        if not (self.cfg.checkpoint.resume_from_checkpoint and self.checkpointer):
            return 0
        latest = self.checkpointer.latest_step()
        if self.distributed:
            latest = int(host_broadcast(-1 if latest is None else latest))
            latest = None if latest < 0 else latest
        if latest is None:
            if self.cfg.checkpoint.resume_from_checkpoint == "auto":
                main_print("resume=auto: no checkpoint found, starting fresh")
                return 0
            raise FileNotFoundError(
                f"no checkpoint to resume in {self.checkpointer.directory}")
        extra, step = self.checkpointer.restore(self.state, step=latest)
        self._replicate()
        main_print(f"resumed from checkpoint step {step}")
        data_state = LoaderState.from_dict(extra.get("data_state"))
        self.train_loader.state = data_state
        return data_state.epoch

    def export_inference(self, path: str) -> str:
        """Write the (EMA-resolved) serving artifact of the current state;
        with `--serve.quantization int8` it is baked int8. Rank 0 writes;
        every rank returns once it has."""
        if is_main_process():
            export_inference(
                path, self.model, config=self.cfg,
                meta={"num_classes": self.num_classes,
                      "model": self.cfg.model.name},
                step=self.state.step, params=self.state.eval_params(),
                quantization=self.cfg.serve.quantization)
        sync_global_devices("export_inference")
        return path

    def close(self) -> None:
        """Release the loaders and finish the trackers (fit(), evaluate()
        and an export-only run all end here)."""
        if self.trackers is not None:
            self.trackers.finish()
            self.trackers = None
        self.train_loader.close()
        self.val_loader.close()

    def _make_checkpointer(self, directory: str) -> Checkpointer:
        return Checkpointer(directory, max_to_keep=self.cfg.checkpoint.max_to_keep,
                            reliability=self.cfg.reliability)

    def _emergency_save(self, epoch: int, reason: str = "") -> None:
        """The preemption grace path's save: a checkpoint of kind
        "preempt" at the consumed loader position (unless this very step is
        already on disk, from a `checkpointing_steps` boundary) and the
        emergency record. A run without checkpointing gets a checkpointer
        here: a preempted run must resume with `resume=auto`."""
        cfg = self.cfg
        t0 = time.perf_counter()
        if self.checkpointer is None:
            self.checkpointer = self._make_checkpointer(
                os.path.join(cfg.checkpoint.output_dir, "checkpoints"))
        step = self.state.step
        # every rank stops at this step, and every earlier save ended at a
        # barrier: all ranks read the same directory here
        if self.checkpointer.latest_step() != step:
            self._save("preempt", epoch)
        if is_main_process():
            record_emergency(cfg.checkpoint.output_dir, step=step, epoch=epoch,
                             checkpoint_dir=self.checkpointer.directory,
                             reason=reason)
        main_print(f"preempted ({reason or 'requested'}): emergency checkpoint "
                   f"at step {step} in {time.perf_counter() - t0:.3f} s; resume "
                   "with --resume_from_checkpoint auto", flush=True)

    def _save(self, kind: str, epoch: int) -> None:
        if self.checkpointer is None:
            return
        self.checkpointer.save(self.state.step, self.state, {
            "kind": kind, "epoch": epoch,
            "data_state": self.train_loader.state.to_dict(),
            "num_classes": self.num_classes, "model": self.cfg.model.name})

    # --- eval / fit -------------------------------------------------------

    def _run_eval(self, epoch: int) -> tuple:
        """One pass over the val loader; (top1, top5, mean loss). Under data
        parallelism each rank scores its share (every rank the same number
        of batches) and the four sums are added across ranks once."""
        val = SumMetrics()
        for i, batch in enumerate(self.val_prefetch.epoch(epoch, from_start=True)):
            val.update(self.eval_step(self.state, batch))
            if 0 <= self.cfg.data.limit_val_batches <= i + 1:
                break
        if self.distributed:
            val.accuracy()  # drains the pending device sums
            keys = ("loss_sum", "correct", "correct5", "count")
            sums = host_reduce_sum(np.array([getattr(val, k) for k in keys]))
            for k, v in zip(keys, sums.tolist()):
                setattr(val, k, v)
        return val.accuracy(), val.accuracy_top5(), val.mean_loss()

    def evaluate(self) -> dict:
        """The validation loop once, without training (scores a resumed
        checkpoint or converted weights: `--resume_from_checkpoint` or
        `--model.pretrained_path` decide the weights)."""
        if not (self.cfg.checkpoint.resume_from_checkpoint
                or (self.cfg.model.pretrained and self.cfg.model.pretrained_path)):
            if is_main_process():
                logger.warning(
                    "evaluate() without --resume_from_checkpoint or "
                    "--model.pretrained_path: scoring freshly-initialized "
                    "random weights — the result is meaningless.")
        try:
            self._maybe_resume()
            acc, acc5, loss = self._run_eval(epoch=0)
            if self.is_pretraining:
                main_print(f"evaluate: val_recon_loss={loss:.4f}")
                result = {"val_recon_loss": loss}
            else:
                main_print(f"evaluate: val_acc={acc:.4f} val_acc5={acc5:.4f}")
                result = {"val_accuracy": acc, "val_accuracy_top5": acc5,
                          "val_loss": loss}
            if self.trackers is not None:
                self.trackers.log(result, step=self.state.step)
            return result
        finally:
            self.close()

    @staticmethod
    def _print_step(values: Dict[str, float], gstep: int) -> None:
        main_print(f"step {gstep}: loss={values['train_loss_step']:.4f} "
              f"lr={values['lr']:.6g} grad_norm={values['grad_norm']:.4f}",
              flush=True)

    def _guard_rollback(self, action) -> None:
        """Carry out a rollback verdict: the last-known-good state loaded
        into the live model and optimizer, the loader moved just past the
        anomalous batch (replaying it would diverge the same way)."""
        _, step = self.train_guard.restore(self.state, action)
        self._replicate()
        self.train_loader.state = LoaderState.from_dict(action.resume_position)
        main_print(f"guard: rolled back to last-known-good step {step} "
              f"({action.reason}); loader fast-forwarded to epoch "
              f"{self.train_loader.state.epoch} position "
              f"{self.train_loader.state.position}"
              + (f"; replay bundle: {action.bundle_path}"
                 if action.bundle_path else ""), flush=True)

    def fit(self) -> dict:
        cfg = self.cfg
        starting_epoch = self._maybe_resume()
        gstep = self.state.step
        last_val_acc = last_val_acc5 = last_val_loss = 0.0
        last_train_loss = float("nan")
        last_perf: Dict[str, float] = {}
        epoch_train_times = []
        # step metrics are read one step late: after the next dispatch
        deferred = DeferredStepLogger(self.trackers, on_flush=self._print_step)
        tguard = self.train_guard
        # SIGTERM/SIGINT set an Event; the loop reads it once per step
        guard = get_guard() if cfg.reliability.graceful_shutdown else None
        if guard is not None:
            guard.install()
        preempted = False
        try:
            # a rollback re-enters this epoch, or an earlier one, from the
            # loader position it set
            epoch = starting_epoch
            while epoch < cfg.optim.num_epochs:
                epoch_loss = MeanLoss()
                t_epoch = time.time()
                steps_done = 0
                rolled_back = False
                self.train_prefetch.pop_wait()
                for i, batch in enumerate(self.train_prefetch.epoch(epoch)):
                    metrics = self.train_step(self.state, batch)
                    gstep += 1
                    steps_done += 1
                    deferred.flush()
                    if tguard is not None:
                        # observes the previous step; a rollback abandons
                        # the one just dispatched
                        action = tguard.step(gstep, metrics, batch,
                                             self.train_loader.state,
                                             self.state)
                        if action is not None:
                            self._guard_rollback(action)
                            rolled_back = True
                            break
                    epoch_loss.update(metrics["loss"])
                    if gstep % cfg.tracking.log_every == 0:
                        deferred.defer({"train_loss_step": metrics["loss"],
                                        "lr": metrics["lr"],
                                        "grad_norm": metrics["grad_norm"]},
                                       step=gstep)
                    if (isinstance(self.checkpointing_steps, int)
                            and gstep % self.checkpointing_steps == 0):
                        self._save("step", epoch)
                    # a signal seen by any rank stops every rank here
                    if any_process(guard is not None and guard.requested):
                        # the step above is dispatched: leaving here never
                        # abandons an optimizer update
                        preempted = True
                        break
                    if 0 <= cfg.data.limit_train_batches <= i + 1:
                        break
                if preempted:
                    # no eval, no further epochs
                    deferred.flush()
                    self._emergency_save(epoch, reason=guard.reason or "peer")
                    break
                deferred.flush()
                if tguard is not None and not rolled_back:
                    # the epoch's last step is still pending in the guard
                    action = tguard.flush(self.state, self.train_loader.state)
                    if action is not None:
                        self._guard_rollback(action)
                        rolled_back = True
                if rolled_back:
                    gstep = self.state.step
                    epoch = self.train_loader.state.epoch
                    continue
                last_train_loss = epoch_loss.mean()  # the epoch's one sync
                t_train = time.time() - t_epoch
                epoch_train_times.append(t_train)
                wait_s = self.train_prefetch.pop_wait()
                last_val_acc, last_val_acc5, last_val_loss = self._run_eval(epoch)
                val_str = (f"val_recon_loss={last_val_loss:.4f}"
                           if self.is_pretraining else
                           f"val_acc={last_val_acc:.4f} "
                           f"val_acc5={last_val_acc5:.4f}")
                main_print(f"epoch {epoch}: {val_str} "
                           f"train_loss={last_train_loss:.4f} "
                           f"({time.time() - t_epoch:.1f}s)", flush=True)
                if t_train > 0 and steps_done > 0:
                    sps = steps_done / t_train
                    # clips of the global batch: every rank's share
                    cps = sps * self.train_loader.samples_per_yield * self.world
                    last_perf = {
                        "steps_per_sec": sps,
                        "clips_per_sec": cps,
                        "input_wait_s": wait_s,
                        "input_wait_frac": min(wait_s / t_train, 1.0),
                    }
                    if self.distributed:
                        last_perf["clips_per_sec_per_card"] = cps / self.world
                    if tguard is not None:
                        last_perf.update(tguard.perf_keys())
                if self.trackers is not None:
                    epoch_metrics = {"train_loss_epoch": last_train_loss,
                                     "epoch": epoch}
                    if self.is_pretraining:
                        epoch_metrics["val_recon_loss"] = last_val_loss
                    else:
                        epoch_metrics["accuracy"] = last_val_acc
                        epoch_metrics["accuracy_top5"] = last_val_acc5
                    epoch_metrics.update(last_perf)
                    self.trackers.log(epoch_metrics, step=epoch)
                if cfg.debug_desync:
                    check_desync(float(global_norm(
                        [p.detach() for p in self.model.parameters()])),
                        name=f"params@epoch{epoch}")
                if self.checkpointing_steps == "epoch":
                    self._save("epoch", epoch)
                epoch += 1
            if not preempted:
                self._save("final", cfg.optim.num_epochs - 1)
        finally:
            if guard is not None:
                guard.uninstall()  # the handlers from before fit()
            self.close()
        result = {"train_loss": last_train_loss, "steps": self.state.step,
                  "epoch_train_times": epoch_train_times,
                  "flops_per_step": None, "analytic_flops_per_step": None,
                  "preempted": preempted, **last_perf}
        if self.is_pretraining:
            result["val_recon_loss"] = last_val_loss
        else:
            result["val_accuracy"] = last_val_acc
            result["val_accuracy_top5"] = last_val_acc5
        return result
