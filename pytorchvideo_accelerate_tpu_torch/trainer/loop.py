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
NotImplementedError naming their ROADMAP item; the debug options
(`debug_nans`, `debug_asserts`, `profile`), the opt-in telemetry of later
slices (`obs.watchdog_timeout_s`, `obs.trace_sample_rate`,
`obs.profile_steps`), a `model.pretrained` without a path and a
`model.pretrained_path` without `model.pretrained` print one line each and
train on.

Telemetry (`obs.enabled`, on by default, as in the JAX package): the step
loop's sections are spans (`step`, `log`, `sync`, `ckpt`, `eval`; the
prefetchers add `input_wait` and `h2d`), drained every `log_every` steps
into the trackers as `obs/<span>_s` with `obs/window_wall_s` and
`obs/unattributed_s` (the window's wall time less its consumer spans), and
into the epoch's `obs_step_s`, `obs_input_wait_frac` and `obs_h2d_s`; the
step adds the health gauges `param_norm`, `update_ratio` and `nonfinite`,
logged as `obs/<name>` and published as `pva_train_param_norm`,
`pva_train_update_ratio` and `pva_train_nonfinite_loss_total`; the flight
recorder (`obs.flight_recorder_events` events) is installed on
`<output_dir>/flight_record.json` and dumped on an exception out of
`fit()`, on SIGTERM and on a preemption; the memory ledger
(`obs.memory_ledger`) accounts the train state and the prefetch rings
against the card's allocator; each `log_every` boundary ticks the metrics
history (`obs.history_ticks`). With `--obs.enabled false` none of it runs
and the logged keys are the ones without telemetry. Checkpoints are
written asynchronously (`checkpoint.async_checkpoint`): the step thread
queues the host copy, the Checkpointer's writer thread writes it; the
Trainer fences before the next save, before every restore and at the end
of `fit()`, `evaluate()` and `close()`, and the preemption save is
synchronous.

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
ranks at each epoch's end. Without a group it runs as a single process,
launch for launch as before.

The model axis (`--mesh.model M`, M dividing the world; `mesh.data` -1 or
world / M): the ranks sit on the (world / M, M) train mesh, rank r at
(r // M, r % M) (`distributed.initialize_mesh`), and the axis is spent as
the JAX trainer spends it (`parallel/tensor_parallel.py layout`, printed on
rank 0): MViT and VideoMAE split heads and MLP widths over it
(tensor-parallel), `--model.attention ring|ulysses` splits the
attention's tokens instead (context-parallel), `--parallel.pipeline_stages
M` cuts their block stacks into M stages instead (pipelined,
`parallel/pipeline.py`: the (G, B) micro axis folded into one forward,
eval unpipelined on every rank, the step's perf keys `pipeline_stages`,
`pipeline_microbatches`, `pipeline_bubble_frac_analytic`,
`pipeline_cps_per_chip`; on the library mesh the stages take the tensor
axis and compose with ring / Ulysses over context), the conv families
replicate. Every rank builds the full-width model from the seed (and loads
`--model.pretrained_path` into it), then keeps its shards; the ranks of a
model group load the same batches (the loader is dealt by data index and
count), eval sums are added over the data axis, and checkpoints and the
exported artifact hold the full tree, gathered over the model group, so
they resume and serve at any layout.

The library mesh (`--mesh.data D --mesh.fsdp F --mesh.tensor T
--mesh.context C`, any of F, T, C above 1; `--mesh.model` above 1 beside
them raises the JAX package's ValueError): the ranks sit on the (D, F, T,
C) grid (`distributed.initialize_library_mesh`), the batch shards over data
x fsdp (the loader dealt by batch-shard index and count, `--batch_size` a
shard's), MViT and VideoMAE split over `tensor` while ring / Ulysses split
the tokens over `context`, and every leaf of at least 2^16 elements keeps
its fsdp chunk (`parallel/fsdp.py`, the JAX `param_sharding` rule). Every
rank builds the full model (and loads `--model.pretrained_path` into it),
takes rank 0's copy, then cuts: tensor and context, then fsdp. Eval sums
over the batch shards; checkpoints and the export hold the full tree,
gathered over fsdp and tensor, so they resume at any layout.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from pytorchvideo_accelerate_tpu_torch import obs
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
from pytorchvideo_accelerate_tpu_torch.obs import memory as obs_memory
from pytorchvideo_accelerate_tpu_torch.parallel.collectives import (
    broadcast_,
    host_broadcast,
    host_reduce_sum,
)
from pytorchvideo_accelerate_tpu_torch.parallel.distributed import (
    any_process,
    batch_count,
    batch_index,
    check_desync,
    data_count,
    data_group,
    fsdp_count,
    fsdp_index,
    group_ranks,
    initialize_distributed,
    initialize_library_mesh,
    initialize_mesh,
    is_distributed,
    is_main_process,
    local_device_index,
    main_print,
    model_index,
    process_count,
    process_index,
    sync_global_devices,
    tensor_count,
    tensor_index,
)
from pytorchvideo_accelerate_tpu_torch.parallel.mesh import (
    cp_axis,
    data_shard_count,
    is_library,
    mesh_line,
    resolve_layout,
)
from pytorchvideo_accelerate_tpu_torch.parallel.pipeline import (
    PipelinePlan,
    analytic_bubble_frac,
)
from pytorchvideo_accelerate_tpu_torch.parallel.pipeline import (
    make_plan as make_pipeline_plan,
)
from pytorchvideo_accelerate_tpu_torch.parallel.sharding import full_state_dict
from pytorchvideo_accelerate_tpu_torch.parallel.tensor_parallel import (
    CP_BACKENDS,
    apply_model_axis,
    layout,
    param_kinds,
)
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
    debug option and opt-in telemetry option set, for a `model.pretrained`
    without a path and for a `model.pretrained_path` without
    `model.pretrained`."""
    d, m = cfg.data, cfg.model
    refused = [
        (cfg.parallel.pipeline_stages > 1 and cfg.mesh.fsdp > 1,
         "parallel.pipeline_stages > 1 with mesh.fsdp > 1 (pipeline x "
         "FSDP, ROADMAP.md A)"),
        (d.dataplane_workers > 0,
         "data.dataplane_workers (the dataplane, ROADMAP.md A.7)"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} is not ported to PyTorch yet")
    for on, flag in ((cfg.debug_nans, "debug_nans"),
                     (cfg.debug_asserts, "debug_asserts"),
                     (cfg.profile, "profile"),
                     (cfg.obs.enabled and cfg.obs.watchdog_timeout_s > 0,
                      "obs.watchdog_timeout_s"),
                     (cfg.obs.enabled and cfg.obs.trace_sample_rate > 0,
                      "obs.trace_sample_rate"),
                     (bool(cfg.obs.profile_steps), "obs.profile_steps")):
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
        # (data, model), or the library mesh's (data, fsdp, tensor, context)
        self.mesh_shape = resolve_layout(cfg.mesh, self.world)
        library = is_library(self.mesh_shape)
        if self.distributed and library:
            initialize_library_mesh(*self.mesh_shape[1:])
        elif self.distributed:
            initialize_mesh(self.mesh_shape[1])
        # pipeline stages spend the model axis (the library mesh's tensor
        # axis): no Megatron TP then; on the train mesh ring / Ulysses want
        # the same axis and make_plan refuses, on the library mesh they
        # keep the context axis
        self.pipeline_plan: Optional[PipelinePlan] = None
        if cfg.parallel.pipeline_stages > 1:
            self.pipeline_plan = make_pipeline_plan(
                self.mesh_shape, cfg.parallel.pipeline_stages,
                microbatches=cfg.parallel.pipeline_microbatches,
                accum_steps=cfg.optim.gradient_accumulation_steps,
                cp_axis_name=(cp_axis(self.mesh_shape)
                              if cfg.model.attention in CP_BACKENDS else None))
        self.device = resolve_train_device(cfg)
        # telemetry before the data stack, so the prefetchers' spans and the
        # ledger's allocation sites see it (JAX `loop.py`); off, the ledger
        # and the history are disarmed too
        self.obs_on = cfg.obs.enabled
        obs.configure(enabled=cfg.obs.enabled,
                      capacity=cfg.obs.flight_recorder_events)
        obs_memory.configure(enabled=self.obs_on and cfg.obs.memory_ledger,
                             recorder=obs.get_recorder(), device=self.device)
        obs.history.configure(enabled=self.obs_on and cfg.obs.history_ticks > 0,
                              capacity=cfg.obs.history_ticks)
        if self.obs_on:
            obs.get_recorder().install(cfg.checkpoint.output_dir)
        # the tensor-parallel split: the library mesh's tensor axis, or the
        # model axis
        self.model_axis = layout(
            cfg.model.name, cfg.model.attention, tensor_count(), tensor_index(),
            library=library, fsdp_count=fsdp_count(), fsdp_index=fsdp_index(),
            pipeline=self.pipeline_plan)
        if self.distributed:
            main_print(mesh_line(self.mesh_shape, self.device.type,
                                 self.model_axis.mode), flush=True)
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
        # the batch size is per card (a batch shard), as in the JAX package
        global_batch = d.batch_size * data_shard_count(self.mesh_shape)
        # the tensor and context ranks of a batch shard share its slice:
        # dealt by batch-shard index (data x fsdp)
        loader_kw = dict(seed=cfg.seed, num_workers=d.num_workers,
                         process_index=batch_index(), process_count=batch_count(),
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
        # the eval wait nests inside the "eval" span: background-classed names
        self.val_prefetch = DevicePrefetcher(
            self.val_loader, self.device, depth=d.device_prefetch_depth,
            wait_name="eval_input_wait", h2d_name="eval_h2d")

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
        # the full-width model on every rank (and the pretrained weights
        # loaded into it), then this rank's shards of it
        self.model = create_model(cfg.model, cfg.mixed_precision,
                                  seed=cfg.seed, data_cfg=cfg.data,
                                  pipeline=self.pipeline_plan)
        self.pretrained_report: Optional[dict] = None
        if cfg.model.pretrained and cfg.model.pretrained_path:
            self._load_pretrained()
        if self.model_axis.library and self.distributed:
            # rank 0's full model on every rank, before the cut (on the
            # device: NCCL carries no host tensor)
            self.model = self.model.to(self.device)
            self._broadcast_model(None, 0)
        self.model = apply_model_axis(self.model, self.model_axis).to(self.device)
        self._replicate()
        steps_per_epoch = self.train_loader.steps_per_epoch()
        self.total_steps = max(steps_per_epoch * cfg.optim.num_epochs, 1)
        optimizer = build_optimizer(
            cfg.optim, self.total_steps, self.model.named_parameters(),
            backbone_filter=getattr(type(self.model), "backbone_param_filter",
                                    None),
            freeze_backbone=cfg.model.freeze_backbone,
            sharded=param_kinds(self.model))
        self.lr_schedule = optimizer.schedule
        self.state = TrainState.create(self.model, optimizer,
                                       ema_decay=cfg.optim.ema_decay)
        self._ledger_train_state()
        if self.is_pretraining:
            self.train_step = make_pretrain_step(
                self.model, optimizer,
                accum_steps=cfg.optim.gradient_accumulation_steps,
                ema_decay=cfg.optim.ema_decay, seed=cfg.seed,
                guard_skip=cfg.guard.enabled, health_metrics=self.obs_on,
                pipeline=self.pipeline_plan)
            # eval runs without autograd: the plain loop on every rank, the
            # JAX trainer's unpipelined eval twin
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
            guard_skip=cfg.guard.enabled, health_metrics=self.obs_on,
            pipeline=self.pipeline_plan)
        self.eval_step = make_eval_step(
            self.model, label_smoothing=cfg.optim.label_smoothing,
            device_normalize=self._device_normalize)

    def _pipeline_perf(self, perf: dict) -> None:
        """The JAX trainer's pipeline keys: the plan's stages and
        microbatches, the analytic fill-drain bubble and clips/s per card,
        and the `pva_pipeline_bubble_frac` gauge when obs is on."""
        plan = self.pipeline_plan
        perf["pipeline_stages"] = plan.stages
        perf["pipeline_microbatches"] = plan.microbatches
        perf["pipeline_bubble_frac_analytic"] = analytic_bubble_frac(
            plan.stages, plan.microbatches)
        perf["pipeline_cps_per_chip"] = perf["clips_per_sec"] / self.world
        if self.obs_on:
            obs.get_registry().gauge(
                "pva_pipeline_bubble_frac",
                "pipeline fill/drain idle fraction, analytic (P-1)/(M+P-1)",
            ).set(perf["pipeline_bubble_frac_analytic"])

    def _ledger_train_state(self) -> None:
        """The ledger's `train_state` component: the bytes of this rank's
        parameters, buffers, optimizer state and EMA. Set at construction
        and again after the first step (torch makes the optimizer's state
        at the first update) and after a restore."""
        obs_memory.release("train_state")
        obs_memory.register("train_state", obs_memory.tree_nbytes(self.state))

    def _load_pretrained(self) -> None:
        """Merge `--model.pretrained_path` into the fresh full-width model
        and print the JAX Trainer's report lines. Every rank reads the
        file; `_replicate()` then makes rank 0's copy every rank's (the
        first rank's of each data group, under a model axis)."""
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
        """The data group's first rank's parameters and floating buffers
        (the BN running averages) on every rank of the group: one broadcast
        per dtype, after init and after a restore (a no-op without a group
        or with one data slice). At model 1 that is rank 0 to every rank;
        on a model axis each shard comes from its data group's first rank.
        On the library mesh rank 0's full model went to every rank before
        the cut, and a restore loads one file on every rank: no-op."""
        if self.distributed and data_count() > 1 and not self.model_axis.library:
            group = data_group()
            self._broadcast_model(group, group_ranks(group)[0])

    def _broadcast_model(self, group, src: int) -> None:
        broadcast_([p.data for p in self.model.parameters()]
                   + [b for b in self.model.buffers() if b.is_floating_point()],
                   src=src, group=group)

    # --- resume / export --------------------------------------------------

    def _maybe_resume(self) -> int:
        """Restore the latest checkpoint and the data position; returns the
        starting epoch. Under data parallelism rank 0's latest step is
        every rank's (a directory scan could race a landing checkpoint)."""
        if not (self.cfg.checkpoint.resume_from_checkpoint and self.checkpointer):
            return 0
        self.checkpointer.wait()
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
        self._ledger_train_state()
        main_print(f"resumed from checkpoint step {step}")
        data_state = LoaderState.from_dict(extra.get("data_state"))
        self.train_loader.state = data_state
        return data_state.epoch

    def export_inference(self, path: str) -> str:
        """Write the (EMA-resolved) serving artifact of the current state;
        with `--serve.quantization int8` it is baked int8. Rank 0 writes;
        every rank returns once it has."""
        axis = self.model_axis
        full = full_state_dict(self.model.state_dict(), axis)
        ema = self.state.eval_params()
        if ema is not None:
            ema = full_state_dict(ema, axis)
        if is_main_process():
            export_inference(
                path, self.model, config=self.cfg,
                meta={"num_classes": self.num_classes,
                      "model": self.cfg.model.name},
                step=self.state.step, params=ema,
                quantization=self.cfg.serve.quantization, state=full)
        sync_global_devices("export_inference")
        return path

    def close(self, unwinding: Optional[BaseException] = None) -> None:
        """Finish the trackers, fence the checkpoint writes (the run's and
        the guard's ring) and release the loaders (fit(), evaluate() and an
        export-only run all end here). Each step runs even when one before
        it raised, and the first error raises here: a failed write is never
        lost. `unwinding`: the exception this rank is leaving on. The
        writers are then fenced without the rank barrier (the other ranks
        may be stuck in a collective and never reach it), and an error here
        is added to `unwinding` as a note and logged, instead of replacing
        it."""
        barrier = unwinding is None
        steps = []
        if self.trackers is not None:
            steps.append(self.trackers.finish)
            self.trackers = None
        if self.checkpointer is not None:
            steps.append(lambda: self.checkpointer.close(barrier))
        if self.train_guard is not None:
            steps.append(lambda: self.train_guard.close(barrier))
        steps += [self.train_loader.close, self.val_loader.close]
        errors = []
        for step in steps:
            try:
                step()
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)
        if not errors:
            return
        if unwinding is None:
            for e in errors[1:]:
                errors[0].add_note(f"also raised while closing: {e!r}")
            raise errors[0]
        for e in errors:
            logger.error("while closing after %r", unwinding, exc_info=e)
            unwinding.add_note(f"also raised while closing: {e!r}")

    def _make_checkpointer(self, directory: str,
                           use_async: Optional[bool] = None) -> Checkpointer:
        return Checkpointer(directory, max_to_keep=self.cfg.checkpoint.max_to_keep,
                            reliability=self.cfg.reliability,
                            use_async=(self.cfg.checkpoint.async_checkpoint
                                       if use_async is None else use_async))

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
                os.path.join(cfg.checkpoint.output_dir, "checkpoints"),
                use_async=False)
        step = self.state.step
        # every rank stops at this step, and the fence ends every earlier
        # save at a barrier: all ranks read the same directory here
        self.checkpointer.wait()
        if self.checkpointer.latest_step() != step:
            self._save("preempt", epoch)
        self.checkpointer.wait()  # on disk before the process may exit
        if is_main_process():
            record_emergency(cfg.checkpoint.output_dir, step=step, epoch=epoch,
                             checkpoint_dir=self.checkpointer.directory,
                             reason=reason)
        if self.obs_on:
            recorder = obs.get_recorder()
            recorder.record("preempt", "emergency checkpoint saved",
                            step=step, epoch=epoch)
            recorder.dump()
        main_print(f"preempted ({reason or 'requested'}): emergency checkpoint "
                   f"at step {step} in {time.perf_counter() - t0:.3f} s; resume "
                   "with --resume_from_checkpoint auto", flush=True)

    def _save(self, kind: str, epoch: int) -> None:
        if self.checkpointer is None:
            return
        with obs.span("ckpt"):
            self._save_inner(kind, epoch)

    def _save_inner(self, kind: str, epoch: int) -> None:
        self.checkpointer.save(self.state.step, self.state, {
            "kind": kind, "epoch": epoch,
            "data_state": self.train_loader.state.to_dict(),
            "num_classes": self.num_classes, "model": self.cfg.model.name})

    # --- eval / fit -------------------------------------------------------

    def _run_eval(self, epoch: int) -> tuple:
        """One pass over the val loader; (top1, top5, mean loss). Under data
        parallelism each rank scores its share (every rank the same number
        of batches) and the four sums are added across the batch shards
        once."""
        val = SumMetrics()
        with obs.span("eval"):
            for i, batch in enumerate(self.val_prefetch.epoch(epoch,
                                                              from_start=True)):
                val.update(self.eval_step(self.state, batch))
                if 0 <= self.cfg.data.limit_val_batches <= i + 1:
                    break
        if self.distributed:
            val.accuracy()  # drains the pending device sums
            keys = ("loss_sum", "correct", "correct5", "count")
            # the tensor and context ranks of a batch shard score the same
            # clips: one counts
            mine = np.array([getattr(val, k) if model_index() == 0 else 0.0
                             for k in keys])
            sums = host_reduce_sum(mine)
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
        unwinding = None
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
        except BaseException as e:
            unwinding = e
            raise
        finally:
            self.close(unwinding)

    @staticmethod
    def _print_step(values: Dict[str, float], gstep: int) -> None:
        main_print(f"step {gstep}: loss={values['train_loss_step']:.4f} "
              f"lr={values['lr']:.6g} grad_norm={values['grad_norm']:.4f}",
              flush=True)

    def _guard_rollback(self, action) -> None:
        """Carry out a rollback verdict: the last-known-good state loaded
        into the live model and optimizer, the loader moved just past the
        anomalous batch (replaying it would diverge the same way). The
        run's own writes are fenced first, the ring's by the guard."""
        if self.checkpointer is not None:
            self.checkpointer.wait()
        _, step = self.train_guard.restore(self.state, action)
        self._replicate()
        self._ledger_train_state()
        self.train_loader.state = LoaderState.from_dict(action.resume_position)
        if self.obs_on:
            obs.get_recorder().record(
                "guard", "rollback", lkg_step=step,
                resume=dict(action.resume_position), reason=action.reason)
        main_print(f"guard: rolled back to last-known-good step {step} "
              f"({action.reason}); loader fast-forwarded to epoch "
              f"{self.train_loader.state.epoch} position "
              f"{self.train_loader.state.position}"
              + (f"; replay bundle: {action.bundle_path}"
                 if action.bundle_path else ""), flush=True)

    def _on_flush(self):
        """The DeferredStepLogger hook: the step line, and with obs on the
        logged values mirrored into the metric registry (JAX
        `_obs_on_flush`): the grad and param norm and the update ratio as
        gauges, a non-finite loss counted and warned into the flight
        recorder. Sampled at `log_every`, read one step late."""
        if not self.obs_on:
            return self._print_step
        reg = obs.get_registry()
        g_grad = reg.gauge("pva_train_grad_norm",
                           "global gradient norm (sampled at log_every)")
        g_param = reg.gauge("pva_train_param_norm",
                            "global parameter norm (sampled at log_every)")
        g_ratio = reg.gauge("pva_train_update_ratio",
                            "update-norm / param-norm (sampled at log_every)")
        c_nonfinite = reg.counter(
            "pva_train_nonfinite_loss_total",
            "non-finite loss values observed at log_every sampling")

        def on_flush(vals: Dict[str, float], step: int) -> None:
            self._print_step(vals, step)
            g_grad.set(vals["grad_norm"])
            g_param.set(vals["obs/param_norm"])
            g_ratio.set(vals["obs/update_ratio"])
            if vals["obs/nonfinite"]:
                c_nonfinite.inc()
                obs.get_recorder().warn("non-finite loss", step=step)

        return on_flush

    def fit(self) -> dict:
        cfg = self.cfg
        starting_epoch = self._maybe_resume()
        gstep = self.state.step
        last_val_acc = last_val_acc5 = last_val_loss = 0.0
        last_train_loss = float("nan")
        last_perf: Dict[str, float] = {}
        epoch_train_times = []
        # step metrics are read one step late: after the next dispatch
        deferred = DeferredStepLogger(self.trackers, on_flush=self._on_flush())
        tguard = self.train_guard
        # obs windows: the collector aggregates named spans; each log_every
        # boundary drains them into the trackers (obs/<span>_s, the
        # window's wall time and its unattributed rest), and epoch_spans
        # keeps the epoch's totals for the perf keys
        collector = obs.get_collector() if self.obs_on else None
        epoch_spans: Dict[str, float] = {}

        def drain_spans(log_step=None, window_wall=None):
            if collector is None:
                return
            window = collector.pop_window()
            for name, (total, _count) in window.items():
                epoch_spans[name] = epoch_spans.get(name, 0.0) + total
            if log_step is None or self.trackers is None or not window:
                return
            vals = {f"obs/{n}_s": t for n, (t, _c) in window.items()}
            if window_wall is not None:
                # consumer spans account the loop's wall time; background
                # ones overlap it on worker threads: reported, not summed
                consumer = sum(t for n, (t, _c) in window.items()
                               if n not in obs.BACKGROUND_SPANS)
                vals["obs/window_wall_s"] = window_wall
                vals["obs/unattributed_s"] = window_wall - consumer
            self.trackers.log(vals, step=log_step)

        if collector is not None:
            collector.pop_window()  # construction and resume: no window's
        # SIGTERM/SIGINT set an Event; the loop reads it once per step
        guard = get_guard() if cfg.reliability.graceful_shutdown else None
        if guard is not None:
            guard.install()
        preempted = False
        # the ledger's train_state again after the first step, which makes
        # the optimizer's state
        ledgered = False
        window_t0 = time.perf_counter()
        unwinding = None
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
                # spans between epochs (the epoch-end save) are no window's
                drain_spans()
                epoch_spans.clear()
                window_t0 = time.perf_counter()
                for i, batch in enumerate(self.train_prefetch.epoch(epoch)):
                    with obs.span("step"):
                        metrics = self.train_step(self.state, batch)
                    gstep += 1
                    steps_done += 1
                    if not ledgered:
                        self._ledger_train_state()
                        ledgered = True
                    with obs.span("log"):
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
                        vals = {"train_loss_step": metrics["loss"],
                                "lr": metrics["lr"],
                                "grad_norm": metrics["grad_norm"]}
                        if self.obs_on:
                            # the health gauges ride the same deferred read
                            vals["obs/param_norm"] = metrics["param_norm"]
                            vals["obs/update_ratio"] = metrics["update_ratio"]
                            vals["obs/nonfinite"] = metrics["nonfinite"]
                        deferred.defer(vals, step=gstep)
                    if self.obs_on and gstep % cfg.tracking.log_every == 0:
                        now = time.perf_counter()
                        drain_spans(log_step=gstep, window_wall=now - window_t0)
                        window_t0 = now
                        # a scrape tick of the history ring: the ledger's
                        # gauges land in it too
                        hist = obs.history.get_history()
                        if hist is not None:
                            hist.tick()
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
                epoch_mean = float("nan")
                if not rolled_back:
                    with obs.span("sync"):
                        epoch_mean = epoch_loss.mean()  # the epoch's one sync
                with obs.span("log"):
                    deferred.flush()
                if tguard is not None and not rolled_back:
                    # the epoch's last step is still pending in the guard
                    action = tguard.flush(self.state, self.train_loader.state)
                    if action is not None:
                        self._guard_rollback(action)
                        rolled_back = True
                if rolled_back:
                    gstep = self.state.step
                    drain_spans()
                    epoch_spans.clear()
                    window_t0 = time.perf_counter()
                    epoch = self.train_loader.state.epoch
                    continue
                last_train_loss = epoch_mean
                t_train = time.time() - t_epoch
                epoch_train_times.append(t_train)
                wait_s = self.train_prefetch.pop_wait()
                if self.obs_on:
                    # the train section's last window closes before eval
                    now = time.perf_counter()
                    drain_spans(log_step=gstep, window_wall=now - window_t0)
                    window_t0 = now
                last_val_acc, last_val_acc5, last_val_loss = self._run_eval(epoch)
                if self.obs_on:
                    # the eval window: logged, no sum (eval nests its waits)
                    drain_spans(log_step=gstep)
                    window_t0 = time.perf_counter()
                val_str = (f"val_recon_loss={last_val_loss:.4f}"
                           if self.is_pretraining else
                           f"val_acc={last_val_acc:.4f} "
                           f"val_acc5={last_val_acc5:.4f}")
                main_print(f"epoch {epoch}: {val_str} "
                           f"train_loss={last_train_loss:.4f} "
                           f"({time.time() - t_epoch:.1f}s)", flush=True)
                if t_train > 0 and steps_done > 0:
                    sps = steps_done / t_train
                    # clips of the global batch: every batch shard's share
                    cps = sps * self.train_loader.samples_per_yield * batch_count()
                    last_perf = {
                        "steps_per_sec": sps,
                        "clips_per_sec": cps,
                        "input_wait_s": wait_s,
                        "input_wait_frac": min(wait_s / t_train, 1.0),
                    }
                    if self.distributed:
                        last_perf["clips_per_sec_per_card"] = cps / self.world
                    if self.pipeline_plan is not None:
                        self._pipeline_perf(last_perf)
                    if tguard is not None:
                        last_perf.update(tguard.perf_keys())
                    if self.obs_on:
                        # the span-sourced successors of input_wait_frac
                        last_perf["obs_step_s"] = (
                            epoch_spans.get("step", 0.0) / steps_done)
                        last_perf["obs_input_wait_frac"] = min(
                            epoch_spans.get("input_wait", 0.0) / t_train, 1.0)
                        last_perf["obs_h2d_s"] = (
                            epoch_spans.get("h2d", 0.0) / steps_done)
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
                    kinds = param_kinds(self.model)
                    named = list(self.model.named_parameters())
                    check_desync(float(global_norm(
                        [p.detach() for _, p in named],
                        [kinds[n] for n, _ in named])),
                        name=f"params@epoch{epoch}")
                if self.checkpointing_steps == "epoch":
                    self._save("epoch", epoch)
                epoch += 1
            if not preempted:
                self._save("final", cfg.optim.num_epochs - 1)
        except BaseException as e:
            # the flight recorder's purpose: the recent span and metric
            # timeline survives the crash as <output_dir>/flight_record.json
            if self.obs_on:
                recorder = obs.get_recorder()
                recorder.record("exception", type(e).__name__,
                                message=str(e)[:500], step=gstep)
                recorder.dump()
            unwinding = e
            raise
        finally:
            if guard is not None:
                guard.uninstall()  # the handlers from before fit()
            self.close(unwinding)  # fences the checkpoint writes
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
