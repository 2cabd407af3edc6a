"""Typed configuration + CLI for the framework (the PyTorch port's own copy).

The dataclass tree, flags, defaults, `parse_cli`, `config_from_dict` and
`to_dict` are the JAX package's, kept identical so an artifact's
`meta.json["config"]` and a launch command parse the same way in both
packages (tests/test_torch_config.py holds them together). The port keeps
a copy instead of importing it: it imports nothing of the JAX package.
Fields of subsystems not ported yet parse and are unused (see ROADMAP.md).

Replaces the reference's two-tier config system (SURVEY.md §5 "Config / flag
system"): ``accelerate config`` YAML + env vars for infrastructure, and Python
Fire turning ``main()``'s 26 kwargs into flags (reference ``run.py:328-427``).
Here both tiers live in one typed dataclass tree with dotted CLI overrides
(``--optim.lr 0.1``) plus flat aliases for every reference flag name
(``--lr 0.1`` works too), so a reference user can bring their launch command
across unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


@dataclass
class MeshConfig:
    """Device-mesh shape. Product of explicit axes must divide device count.

    The trainer runs on the 2-D ``(data, model)`` train mesh
    (parallel/mesh.py make_train_mesh; docs/PARALLELISM.md): ``data`` = data
    parallel (batch sharding + implicit gradient psum), ``model`` = the
    model-parallel axis — transformer families (mvit/videomae) split
    attention heads and MLP widths over it, the context-parallel lane
    (``--model.attention ring|ulysses``) shards the token axis over it, and
    conv families replicate over it.  -1 on ``data`` means "use all
    remaining devices". Checkpoints are portable across train-mesh shapes.

    The legacy ``fsdp``/``tensor``/``context`` axes select the 4-axis
    library mesh instead (parallel/ research layout): ``fsdp`` =
    parameter/optimizer-state sharding (also shards the batch), ``tensor``
    = tensor parallelism, ``context`` = sequence/context parallelism.
    ``model`` cannot combine with them.
    """

    data: int = -1
    model: int = 1
    fsdp: int = 1
    tensor: int = 1
    context: int = 1


@dataclass
class ParallelConfig:
    """Pipeline parallelism over the mesh's model axis
    (parallel/pipeline.py; docs/PARALLELISM.md § pipeline).

    ``pipeline_stages`` > 1 partitions the transformer trunk's block
    stack into that many stages placed one per model-axis slice (the 2-D
    train mesh's ``model`` axis, or ``tensor`` on the library mesh — the
    stage count must equal that axis's size), and the train step streams
    microbatches through the stages (a fill-drain schedule: every
    microbatch's forward, then every backward in reverse). Transformer
    families only (mvit/videomae); on the 2-D train mesh the stages SPEND
    the model axis, so they exclude Megatron TP and ring/ulysses CP there —
    compose pipeline x CP on the library mesh (tensor=P, context=C)
    instead; not with fsdp > 1 yet (NotImplementedError). Checkpoints are layout-portable: the param tree is identical
    to the unpipelined model, so a run saved under (data, P) resumes
    unpipelined on (N, 1) or a single chip (trainer/checkpoint.py)."""

    pipeline_stages: int = 1
    # microbatches streamed through the stages per step; 0 = auto (reuse
    # optim.gradient_accumulation_steps when accumulation is on — the
    # batch already carries the micro axis — else 2 x stages). More
    # microbatches amortize the fill/drain bubble:
    # bubble = (P-1)/(M+P-1) per direction.
    pipeline_microbatches: int = 0


@dataclass
class DataConfig:
    """Data pipeline knobs (reference `run.py:140-183` + transform stack R6)."""

    data_dir: str = ""
    # alternative to the dir-per-class tree: pytorchvideo from_csv-style
    # `path label` list files (one video per line, space- or comma-
    # separated, integer labels; relative paths resolve against data_dir)
    train_list: str = ""
    val_list: str = ""
    # pre-decoded frame cache (data/cache.py, built offline with
    # `python -m pytorchvideo_accelerate_tpu_torch.data.cache build`): when set,
    # clips come from memmap slices instead of per-clip video decode; expects
    # train/ and val/ sub-caches mirroring data_dir
    cache_dir: str = ""
    synthetic: bool = False  # synthetic clips (test/bench fixture; SURVEY §4.4)
    synthetic_num_videos: int = 64
    num_frames: int = 8  # run.py:374 default; 32 in run_slowfast_r50.sh
    sampling_rate: int = 8  # pva: disable=knob-read -- read via the clip_duration property below (the one derived config value)
    frames_per_second: int = 30  # pva: disable=knob-read -- read via the clip_duration property below (the one derived config value)
    batch_size: int = 8  # per data-parallel shard, matching per-rank semantics
    # auto | thread | process (native shm decode workers). auto = threads:
    # cv2/numpy release the GIL and threads won every measurement made
    # (bench transport_crossover). process is an explicit opt-in for
    # GIL-holding pure-Python transform stacks.
    transport: str = "auto"
    num_workers: int = 8
    # HOST-side prefetch: decoded numpy batches assembled ahead of
    # consumption inside ClipLoader (bounds decode-thread run-ahead). Raise
    # when decode latency is spiky (cold storage, long-GOP videos).
    prefetch_batches: int = 2
    # DEVICE-side prefetch: on-device batches held ahead of the step loop by
    # data/device_prefetch.DevicePrefetcher, overlapping the host->HBM copy
    # of batch N+1 with compute of batch N. Each unit costs one batch of
    # HBM; 0 = synchronous inline placement (the A/B baseline). Distinct
    # from prefetch_batches: that hides DECODE latency on the host, this
    # hides TRANSFER latency onto the chip.
    device_prefetch_depth: int = 2
    # DISAGGREGATED decode (dataplane/; docs/INPUT_PIPELINE.md): >0 spawns
    # that many decode-worker PROCESSES (pva-tpu-dataworker) and the train
    # loader's decode happens there — clip tensors stream back over a
    # zero-copy wire protocol into the device-prefetch ring, byte-identical
    # to local decode (epoch/shuffle/quarantine state stays trainer-owned;
    # checkpoints and mid-epoch resume are unchanged). 0 = local decode.
    # Additional workers (other hosts) may connect to dataplane_listen at
    # any time and join mid-epoch.
    dataplane_workers: int = 0
    # per-worker in-flight lease bound; the trainer-side reorder buffer is
    # bounded by credits x workers (credit-based back-pressure — a slow
    # trainer idles workers, never balloons their memory)
    dataplane_credits: int = 2
    # host:port the feed listens on for workers (port 0 = ephemeral,
    # logged at startup; bind a routable address for cross-host workers)
    dataplane_listen: str = "127.0.0.1:0"
    crop_size: int = 256
    min_short_side_scale: int = 256
    max_short_side_scale: int = 320
    mean: tuple = (0.45, 0.45, 0.45)
    std: tuple = (0.225, 0.225, 0.225)
    horizontal_flip_p: float = 0.5
    # cast clips to the compute dtype on the host (half the host->HBM bytes;
    # value-preserving for the supervised models, which cast inputs on
    # device anyway — NOT applied to VideoMAE pretraining, whose fp32
    # regression target would be quantized). "auto" follows
    # TrainConfig.mixed_precision; "fp32" keeps float32 clips.
    host_cast: str = "auto"  # auto (bf16 host cast) | fp32 | u8 (ship raw
    # uint8, normalize in-graph on device: 4x less host->HBM transfer)
    decode_audio: bool = False  # pva: disable=knob-read -- reference-API parity knob; the audio pathway is not implemented yet
    # multi-view val: views/video with view-averaged logits (the reference's
    # uniform clip-tiling eval, run.py:163); 1 = single center clip
    eval_num_clips: int = 1
    # spatial crops per temporal view (uniform_crop along the longer side);
    # the SlowFast/X3D papers' 30-view protocol = 10 clips x 3 crops
    eval_num_spatial_crops: int = 1
    limit_train_batches: int = -1  # run.py:385
    limit_val_batches: int = -1


@dataclass
class ModelConfig:
    """Model selection + finetuning controls (reference `run.py:105-118`)."""

    name: str = "slow_r50"  # models.available_models(): slow_r50|slowfast_r50|
    # slowfast_r101|c2d_r50|x3d_xs|x3d_s|x3d_m|x3d_l|r2plus1d_r50|csn_r101|
    # mvit_b|mvit_b_32x3|videomae_b|videomae_b_pretrain
    num_classes: int = 0  # 0 = infer from dataset labels (replaces run.py:185)
    pretrained: bool = False
    pretrained_path: str = ""  # converted torch-hub weights (models/convert.py)
    freeze_backbone: bool = False  # run.py:108,116 semantics via optax masking
    slowfast_alpha: int = 4
    dropout_rate: float = 0.5
    # Transformer-family extras (MViT/VideoMAE); ignored by CNNs.
    attention: str = "dense"  # dense (XLA-fused) | pallas (ops/pallas_attention)
    # | ring | ulysses (context-parallel, parallel/ring_attention.py + ulysses.py)
    mask_ratio: float = 0.9  # VideoMAE pretrain tube-mask ratio
    # depthwise-conv lowering for X3D / MViT pooling (ops/depthwise.py):
    # "conv" = XLA grouped convolution; "shift" = tap decomposition into
    # fused VPU multiply-adds; "pallas" = hand-tiled halo kernel (one
    # HBM->VMEM DMA per output tile; stride-1 blocks only, strided entries
    # fall back to conv). Same param tree in all cases; A/B on device with
    # scripts/perf_sweep.py
    depthwise_impl: str = "conv"
    # fused conv->norm->activation lowering for the slowfast/x3d/slow
    # residual-block hot paths (ops/pallas_fused.py; docs/KERNELS.md):
    # "off" = today's unfused graph, byte-for-byte; "auto" = hand-tiled
    # Pallas kernels on TPU and the scale-folded XLA formulation
    # elsewhere; "pallas"/"xla" force one lowering (parity tests,
    # graphcheck, pva-tpu-kbench A/Bs). Same param tree in every mode —
    # checkpoints and converted weights are interchangeable across the
    # knob. Strided sites and non-BN convs keep the unfused path.
    fused_kernels: str = "off"
    # per-block jax.checkpoint (rematerialization): only block-boundary
    # activations (plus one block's interior at a time) stay resident,
    # trading one extra forward of recompute for the activation HBM that
    # gates long clips / bigger batches on a fixed chip
    remat: bool = False
    # temporal attention band for the VideoMAE classifier trunk
    # (models/videomae.py; docs/SERVING.md § trunk-reuse): "none" =
    # bidirectional, byte-for-byte the pre-knob graph; "causal" = a
    # token attends only its own and earlier temporal slots; "windowed"
    # = only the trailing attn_window slots. The banded trunk is what
    # makes per-tubelet states KV-cacheable for streaming serving
    # (--serve.stream_trunk) — finetune with the mask on so serving
    # accuracy recovers (the recipe in docs/SERVING.md).
    attn_mask: str = "none"  # none | causal | windowed
    attn_window: int = 0     # temporal slots (= frames / tubelet_t)


@dataclass
class OptimConfig:
    """Optimizer/schedule (reference `run.py:192-195`)."""

    optimizer: str = "sgd"
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    gradient_accumulation_steps: int = 1  # default 4 in reference launch recipe
    num_epochs: int = 4
    schedule: str = "cosine"  # cosine (CosineAnnealingLR semantics) | constant
    warmup_steps: int = 0
    label_smoothing: float = 0.0
    grad_clip_norm: float = 0.0  # 0 = off
    # in-graph mixup (Zhang 2018 arXiv:1710.09412): lambda ~ Beta(a, a)
    # per step, clips mixed with the FLIPPED batch on device (timm's
    # pairing — a static reversal GSPMD lowers to a one-hop collective
    # permute, not the cross-device gather a random permutation would
    # cost), loss = lam*CE(y) + (1-lam)*CE(y_flip). The MViT/SlowFast
    # K400 recipes train with it (alpha 0.8 typical); 0 = off.
    # Supervised steps only.
    mixup_alpha: float = 0.0
    # in-graph cutmix (Yun 2019 arXiv:1905.04899): a spatial box of the
    # flipped clip (shared across time), label weight = kept-area
    # fraction; when both alphas are on, a coin picks mixup OR cutmix per
    # forward — per MICRO-batch under grad accumulation (timm's
    # switching at micro granularity). 1.0 typical; 0 = off.
    cutmix_alpha: float = 0.0
    # exponential moving average of weights, updated in-graph each step;
    # when on, evaluation scores the EMA weights (the MViT/VideoMAE
    # fine-tune recipes' convention; 0.9999 typical). EMA rides the
    # checkpoint; toggling it across a resume changes the state tree and
    # fails loudly. 0 = off.
    ema_decay: float = 0.0


@dataclass
class CheckpointConfig:
    """Checkpoint/resume (reference `run.py:123-133, 203-224, 276-325`)."""

    output_dir: str = "."
    # "epoch" | integer string | "" (off) — exact reference parsing semantics.
    checkpointing_steps: str = ""
    # path | "auto" (scan output_dir for latest — fixes run.py:208-212 dead
    # code) | "" (off)
    resume_from_checkpoint: str = ""
    max_to_keep: int = 0  # 0 = keep all (ProjectConfiguration.total_limit)
    async_checkpoint: bool = True


@dataclass
class ServeConfig:
    """Inference serving (serving/: engine + micro-batcher + HTTP endpoint).

    No reference equivalent — the reference stack is training-only. The
    engine restores a params-only artifact written by `export_inference`
    (EMA-resolved), pins the weights to the mesh, and serves `/predict`
    behind an adaptive micro-batcher; see docs/SERVING.md."""

    # export_inference artifact directory (weights.npz + meta.json) —
    # produce one with `--export_inference PATH` after/with a resume
    checkpoint: str = ""
    host: str = "127.0.0.1"
    port: int = 8100
    # batcher flush policy: a batch launches when `max_batch_size` requests
    # are queued OR the oldest has waited `max_wait_ms` — the classic
    # latency/throughput knob pair. The batch is then padded UP to the
    # nearest compiled bucket (multiples of the mesh's data-shard count,
    # doubling up to max_batch_size) with masked rows, so every batch shape
    # hits a cached executable instead of recompiling.
    max_batch_size: int = 8
    max_wait_ms: float = 5.0
    # bound on queued-but-unbatched requests; submissions beyond it are
    # rejected (HTTP 503) instead of growing latency without limit
    max_queue: int = 256
    # rolling window (completed requests) for the latency percentiles and
    # throughput reported by /stats
    stats_window: int = 1024
    # per-request wall-clock budget inside the server before a 504
    request_timeout_s: float = 30.0
    # admission control (serving/admission.py): shed load with
    # 503 + Retry-After once queue depth crosses shed_queue_frac *
    # max_queue (the "degraded" state) — BEFORE latency collapses at the
    # hard queue bound; recover to "healthy" below recover_queue_frac.
    shed_queue_frac: float = 0.9
    recover_queue_frac: float = 0.5
    # the Retry-After seconds sent with every 503/504 rejection
    retry_after_s: float = 1.0
    # drain-on-SIGTERM budget: stop accepting, flush in-flight futures,
    # then shut down (0 = no drain handler; the PR-3 dump-only behavior)
    drain_grace_s: float = 10.0
    # batching front on the hot path (fleet/scheduler.py): "edf" (default)
    # is the continuous-batching scheduler — per-request deadlines,
    # realtime/batch priority classes, earliest-deadline-first launches,
    # shed-before-deadline-miss with 503 + Retry-After; "micro" restores
    # the fixed launch-on-max-or-timeout MicroBatcher policy
    scheduler: str = "edf"
    # default deadlines per priority class (explicit per-request
    # deadline_ms in the /predict body overrides); a request that provably
    # cannot meet its deadline is shed instead of riding to a 504
    realtime_deadline_ms: float = 2000.0
    batch_deadline_ms: float = 10000.0
    # quantized inference (serving/quantize.py; docs/SERVING.md §
    # quantization): "off" = full-precision weights, byte-identical to
    # the pre-quantization engine; "int8" = per-channel absmax int8
    # WEIGHTS dequantized to the compute dtype (bf16 activations)
    # inside the jitted forward — 4x smaller artifacts/HBM residency
    # and hot-swap transfers, quality-gated against full-precision
    # evaluate() top-1 (tests/test_zquant.py). Applies at
    # `export_inference` time (bakes a quantized artifact) AND at
    # engine load time (on-the-fly quantization of fp artifacts).
    quantization: str = "off"
    # per-deployment latency-histogram bucket bounds (comma-separated
    # MILLISECONDS, e.g. "5,10,25,50,100,250,1000"); "" keeps the shared
    # serving ladder. An interactive tier wants sub-ms resolution, a bulk
    # tier wants multi-second tails — one ladder fits neither
    # (obs/registry.py family buckets).
    latency_buckets_ms: str = ""
    # stateful streaming sessions (streaming/; docs/SERVING.md §
    # streaming): wrap the engine in a StreamingEngine so /stream serves
    # incremental rolling-window advances — each request ships only the
    # new frames, the window ring stays device-resident, and the
    # continuous-batching scheduler batches advances across sessions.
    # /predict keeps serving stateless one-shot requests either way.
    streaming: bool = False
    # HBM budget for device-resident session rings; admission refuses a
    # new session (503 + Retry-After) when every slot under the budget is
    # held by a live session
    stream_session_budget_mb: float = 256.0
    # idle sessions past this are evicted (their slot reclaimed); a
    # stream that stopped advancing is a leak, not a client
    stream_session_ttl_s: float = 120.0
    # strides to pre-compile at server build (comma-separated frames per
    # advance) for the artifact's clip geometry: the first advance at an
    # un-prewarmed (stride, bucket) pays a synchronous compile on the
    # flush thread, which both stalls the launch AND poisons the
    # service-time EWMA into transient deadline sheds — exactly the cold
    # start `InferenceEngine.warmup` prevents for /predict. Strides that
    # do not divide the window (or the model tubelet) are skipped.
    stream_strides: str = "2"
    # streaming trunk-compute reuse (streaming/engine.py KV rings;
    # docs/SERVING.md § trunk-reuse): "full" = today's graph
    # byte-for-byte (the trunk re-runs over the cached token ring each
    # advance); "causal"/"windowed" = the banded-attention trunk whose
    # per-tubelet K/V are cached in device-resident KV rings, so an
    # advance computes only the new tubelets' queries. Changes the math:
    # serve a backbone FINETUNED with the matching model.attn_mask (the
    # quality gate + recipe in docs/SERVING.md), or eat the top-1 delta
    # the bench STREAM lane reports. VideoMAE classifiers only —
    # MViT/conv/dual-rate families refuse loudly.
    stream_trunk: str = "full"  # full | causal | windowed


@dataclass
class FleetConfig:
    """Replica-pool serving tier (fleet/): router, health gating, hot-swap,
    load harness defaults (docs/SERVING.md § fleet). `serve.*` configures
    ONE replica; `fleet.*` configures the tier around N of them."""

    # replicas the bench fleet lane / CI harnesses stand up (production
    # fleets register real processes with the pool instead)
    replicas: int = 2
    # health-poll cadence for pool membership; route-around on an observed
    # death is immediate, this bounds how fast a DEAD-but-silent replica
    # leaves the rotation (and how fast a recovered one rejoins)
    health_interval_s: float = 0.5
    # per-request re-dispatch budget after a replica dies mid-flight
    route_retries: int = 2
    # open-loop load-harness defaults (fleet/loadgen.py, pva-tpu-loadgen)
    loadgen_rps: float = 50.0
    loadgen_duration_s: float = 5.0
    # the SLO the SERVE_FLEET bench lane asserts (p99 over completions)
    slo_p99_ms: float = 1500.0


@dataclass
class ControlConfig:
    """Fleet-intelligence loops (fleet/control/): SLO-driven autoscaling,
    multi-model budget, canary rollout (docs/SERVING.md § fleet
    intelligence). These dials shape the DAMPING — an undamped controller
    against an open-loop load generator is an oscillator."""

    # autoscaler pool bounds; min >= 1 (the last routable replica is
    # never drained, no matter what the signals say)
    min_replicas: int = 1
    max_replicas: int = 8
    # the p99 the controller defends; scale-up fires when the smoothed
    # pooled p99 crosses it (the FLEET_AUTO lane asserts convergence
    # back under it after a traffic step)
    slo_p99_ms: float = 500.0
    # hysteresis band on smoothed backlog per routable replica: above
    # `queue_high` grow, below `queue_low` (AND p99 under
    # downscale_frac * SLO) shrink; the gap between them is damping
    queue_high: float = 4.0
    queue_low: float = 0.5
    downscale_frac: float = 0.5
    # dead time after every action + control cadence + signal smoothing
    cooldown_s: float = 2.0
    interval_s: float = 0.25
    ewma_alpha: float = 0.5
    # scale-down grace for in-flight requests after the victim drains
    # and its sessions re-home
    drain_grace_s: float = 5.0
    # shared compiled-cache/HBM budget across model families (MB);
    # the lowest-priority over-budget family sheds, the pool never does
    budget_mb: float = 4096.0
    # canary: fraction of the fleet that takes the new artifact, the
    # direction-aware regression threshold (perfdiff semantics), and the
    # escalation-ladder strike count before auto-rollback
    canary_fraction: float = 0.25
    canary_threshold: float = 0.2
    canary_rollback_after: int = 2


@dataclass
class ObsConfig:
    """Telemetry spine (obs/): spans, flight recorder, watchdog, registry.

    `enabled` gates the whole layer: spans become no-ops, the compiled
    train step drops its health gauges, and the logged metric keys revert
    exactly to the pre-obs set. The watchdog is opt-in on top (a
    no-progress deadline only the operator can pick); see
    docs/OBSERVABILITY.md for the runbook."""

    enabled: bool = True
    # no-progress deadline (seconds) before the watchdog dumps all-thread
    # stacks + the flight record to stderr/output_dir — evidence BEFORE an
    # external timeout kills the process blind. 0 = watchdog off.
    watchdog_timeout_s: float = 0.0
    # bounded in-memory event ring (spans/metrics/warnings) dumped to
    # <output_dir>/flight_record.json on exception, SIGTERM, or stall
    flight_recorder_events: int = 512
    # distributed tracing (obs/trace.py): head-based sampling rate for new
    # trace roots (train steps, /predict requests, loadgen arrivals).
    # 0 = tracing disarmed, structurally zero overhead (the default);
    # incoming `traceparent` headers are always continued once armed —
    # the remote head already made the sampling decision.
    trace_sample_rate: float = 0.0
    # bounded per-process trace-event ring, exported as Chrome/Perfetto
    # JSON (<output_dir>/trace_ring.json; merge N of them with
    # `pva-tpu-trace`)
    trace_ring_events: int = 4096
    # pva-tpu-hbm (obs/memory.py): arm the device-memory ledger — real
    # allocation sites register bytes, cross-checked against the
    # backend's memory_stats() where available (docs/OBSERVABILITY.md
    # § memory ledger). Off = one global read at each site.
    memory_ledger: bool = True
    # on-demand profiler window, run-relative: "A..B" captures
    # jax.profiler from this run's step A until step B, written
    # atomically under <output_dir>/profile_<tag>/ (obs/profiler.py).
    # "" = disarmed.
    profile_steps: str = ""
    # metrics-history ring over Registry.scrape() ticks (obs/history.py):
    # the substrate for burn-rate alerting, /history, and the
    # autoscaler's shared EWMAs. 0 disables.
    history_ticks: int = 512


@dataclass
class ReliabilityConfig:
    """Resilience substrate (reliability/): retries, preemption grace,
    emergency checkpoints (docs/RELIABILITY.md). Fault injection has no
    config here on purpose — arming a FaultPlan is a chaos-harness act
    (`pva-tpu-chaos`), never a production knob."""

    # SIGTERM/SIGINT grace path in Trainer.fit(): finish the in-flight
    # step, write an emergency checkpoint (resume=auto round-trips to the
    # exact step), dump the flight record, exit 0. False restores PR 3's
    # dump-only signal behavior.
    graceful_shutdown: bool = True
    # total decode attempts per clip read before the substitution path
    # takes over (transient I/O — cold NFS, flaky storage — recovers here;
    # a truly corrupt file still substitutes after the budget)
    decode_retries: int = 2
    # total attempts for checkpoint/artifact writes (orbax save dispatch,
    # inference-export files, the emergency record)
    ckpt_retries: int = 3
    # total attempts per tracker call before the tracker is disabled
    # (PR 3 disabled on the FIRST failure; a tracker outage is usually
    # transient, losing the rest of the run's metrics is not)
    tracker_retries: int = 2
    # backoff shape for checkpoint/artifact writes: base * 2^attempt *
    # jitter, capped per try at retry_max_delay_s, whole-call wall time
    # capped at retry_deadline_s. retry_base_delay_s also seeds the decode
    # read backoff; the decode deadline (5s — the substitution path waits
    # behind it) and the tracker budget (2s — a logging outage must never
    # stall a training step longer) are fixed by design.
    retry_base_delay_s: float = 0.05
    retry_max_delay_s: float = 2.0
    retry_deadline_s: float = 30.0


@dataclass
class GuardConfig:
    """Self-healing training (reliability/guard.py TrainGuard —
    docs/RELIABILITY.md § divergence runbook): in-graph nonfinite
    skip-batch, EWMA anomaly detection on loss/grad_norm, a last-known-good
    checkpoint ring with automatic rollback past the offending data span,
    replay bundles, and bad-sample quarantine. Disarmed (the default) the
    step graph carries no skip branch and the step loop does one None
    check — structurally zero overhead."""

    enabled: bool = False
    # policy: which anomaly signals escalate. "nonfinite" (NaN/inf loss or
    # grad norm), "spike" (EWMA z-score excursion on loss/grad_norm), or
    # "both". The in-graph skip-batch always covers nonfinite updates when
    # the guard is enabled, regardless of policy.
    policy: str = "both"
    # LKG cadence/ring: an async orbax save to <output_dir>/guard_lkg every
    # `lkg_every_steps` healthy steps; the ring keeps `lkg_keep` entries
    # (orbax max_to_keep pruning). LKG only advances when no anomaly was
    # observed within the cadence window.
    lkg_every_steps: int = 50
    lkg_keep: int = 3
    # EWMA spike detector shape: upward z-score threshold, smoothing
    # factor, and the observation budget during which spikes never fire
    # (young statistics + warmup loss cliffs must not false-positive)
    spike_zscore: float = 6.0
    ewma_alpha: float = 0.05
    warmup_steps: int = 20
    # escalation ladder: anomalies below `rollback_after` consecutive
    # observations are skips (recorded; the in-graph skip already
    # protected the state); at the threshold the guard rolls back to the
    # LKG and fast-forwards the loader past the offending span; more than
    # `max_rollbacks` rollbacks raises GuardHalt (a rollback loop means
    # data or optimizer trouble — see the runbook)
    rollback_after: int = 2
    max_rollbacks: int = 2
    # bad-sample quarantine (data/manifest.Quarantine): decode failures
    # per clip before the path is quarantined to the persisted
    # <output_dir>/quarantine.json sidecar the sampler excludes. 0 = off.
    # Counts at most one failure per clip per run (the in-run substitution
    # memory), so budget > 1 means "failed in that many runs/sessions".
    quarantine_budget: int = 3


@dataclass
class TrackingConfig:
    """Metric logging (reference `run.py:227-231, 267-274, 306-315`)."""

    with_tracking: bool = False
    logging_dir: str = "pytorchvideo_accelerate_tpu_runs"
    log_every: int = 10
    # "all" resolves to every importable tracker, like accelerate
    # tracking.py:1260-1290; individual: "tensorboard", "wandb", "jsonl".
    trackers: str = "all"


@dataclass
class TrainConfig:
    mesh: MeshConfig = field(default_factory=MeshConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    control: ControlConfig = field(default_factory=ControlConfig)  # pva: disable=knob-read -- control-plane dials ride TrainConfig for dotted-key CLI parsing; the fleet runner (ROADMAP 4/5) consumes the block
    obs: ObsConfig = field(default_factory=ObsConfig)
    reliability: ReliabilityConfig = field(default_factory=ReliabilityConfig)
    guard: GuardConfig = field(default_factory=GuardConfig)

    seed: int = 42  # run.py:138 set_seed(42); run.py:355 exposes --seed
    # write a params-only (EMA-resolved) serving artifact to this path and
    # exit without training — combine with --resume_from_checkpoint to
    # export a finished run; serve it with
    # `pva-tpu-serve --serve.checkpoint PATH` (trainer/checkpoint.py
    # export_inference; docs/SERVING.md)
    export_inference: str = ""
    # run the validation loop once and exit (score a resumed/converted
    # checkpoint); no reference equivalent — run.py always trains
    eval_only: bool = False
    # "bf16" = bf16 compute / fp32 params (TPU-native replacement for the
    # reference's fp16 GradScaler path, SURVEY §2.3-N7); "fp32" = full fp32.
    mixed_precision: str = "bf16"
    cpu: bool = False  # force CPU backend (reference --cpu)
    # >0: probe CUDA init in a disposable subprocess with this deadline
    # (seconds) before the Trainer touches the card, and raise if it does
    # not answer: a wedged driver otherwise hangs the job in its first CUDA
    # call with no error (utils/device_doctor.py). 0 = off; --cpu: no probe.
    device_init_timeout: int = 0
    # persistent XLA compilation cache dir ("" = off): pays the 1-2 min
    # model compile once per config instead of once per restart
    compilation_cache_dir: str = ""
    profile: bool = False  # jax.profiler trace of a step window (SURVEY §5)
    profile_dir: str = "/tmp/pva_tpu_profile"
    # the first NaN raises FloatingPointError naming its module, and anomaly
    # mode checks the backward (utils/debug_nans.py)
    debug_nans: bool = False
    # each step's batch held to the step's shape and dtype contract before
    # anything runs (trainer/steps.py assert_batch_contract)
    debug_asserts: bool = False
    # per-epoch cross-host fingerprint comparison (multi-process runs)
    debug_desync: bool = False
    # Multi-host control plane (jax.distributed.initialize); empty = single
    # process or auto-detected TPU pod env.
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1

    @property
    def clip_duration(self) -> float:
        """`(sampling_rate * num_frames) / fps` — reference run.py:140."""
        d = self.data
        return (d.sampling_rate * d.num_frames) / d.frames_per_second

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


# --- CLI ------------------------------------------------------------------

# Flat reference-flag aliases -> dotted path, so the reference launch command
# (run_slowfast_r50.sh) maps 1:1 onto the new CLI.
_REFERENCE_ALIASES = {
    "cpu": "cpu",
    "mixed_precision": "mixed_precision",
    "seed": "seed",
    "checkpointing_steps": "checkpoint.checkpointing_steps",
    "resume_from_checkpoint": "checkpoint.resume_from_checkpoint",
    "output_dir": "checkpoint.output_dir",
    "with_tracking": "tracking.with_tracking",
    "logging_dir": "tracking.logging_dir",
    "log_every": "tracking.log_every",
    "data_dir": "data.data_dir",
    "num_frames": "data.num_frames",
    "sampling_rate": "data.sampling_rate",
    "frames_per_second": "data.frames_per_second",
    "num_workers": "data.num_workers",
    "batch_size": "data.batch_size",
    "limit_train_batches": "data.limit_train_batches",
    "limit_val_batches": "data.limit_val_batches",
    "num_epochs": "optim.num_epochs",
    "lr": "optim.lr",
    "momentum": "optim.momentum",
    "weight_decay": "optim.weight_decay",
    "gradient_accumulation_steps": "optim.gradient_accumulation_steps",
    "pretrained": "model.pretrained",
    "freeze_backbone": "model.freeze_backbone",
    "slowfast_alpha": "model.slowfast_alpha",
    "model_name": "model.name",
    "synthetic": "data.synthetic",
    "cache_dir": "data.cache_dir",
    "eval_num_clips": "data.eval_num_clips",
    "eval_num_spatial_crops": "data.eval_num_spatial_crops",
    "trackers": "tracking.trackers",
}


def _leaf_fields(cfg=None, prefix=""):
    """Yield (dotted_name, default_value) pairs for every leaf field."""
    obj = cfg if cfg is not None else TrainConfig()
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaf_fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def _unknown_key_message(dotted: str, valid: set) -> str:
    """Diagnosis for an unknown dotted key. When the key's block prefix IS a
    known config block (`--serve.typo_key`), list that block's valid keys —
    a typo under a real block must fail loudly and helpfully, never be
    silently ignored or answered with a bare 'unknown'."""
    block = dotted.split(".", 1)[0]
    block_keys = sorted(k for k in valid if k.startswith(block + "."))
    if "." in dotted and block_keys:
        return (f"unknown key {dotted!r} under config block {block!r}; "
                f"valid keys: " + ", ".join(block_keys))
    return f"unknown key {dotted!r} (see --help for the full flag list)"


def _coerce(value: str, default: Any):
    if isinstance(default, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):  # config-file JSON 0/1
            return bool(value)
        return value.lower() in ("1", "true", "yes", "y", "t")
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    if isinstance(default, tuple):
        if isinstance(value, (list, tuple)):  # config-file native lists
            return tuple(type(default[0])(p) for p in value)
        parts = [p for p in str(value).replace("(", "").replace(")", "").split(",") if p]
        return tuple(type(default[0])(p) for p in parts)
    return value


def _set_dotted(cfg: TrainConfig, dotted: str, value: Any) -> None:
    obj = cfg
    parts = dotted.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    current = getattr(obj, parts[-1])
    if value is None:  # bare `--flag` with no value
        if not isinstance(current, bool):
            raise ValueError(f"flag requires a value ({type(current).__name__})")
        value = "true"
    setattr(obj, parts[-1], _coerce(value, current))


def config_from_dict(data: dict, base: Optional[TrainConfig] = None,
                     source: str = "<dict>") -> TrainConfig:
    """Apply a (flat or nested) config dict onto a TrainConfig.

    Accepts `{"optim": {"lr": 0.1}}` nesting, dotted keys ("optim.lr"), or
    the flat reference aliases ("lr"); `TrainConfig.to_dict()` output loads
    back unchanged. Shared by `--config file.json` and the serving engine's
    artifact-embedded config (trainer/checkpoint.py meta.json).
    """
    cfg = base or TrainConfig()
    valid = {name for name, _ in _leaf_fields()}

    def apply(tree: dict, prefix: str) -> None:
        for k, v in tree.items():
            dotted = prefix + str(k).replace("-", "_")
            if isinstance(v, dict) and dotted not in valid:
                apply(v, dotted + ".")
                continue
            dotted = _REFERENCE_ALIASES.get(dotted, dotted)
            if dotted not in valid:
                raise ValueError(
                    f"{_unknown_key_message(dotted, valid)} in {source}")
            _set_dotted(cfg, dotted, v)

    apply(data, "")
    return cfg


def load_config_file(path: str, base: Optional[TrainConfig] = None) -> TrainConfig:
    """Apply a JSON config file onto a TrainConfig (see `config_from_dict`).

    The `accelerate config` YAML tier's equivalent (SURVEY §5 "Config / flag
    system"): persistent settings in a file, per-run overrides as flags.
    """
    with open(path) as f:
        data = json.load(f)
    return config_from_dict(data, base=base, source=path)


def parse_cli(argv: Optional[Sequence[str]] = None, base: Optional[TrainConfig] = None) -> TrainConfig:
    """Parse ``--flag value`` / ``--flag=value`` / bare boolean ``--flag``.

    Accepts both dotted names (``--optim.lr``) and the reference's flat flag
    names (``--lr``), including ``--is_slowfast`` which maps onto
    ``model.name=slowfast_r50`` for drop-in launch-script compatibility.
    ``--config file.json`` loads a config file FIRST (flags override it) —
    the `accelerate config` two-tier equivalent.
    """
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = base or TrainConfig()
    # config files apply before any flag, wherever --config appears
    def load_file(path):
        try:
            return load_config_file(path, base=cfg)
        except (OSError, ValueError) as e:  # ValueError covers bad JSON too
            raise SystemExit(f"--config {path}: {e}")

    remaining = []
    i = 0
    while i < len(argv):
        if argv[i] in ("--config", "--config_file"):
            if i + 1 >= len(argv):
                raise SystemExit("--config requires a file path")
            cfg = load_file(argv[i + 1])
            i += 2
        elif argv[i].startswith(("--config=", "--config_file=")):
            cfg = load_file(argv[i].split("=", 1)[1])
            i += 1
        else:
            remaining.append(argv[i])
            i += 1
    argv = remaining
    valid = {name for name, _ in _leaf_fields()}

    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument: {tok}")
        tok = tok[2:]
        if "=" in tok:
            key, value = tok.split("=", 1)
            i += 1
        else:
            key = tok
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                value = argv[i + 1]
                i += 2
            else:
                value = None  # bare flag: only valid for booleans
                i += 1
        key = key.replace("-", "_")
        if key == "is_slowfast":  # reference flag (run.py:351)
            if value is None or _coerce(value, True):
                cfg.model.name = "slowfast_r50"
            continue
        if key == "pin_memory":  # reference flag (run.py:354); no TPU meaning
            continue            # (host->HBM transfer is the runtime's job)
        if key == "help":
            print(usage())
            raise SystemExit(0)
        dotted = _REFERENCE_ALIASES.get(key, key)
        if dotted not in valid:
            raise SystemExit(
                f"unknown flag --{key}: {_unknown_key_message(dotted, valid)}")
        try:
            _set_dotted(cfg, dotted, value)
        except (TypeError, ValueError) as e:
            raise SystemExit(f"invalid value for --{key}: {e}")
    return cfg


def usage() -> str:
    lines = [
        "flags (dotted or reference-style):",
        "  --config FILE.json (JSON config applied before flags; nested,",
        "      dotted, or flat-alias keys — see load_config_file)",
        "  --write_config FILE.json (resolve all flags/config files into",
        "      one JSON and exit; reuse via --config)",
    ]
    for name, default in _leaf_fields():
        lines.append(f"  --{name} (default: {default!r})")
    return "\n".join(lines)
