#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: serve and train full-width SlowFast-R50,
serve and train full-width X3D-M, serve CSN-R101, serve and train MViT-B,
serve VideoMAE-B and pretrain it (MAE), serve R(2+1)D-50 and train it
from a frame cache of real-format clips, train SlowFast-R50 with
mixup/cutmix, the guard and tracking and MViT-B 32x3 under remat, serve
SlowFast-R50 with the server's defaults and SlowFast-R50 and MViT-B with
int8 weights, stream sessions of SlowFast-R50 (over HTTP), VideoMAE-B and
MViT-B, serve SlowFast-R50 from a fleet of replicas (router, hot swap,
route-around, autoscaler, session affinity), preempt and resume a
SlowFast-R50 training run, train
SlowFast-R50 data-parallel across processes, and fine-tune SlowFast-R50,
MViT-B 32x3, X3D-S and VideoMAE-B from full-width hub-layout checkpoints
(and VideoMAE-B from its own MAE pretraining), train MViT-B and VideoMAE-B
tensor- and context-parallel and VideoMAE-B (fine-tune and MAE) in two
pipeline stages, and train SlowFast-R50 fully sharded (fsdp) and
VideoMAE-B tensor x context parallel on the library mesh, on one GPU (and
across two cards, where the machine has them).

    python3 chip_smoke.py            # from the repo root, on a CUDA machine

Drives the port only (no JAX), one JSON line per phase:

1. device   the card, and its name and power limit from nvidia-smi
2. build    the kernels compiled from ops/csrc with nvcc, one process each;
            gemm_build: ptxas's registers and spills and the runtime's
            attributes of both GEMM kernels in every tile configuration
            (`fused.gemm_attrs`): no spills, at most 227 KB of shared
            memory, at least one block per SM; dw_build: the same for the
            depthwise kernel in every configuration x tap instantiation
            ((3,3,3), (5,1,1), generic; `fused.dw_attrs`), each holding the
            blocks per SM its plan counts on
3. weights  seeded SlowFast-R50 weights (K700 head), BN running stats
            calibrated to the real batch statistics, head classes 0-4
            planted on the 5 request clips (`plant_head`), written as an
            inference artifact with the port's `export_inference`
4. kernels  every fused site of one bucket-8 forward: the CUDA kernel held
            against its plain PyTorch version on the same bf16 inputs, two
            launches bitwise equal, and kernel / plain / library (cuDNN or
            cuBLAS + bias + act) device times (`device_ms`), with the
            GEMM configuration `gemm_plan` chose, its attributes, TFLOP/s,
            GB/s and the ratio to the library; then the same for the
            backward's dx launch of the kernel (the transposed stencil on a
            bf16 dz; library: `dz @ wf^T`, `torch.nn.grad.conv3d_input`);
            kernel_sums: rows 1, 1b, 2, 2b summed over the forward's
            sites, with the host time of the wrappers' plan lookup
5. serve    the port's HTTP server (`build_server`, micro scheduler) answers
            5 /predict requests sent at once; the launch counters,
            zeroed just before, must show 41 pointwise and 51 conv launches
            per forward; logits must agree with the plain path
6. timing   bucket-8 forward with the kernels, the plain path and unfused
7. profile  device time per forward by kernel class, device busy share
8. train    `run.main` trains on the reference recipe's geometry (B=8 x
            accumulation 4, 32 frames at 256^2, bf16) for 4 steps; the
            counters, zeroed just before fit(), must show one forward and
            one dx launch per fused site per micro-step plus one forward
            per eval forward; the step-2 checkpoint restores bitwise; the
            exported artifact serves the trainer's logits
9. train_parity  one B=8 micro-step through the kernels against plain
            PyTorch (`train_parity_phase`)
10. train_timing  ms per micro-step through the kernels, unfused and
            plain; peak memory; a profiled micro-step
10b. transport  16 fp32 clips of SlowFast-R50's train transforms, B=8, 8
            workers, one epoch on threads and one through forked workers
            and the native shm ring: no fallback, the batches byte-equal,
            clips/s of each; a worker that touches CUDA fails in-band
10c. observe_train  a SlowFast-R50 Trainer, B=8, 4 steps, with `--data.transport
            process --obs.profile_steps 1..3 --obs.trace_sample_rate 1.0`:
            launches exact, the window's trace holding rows 1-2b's
            launches of its 2 micro-steps exactly, a `train_step` root a
            step, `h2d` in a step's trace, `pva-torch-trace` merging the
            ring with the flight record
11. x3d_weights, csn_weights  the same seeded, calibrated, planted
            artifacts for X3D-M (16 frames at 224^2) and CSN-R101 (32 frames
            at 224^2), and the site shapes of one plain bucket-8 (X3D-M) and
            bucket-4 (CSN) forward
12. kernels (dw)  the depthwise kernel (`csrc/depthwise3d.cu`) through both
            entry points, forward and dx, at every distinct depthwise site
            shape of those two forwards: `fused_dw_bn_act` against
            `dw_bn_act_plain`, `depthwise3d_s1` against
            `depthwise_conv3d_shift`, two launches bitwise equal; library:
            one bf16 `F.conv3d(groups=C)` (+ bias + act) and
            `conv3d_input(groups=C)`; each row with the configuration and T
            chunk `dw_plan` chose, its attributes, GB/s and the bound's share
            of the kernel's time; x3d_dw_dk: the plain tap gradient
            (`depthwise_tap_grads_f32`) summed over one X3D-M micro-step; then
            the pointwise kernel, forward and dx, at X3D-M's 53 sites (widths
            54 and 108 take its 4-byte copy path) and CSN-R101's 67, and the
            sums of both kernels' rows
13. x3d_serve  `build_server` serves the X3D-M artifact to 5 /predict
            requests with `{"video": ...}` under `fused_kernels auto`: 53
            pointwise and 23 depthwise launches per forward
            (`expected_forward_launches`); logits against the plain path;
            then forward times and profiles (kernels, plain, unfused cuDNN
            grouped conv, `depthwise_impl pallas`)
14. x3d_depthwise_impl  an X3D-M engine with `fused_kernels off,
            depthwise_impl pallas` runs bucket 8: 23 `depthwise3d_s1`
            launches; logits against `depthwise_impl shift`
15. x3d_train  `run.main` trains X3D-M (B=8, 16 frames at 224^2, bf16) for
            2 steps with a checkpoint each step, counters checked as in 8,
            the step-1 checkpoint restored bitwise, the export served; then
            one step of `run.main` with `fused_kernels off, depthwise_impl
            pallas` (row 4 forward and dx on the training path)
16. x3d_train_parity, x3d_train_timing  one B=8 micro-step with the
            forward held fixed, through rows 1+3 (`auto`) and through row 4
            (`off` + `depthwise_impl pallas`), against plain autograd; ms
            per micro-step of each lowering, peak memory, a profile
17. csn_serve  the engine runs one CSN-R101 bucket-4 forward under `auto`:
            67 pointwise and 30 depthwise launches; logits against the
            plain path; forward times
18. mvit_weights, videomae_weights  seeded MViT-B and VideoMAE-B artifacts
            (16 frames at 224^2, a residual branch's last projection x0.1,
            head planted on 5 request clips), the `attention dense` engine
            on the same weights, and the attention sites of its bucket-8
            forward (and of one VideoMAE-B pretraining forward, B=8); the
            depthwise rows of `depthwise3d_s1` and its dx at MViT-B's 4
            stride-1 K/V pools, and their sums
19. kernels (attention)  the flash kernels (`csrc/flash_attention.cu`,
            `csrc/flash_attention_bwd.cu`) at every distinct site shape:
            forward (out and lse) against `flash_fwd_plain`, dq and dk/dv
            (launched through the wrapper's plan: `launch_dq`,
            `launch_dkv` with its query splits) against `flash_bwd_plain`,
            two backward launches bitwise equal; kernel, plain and library
            (`F.scaled_dot_product_attention`, timed only) device times,
            each kernel's ratio to the library's, each kernel's ptxas
            report (registers, spills; none at D = 64 and 96) and runtime
            attributes (shared memory, blocks per SM); lse within 1e-4
            absolute; two forward launches bitwise equal in out and lse
20. mvit_serve  `build_server` serves MViT-B under `attention pallas,
            depthwise_impl pallas`: 16 flash and 4 `depthwise3d_s1` launches
            per forward; logits against the dense engine; mvit_timing
            (flash, dense) and mvit_profile (with the strided pools' cuDNN
            grouped-conv time)
21. videomae_serve  VideoMAE-B the same way: 12 flash launches per forward
22. mvit_train  `run.main` trains MViT-B (B=8, bf16, lr 0.01) for 2 steps
            with a checkpoint each step: per micro-step 16 flash forward,
            16 dq, 16 dk/dv, 4 `depthwise3d_s1` and 4 of its dx launches
            (plus the eval forwards); the step-1 checkpoint restored
            bitwise; the export serves the trainer's logits
23. mvit_train_parity, mvit_train_timing  end to end the loss through the
            kernels against `attention dense`; with the forward fixed the
            whole gradient and one SGD update against plain autograd; ms
            per micro-step and peak memory of both, a profile;
            videomae_train_timing: one B=8 VideoMAE-B classifier micro-step
            through the kernels (12 + 12 + 12 launches) against dense
            attention, ms and peak memory of both
24. videomae_pretrain  `run.main` pretrains VideoMAE-B (B=8, MAE ratio
            0.9) for 2 steps: 16 forward, 16 dq and 16 dk/dv launches per
            micro-step; the step-1 checkpoint restored bitwise
25. videomae_pretrain_parity  one micro-step under one mask: the loss
            through the kernels against `attention dense`; times, memory
26. r2plus1d_weights, r2plus1d_kernels  a seeded R(2+1)D-50 artifact (16
            frames at 224^2, 400 classes, 28.1M parameters) and the pointwise
            and conv kernels, forward and dx, at every fused site shape of
            its bucket-8 forward (32 pointwise sites, 26 conv sites; the 11
            strided sites and the stem stay cuDNN)
27. r2plus1d_serve  `build_server` serves it to 5 /predict requests under
            `fused_kernels auto`: 32 pointwise and 26 conv launches per
            forward; logits against the plain path; r2plus1d_timing
            (kernels, plain, unfused) and r2plus1d_profile
28. r2plus1d_train  a frame cache (`index.json` + `data.bin`, the format of
            `data/cache.py`) of seeded uint8 frames: 16 train and 8 val
            videos of 64 frames at 256x320, 30 fps, labels in 400 classes;
            `run.main` trains R(2+1)D-50 from it (`--data.cache_dir`, B=8, 16
            frames at 224^2, bf16) for 2 steps with a checkpoint each step,
            counters checked as in 8, num_classes taken from the cache, the
            step-1 checkpoint restored bitwise, the export served;
            r2plus1d_train_parity (the loss through the kernels against
            `xla`; with the forward fixed, the whole gradient and one SGD
            update against plain autograd) and r2plus1d_train_timing
            (kernels, unfused, plain; peak memory; fit()'s clips/s and input
            wait share)
30. features_train  SlowFast-R50 at the reference geometry (32 frames at
            256^2, B=8 x accumulation 2, 5 steps of synthetic clips) through
            `Trainer` with mixup 0.8 + cutmix 1.0, the EMA, the guard (LKG
            every step, rollback after 2) and jsonl tracking every step; the
            train loader's 3rd and 4th batches NaN-poisoned: both steps
            report `skipped`, the 3rd leaves the state bitwise, the guard
            rolls back to its LKG of step 3 (bitwise its file) and the
            loader resumes at the 5th batch, fit() ends finite, launches
            exact, the jsonl complete; then one B=8 micro-step under a
            fixed mixup draw with the forward held fixed against plain
            autograd, ms per optimizer step plain / mixed / mixed + guard,
            and fit()'s clips/s with tracking on and off and with tracking
            on and the obs layer off. The obs layer is on (the default):
            its window and epoch keys in the jsonl (none with obs off), the
            health gauges of step 1 against f32 norms recomputed from the
            state (`param_norm`, `update_ratio` within 1e-3), `nonfinite`
            per step, the memory ledger's `train_state` and
            `pva_hbm_bytes_in_use` against the state's bytes and
            `torch.cuda.memory_allocated()`, the LKG ring's async saves
            (dispatch on the step thread, write until landed); then the
            full train state saved async and sync (`async_checkpoint`):
            the time on the step thread, the files bitwise, a step resumed
            from each
31. remat_train  hub mvit_base_32x3 (32 frames at 224^2, drop path 0.3,
            `attention pallas, depthwise_impl pallas`): B=4 micro-steps with
            and without `--model.remat`; per run ms, peak memory and the
            launches of one micro-step (under remat 2 x 16 flash forwards,
            2 x 4 `depthwise3d_s1`, 16 dq and 16 dk/dv); the loss bitwise
            equal, the gradients bitwise or within 1e-2; then the same pair
            with every drop path at rate 0, its loss and gradient gap
            reported (`drop_path0`)
32. real_video_route  with cv2 on this machine: 4 mp4s written with cv2,
            cached by `build_cache`, a clip read back through `FrameCache`
            byte-equal to `decode_span`; then a list manifest with one
            corrupt mp4 trained 2 epochs with `--guard.enabled
            --guard.quarantine_budget 1` (tiny3d, plain lowering): the
            sidecar names the file, the second epoch never opens it.
            Without cv2: `Trainer` on a `--data_dir` tree raises
            `NoVideoDecoderError` naming the cache route. The phase says
            which case ran
33. edf_serve  phase 3's SlowFast-R50 artifact through `build_server` with
            no `--serve.scheduler` flag (the EDF scheduler): 8 batch-class
            requests at once, 2 realtime ones in turn, then a realtime one
            whose `deadline_ms` is half the measured bucket-1 service time:
            logits against the plain path, that one request shed (503 +
            Retry-After, counted in /stats and /metrics) and no other,
            /metrics counts and the latency histogram's count equal to the
            requests answered, 41 pointwise and 51 conv launches per forward,
            POST /drain then /healthz 503; client and server p50/p99 per
            class, launches per batch, bucket fill; a POST /profile window
            (202, then 409) holding one forward's launches of rows 1 and 2,
            and a request with a `traceparent` echoed, found in the ring
            dumped at drain and in /stats `slowest_traces`
34. int8_serve  int8 artifacts of SlowFast-R50 and MViT-B baked by the
            port's `export_inference`, each served by `build_server`: the
            fp forward's launches (rows 1 and 2; rows 4 and 5), the logits
            against the plain path on the same int8 weights (as serve),
            top-1 agreement with the fp artifact's kernel path >= 0.75 (the
            JAX package's gate; its absolute 5e-2 on the logits reported,
            `INT8_ATOL`) and the largest logit difference within 5e-2 * (1 +
            the largest |fp logit|) (`INT8_REL`), an on-the-fly quantized
            engine bitwise the baked one; resident weight bytes, a bucket-8
            forward's peak memory and its ms, int8 against fp
35. preempt_train  `run.main` in a child process on SlowFast-R50 (32
            frames at 256^2, B=4, 6 steps, a checkpoint every 3): unbroken;
            then SIGTERM once its log shows step 3: exit 0, `preempted`, a
            "preempt" checkpoint of the step it finished (off a
            checkpointing boundary) at its loader position, the
            emergency record; `--resume_from_checkpoint auto` ends at the unbroken
            run's step count, losses within 5e-2 * (1 + |loss|), launches of
            the two children adding up to the unbroken run's
36. dp_train  data parallelism across processes on full-width SlowFast-R50
            (32 frames at 256^2, a global batch of 8 clips, 6 steps, lr
            0.01, mixing off), each arm `run.main`'s Trainer in child
            processes: (a) one process, no group; (b) a one-rank NCCL group
            (the data-parallel path at world 1); (c) two ranks of 4 clips
            sharing the card over gloo; (d) two ranks over NCCL on two
            cards through `launch.py`, run only when the machine has two
            cards (else one line says why). Exact launches of rows 1-2b on
            every rank, the ranks' parameters and BN running averages
            bitwise equal after every step, the last checkpoint restoring
            bitwise on every rank, losses within 5e-2 * (1 + |loss|) of
            (a)'s, (b)'s first step within 1e-2 * (1 + |loss|), (c)'s
            all-reduced gradient the ranks' mean bitwise and its head
            gradient within 5e-2 of (a)'s; then (c) with SIGTERM to rank 1
            alone: both ranks stop at one step off a checkpoint boundary,
            exit 0, one "preempt" checkpoint. Step ms (synchronised), the
            all-reduces a micro-step and their bytes, peak memory per rank.
            Arm (c) runs under the hang watch (slice 18): each rank with
            `--obs.watchdog_timeout_s 10` and a schedule recorder, rank 1
            with a `collective.sync` delay of 25 s armed in the barrier of
            its last checkpoint fence (`Checkpointer.close`), after the
            timed steps: both ranks' watchdogs attribute the same wedged
            `barrier`, each flight record holds the stall (rank 1's alone
            the fault), no stall comes before the fault, and the merged
            schedules do not diverge (`dp_hang_hold`)
37. hub_finetune  the reference's recipe: a full-width `slowfast_r50`
            checkpoint in the hub layout (every key and shape of
            tests/hub_manifests.py, seeded values, a K400 head, a
            `model_state` wrapper) written as `.pth`, converted by the CLI
            (`models/convert.py main`) to `.npz`, then 3 steps of B=8 x 4
            (32 frames at 256^2, 700 classes) through `run.main` with
            `--model.pretrained --model.pretrained_path X.npz
            --freeze_backbone`: every backbone tensor loaded and only the
            head's `proj` kernel and bias mismatched; the state after init
            the file's bitwise; after the steps every frozen parameter
            bitwise unchanged and the head moved; launches exact (rows 1,
            1b, 2, 2b); the `.pth` loaded directly bitwise the `.npz`
            route; the same fine-tune without `--freeze_backbone`; write,
            convert and load seconds, step ms, peak memory of each
38. hub_interp_finetune  a full-width hub `mvit_b` (16x4: an (8, 56, 56)
            position grid) into `mvit_b_32x3` (a (16, 56, 56) grid) under
            `--model.remat`, 2 steps of B=4: the report's interpolated
            `pos_embed` within 1e-6 of the plain resize of the file's table
            on the card, only the head mismatched, every other leaf bitwise;
            launches exact (rows 4, 4b, 5, 6, 7)
39. hub_x3d  a full-width hub `x3d_s` fine-tuned as X3D-S (13 frames at
            160^2), 2 steps of B=8: only `proj` mismatched, the rest bitwise;
            launches exact (rows 1, 1b, 3, 3b)
40. mae_handoff  VideoMAE-B MAE pretraining, 2 steps with a checkpoint;
            `pva-torch-convert CKPT_DIR out.npz` (the final state bitwise,
            no optimizer state); the VideoMAE-B classifier 2 steps with
            `--model.pretrained`: every encoder leaf loaded bitwise the
            export, the head and fc_norm fresh; launches exact (rows 5-7)
41. model_axis_train  the (data, model) train mesh at (1, 2), two gloo
            ranks on the card, against one process on a global batch of 4
            (3 steps): MViT-B and VideoMAE-B tensor-parallel, VideoMAE-B
            Ulysses and ring, VideoMAE-B fine-tune and MAE pretraining in
            2 pipeline stages of 4 microbatches (`model_axis_train_phase`);
            (e) and (h) over NCCL on two cards only where present
42. hang_watch  an in-process full-width SlowFast-R50 Trainer with
            `--debug_nans --debug_asserts --device_init_timeout 120
            --obs.watchdog_timeout_s 30`: the probe child reports the card;
            2 clean steps of B=8, no stall, launches exact; a
            `step.dispatch` ``nan`` plan on the 3rd raises
            FloatingPointError naming a module; a batch whose label has the
            wrong rank raises AssertionError before any launch
            (`hang_watch_phase`); the step ms under the debug flags are
            reported beside train_timing's micro-step, not held
43. library_mesh_train  the library mesh (data, fsdp, tensor, context):
            (a) SlowFast-R50 at (1, 2, 1, 1) on dp_train's geometry, its
            43 leaves of >= 2^16 elements held as fsdp chunks; (b)
            VideoMAE-B at (1, 1, 2, 2) with Ulysses, 3 of its 12 heads a
            rank over all 1568 tokens; gloo ranks sharing the card; (c) (a)
            over NCCL on two cards only where present
            (`library_mesh_train_phase`)
44. stream_serve  streaming sessions (`streaming/engine.py`): (a) the
            SlowFast-R50 artifact of phase 3 through `build_server`
            with `--serve.streaming true --serve.scheduler edf
            --serve.stream_strides 8`: 4 sessions established over /stream
            with 32 x 256^2 u8 windows, then 5 advances each (a
            wraparound of the dual rings and one more), each response
            held against `full_recompute` of the client's window, one
            window against /predict of the same clip, 41 pointwise and
            51 conv launches
            per forward, 409 for an unknown session sent with no window,
            503 + Retry-After for a 5th session past the 32 MB budget;
            (b) VideoMAE-B's token ring (12 flash launches per step) and a
            `--model.attn_mask causal` VideoMAE-B with `trunk="causal"` K/V
            rings in bf16 and in int8 (0 launches: the masked attention
            runs on the dense route), 2 sessions, stride 2, two
            wraparounds, against `full_recompute` and
            `full_recompute_history`; (c) MViT-B's stem ring, 2 sessions,
            stride 4, one wraparound, against `full_recompute_history`, 16
            flash and 4 `depthwise3d_s1` launches per step; (d) a green
            VideoMAE-B on other seeded weights, `prepare_carry_from`, then
            `Scheduler.swap_engine` with (b)'s token sessions live: the
            next advance, sent with no window, against green's
            `full_recompute`, the blackout ms. Each family: advance against
            full_recompute ms at one bucket, H2D bytes per advance against
            a full window, ring bytes per session, `memory_allocated()`
            byte-equal over the last 4 advances (`stream_serve_phase`)
45. fleet_serve  the serving fleet (`fleet/`): two SlowFast-R50 replicas
            (streaming EDF fronts, stride 8) restored from the phase-3
            artifact (blue) behind a `ReplicaPool` (health polled every
            0.5 s) and a `Router`; green a second export on other seeded
            weights planted on the same 5 clips. (a) an open-loop `LoadGen`
            at 50 rps for 5 s: zero failures, `assert_slo` at p99 1500
            ms, every response blue's, and one /predict through an
            `InferenceServer` whose batcher is the router; (b) `hot_swap`
            of both replicas to green under an 8 s load: zero failures,
            every response within 5e-2 * (1 + |oracle|) of blue's or
            green's plain path with its top-1, green's once the swap
            returned, the blackout a replica; (c) a replica's scheduler
            closed under load: zero failures, the pool lists it down
            within one poll, a fresh replica added back takes traffic;
            (e) `Autoscaler.step()` under a 40-request backlog spawns a
            third replica, one idle step drains one, the last is never
            drained; `ModelBudget` reads "measured" footprints; the ledger
            publishes `pva_hbm_drift_frac` for the ring pools; (d) two
            sessions through the router, every advance on the replica
            holding its ring, the holder of one closed and its next
            advance re-established on the other, each response against
            `full_recompute`. Launches exact in each arm: 41 / 51 per
            SlowFast-R50 forward it ran (`fleet_serve_phase`)
The train phase of SlowFast-R50 also holds the Trainer's MFU keys:
`tflops_per_sec_per_chip` and `mfu` (0 < mfu < 1.05) present, the peak
from the data sheet on an H100, and `flops_per_step` equal to the count
the same config gives from CPU tensors of the step's shapes
(`mfu_facts`).
The serving phases run with the obs layer on: edf_serve also holds the
ledger's weight bytes on /metrics, /history's series of the request
counters, and a 503 on /history from a server built with
`--obs.enabled false`; preempt_train holds the flight record's "preempt"
events. The `seconds` line reports the script's time since it started.

Then the kernels' JSON line (11 entries; its ms, plain_ms, library_ms and
bound_ms are summed over the kernel's launches in one bucket-8 forward of
the model that carries it, SlowFast-R50 for the pointwise and conv kernels,
X3D-M for the depthwise ones, MViT-B for the flash ones; for a backward
row over its launches in one B=8 micro-step; launches are those of the
main-path phase that runs the kernel: serve, train, x3d_serve,
x3d_depthwise_impl, x3d_train, mvit_serve and mvit_train; the GEMM
kernels' entries carry the same sums and launches for R(2+1)D-50, from
r2plus1d_serve and r2plus1d_train, under "r2plus1d_r50"; the rows on
slice 10's paths carry "train_features": the launches of features_train
(rows 1-2b, with their SlowFast-R50 sums) or of one remat_train
micro-step (rows 4, 4b, 5, 6, 7); rows 1, 1b, 2, 2b, 4 and 5 carry
"edf_serve", "int8_serve" and "preempt_train" sub-entries with those
phases' launches, and rows 1, 1b, 2, 2b a "dp_train" one with the
launches of one rank of dp_train's arm (c); every row carries the
launches of the fine-tuning phases that run it: "hub_finetune" on rows
1-2b, "hub_x3d" on rows 1, 1b, 3, 3b, "hub_interp_finetune" on rows 4-7,
"mae_handoff" on rows 5-7; "model_axis_train" on rows 4-7,
"model_axis_train_pipeline" on rows 5-7 (one stage rank of arm (f)) and
"library_mesh_train_a" / "_b" on rows 1-2b / 5-7: one rank's launches;
"hang_watch" on rows 1-2b: its 2 clean steps' launches; "observe_train"
on rows 1-2b; "stream_serve" on rows 1, 2, 4 and 5: the launches of the
four arms together; "fleet_serve" on rows 1 and 2: its five arms'),
the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failed check
raises: the script exits non-zero and prints no result. It exits non-zero
at once without CUDA.

A kernel row's device times (kernel, plain, library) come from CUDA events
around calls that the card runs back to back (`device_ms`). The
breakdowns by kernel class come from torch.profiler profiles that
`device_events` holds complete (`reps` times one call's kernels, or taken
again); one that stays incomplete is reported as such, not summed. The
`seconds` phase counts the retakes and the incomplete profiles.

Tolerances. Kernel vs plain version: both multiply bf16 operands exactly,
sum in f32 and round once to bf16, so elementwise
|kernel - plain| <= 1e-2 * (1 + |plain|). Served logits vs the plain path:
every layer rounds to bf16 (relative 2^-9) in a different summation order,
compounded over ~50 layers: |served - plain| <= 5e-2 * (1 + |plain|), and
top-1 must agree wherever the plain top-1 margin exceeds 2 * 5e-2 * (1 +
|top logit|). The training loss, the head's gradient (SlowFast), and (with
the forward held fixed) the whole gradient and one SGD update: within 5e-2
(the gradients relative in the 2-norm). The flash kernels' dq, dk and dv are
held elementwise like the forward, against `flash_bwd_plain` on the same
(out, lse).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
NUM_CLASSES = 700
FRAMES, CROP, ALPHA, BUCKET = 32, 256, 4, 8
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = 1e-2
LSE_TOL = 1e-4  # flash lse, absolute: f32 all through, feeds the backward
LOGIT_TOL = 5e-2
PLANTED_LOGIT = 6.0
# scale of each residual branch's final BN (`conv_c.norm.weight`) in the
# seeded serving weights: the X3D and SlowFast training recipes zero-init it
# (ZERO_INIT_FINAL_BN). At the full scale, bf16 rounding grows with depth
# in these random nets: X3D-M's conv5 output drifts ~50% from an f32 run of
# the same weights (a CPU run at 8x112^2), at 0.1 ~3%
RESIDUAL_BN_SCALE = 0.1
# the same for the transformers: scale of each block's residual branch's
# last projection (`proj`, `mlp_fc2`) in the seeded serving weights. At
# the full scale a CPU run of MViT-B at 4x32^2 (all 16 blocks, full width)
# put bf16 logits 0.063 from an f32 run of the same weights, past the
# 5e-2 * (1 + |plain|) tolerance; at 0.1, 0.038
RESIDUAL_PROJ_SCALE = 0.1
PW_PER_FORWARD, CONV_PER_FORWARD = 41, 51
SITES_PER_FORWARD = {"fused_pw_bn_act": PW_PER_FORWARD,
                     "fused_conv_bn_act": CONV_PER_FORWARD}
# the depthwise slice: X3D-M and CSN-R101 (models/x3d.py, models/csn.py)
X3D_DEPTHS, CSN_DEPTHS = (3, 5, 11, 7), (3, 4, 23, 3)
CSN_BUCKET = 4
# (frames, crop) each model is served and trained at
GEOMETRY = {"slowfast_r50": (FRAMES, CROP), "x3d_m": (16, 224),
            "csn_r101": (32, 224), "mvit_b": (16, 224), "videomae_b": (16, 224),
            "videomae_b_pretrain": (16, 224), "r2plus1d_r50": (16, 224),
            "mvit_b_32x3": (32, 224), "x3d_s": (13, 160)}
# head classes of each model's seeded artifact and training run (the hub
# head of R(2+1)D-50 is Kinetics-400); NUM_CLASSES otherwise
CLASSES = {"r2plus1d_r50": 400}
# R(2+1)D-50 (models/r2plus1d.py): blocks per stage, and the stages whose
# entry strides T (a strided temporal factor, not fused)
R2_DEPTHS, R2_T_STRIDED_STAGES = (3, 4, 6, 3), 2
# the attention slice: MViT-B (models/mvit.py) and VideoMAE-B
# (models/videomae.py) through the flash kernels
MVIT_STAGE_STARTS, MVIT_DEPTH, MVIT_KV_STRIDE = (1, 3, 14), 16, (1, 8, 8)
VIT_DEPTH, VIT_DECODER_DEPTH = 12, 4
TRANSFORMER_LR = 0.01
ATTN_ARGV = ["--model.attention", "pallas", "--model.depthwise_impl", "pallas"]
# the train phases: run.main on the reference recipe's geometry for
# SlowFast-R50; two steps of B=8 with a checkpoint each step for X3D-M
SLOWFAST_TRAIN = dict(name="slowfast_r50", batch=8, accum=4, epochs=2,
                      videos=64, ckpt_every=2)
X3D_TRAIN = dict(name="x3d_m", batch=8, accum=1, epochs=1, videos=16,
                 ckpt_every=1)
# two steps of B=8 with a checkpoint each step, through the flash kernels
# (and row 4 at MViT's stride-1 K/V pools); SGD at lr 0.01 (MViT's global
# gradient norm at init is ~37: a CPU f32 run of mvit_t)
MVIT_TRAIN = dict(X3D_TRAIN, name="mvit_b", lr=TRANSFORMER_LR, argv=ATTN_ARGV)
MAE_TRAIN = dict(X3D_TRAIN, name="videomae_b_pretrain", lr=TRANSFORMER_LR,
                 argv=ATTN_ARGV[:2], pretrain=True)
# one B=8 micro-step of the VideoMAE-B classifier (fine-tuning), timed only
VIDEOMAE_TRAIN = dict(X3D_TRAIN, name="videomae_b", lr=TRANSFORMER_LR,
                      argv=ATTN_ARGV[:2])
# R(2+1)D-50 from a frame cache: 16 train videos (2 steps of B=8, a
# checkpoint each step) and 8 val videos of 64 frames at 256x320, 30 fps;
# 16 frames x sampling rate 4 (hub r2plus1d_r50 16x4) span 64 frames
R2_TRAIN = dict(name="r2plus1d_r50", batch=8, accum=1, epochs=1, videos=16,
                val_videos=8, ckpt_every=1, sampling_rate=4,
                cache_frames=64, cache_size=(256, 320), cache_fps=30.0)
# the training features (mixup/cutmix, the guard, tracking) on SlowFast-R50
# at the reference geometry: 5 steps of B=8 x accumulation 2 through
# Trainer, the batches of steps 3 and 4 poisoned with NaN
FEATURES_TRAIN = dict(SLOWFAST_TRAIN, accum=2, epochs=1, videos=80, ckpt_every=0,
                      argv=["--optim.mixup_alpha", "0.8",
                            "--optim.cutmix_alpha", "1.0",
                            "--optim.ema_decay", "0.999", "--guard.enabled",
                            "--guard.lkg_every_steps", "1",
                            "--guard.rollback_after", "2",
                            "--tracking.with_tracking",
                            "--tracking.trackers", "jsonl",
                            "--tracking.log_every", "1"])
POISONED_TAKES = (3, 4)  # the train loader's 3rd and 4th batches
# fit()'s step time with tracking on and off, and with tracking on and the
# obs layer off: Trainers of one epoch of 4 plain steps each, in turns on,
# off, obs_off (the first interval of each dropped: 3 per setting; 6 steps
# before the library-mesh phase, turns on, off, off, on before the
# data-parallel phase, and 12 steps before the serving-defaults and
# preemption phases; no obs_off turn before the telemetry phase)
TRACKING_TRAIN = dict(SLOWFAST_TRAIN, accum=2, epochs=1, videos=64, ckpt_every=0)
TRACKING_ORDER = ("on", "off", "obs_off")
# the armed guard's and mixing's cost: optimizer steps timed in rounds of
# plain, mixed, mixed + armed guard (the order turned each round; 6 rounds
# before the library-mesh phase, 8 before the data-parallel phase, 24
# before the serving-defaults and preemption phases, 4 before the telemetry
# phase, 3 before the hang-watch phase, 2 before the transport-and-tracing
# phases)
ARMED_ROUNDS = 1
# hub mvit_base_32x3 (32 frames x stride 3 at 224^2, drop path 0.3) under
# per-block remat: B=4 micro-steps with and without --model.remat
REMAT_TRAIN = dict(X3D_TRAIN, name="mvit_b_32x3", batch=4, lr=TRANSFORMER_LR,
                   argv=ATTN_ARGV + ["--sampling_rate", "3"])
TRAIN_BATCH = SLOWFAST_TRAIN["batch"]
BASE_LR = 0.1  # OptimConfig default, cosine to 0 over the run, no warmup
# profiled calls per timing of a depthwise-slice kernel row (10 before the
# hang-watch phase, 5 before the transport-and-tracing phases)
DW_REPS = 3
# calls per class breakdown (a forward or a micro-step; 3 forwards and 2
# micro-steps before the smoke grew the fine-tuning phases, cut to keep the
# whole smoke inside its time limit)
PROFILE_REPS = 1
# main-path sites reported by name: module path -> label
NAMED_SITES = {
    "slow_res2.block1.conv_c": "slow res2 conv_c 64->256",
    "fast_res2.block0.branch1": "fast res2 branch1 Cin=8",
    "slow_res2.block1.conv_b": "slow res2 conv_b (1,3,3) 64->64",
    "fast_res2.block0.conv_a": "fast res2 conv_a (3,1,1) 8->8",
    "slow_res5.block1.conv_b": "slow res5 conv_b (1,3,3) 512->512",
    "slow_res4.block1.conv_a": "slow res4 conv_a (3,1,1) 1024->256",
}
_DW_SRC = "pytorchvideo_accelerate_tpu_torch/ops/csrc/depthwise3d.cu"
_FLASH_SRC = "pytorchvideo_accelerate_tpu_torch/ops/csrc/flash_attention.cu"
_FLASH_BWD_SRC = "pytorchvideo_accelerate_tpu_torch/ops/csrc/flash_attention_bwd.cu"
SOURCES = {
    "fused_pw_bn_act": ("pytorchvideo_accelerate_tpu_torch/ops/csrc/fused_pw_bn_act.cu",
                        "pytorchvideo_accelerate_tpu/ops/pallas_fused.py:123"),
    "fused_conv_bn_act": ("pytorchvideo_accelerate_tpu_torch/ops/csrc/fused_conv_bn_act.cu",
                          "pytorchvideo_accelerate_tpu/ops/pallas_fused.py:183"),
    # the backward's dx launch of each kernel (ops/fused.py PwBnAct and
    # ConvBnAct), the port of the custom VJPs' dx pass
    "fused_pw_bn_act.bwd_dx": ("pytorchvideo_accelerate_tpu_torch/ops/csrc/fused_pw_bn_act.cu",
                               "pytorchvideo_accelerate_tpu/ops/pallas_fused.py:162"),
    "fused_conv_bn_act.bwd_dx": ("pytorchvideo_accelerate_tpu_torch/ops/csrc/fused_conv_bn_act.cu",
                                 "pytorchvideo_accelerate_tpu/ops/pallas_fused.py:252"),
    # the depthwise stencil's two entry points and their dx launches
    # (ops/fused.py DwBnAct, ops/depthwise.py Depthwise3dS1)
    "fused_dw_bn_act": (_DW_SRC, "pytorchvideo_accelerate_tpu/ops/pallas_fused.py:286"),
    "fused_dw_bn_act.bwd_dx": (_DW_SRC, "pytorchvideo_accelerate_tpu/ops/pallas_fused.py:350"),
    "depthwise3d_s1": (_DW_SRC, "pytorchvideo_accelerate_tpu/ops/pallas_depthwise.py:58"),
    "depthwise3d_s1.bwd_dx": (_DW_SRC, "pytorchvideo_accelerate_tpu/ops/pallas_depthwise.py:157"),
    # the flash attention forward and its custom VJP's two backward kernels
    # (ops/flash_attention.py FlashAttention)
    "flash_attention": (_FLASH_SRC, "pytorchvideo_accelerate_tpu/ops/pallas_attention.py:54"),
    "flash_attention.bwd_dq": (_FLASH_BWD_SRC, "pytorchvideo_accelerate_tpu/ops/pallas_attention.py:93"),
    "flash_attention.bwd_dkv": (_FLASH_BWD_SRC, "pytorchvideo_accelerate_tpu/ops/pallas_attention.py:116"),
}
# per kernel of the kernels line: the model whose bucket-8 forward (and B=8
# micro-step, for dx) its times are summed over, and the main-path phases
# whose launches it reports (forward, dx)
LINE = {"fused_pw_bn_act": ("slowfast_r50", "serve", "train"),
        "fused_conv_bn_act": ("slowfast_r50", "serve", "train"),
        "fused_dw_bn_act": ("x3d_m", "x3d_serve", "x3d_train"),
        "depthwise3d_s1": ("x3d_m", "x3d_depthwise_impl", "x3d_train_depthwise_impl"),
        "flash_attention": ("mvit_b", "mvit_serve", "mvit_train")}


# the artifacts `make_artifact` wrote, by model: (path, request clips)
ARTIFACTS = {}
# what a later phase reuses of an earlier one: dp_train's one-process arm
# and model_axis_train's one-process references (`library_mesh_train`)
KEPT = {}


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line per phase, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "at_s": round(time.perf_counter() - T_START, 1),
                      **fields}), flush=True)


def check(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


PROFILE_RETAKES = [0]  # profiles taken again: incomplete (see `device_events`)
INCOMPLETE_PROFILES = [0]  # breakdowns left without a complete profile
SPIN_CYCLES_PER_S = 2.0e9  # at least the card's SM clock (H100 SXM: 1.98 GHz)


class IncompleteProfile(RuntimeError):
    pass


class DeviceEvent:
    """One device-side event of a profile: its kernel (or copy) name and
    its start and end, in microseconds."""

    __slots__ = ("name", "start", "end")

    def __init__(self, name: str, start: float, end: float):
        self.name, self.start, self.end = name, start, end

    @property
    def us(self) -> float:
        return self.end - self.start


def _profiled(torch, fn, reps: int):
    """The device-side events (kernels, copies) torch.profiler records over
    `reps` calls of `fn`. Only the CUDA activity is traced (tracing the
    host-side ops too spreads the device work over a longer span: PERF.md
    §3), and the events are read from the profiler's raw results: the host-side
    ops and the `FunctionEvent` table that `prof.events()` builds cost
    several times the profiled work, for the same names and times. The
    profile object is freed here: its table of bound methods makes it a
    reference cycle, which would keep its trace alive until the cyclic
    garbage collector runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kev = [DeviceEvent(e.name(), e.start_ns() / 1e3,
                       (e.start_ns() + e.duration_ns()) / 1e3)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    prof.profiler.kineto_results = None
    prof.profiler = None
    prof.action_map = None
    return kev


def device_events(torch, fn, reps: int, attempts: int = 1):
    """The device-side events of `reps` calls of `fn` after one warm-up
    call, from a profile that is known to be complete. On the card a
    profile can come back with some or all of its device events missing:
    from the X3D phases on, a profile of one depthwise launch held no event
    at all, and one of ten held three or ten, however often it was taken.
    So a profile of one call counts the kernels a call launches, and the
    profile of `reps` calls is kept only if it holds `reps` times as many,
    to within 1% (exactly, below 100 kernels); otherwise both are taken
    again after a garbage collection, and after `attempts` (one since the
    smoke grew the data-parallel phase, two before)
    `IncompleteProfile` is raised. The 1% admits what a call really varies
    by: a bucket-8 SlowFast-R50 forward launched 1323 or 1324 kernels (an
    elementwise kernel more or less) on the H100, while a lost call or a
    lost window is a third or all of a profile. Copies and memsets are kept
    but not counted: a pageable host-to-device copy shows as a varying
    number of chunks."""
    import gc
    from collections import Counter

    def kernels(events):
        return Counter(e.name for e in events
                       if not e.name.startswith(("Memcpy", "Memset")))

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        one = kernels(_profiled(torch, fn, 1))
        kev = _profiled(torch, fn, reps)
        many = kernels(kev)
        want = reps * sum(one.values())
        if want and abs(sum(many.values()) - want) <= want // 100:
            return kev
        diff = sorted((k[:48], many[k], reps * one[k]) for k in set(many) | set(one)
                      if many[k] != reps * one[k])
        seen.append((sum(one.values()), sum(many.values()), diff[:3]))
        PROFILE_RETAKES[0] += 1
        gc.collect()
    raise IncompleteProfile(
        f"no complete profile of {reps} calls in {attempts} attempts (kernels "
        f"of one call, of {reps}, first names that differ: {seen})")


def device_ms(torch, fn, reps: int = 20, attempts: int = 8) -> float:
    """Device time of one `fn()` call: CUDA events around `reps` calls that
    the card runs back to back. The calls are queued behind a spin kernel
    (`torch.cuda._sleep`) sized to outlast the host's launching of them; the
    start event must still be pending when the last call has been queued,
    which proves the card had not begun them, so no host gap is timed. If it
    was not (a slow host, or a launch queue that filled), the calls are
    timed again in chunks half the size behind a spin twice as long. Only
    the card's own gaps between back-to-back kernels (about a microsecond)
    count beyond the kernels. Fails the smoke after `attempts`."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t  # launching one call
    torch.cuda.synchronize()
    chunk, scale = reps, 3.0
    for _ in range(attempts):
        total, done = 0.0, 0
        while done < reps:
            k = min(chunk, reps - done)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (scale * host_s * k + 2e-4)))
            start.record()
            for _ in range(k):
                fn()
            end.record()
            queued = not start.query()
            torch.cuda.synchronize()
            if not queued:
                break
            total += start.elapsed_time(end)
            done += k
        if done == reps:
            return total / reps
        chunk, scale = max(1, chunk // 2), scale * 2
    raise RuntimeError(f"chip_smoke check failed: {reps} calls never ran back "
                       f"to back ({attempts} attempts)")


def serve_cfg(parse_cli, fused: str, name: str = "slowfast_r50",
              impl: str = "conv", bucket: int = BUCKET, attention: str = "dense"):
    frames, crop = GEOMETRY[name]
    return parse_cli([
        "--model.name", name, "--model.num_classes", str(classes(name)),
        "--model.fused_kernels", fused, "--model.depthwise_impl", impl,
        "--model.attention", attention,
        "--num_frames", str(frames), "--data.crop_size", str(crop),
        "--slowfast_alpha", str(ALPHA), "--data.host_cast", "u8",
        "--mixed_precision", "bf16", "--serve.max_batch_size", str(bucket)])


def is_transformer(name: str) -> bool:
    return name.startswith(("mvit", "videomae"))


def classes(name: str) -> int:
    return CLASSES.get(name, NUM_CLASSES)


def u8_clips(rng, name: str, n: int) -> dict:
    """n seeded u8 clips at `name`'s serving geometry, NDHWC: noise, and for
    the transformers noise of +-48 around a per-clip colour. Their heads
    read a mean over thousands of tokens, which averages pure noise clips
    to nearly one feature; a colour per clip keeps the request clips'
    pooled features apart, so the planted head stays well conditioned."""
    frames, crop = GEOMETRY[name]
    if name.startswith("slowfast"):
        return {"slow": rng.integers(0, 256, (n, frames // ALPHA, crop, crop, 3), np.uint8),
                "fast": rng.integers(0, 256, (n, frames, crop, crop, 3), np.uint8)}
    if is_transformer(name):
        base = rng.integers(48, 208, (n, 1, 1, 1, 3))
        noise = rng.integers(-48, 48, (n, frames, crop, crop, 3))
        return {"video": (base + noise).astype(np.uint8)}
    return {"video": rng.integers(0, 256, (n, frames, crop, crop, 3), np.uint8)}


def bucket_batch(clips, bucket: int) -> dict:
    """The request clips stacked and padded with copies of the first to
    `bucket` rows."""
    return {k: np.stack([c[k] for c in clips] + [clips[0][k]] * (bucket - len(clips)))
            for k in clips[0]}


def seeded_state_dict(model, rng):
    """He-scaled conv weights (fan-in = in-channels x taps), BN affine near
    identity (a residual branch's final BN scale times RESIDUAL_BN_SCALE),
    LayerNorm scales near 1, Linear weights std 1/sqrt(in) (a transformer
    block's `proj` and `mlp_fc2` times RESIDUAL_PROJ_SCALE), zero Linear and
    conv biases, running statistics 0 and 1; MViT's pos_embed and VideoMAE's
    mask_token std 0.02."""
    sd = model.state_dict()
    out = {}
    for name, t in sd.items():
        shape = tuple(t.shape)
        stem, _, leaf = name.rpartition(".")
        bn = f"{stem}.running_var" in sd
        if leaf == "weight" and len(shape) == 5:
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape, np.float32) * np.sqrt(2.0 / fan_in)
        elif leaf == "weight" and len(shape) == 2:
            v = rng.standard_normal(shape, np.float32) / np.sqrt(shape[1])
            if "block" in stem and stem.rpartition(".")[2] in ("proj", "mlp_fc2"):
                v *= RESIDUAL_PROJ_SCALE
        elif leaf == "weight" and bn:
            v = rng.uniform(0.8, 1.2, shape).astype(np.float32)
            if stem.endswith("conv_c.norm"):
                v *= RESIDUAL_BN_SCALE
        elif leaf == "bias" and bn:
            v = rng.standard_normal(shape, np.float32) * 0.05
        elif leaf == "weight" and len(shape) == 1:  # LayerNorm scale
            v = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        elif leaf in ("pos_embed", "mask_token"):
            v = rng.standard_normal(shape, np.float32) * 0.02
        elif leaf in ("bias", "running_mean"):
            v = np.zeros(shape, np.float32)
        elif leaf == "running_var":
            v = np.ones(shape, np.float32)
        else:
            raise KeyError(f"no seeding rule for {name}")
        out[name] = v
    return out


def head_proj(model):
    """The classifier's final Linear (`head.proj`, X3D's `proj`, or the
    transformers' `head`)."""
    head = getattr(model, "head", None)
    if head is None:
        return model.proj
    return getattr(head, "proj", head)


def device_inputs(torch, clips: dict, norm):
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
        device_normalize_batch,
        model_inputs,
    )

    return model_inputs(device_normalize_batch(
        {k: torch.from_numpy(v).cuda() for k, v in clips.items()}, norm))


def calibrate_bn(torch, model, clips, norm):
    """Set every BN's running stats to the batch statistics of its input on
    `clips` (one unfused bf16 forward), so activations stay O(1) through
    the ~50 layers and the logits are not all ~0."""
    from pytorchvideo_accelerate_tpu_torch.models.common import BNAffine

    if not any(isinstance(m, BNAffine) for m in model.modules()):
        return

    def hook(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3, 4)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3, 4), unbiased=False))

    handles = [m.register_forward_pre_hook(hook)
               for m in model.modules() if isinstance(m, BNAffine)]
    try:
        with torch.inference_mode():
            model(device_inputs(torch, clips, norm))
    finally:
        for h in handles:
            h.remove()


def plant_head(torch, model, clips, norm, logit: float = PLANTED_LOGIT):
    """Plant head classes 0..n-1 on the n request clips: row i is clip i's
    pooled feature centred on the clips' mean, scaled so that clip i scores
    `logit` on class i (a nearest-mean classifier over the clips). The other
    rows stay random, so each request has an input-dependent top-1 with a
    margin the top-1 check can hold the served path to."""
    feats = []
    proj = head_proj(model)
    handle = proj.register_forward_pre_hook(
        lambda mod, args: feats.append(args[0].float().cpu().numpy()))
    try:
        with torch.inference_mode():
            model(device_inputs(torch, bucket_batch(clips, len(clips)), norm))
    finally:
        handle.remove()
    f = feats[0].astype(np.float64)
    mean = f.mean(axis=0)
    d = f - mean
    rows = logit * d / (d * d).sum(axis=1, keepdims=True)
    n = len(clips)
    with torch.no_grad():
        proj.weight[:n].copy_(torch.from_numpy(rows))
        proj.bias[:n].copy_(torch.from_numpy(-(rows @ mean)))


def make_artifact(torch, work: str, name: str, rng, requests: int = 5,
                  bucket: int = BUCKET, attention: str = "dense",
                  impl: str = "conv", clips=None, tag: str = ""):
    """Seeded `name` weights, BN calibrated on 2 noise clips, head classes
    planted on `requests` request clips (`clips` when given), exported with
    the port's `export_inference` under a config that serves through
    `attention` and `impl`; `tag` names another artifact of `name` (kept
    out of ARTIFACTS). Returns (artifact path, its state, the clips, the
    normalisation, the parameter count)."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import (
        export_inference,
        load_inference,
    )

    art = os.path.join(work, f"{name}{tag}_artifact")
    cfg = serve_cfg(parse_cli, "auto", name, impl, bucket, attention)
    norm = (cfg.data.mean, cfg.data.std)
    calib = create_model(serve_cfg(parse_cli, "off", name).model, "bf16",
                         data_cfg=cfg.data).eval()
    state = seeded_state_dict(calib, rng)
    calib.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    calib.cuda()
    calibrate_bn(torch, calib, u8_clips(rng, name, 2), norm)
    # requests: distinct seeded u8 clips at the serving geometry
    if clips is None:
        clips = [{k: v[0] for k, v in u8_clips(rng, name, 1).items()}
                 for _ in range(requests)]
    plant_head(torch, calib, clips, norm)
    export_inference(art, calib, cfg, meta={"num_classes": classes(name),
                                            "model": name})
    if not tag:
        ARTIFACTS[name] = (art, clips)
    del calib
    state, _ = load_inference(art)
    n_params = int(sum(v.size for k, v in state.items()
                       if not k.endswith(("running_mean", "running_var"))))
    return art, state, clips, norm, n_params


def make_engine(torch, name: str, state, norm, fused: str, impl: str = "conv",
                bucket: int = BUCKET, attention: str = "dense",
                quantization: str = "off", attn_mask: str = "none"):
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine

    cfg = serve_cfg(parse_cli, fused, name, impl, attention=attention)
    cfg.model.attn_mask = attn_mask
    return InferenceEngine(
        create_model(cfg.model, "bf16", data_cfg=cfg.data),
        state, num_classes=classes(name), max_batch_size=bucket,
        device_normalize=norm, input_dtype="uint8", model_name=name,
        quantization=quantization)


def expected_forward_launches(name: str) -> dict:
    """Kernel launches of one eval forward under `fused_kernels auto`, from
    the code. SlowFast-R50: 41 pointwise and 51 odd-tap conv sites. X3D
    (models/x3d.py): every block's conv_a and conv_c and conv5 are pointwise
    sites (branch1 is never fused); every block's conv_b but a stage's
    strided first, and stem_t, are depthwise sites. CSN (models/csn.py):
    every block's conv_a and conv_c, and res2 block0's stride-1 branch1 (a
    width change), are pointwise; every conv_b but the strided res3-res5
    entries is depthwise. R(2+1)D (models/r2plus1d.py): every block's conv_a
    and conv_c are pointwise; the conv_b_s of every block but a stage's
    first (spatially strided) and the conv_b_t of every block but the
    temporally strided res4 and res5 entries are conv sites."""
    if name == "slowfast_r50":
        return dict(SITES_PER_FORWARD)
    if name == "r2plus1d_r50":
        blocks = sum(R2_DEPTHS)
        return {"fused_pw_bn_act": 2 * blocks,
                "fused_conv_bn_act": (blocks - len(R2_DEPTHS))
                + (blocks - R2_T_STRIDED_STAGES)}
    if name == "mvit_b":
        return expected_mvit_launches()
    if name == "videomae_b":
        return {"flash_attention": VIT_DEPTH}
    if name == "videomae_b_pretrain":
        return {"flash_attention": VIT_DEPTH + VIT_DECODER_DEPTH}
    if name == "x3d_m":
        blocks = sum(X3D_DEPTHS)
        return {"fused_pw_bn_act": 2 * blocks + 1,
                "fused_dw_bn_act": blocks - len(X3D_DEPTHS) + 1}
    blocks = sum(CSN_DEPTHS)
    return {"fused_pw_bn_act": 2 * blocks + 1,
            "fused_dw_bn_act": blocks - (len(CSN_DEPTHS) - 1)}


def expected_mvit_launches() -> dict:
    """Launches of one MViT-B eval forward under `attention pallas,
    depthwise_impl pallas`, from models/mvit.py's schedule: one flash
    attention per block; the K/V pools run in every block, and those whose
    kv stride has halved to (1,1,1) (the blocks after the last stage start
    that brings it there) are stride-1 depthwise sites, two per block."""
    kv, s1_blocks = list(MVIT_KV_STRIDE), 0
    for i in range(MVIT_DEPTH):
        if i in MVIT_STAGE_STARTS:
            kv = [max(s // 2, 1) if j > 0 else s for j, s in enumerate(kv)]
        s1_blocks += kv == [1, 1, 1]
    return {"flash_attention": MVIT_DEPTH, "depthwise3d_s1": 2 * s1_blocks}


def expected_depthwise_impl_launches() -> dict:
    """`depthwise3d_s1` launches of one X3D-M eval forward under
    `fused_kernels off, depthwise_impl pallas`: the stride-1 odd-tap
    depthwise sites, the same set as the fused ones."""
    return {"depthwise3d_s1": expected_forward_launches("x3d_m")["fused_dw_bn_act"]}


def check_launches(launches: dict, per_forward: dict, forwards: int,
                   what: str) -> None:
    want = {k: per_forward.get(k, 0) * forwards for k in SOURCES}
    check(all(launches[k] == want[k] for k in SOURCES),
          f"{what}: launches {launches}, expected {want} over {forwards} forwards")


def record_sites(torch, model, run):
    """{module name: (NDHWC input shape, weight DHWIO shape, act)} of every
    fused ConvBNAct site that `run()` goes through."""
    from pytorchvideo_accelerate_tpu_torch.models.common import ConvBNAct

    sites = {}

    def make(name):
        def hook(mod, args):
            b, c, t, h, w = args[0].shape
            kt, kh, kw = mod.kernel
            sites[name] = ((b, t, h, w, c),
                           (kt, kh, kw, c, mod.conv.out_channels), mod.act)
        return hook

    handles = [m.register_forward_pre_hook(make(n))
               for n, m in model.named_modules()
               if isinstance(m, ConvBNAct) and m.fuse]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return sites


def record_dw_sites(run):
    """[(NDHWC input shape, taps shape, act)] of every fused depthwise site
    that `run()` goes through under `fused_kernels xla`, in call order."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    sites = []
    plain = fused.dw_bn_act_plain

    def recording(x, kf, bias32, act):
        sites.append((tuple(x.shape), tuple(kf.shape), act))
        return plain(x, kf, bias32, act)

    fused.dw_bn_act_plain = recording
    try:
        run()
    finally:
        fused.dw_bn_act_plain = plain
    return sites


def act_(y, act: str):
    """The epilogue activation in place (the library yardstick's)."""
    import torch.nn.functional as F

    if act == "relu":
        return y.relu_()
    if act == "silu":
        return F.silu(y, inplace=True)
    return y


def inside_taps(k: int, n: int) -> int:
    """Taps of a stride-1 SAME window of odd width k over n positions that
    land inside the volume, summed over the n outputs: k*n - p*(p+1) for
    p = k//2 <= n."""
    p = k // 2
    return sum(max(0, n - abs(d)) for d in range(-p, p + 1))


def site_bound(x_shape, w_shape):
    """(flops, bytes) the site must do and move: each input read once, the
    output written once; only the multiplies by taps inside the volume
    (those by the SAME zero padding are not needed)."""
    b, t, h, w, _ = x_shape
    m = b * t * h * w
    kt, kh, kw, cin, cout = w_shape
    taps = inside_taps(kt, t) * inside_taps(kh, h) * inside_taps(kw, w)
    flops = 2.0 * b * taps * cin * cout
    nbytes = 2.0 * (m * cin + kt * kh * kw * cin * cout + m * cout) + 4.0 * cout
    return flops, nbytes


def dw_site_bound(x_shape, k_shape, bias: bool):
    """(flops, bytes) of a stride-1 SAME depthwise site: a multiply-add per
    tap inside the volume, x read and the output written once (both bf16,
    the same shape), the bf16 taps and the f32 bias read once."""
    b, t, h, w, c = x_shape
    kt, kh, kw = k_shape[:3]
    taps = inside_taps(kt, t) * inside_taps(kh, h) * inside_taps(kw, w)
    nbytes = 2.0 * (2 * b * t * h * w * c + kt * kh * kw * c) + (4.0 * c if bias else 0.0)
    return 2.0 * b * taps * c, nbytes


def _kernel_row(torch, kname, model, names, x_shape, w_shape, act, kern,
                plain, library, bound, reps: int = 20, facts=None) -> dict:
    """Hold `kern()` against `plain()` and time kernel, plain and library
    (device time); `bound` is the site's (flops, bytes). With `facts` (the
    GEMM kernels' configuration and build facts, added to the row) two
    launches must also be bitwise equal."""
    got = kern()
    if facts is not None:
        again = kern()
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{names[0]} ({kname}): two launches differ")
        del again
    got = got.float()
    want = plain().float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{names[0]}: non-finite output")
    err = (got - want).abs()
    excess = (err - KERNEL_TOL * (1 + want.abs())).max().item()
    max_err = err.max().item()
    check(excess <= 0, f"{names[0]} ({kname} {x_shape} {w_shape} {act}): "
          f"max_abs_err {max_err} over tolerance")
    del got, want, err
    kernel_ms = device_ms(torch, kern, reps)
    plain_ms = device_ms(torch, plain, reps)
    library_ms = device_ms(torch, library, reps)
    flops, nbytes = bound
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    row = {"kernel": kname, "model": model, "sites": names,
           "per_forward": len(names),
           "x": list(x_shape), "w": list(w_shape), "act": act,
           "max_abs_err": max_err, "tolerance": f"{KERNEL_TOL}*(1+|plain|)",
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "flop_ms": t_ops, "byte_ms": t_bytes,
           "tflops": flops / kernel_ms / 1e9, "gbps": nbytes / kernel_ms / 1e6,
           "bound_share": max(t_ops, t_bytes) / kernel_ms,
           "library_ratio": kernel_ms / library_ms,
           "named": [NAMED_SITES[n] for n in names if n in NAMED_SITES],
           **(facts or {})}
    emit("kernels", **row)
    return row


def gemm_facts(kname: str, config: int) -> dict:
    """The GEMM configuration a launch of `kname` ran in, and its build
    facts on this card (`fused.gemm_attrs`)."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    return {"config": config, "tile": fused.gemm_tile(config)[0],
            "path": fused.gemm_path(config),
            "attrs": fused.gemm_attrs(kname.split(".")[0], config)}


def gemm_build_facts() -> dict:
    """ptxas's registers and spills and the runtime's attributes of both GEMM
    kernels in every configuration, ptxas's lines found by the config id in
    the kernel's mangled name (`<kernel>_kernelILi<id>EE`). Each must have
    its ptxas report, spill nothing, fit a block's 227 KB of shared memory
    and at least one block per SM."""
    from pytorchvideo_accelerate_tpu_torch.ops import _build, fused

    out = {}
    for kname in ("fused_pw_bn_act", "fused_conv_bn_act"):
        report = ptxas_report(_build.build_logs.get(kname, ""))
        for config in range(fused.GEMM_CONFIGS):
            tag = f"{kname}_kernelILi{config}EE"
            ptx = [v for k, v in report.items() if tag in k]
            check(len(ptx) == 1, f"{kname} config {config}: {len(ptx)} ptxas reports")
            facts = {"ptxas": ptx[0], **gemm_facts(kname, config)}
            attrs = facts["attrs"]
            check(ptx[0].get("spill_stores", 0) + attrs["local_bytes"] == 0
                  and 0 < attrs["smem_bytes"] <= 227 * 1024
                  and attrs["blocks_per_sm"] >= 1, f"{kname} config {config}: {facts}")
            out[f"{kname}/{config}"] = facts
    return out


def host_us(fn, reps: int = 2000) -> float:
    """Host-clock microseconds of one `fn()` call, over `reps` calls."""
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps * 1e6


def kernel_sums(rows) -> dict:
    """{model: {kernel: ms, library_ms, plain_ms, bound_ms summed over the
    model's launches, and their ratio}} of the GEMM and depthwise kernels'
    rows, the GEMM rows with `plan_host_ms`: the host time the wrappers'
    plan lookup and checks (`fused._gemm_config` on contiguous operands) add
    over those launches."""
    out = {}
    for r in rows:
        if r["kernel"].startswith("flash_attention"):
            continue
        d = out.setdefault(r["model"], {}).setdefault(
            r["kernel"], {"launches": 0, "ms": 0.0, "library_ms": 0.0,
                          "plain_ms": 0.0, "bound_ms": 0.0, "plan_host_ms": 0.0})
        d["launches"] += r["per_forward"]
        d["plan_host_ms"] += r.get("plan_host_us", 0.0) * r["per_forward"] / 1e3
        for key, field in (("ms", "kernel_ms"), ("library_ms", "library_ms"),
                           ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms")):
            d[key] += r[field] * r["per_forward"]
    for kernels in out.values():
        for d in kernels.values():
            d["library_ratio"] = d["ms"] / d["library_ms"]
            d["bound_share"] = d["bound_ms"] / d["ms"]
    return out


# timed calls of each SlowFast-R50 GEMM kernel row (and its plain and
# library versions): 20 before the library-mesh phase, 10 before the
# hang-watch phase, 5 before the transport-and-tracing phases, 3 before the
# streaming phase
GEMM_REPS = 2
# timed calls of each flash kernel row and strided MViT pool (5 before the
# hang-watch phase, 3 before the transport-and-tracing phases)
ATTN_REPS = 2


def kernel_phase(torch, sites, model: str = "slowfast_r50", reps: int = GEMM_REPS):
    """Hold each kernel against its plain version at every site shape of
    `model` and time kernel, plain and library versions there: the forward
    launch, and the backward's dx launch (the same kernel against the
    transposed, for a conv tap-flipped, weights on a bf16 dz)."""
    import torch.nn.functional as F

    from pytorchvideo_accelerate_tpu_torch.ops import fused

    rng = np.random.default_rng(SEED + 1)
    uniq = {}
    for name, key in sites.items():
        uniq.setdefault(key, []).append(name)
    rows = []
    for (x_shape, w_shape, act), names in uniq.items():
        kt, kh, kw, cin, cout = w_shape
        b, t, h, w, _ = x_shape
        pw = (kt, kh, kw) == (1, 1, 1)
        kname = "fused_pw_bn_act" if pw else "fused_conv_bn_act"
        x = torch.from_numpy(rng.standard_normal(x_shape, np.float32)).cuda().bfloat16()
        wf = torch.from_numpy(
            rng.standard_normal(w_shape, np.float32)
            * np.sqrt(2.0 / (kt * kh * kw * cin))).cuda().bfloat16()
        bias = torch.from_numpy(rng.standard_normal(cout, np.float32) * 0.1).cuda()
        dz = torch.from_numpy(rng.standard_normal(
            (b, t, h, w, cout), np.float32)).cuda().bfloat16()
        zeros = torch.zeros(cin, device="cuda")
        bias16 = bias.bfloat16()
        pads = (kt // 2, kh // 2, kw // 2)
        if pw:
            x2d, w2d = x.reshape(-1, cin), wf.reshape(cin, cout)
            dz2d, wt = dz.reshape(-1, cout), wf.reshape(cin, cout).t().contiguous()
            plans = (lambda: fused._gemm_config(None, *x2d.shape, cout,
                                                x2d.contiguous(), w2d.contiguous()),
                     lambda: fused._gemm_config(None, *dz2d.shape, cin,
                                                dz2d.contiguous(), wt.contiguous()))
            fwd = (lambda: fused._pw_cuda(x2d, w2d, bias, act),
                   lambda: fused.pw_bn_act_plain(x2d, w2d, bias, act),
                   lambda: act_(torch.addmm(bias16, x2d, w2d), act))
            bwd = (lambda: fused._pw_cuda(dz2d, wt, zeros, "identity",
                                          "fused_pw_bn_act.bwd_dx"),
                   lambda: fused.pw_bn_act_plain(dz2d, wt, zeros, "identity"),
                   lambda: dz2d @ wt)
        else:
            xc, dzc = x.permute(0, 4, 1, 2, 3), dz.permute(0, 4, 1, 2, 3)
            wc = wf.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            wt = wf.flip(0, 1, 2).transpose(3, 4).contiguous()
            m, taps = b * t * h * w, kt * kh * kw
            plans = (lambda: fused._gemm_config(None, m, taps * cin, cout,
                                                x.contiguous(), wf.contiguous()),
                     lambda: fused._gemm_config(None, m, taps * cout, cin,
                                                dz.contiguous(), wt.contiguous()))
            fwd = (lambda: fused._conv_cuda(x, wf, bias, act),
                   lambda: fused.conv_bn_act_plain(x, wf, bias, act),
                   lambda: act_(F.conv3d(xc, wc, bias16, padding=pads), act))
            bwd = (lambda: fused._conv_cuda(dz, wt, zeros, "identity",
                                            "fused_conv_bn_act.bwd_dx"),
                   lambda: fused.conv_bn_act_plain(dz, wt, zeros, "identity"),
                   lambda: torch.nn.grad.conv3d_input(
                       (b, cin, t, h, w), wc, dzc, padding=pads))
        facts = [{**gemm_facts(kname, plan()), "plan_host_us": host_us(plan)}
                 for plan in plans]
        rows.append(_kernel_row(torch, kname, model, names, x_shape, w_shape,
                                act, *fwd, site_bound(x_shape, w_shape), reps,
                                facts[0]))
        # dx: the same stencil with Cin and Cout swapped
        rows.append(_kernel_row(torch, kname + ".bwd_dx", model, names,
                                x_shape, w_shape, "identity", *bwd,
                                site_bound((b, t, h, w, cout),
                                           (kt, kh, kw, cout, cin)), reps,
                                facts[1]))
    if model == "slowfast_r50":
        for label_site in NAMED_SITES:
            check(label_site in sites, f"named site {label_site} not on the path")
    return rows


def dw_facts(x_shape, k_shape) -> dict:
    """The depthwise configuration and T chunk `dw_plan` picks for a site on
    this card, and the build facts of the kernel it runs there."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    b, t, h, w, c = x_shape
    taps = tuple(k_shape[:3])
    config, tchunk = fused.dw_plan(b, t, h, w, c, *taps, fused._sm_count(0))
    return {"config": config, "tile": fused.dw_tile(config)[0],
            "path": fused.dw_path(config), "tchunk": tchunk,
            "blocks": fused.dw_grid(b, t, h, w, c, config, tchunk),
            "attrs": fused.dw_attrs(config, taps)}


# taps each depthwise instantiation is reported at: the two fixed ones and
# the generic one (any other odd taps)
DW_BUILD_TAPS = ((3, 3, 3), (5, 1, 1), (3, 5, 5))


def dw_build_facts() -> dict:
    """ptxas's registers and spills and the runtime's attributes of the
    depthwise kernel that each configuration runs for each of
    `DW_BUILD_TAPS`, ptxas's line found by the template arguments in the
    mangled name (`dw_kernelILi<config>ELi<kt>ELi<kh>ELi<kw>EE`, the taps
    `dw_attrs` says it is compiled for, 0 for the generic ones). Each must
    have its ptxas report, spill nothing, fit a block's 227 KB of shared
    memory and, with fixed-size taps, hold the blocks per SM its plan counts
    on."""
    from pytorchvideo_accelerate_tpu_torch.ops import _build, fused

    report = ptxas_report(_build.build_logs.get("depthwise3d", ""))
    out = {}
    for config in range(fused.DW_CONFIGS):
        for taps in DW_BUILD_TAPS:
            attrs = fused.dw_attrs(config, taps)
            compiled = attrs["compiled_taps"]
            tag = "dw_kernelILi{}ELi{}ELi{}ELi{}EE".format(config, *compiled)
            ptx = [v for k, v in report.items() if tag in k]
            check(len(ptx) == 1, f"depthwise config {config} taps {compiled}: "
                  f"{len(ptx)} ptxas reports")
            facts = {"ptxas": ptx[0], "tile": fused.dw_tile(config)[0],
                     "path": fused.dw_path(config), "taps": taps, "attrs": attrs}
            check(ptx[0].get("spill_stores", 0) + attrs["local_bytes"] == 0
                  and 0 < attrs["smem_bytes"] <= 227 * 1024
                  and attrs["blocks_per_sm"] >= (fused.dw_tile(config)[4]
                                                 if taps != (3, 5, 5) else 1),
                  f"depthwise config {config} taps {taps}: {facts}")
            out["{}/{}{}{}".format(config, *taps)] = facts
    return out


def dw_rows(torch, model: str, x_shape, k_shape, fused_keys, names, rng,
            reps: int = DW_REPS):
    """The depthwise kernel's rows at one site shape: `fused_dw_bn_act` for
    each act of `fused_keys` ({act: site names}; none for MViT-B's pools) and
    its dx, `depthwise3d_s1` and its dx, each held against its plain version,
    two launches bitwise equal, timed beside its library call (one bf16
    cuDNN `F.conv3d(groups=C)`, + bias + act for `fused_dw_bn_act`;
    `conv3d_input(groups=C)` for dx), with the plan's configuration, GB/s of
    the bound bytes and the bound's share of the kernel's time."""
    import torch.nn.functional as F

    from pytorchvideo_accelerate_tpu_torch.ops import depthwise, fused

    b, t, h, w, c = x_shape
    kt, kh, kw = k_shape[:3]
    x = torch.from_numpy(rng.standard_normal(x_shape, np.float32)).cuda().bfloat16()
    k = torch.from_numpy(rng.standard_normal(k_shape, np.float32)
                         / np.sqrt(kt * kh * kw)).cuda().bfloat16()
    bias = torch.from_numpy(rng.standard_normal(c, np.float32) * 0.1).cuda()
    dz = torch.from_numpy(rng.standard_normal(x_shape, np.float32)).cuda().bfloat16()
    kflip, zeros, bias16 = k.flip(0, 1, 2).contiguous(), torch.zeros(c, device="cuda"), bias.bfloat16()
    xc, dzc = x.permute(0, 4, 1, 2, 3), dz.permute(0, 4, 1, 2, 3)
    kc = k.permute(4, 3, 0, 1, 2).contiguous()
    pads = (kt // 2, kh // 2, kw // 2)
    facts = dw_facts(x_shape, k_shape)

    def dx_library():
        return torch.nn.grad.conv3d_input((b, c, t, h, w), kc, dzc,
                                          padding=pads, groups=c)

    def row(kname, sites, act, kern, plain, library, has_bias):
        return _kernel_row(torch, kname, model, sites, x_shape, k_shape, act, kern, plain,
                           library, dw_site_bound(x_shape, k_shape, has_bias), reps, facts)

    rows = []
    for act, sites in fused_keys.items():
        rows.append(row(
            "fused_dw_bn_act", sites, act,
            lambda: fused._dw_cuda(x, k, bias, act, "fused_dw_bn_act"),
            lambda: fused.dw_bn_act_plain(x, k, bias, act),
            lambda: act_(F.conv3d(xc, kc, bias16, padding=pads, groups=c), act), True))
    if fused_keys:
        rows.append(row(
            "fused_dw_bn_act.bwd_dx", names, "identity",
            lambda: fused._dw_cuda(dz, kflip, zeros, "identity", "fused_dw_bn_act.bwd_dx"),
            lambda: fused.dw_bn_act_plain(dz, kflip, zeros, "identity"),
            dx_library, True))
    rows.append(row(
        "depthwise3d_s1", names, "identity",
        lambda: fused._dw_cuda(x, k, None, "identity", "depthwise3d_s1"),
        lambda: depthwise.depthwise_conv3d_shift(x, k),
        lambda: F.conv3d(xc, kc, None, padding=pads, groups=c), False))
    rows.append(row(
        "depthwise3d_s1.bwd_dx", names, "identity",
        lambda: fused._dw_cuda(dz, kflip, None, "identity", "depthwise3d_s1.bwd_dx"),
        lambda: depthwise.depthwise_conv3d_shift(dz, kflip),
        dx_library, False))
    del x, k, dz, kflip, xc, dzc, kc
    free_cuda(torch)
    return rows


def dw_kernel_phase(torch, model: str, sites, reps: int = DW_REPS):
    """The depthwise kernel at every distinct depthwise site shape of
    `model`'s forward (`record_dw_sites`), through both entry points,
    forward and the backward's dx (the stencil against the tap-flipped taps
    on a bf16 dz): `dw_rows`."""
    rng = np.random.default_rng(SEED + 5)
    fused_keys, s1_keys = {}, {}
    for i, (x_shape, k_shape, act) in enumerate(sites):
        name = f"{model} dw site {i}"
        fused_keys.setdefault((x_shape, k_shape), {}).setdefault(act, []).append(name)
        s1_keys.setdefault((x_shape, k_shape), []).append(name)
    rows = []
    for (x_shape, k_shape), names in s1_keys.items():
        rows += dw_rows(torch, model, x_shape, k_shape, fused_keys[(x_shape, k_shape)],
                        names, rng, reps)
    return rows


def dw_pool_phase(torch, pool_sites, reps: int = DW_REPS):
    """Row 4 and its dx at MViT-B's stride-1 pools (`record_pool_sites`),
    (3,3,3) taps over (B, T, H, W, C) token grids: `dw_rows` without the
    fused entry point."""
    rng = np.random.default_rng(SEED + 6)
    keys = {}
    for i, (shape, stride) in enumerate(pool_sites):
        if stride == (1, 1, 1):
            b, c, t, h, w = shape
            keys.setdefault((b, t, h, w, c), []).append(f"mvit_b pool {i}")
    check(sum(len(v) for v in keys.values()) == expected_mvit_launches()["depthwise3d_s1"],
          f"MViT-B stride-1 pools {keys}")
    rows = []
    for x_shape, names in keys.items():
        rows += dw_rows(torch, "mvit_b", x_shape, (3, 3, 3, 1, x_shape[-1]), {}, names,
                        rng, reps)
    return rows


def dw_dk_ms(torch, sites, reps: int = DW_REPS) -> dict:
    """Device time of the plain tap gradient (`depthwise_tap_grads_f32` on
    bf16 x and f32 dz, as `DwBnAct.backward` runs it) summed over the
    depthwise sites of one micro-step (`sites` of `record_dw_sites`)."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    rng = np.random.default_rng(SEED + 7)
    total, per_shape = 0.0, {}
    for x_shape, k_shape, _ in sites:
        key = (x_shape, tuple(k_shape[:3]))
        if key not in per_shape:
            x = torch.from_numpy(rng.standard_normal(x_shape, np.float32)).cuda().bfloat16()
            dz32 = torch.from_numpy(rng.standard_normal(x_shape, np.float32)).cuda()
            per_shape[key] = device_ms(
                torch, lambda: fused.depthwise_tap_grads_f32(x, dz32, key[1]), reps)
            del x, dz32
            free_cuda(torch)
        total += per_shape[key]
    return {"dk_plain_ms": total, "sites": len(sites),
            "per_shape_ms": {f"{list(k[0])} {list(k[1])}": v for k, v in per_shape.items()}}


KERNEL_CLASSES = (  # (class, substrings of the device kernel's name)
    ("fused_pw_bn_act", ("fused_pw_bn_act",)),
    ("fused_conv_bn_act", ("fused_conv_bn_act",)),
    ("depthwise3d", ("depthwise3d", "dw_kernel")),
    ("flash_attention", ("flash_",)),
    ("memcpy", ("memcpy", "Memcpy")),
    # cuDNN's convolutions first: their names hold "gemm" too
    ("cudnn_conv", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "Gemm")),
    ("pool", ("pool",)),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def profile_forward(torch, engine, batch, reps: int = PROFILE_REPS) -> dict:
    """Device time by kernel class over `reps` forwards of `batch`
    (torch.profiler), and the device's busy share between the first kernel
    start and the last kernel end."""
    return profile_of(torch, lambda: engine.predict(batch), reps, "forward")


def profile_of(torch, fn, reps: int, unit: str) -> dict:
    """Device time by kernel class over `reps` calls of `fn`, per call, and
    the device's busy share of the span the calls' device work covers."""
    try:
        kev = device_events(torch, fn, reps)
    except IncompleteProfile as e:
        INCOMPLETE_PROFILES[0] += 1
        return {"complete": False, "reason": str(e)}
    span_us = max(e.end for e in kev) - min(e.start for e in kev)
    busy_us = sum(e.us for e in kev)
    classes: dict = {}
    names: dict = {}
    for e in kev:
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in e.name for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + e.us
        names[e.name] = names.get(e.name, 0.0) + e.us
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return {
        "complete": True, "device_events": len(kev), "reps": reps,
        f"device_ms_per_{unit}": busy_us / reps / 1e3,
        f"span_ms_per_{unit}": span_us / reps / 1e3,
        "device_busy_share": busy_us / span_us,
        f"ms_per_{unit}_by_class": {k: v / reps / 1e3 for k, v in
                                    sorted(classes.items(), key=lambda kv: -kv[1])},
        f"top_kernels_ms_per_{unit}": [[n[:90], v / reps / 1e3] for n, v in top],
        f"launches_per_{unit}_by_class": {
            k: sum(1 for e in kev if next(
                (c for c, keys in KERNEL_CLASSES if any(q in e.name for q in keys)),
                "other") == k) / reps for k in classes},
    }


def forward_ms(torch, engine, batch, reps: int = 3):
    """Host-clock ms of synchronised `engine.predict(batch)` calls, after one
    warm-up call (5 calls before the transport-and-tracing phases)."""
    engine.predict(batch)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.predict(batch)
        times.append((time.perf_counter() - t) * 1e3)
    return times


def train_argv(out: str, fused: str = "auto", spec: dict = SLOWFAST_TRAIN,
               impl: str = "conv"):
    """`run.main`'s argv for `spec` on synthetic clips at the model's
    geometry (SlowFast-R50: the reference recipe, 32 frames at 256^2, batch
    8 x accumulation 4, 2 epochs of 64 videos), bf16, SGD at `spec`'s lr,
    with `spec`'s extra flags last. A spec with a `cache_dir` reads its
    clips from that frame cache at its `sampling_rate`, and its head
    classes from the cache's index (no `--model.num_classes`)."""
    frames, crop = GEOMETRY[spec["name"]]
    if "cache_dir" in spec:
        data = ["--data.cache_dir", spec["cache_dir"],
                "--sampling_rate", str(spec["sampling_rate"])]
    else:
        data = ["--synthetic", "--data.synthetic_num_videos", str(spec["videos"]),
                "--model.num_classes", str(NUM_CLASSES)]
    return ["--lr", str(spec.get("lr", BASE_LR)),
            "--model.name", spec["name"], *data, "--num_frames", str(frames),
            "--data.crop_size", str(crop), "--batch_size", str(spec["batch"]),
            "--gradient_accumulation_steps", str(spec["accum"]),
            "--num_epochs", str(spec["epochs"]),
            "--checkpointing_steps", str(spec["ckpt_every"]),
            "--mixed_precision", "bf16", "--model.fused_kernels", fused,
            "--model.depthwise_impl", impl, "--output_dir", out,
            "--log_every", "1"] + spec.get("argv", [])


def expected_train_launches(spec: dict, per_forward: dict) -> dict:
    """Launch totals of one fit() of `train_argv(spec)`, from the code: the
    loader drops the last partial batch, so an epoch is videos // (B *
    accum) optimizer steps of `accum` micro-steps; the val source holds
    `val_videos` (synthetic: max(videos // 4, 4)) clips in ceil(n / B) eval
    forwards per epoch. Each
    micro-step launches every fused site's kernel once forward and once for
    dx (every site's input needs a gradient: it depends on the stem's
    weights); an eval forward launches each once."""
    steps = spec["videos"] // (spec["batch"] * spec["accum"]) * spec["epochs"]
    micro = steps * spec["accum"]
    val = spec.get("val_videos", max(spec["videos"] // 4, 4))
    evals = -(-val // spec["batch"]) * spec["epochs"]
    out = {"steps": steps, "micro_steps": micro, "eval_forwards": evals}
    for k in SOURCES:
        n = per_forward.get(k.split(".")[0], 0)
        out[k] = n * micro if is_backward(k) else n * (micro + evals)
    return out


def is_backward(kname: str) -> bool:
    """A backward launch key ("<kernel>.bwd_dx", ".bwd_dq", ".bwd_dkv")."""
    return "." in kname


def cpu_state(state) -> dict:
    """The leaves of a TrainState that a step writes (model parameters and
    BN running averages, the optimizer's per-parameter state, the EMA) and
    its step, copied to the host, in `TrainState.state_dict()`'s layout."""
    return state_leaves(state.state_dict())


def state_leaves(sd: dict) -> dict:
    """`TrainState.state_dict()` (or its file) without the optimizer's
    param_groups (the LR the schedule sets), tensors on the host."""
    def host(v):
        if hasattr(v, "detach"):
            return v.detach().cpu().clone()
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v
    return {"step": sd["step"], "model": host(sd["model"]),
            "optimizer_state": host(sd["optimizer"]["state"]),
            "ema": host(sd["ema"])}


def unequal_leaves(torch, a, b, path: str = "") -> list:
    """Paths at which two nested dicts of tensors differ (bitwise)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a, b))
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(map(str, a)) != sorted(map(str, b)):
            return [f"{path} keys"]
        return [p for k in a for p in unequal_leaves(torch, a[k], b[k], f"{path}/{k}")]
    return [] if a == b else [path]


def train_clips(rng, spec: dict, n: int) -> dict:
    """n seeded float32 normal clips at the model's training geometry."""
    frames, crop = GEOMETRY[spec["name"]]
    if spec["name"].startswith("slowfast"):
        return {"slow": rng.standard_normal((n, frames // ALPHA, crop, crop, 3), np.float32),
                "fast": rng.standard_normal((n, frames, crop, crop, 3), np.float32)}
    return {"video": rng.standard_normal((n, frames, crop, crop, 3), np.float32)}


def train_phase(torch, work: str, spec: dict = SLOWFAST_TRAIN) -> dict:
    """Train `spec`'s model at full width through `run.main`: the launch
    counters zeroed just before fit(), read just after; lr per step against
    the closed-form cosine; the checkpoint of step `ckpt_every` restored
    bitwise; for a classifier, the final checkpoint exported and served by
    the InferenceEngine, its logits held against the trainer's eval-mode
    forward (a pretraining run has no head to serve)."""
    import math

    from pytorchvideo_accelerate_tpu_torch import run as trun
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine
    from pytorchvideo_accelerate_tpu_torch.trainer import loop
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import model_inputs

    ckpt_every = spec["ckpt_every"]
    out = os.path.join(work, f"train_{spec['name']}")
    argv = train_argv(out, spec=spec)
    seen = {"metrics": [], "snap": None}
    pretrain = spec.get("pretrain", False)
    step_name = "make_pretrain_step" if pretrain else "make_train_step"
    make_step = getattr(loop, step_name)

    def recording(model, optimizer, **kw):
        step = make_step(model, optimizer, **kw)

        def wrapped(state, batch):
            seen.setdefault("batch", {k: (tuple(v.shape), v.dtype)
                                      for k, v in batch.items() if torch.is_tensor(v)})
            m = step(state, batch)
            seen["metrics"].append(m)
            if state.step == ckpt_every:
                seen["snap"] = cpu_state(state)
            return m
        return wrapped

    per_forward = expected_forward_launches(spec["name"])
    want = expected_train_launches(spec, per_forward)
    setattr(loop, step_name, recording)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = trun.main(argv)
    finally:
        setattr(loop, step_name, make_step)
    fit_s = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    losses = [m["loss"].item() for m in seen["metrics"]]
    lrs = [m["lr"] for m in seen["metrics"]]
    check(result["steps"] == want["steps"] == len(losses),
          f"steps {result['steps']} / {len(losses)}, expected {want['steps']}")
    check(all(math.isfinite(v) for v in losses + [result["train_loss"]]),
          f"non-finite loss {losses} {result['train_loss']}")
    lr0 = spec.get("lr", BASE_LR)
    cosine = [lr0 * 0.5 * (1 + math.cos(math.pi * k / want["steps"]))
              for k in range(want["steps"])]
    check(all(abs(a - b) <= 1e-12 for a, b in zip(lrs, cosine)),
          f"lr per step {lrs}, schedule {cosine}")
    check(all(launches[k] == want[k] for k in SOURCES),
          f"launches {launches}, expected {want}")

    # the checkpoint of step `ckpt_every` restores bitwise
    tr = loop.Trainer(parse_cli(argv + ["--resume_from_checkpoint", "auto"]))
    extra, step = tr.checkpointer.restore(tr.state, step=ckpt_every)
    got, snap = cpu_state(tr.state), seen["snap"]
    check(step == got["step"] == snap["step"] == ckpt_every, f"restored step {step}")
    bad = unequal_leaves(torch, got, snap)
    check(not bad, f"restore not bitwise at {bad[:4]}")
    check(extra["data_state"] == {"epoch": 0, "position": ckpt_every},
          f"restored LoaderState {extra['data_state']}")
    mfu = mfu_facts(torch, result, tr, seen["batch"], pretrain) \
        if spec is SLOWFAST_TRAIN else {}
    out_fields = {
        "fit_s": fit_s, "result": result, "losses": losses, "lr": lrs, "mfu": mfu,
        "launches": launches, "expected_launches": want,
        "launches_per_micro_step": {
            k: (launches[k] - (0 if is_backward(k) else
                               want["eval_forwards"] * per_forward.get(k, 0)))
            / want["micro_steps"] for k in SOURCES},
        "restored_step": step, "restored_loader_state": extra["data_state"],
        "restore_bitwise": True}
    if pretrain:
        tr.close()
        del tr
        free_cuda(torch)
        return out_fields

    # export the final checkpoint; the engine serves it
    art = os.path.join(work, f"trained_{spec['name']}_artifact")
    trun.main(argv + ["--resume_from_checkpoint", "auto", "--export_inference", art])
    tr._maybe_resume()
    clips = train_clips(np.random.default_rng(SEED + 2), spec, spec["batch"])
    tr.model.eval()
    with torch.no_grad():
        plain = tr.model(model_inputs({k: torch.from_numpy(v).cuda()
                                       for k, v in clips.items()})
                         ).float().cpu().numpy()
    tr.close()
    del tr
    engine = InferenceEngine.from_artifact(art)
    served = engine.predict(clips)
    del engine
    err = np.abs(served - plain)
    check(bool(np.isfinite(served).all()) and bool(
        (err <= LOGIT_TOL * (1 + np.abs(plain))).all()),
        f"served trained logits differ from the trainer's: max {err.max()}")
    free_cuda(torch)
    return {**out_fields, "served_logit_max_abs_err": float(err.max()),
            "served_logit_std": float(plain.std())}


def mfu_facts(torch, result: dict, tr, batch_shapes: dict, pretrain: bool) -> dict:
    """The Trainer's MFU keys on the card: `tflops_per_sec_per_chip` and
    `mfu` present, 0 < mfu < 1.05, the peak from the data sheet on an H100
    (`utils/hw.py`); `flops_per_step` equal to the count the same config
    gives from CPU tensors of the step's batch shapes (counted again, not
    read from the cache)."""
    from pytorchvideo_accelerate_tpu_torch.utils import hw

    kind = torch.cuda.get_device_name(0)
    tflops, mfu = result.get("tflops_per_sec_per_chip"), result.get("mfu")
    check(tflops is not None and mfu is not None and 0 < mfu < 1.05,
          f"train: tflops_per_sec_per_chip {tflops}, mfu {mfu}")
    check(result.get("mfu_source") == "flop_counter"
          and (result.get("mfu_peak_source") == "datasheet" or "H100" not in kind),
          f"train: mfu_source {result.get('mfu_source')}, peak "
          f"{result.get('mfu_peak_source')} on {kind}")
    hw._STEP_FLOPS.clear()
    cpu = {k: torch.empty(shape, dtype=dt) for k, (shape, dt) in batch_shapes.items()}
    again = hw.count_step_flops(tr.cfg, cpu, pretraining=pretrain,
                                device_normalize=tr._device_normalize, shards=1)
    check(again == result["flops_per_step"],
          f"train: flops_per_step {result['flops_per_step']} on the card, {again} "
          "from the same config on the CPU")
    return {"flops_per_step": result["flops_per_step"], "flops_per_step_cpu": again,
            "tflops_per_sec_per_chip": tflops, "mfu": mfu,
            "peak_tflops": hw.resolve_peak(tr.device)[0],
            "mfu_peak_source": result["mfu_peak_source"],
            "steps_per_sec": result.get("steps_per_sec")}


def depthwise_impl_train_phase(torch, work: str) -> dict:
    """One optimizer step of X3D-M through `run.main` under `fused_kernels
    off, depthwise_impl pallas`: the counters, zeroed just before fit(),
    must show one `depthwise3d_s1` forward and one dx launch per stride-1
    depthwise site per micro-step plus one forward per eval forward."""
    from pytorchvideo_accelerate_tpu_torch import run as trun
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    spec = dict(X3D_TRAIN, videos=X3D_TRAIN["batch"], ckpt_every=0)
    want = expected_train_launches(spec, expected_depthwise_impl_launches())
    argv = train_argv(os.path.join(work, "train_x3d_m_pallas"), "off", spec, "pallas")
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    result = trun.main(argv)
    fit_s = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    check(result["steps"] == want["steps"] == 1, f"steps {result['steps']}")
    check(all(launches[k] == want[k] for k in SOURCES),
          f"depthwise_impl pallas launches {launches}, expected {want}")
    free_cuda(torch)
    return {"fit_s": fit_s, "train_loss": result["train_loss"],
            "launches": launches, "expected_launches": want}


def free_cuda(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def micro_step_fn(torch, fused_mode: str, batch, spec: dict = SLOWFAST_TRAIN,
                  impl: str = "conv", seed: int = 0, mix=None):
    """(model, forward, fn) for a fresh seeded `spec` model in bf16 through
    `fused_mode` (and `depthwise_impl` `impl`) on `batch`: forward() returns
    the training loss, fn() runs one training micro-step (forward +
    backward). `mix` (a `steps.MixDraw`): the batch mixed with its flipped
    self by that draw and the loss of both labels, as the train step's
    mixup/cutmix computes them."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
        _loss_and_metrics,
        mix_batch,
        mix_weight,
        mixed_loss,
        model_inputs,
    )

    cfg = parse_cli(train_argv("unused", fused_mode, spec, impl)
                    + ["--model.dropout_rate", "0",
                       "--model.num_classes", str(classes(spec["name"]))])
    model = create_model(cfg.model, "bf16", seed=seed,
                         data_cfg=cfg.data).cuda().train()
    labels, lam = batch["label"], None
    if mix is not None:
        some = batch["fast" if "fast" in batch else "video"]
        w_hw = mix_weight(mix, some.shape[-3], some.shape[-2], "cuda")
        lam = w_hw.mean()
        batch = mix_batch(batch, w_hw)
    inputs = model_inputs(batch)
    ones = torch.ones(labels.shape[0], device="cuda")

    def forward():
        logits = model(inputs)
        if lam is None:
            return _loss_and_metrics(logits, labels, ones, 0.0)[0]
        return mixed_loss(logits, labels, lam, ones, 0.0)[0]

    def fn():
        model.zero_grad(set_to_none=True)
        loss = forward()
        loss.backward()
        return loss
    return model, forward, fn


def train_batch(torch, seed: int, spec: dict = SLOWFAST_TRAIN) -> dict:
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in train_clips(rng, spec, spec["batch"]).items()}
    batch["label"] = torch.from_numpy(
        rng.integers(0, classes(spec["name"]), spec["batch"])).cuda()
    return batch


def site_functions():
    """{autograd Function of a kernel site: its plain version}."""
    from pytorchvideo_accelerate_tpu_torch.ops import depthwise, flash_attention, fused

    return {fused.PwBnAct: fused.pw_bn_act_plain,
            fused.ConvBnAct: fused.conv_bn_act_plain,
            fused.DwBnAct: fused.dw_bn_act_plain,
            depthwise.Depthwise3dS1: depthwise.depthwise_conv3d_shift,
            flash_attention.FlashAttention: flash_attention.flash_fwd_plain}


def with_site_backward(make, fn):
    """`fn()` with the custom backward of each kernel site's Function
    (`PwBnAct`, `ConvBnAct`, `DwBnAct`, `Depthwise3dS1`) replaced by
    `make(Function, its backward)`."""
    saved = {cls: cls.__dict__["backward"] for cls in site_functions()}
    for cls, backward in saved.items():
        cls.backward = staticmethod(make(cls, backward.__func__))
    try:
        return fn()
    finally:
        for cls, backward in saved.items():
            cls.backward = backward


def plain_site_backward(torch, cls, _):
    """A backward for a kernel site's Function that differentiates the
    site's plain version with torch autograd at the operands its forward
    saved: the reference that the custom backward (dx through the kernel)
    is held to."""
    plain = site_functions()[cls]
    if getattr(cls, "__name__", "") == "FlashAttention":
        def flash_backward(ctx, g):
            # saved (q, k, v, out, lse): differentiate the plain forward
            # at q, k, v
            ops = [t.detach().requires_grad_() for t in ctx.saved_tensors[:3]]
            with torch.enable_grad():
                y = plain(*ops, ctx.scale)[0]
            return (*torch.autograd.grad(y, ops, g), None)
        return flash_backward

    def backward(ctx, g):
        ops = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = plain(*ops, ctx.act) if hasattr(ctx, "act") else plain(*ops)
        got = iter(torch.autograd.grad(y, [t for t in ops if t.requires_grad], g))
        return (*(next(got) if t.requires_grad else None for t in ops),
                *([None] * (len(ctx.needs_input_grad) - len(ops))))
    return backward


def sgd_updates(torch, model, grad_sets):
    """The parameter change of one trainer SGD step from `model`'s current
    parameters for each list of gradients in `grad_sets`."""
    from pytorchvideo_accelerate_tpu_torch.config import OptimConfig
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer

    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    updates = []
    for grads in grad_sets:
        for p, g in zip(params, grads):
            p.grad = g
        build_optimizer(OptimConfig(), 4, model.named_parameters()).step(0)
        with torch.no_grad():
            updates.append(torch.cat([(p - b).flatten() for p, b in zip(params, before)]))
            for p, b in zip(params, before):
                p.copy_(b)
    return updates


def rel_err(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def fixed_forward_parity(torch, fused_mode: str, batch, spec: dict,
                         impl: str = "conv", mix=None):
    """One micro-step graph through `fused_mode`/`impl` (under the fixed
    `mix`, if any) differentiated twice: once through the custom backward
    (dx launches the kernels), once with each site's backward swapped for
    torch autograd of its plain version. Returns the relative differences
    of the whole gradient and of one SGD update."""
    model, forward, _ = micro_step_fn(torch, fused_mode, batch, spec, impl,
                                      mix=mix)
    loss = forward()
    loss.backward(retain_graph=True)
    params = list(model.parameters())
    g_kernel = [p.grad for p in params]
    model.zero_grad(set_to_none=True)
    with_site_backward(lambda cls, inner: plain_site_backward(torch, cls, inner),
                       loss.backward)
    g_plain = [p.grad for p in params]
    del loss
    uk, up = sgd_updates(torch, model, [g_kernel, g_plain])
    grad = rel_err(torch.cat([g.float().flatten() for g in g_kernel]),
                   torch.cat([g.float().flatten() for g in g_plain]))
    update = rel_err(uk, up)
    del model, forward, g_kernel, g_plain, params, uk, up
    free_cuda(torch)
    return grad, update


def train_parity_phase(torch) -> dict:
    """One training micro-step through the kernels (`auto`) against plain
    PyTorch (TF32 off), on one fixed B=8 batch and the same seeded weights.

    (a) End to end, `auto` against `xla` (plain autograd): the loss, and the
    gradient of the head, which depends only on the forward, within the
    tolerance. The whole gradient of this net at init is chaotic in bf16:
    ReLU masks and max-pool winners flip where the lowerings round an
    activation differently, and each flip reroutes a gradient element; two
    plain lowerings (`off` against `xla`) differ as much. That whole-gradient
    difference is printed for both pairs, and held to nothing.
    (b) With the forward held fixed (`fixed_forward_parity`): the whole
    gradient and one SGD step's update must agree within the tolerance."""
    batch = train_batch(torch, SEED + 3)
    e2e = {}
    for mode in ("auto", "xla", "off"):
        model, _, fn = micro_step_fn(torch, mode, batch)
        loss = fn().item()
        e2e[mode] = (loss, torch.cat([p.grad.float().flatten() for p in model.parameters()]),
                     model.head.proj.weight.grad.float().clone())
        del model, fn
        free_cuda(torch)
    (lk, gk, hk), (lp, gp, hp), (_, go, ho) = e2e["auto"], e2e["xla"], e2e["off"]
    out = {"loss_kernels": lk, "loss_plain": lp, "loss_abs_err": abs(lk - lp),
           "loss_tolerance": LOGIT_TOL * (1 + abs(lp)),
           "head_grad_rel_err": rel_err(hk, hp),
           "head_grad_rel_err_off_vs_xla": rel_err(ho, hp),
           "grad_rel_err_end_to_end": rel_err(gk, gp),
           "grad_rel_err_end_to_end_off_vs_xla": rel_err(go, gp),
           "rel_tolerance": LOGIT_TOL}
    del e2e, gk, gp, go, hk, hp, ho
    check(out["loss_abs_err"] <= out["loss_tolerance"], f"train loss {out}")
    check(out["head_grad_rel_err"] <= LOGIT_TOL, f"head gradient {out}")
    (out["grad_rel_err_same_forward"],
     out["update_rel_err_same_forward"]) = fixed_forward_parity(
        torch, "auto", batch, SLOWFAST_TRAIN)
    check(out["grad_rel_err_same_forward"] <= LOGIT_TOL, f"gradients {out}")
    check(out["update_rel_err_same_forward"] <= LOGIT_TOL, f"SGD update {out}")
    return out


def x3d_train_parity_phase(torch) -> dict:
    """X3D-M, one B=8 micro-step, the same seeded weights for each lowering.
    End to end: the loss through the kernels (`auto`) against `xla`, and
    through `depthwise_impl pallas` against `shift`, within the tolerance;
    the head's gradient and the whole gradient are printed (chaotic under
    bf16 rounding at init, as for SlowFast-R50) and held to nothing. With
    the forward held fixed (`fixed_forward_parity`), through rows 1 and 3
    (`auto`) and through row 4 (`off` + `depthwise_impl pallas`): the whole
    gradient and one SGD update within the tolerance."""
    batch = train_batch(torch, SEED + 6, X3D_TRAIN)
    e2e = {}
    for mode, impl in (("auto", "conv"), ("xla", "conv"), ("off", "pallas"),
                       ("off", "shift")):
        model, _, fn = micro_step_fn(torch, mode, batch, X3D_TRAIN, impl)
        loss = fn().item()
        e2e[mode, impl] = (loss, torch.cat([p.grad.float().flatten()
                                            for p in model.parameters()]),
                           head_proj(model).weight.grad.float().clone())
        del model, fn
        free_cuda(torch)
    out = {"rel_tolerance": LOGIT_TOL}
    for label, a, b in (("auto_vs_xla", ("auto", "conv"), ("xla", "conv")),
                        ("pallas_vs_shift", ("off", "pallas"), ("off", "shift"))):
        (la, ga, ha), (lb, gb, hb) = e2e[a], e2e[b]
        out[f"loss_{label}"] = [la, lb]
        out[f"loss_abs_err_{label}"] = abs(la - lb)
        out[f"head_grad_rel_err_{label}"] = rel_err(ha, hb)
        out[f"grad_rel_err_end_to_end_{label}"] = rel_err(ga, gb)
        check(abs(la - lb) <= LOGIT_TOL * (1 + abs(lb)), f"X3D train loss {out}")
    del e2e
    free_cuda(torch)
    for label, mode, impl in (("rows_1_3", "auto", "conv"), ("row_4", "off", "pallas")):
        grad, update = fixed_forward_parity(torch, mode, batch, X3D_TRAIN, impl)
        out[f"grad_rel_err_same_forward_{label}"] = grad
        out[f"update_rel_err_same_forward_{label}"] = update
        check(grad <= LOGIT_TOL and update <= LOGIT_TOL, f"X3D gradients {out}")
    return out


def count_strided_grads(fn):
    """(not contiguous, all) of the gradients that reach the kernel sites'
    custom backward in one `fn()`: each strided one costs a hidden copy
    before its dx launch."""
    seen = [0, 0]

    def counting(cls, inner):
        def backward(ctx, g):
            seen[0] += not g.is_contiguous()
            seen[1] += 1
            return inner(ctx, g)
        return backward

    with_site_backward(counting, fn)
    return seen


def train_timing_phase(torch, spec: dict = SLOWFAST_TRAIN,
                       modes=(("auto", "conv"), ("off", "conv"), ("xla", "conv"))) -> dict:
    """ms per micro-step (forward + backward at B=8, host clock around
    synchronised steps) through each (fused_kernels, depthwise_impl) of
    `modes`: the kernels first, then unfused (cuDNN + BN passes) and the
    plain lowering; peak device memory of each; the profile of the kernels'
    micro-step, and how many gradients reach its kernel sites strided."""
    batch = train_batch(torch, SEED + 4, spec)
    out = {}
    for mode, impl in modes:
        key = mode if impl == "conv" else f"{mode}_{impl}"
        model, _, fn = micro_step_fn(torch, mode, batch, spec, impl)
        timed = micro_step_times(torch, fn)
        out[f"micro_step_ms_{key}"] = timed["micro_step_ms"]
        out[f"peak_mem_gb_{key}"] = timed["peak_mem_gb"]
        if mode == "auto":
            out["profile"] = profile_of(torch, fn, PROFILE_REPS, "micro_step")
            out["site_grads_not_contiguous"], out["site_grads"] = \
                count_strided_grads(fn)
        del model, fn
        free_cuda(torch)
    return out


def post(url: str, body: bytes, timeout: float = 300.0):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        payload = json.loads(r.read())
        return r.status, payload, (time.perf_counter() - t0) * 1e3


def hold_logits(got, want, what: str) -> dict:
    """`got` within LOGIT_TOL * (1 + |want|) of `want`, and the same top-1 on
    every row whose `want` margin is decisive (at least one must be)."""
    check(got.shape == want.shape and bool(np.isfinite(got).all()),
          f"{what}: logits shape {got.shape} or non-finite")
    err = np.abs(got - want)
    check(bool((err <= LOGIT_TOL * (1 + np.abs(want))).all()),
          f"{what}: logits differ: max {err.max()}")
    top2 = np.sort(want, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    decisive = margin > 2 * LOGIT_TOL * (1 + np.abs(top2[:, 1]))
    agree = got.argmax(1) == want.argmax(1)
    check(bool(decisive.any()), f"{what}: no row has a decisive top-1 margin")
    check(bool(agree[decisive].all()), f"{what}: top-1 differs on a decisive row")
    return {"logit_max_abs_err": float(err.max()), "logit_std": float(want.std()),
            "logit_tolerance": f"{LOGIT_TOL}*(1+|plain|)",
            "top1_agree": int(agree.sum()), "top1_decisive": int(decisive.sum()),
            "top1_planted": int((want.argmax(1) == np.arange(len(want))).sum()),
            "top1_margin": margin.tolist()}


# the micro scheduler's wait for a bucket to fill in the serve phases: the
# requests' JSON (~25 MB a SlowFast-R50 clip, ~8 MB at 16x224^2) parses in
# the server one at a time, ~1-3.5 s each, so a batch takes what has
# arrived by then (12 s, and 4 requests then 1, before the library-mesh
# phase; every forward is counted, whatever the batches)
SERVE_MAX_WAIT_MS = 2500
_BODIES = {}  # id(clips) -> the JSON bodies of those request clips


def request_bodies(clips) -> list:
    """The /predict JSON body of each clip (encoded once per clip list)."""
    if id(clips) not in _BODIES:
        _BODIES[id(clips)] = [json.dumps({k: v.tolist() for k, v in c.items()},
                                         separators=(",", ":")).encode() for c in clips]
    return _BODIES[id(clips)]


def serve_phase(torch, art: str, clips, plain_logits, name: str):
    """The port's HTTP server (`build_server`, micro scheduler) answers one
    /predict per clip, all sent at once; the launch counters,
    zeroed just before the server is built, must match
    `expected_forward_launches(name)` per forward (the warm-up forward of
    each bucket included); the logits must agree with the plain path.
    Returns (the closed server, its launches, the phase's fields)."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.serving.server import build_server

    bodies = request_bodies(clips)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    server = build_server(parse_cli([
        "--serve.checkpoint", art, "--serve.port", "0",
        "--serve.scheduler", "micro", "--serve.max_wait_ms", str(SERVE_MAX_WAIT_MS)]))
    server.start()
    try:
        build_s = time.perf_counter() - t0
        host, port = server.address
        url = f"http://{host}:{port}/predict"
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            responses = list(pool.map(lambda b: post(url, b), bodies))
        with urllib.request.urlopen(f"http://{host}:{port}/stats") as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(f"http://{host}:{port}/healthz") as r:
            health = json.loads(r.read())
    finally:
        server.close()
    launches = dict(fused.LAUNCHES)
    check(all(code == 200 for code, _, _ in responses),
          f"HTTP codes {[code for code, _, _ in responses]}")
    forwards = len(server.engine.buckets) + int(stats["batches"])
    check_launches(launches, expected_forward_launches(name), forwards, name)
    served = np.stack([np.asarray(p["logits"], np.float32)
                       for _, p, _ in responses])
    check(served.shape == (len(clips), classes(name)),
          f"served logits shape {served.shape}")
    fields = dict(
        model=name, requests=len(responses), http=[c for c, _, _ in responses],
        server_build_s=build_s, buckets=list(server.engine.buckets),
        forwards=forwards, launches=launches,
        launches_per_forward={k: v / forwards for k, v in launches.items()},
        request_ms_client=[ms for _, _, ms in responses],
        request_ms_server=[p["latency_ms"] for _, p, _ in responses],
        **hold_logits(served, plain_logits, name),
        stats=stats, health=health)
    return server, launches, fields


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from pytorchvideo_accelerate_tpu_torch.ops import _build

    # the plain versions are the references: full f32, no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    seconds = _build.build()
    regs = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
            for k, v in _build.build_logs.items()}
    emit("build", seconds=seconds, total_s=time.perf_counter() - t0,
         ptxas=regs)
    emit("gemm_build", **gemm_build_facts())
    emit("dw_build", **dw_build_facts())

    with tempfile.TemporaryDirectory(prefix="pva_chip_smoke_") as work:
        return run(torch, work, smi, kind)


def run(torch, work: str, smi: str, kind: str) -> int:
    t_start = time.perf_counter()
    launches = {}  # main-path phase -> its launch counts

    # 3. weights + artifact
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    art, state, clips, norm, n_params = make_artifact(torch, work, "slowfast_r50", rng)
    emit("weights", artifact=art, params=n_params, seconds=time.perf_counter() - t0)
    batch = bucket_batch(clips, BUCKET)

    # the plain path: the same weights through fused_kernels xla
    plain_engine = make_engine(torch, "slowfast_r50", state, norm, "xla")
    sites = record_sites(torch, plain_engine.model,
                         lambda: plain_engine.predict(batch))
    n_pw = sum(1 for s in sites.values() if s[1][:3] == (1, 1, 1))
    check(n_pw == PW_PER_FORWARD and len(sites) - n_pw == CONV_PER_FORWARD,
          f"fused sites {n_pw} pointwise / {len(sites) - n_pw} conv, expected "
          f"{PW_PER_FORWARD} / {CONV_PER_FORWARD}")
    plain_logits = plain_engine.predict(batch)[:5]

    # 4. kernels at every site shape of the bucket-8 forward
    rows = kernel_phase(torch, sites)
    emit("kernel_sums", **kernel_sums(rows))

    # 5. serve: the main path, counters zeroed just before it
    server, launches["serve"], fields = serve_phase(torch, art, clips, plain_logits,
                                                    "slowfast_r50")
    emit("serve", **fields)

    # 6. bucket-8 forward times, host clock around synchronised forwards
    off_engine = make_engine(torch, "slowfast_r50", state, norm, "off")
    emit("timing", bucket=BUCKET,
         forward_ms_kernels=forward_ms(torch, server.engine, batch),
         forward_ms_plain=forward_ms(torch, plain_engine, batch),
         forward_ms_unfused_cudnn=forward_ms(torch, off_engine, batch),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("profile", bucket=BUCKET, **profile_forward(torch, server.engine, batch))
    del server, plain_engine, off_engine
    free_cuda(torch)

    # 8. train: the main training path, counters zeroed just before fit()
    train = train_phase(torch, work)
    launches["train"] = train["launches"]
    emit("train", **train)
    # 9. kernels against plain on one training micro-step
    emit("train_parity", **train_parity_phase(torch))
    # 10. micro-step times, clips/s of fit()'s steady epoch, memory, profile
    timing = train_timing_phase(torch)
    KEPT["train_timing_micro_step_ms"] = timing["micro_step_ms_auto"]
    emit("train_timing", batch=TRAIN_BATCH, nvidia_smi=smi,
         fit_clips_per_sec=train["result"].get("clips_per_sec"),
         fit_input_wait_frac=train["result"].get("input_wait_frac"),
         **timing, profile_retakes=PROFILE_RETAKES[0],
         incomplete_profiles=INCOMPLETE_PROFILES[0])
    t_observe = time.perf_counter()
    # 8b-8c. slice 19's paths: the process transport, and the profile
    # window and tracing on a Trainer, counters zeroed just before fit()
    emit("transport", nvidia_smi=smi, **transport_phase(torch, work))
    emit("observe_train", nvidia_smi=smi, **observe_train_phase(torch, work, launches))
    slowfast_s = time.perf_counter() - t_start
    observe_s = time.perf_counter() - t_observe

    rows += depthwise_phases(torch, work, launches)
    t_attention = time.perf_counter()
    rows += attention_phases(torch, work, launches)
    t_r2plus1d = time.perf_counter()
    rows += r2plus1d_phases(torch, work, launches)
    t_features = time.perf_counter()
    # 30-31. this slice's paths: the training features on SlowFast-R50,
    # remat on MViT-B 32x3, counters zeroed just before each
    emit("features_train", nvidia_smi=smi, **features_train_phase(torch, work, launches))
    emit("remat_train", nvidia_smi=smi, **remat_train_phase(torch, launches))
    t_real = time.perf_counter()
    emit("real_video_route", **real_video_route(torch, work))
    t_slice11 = time.perf_counter()
    # 33-35. this slice's paths: the serving defaults on SlowFast-R50 and
    # MViT-B, the preemption grace path, counters zeroed just before each
    emit("edf_serve", nvidia_smi=smi,
         **edf_serve_phase(torch, work, art, clips, plain_logits, launches))
    emit("int8_serve", nvidia_smi=smi, **int8_serve_phase(torch, work, launches))
    emit("preempt_train", nvidia_smi=smi, **preempt_train_phase(torch, work, launches))
    t_stream = time.perf_counter()
    # 44. the streaming path: sessions on SlowFast-R50 (over HTTP),
    # VideoMAE-B and MViT-B, counters zeroed just before each arm
    emit("stream_serve", nvidia_smi=smi, **stream_serve_phase(torch, work, launches))
    t_fleet = time.perf_counter()
    # 45. the serving fleet on SlowFast-R50 replicas, counters zeroed just
    # before each arm
    emit("fleet_serve", nvidia_smi=smi,
         **fleet_serve_phase(torch, work, plain_logits, launches))
    t_slice12 = time.perf_counter()
    # 36. this slice's path: data-parallel training, counters zeroed in
    # each rank just before fit()
    emit("dp_train", nvidia_smi=smi, **dp_train_phase(torch, work, launches))
    t_hang = time.perf_counter()
    # 42. this slice's path: the debug flags and the device probe on one
    # in-process Trainer, counters zeroed just before fit()
    emit("hang_watch", nvidia_smi=smi, **hang_watch_phase(torch, work, launches))
    t_slice13 = time.perf_counter()
    # 37-40. this slice's paths: fine-tuning from full-width hub-layout
    # checkpoints and the MAE handoff, counters zeroed just before each fit()
    emit("hub_finetune", nvidia_smi=smi, **hub_finetune_phase(torch, work, launches))
    emit("hub_interp_finetune", nvidia_smi=smi,
         **hub_interp_finetune_phase(torch, work, launches))
    emit("hub_x3d", nvidia_smi=smi, **hub_x3d_phase(torch, work, launches))
    emit("mae_handoff", nvidia_smi=smi, **mae_handoff_phase(torch, work, launches))
    t_slice14 = time.perf_counter()
    # 41. the model axis (tensor and context parallel)
    # on MViT-B and VideoMAE-B, counters zeroed in each rank just before fit()
    emit("model_axis_train", nvidia_smi=smi,
         **model_axis_train_phase(torch, work, launches))
    t_slice15 = time.perf_counter()
    # 43. the library mesh: fsdp on SlowFast-R50, tensor x context on
    # VideoMAE-B, counters zeroed in each rank just before fit()
    emit("library_mesh_train", nvidia_smi=smi,
         **library_mesh_train_phase(torch, work, launches))

    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        model, fwd_phase, dx_phase = LINE[kname.split(".")[0]]
        phase = dx_phase if is_backward(kname) else fwd_phase
        count = launches[phase][kname]
        check(count > 0, f"{kname} was not launched on the main path ({phase})")
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": count,
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == kname),
            **line_sums(rows, kname, model),
        })
        if kname.split(".")[0] in R2_LINE:
            # this slice's path: R(2+1)D-50's serve and train phases
            r2_count = launches["r2plus1d_train" if is_backward(kname)
                                else "r2plus1d_serve"][kname]
            check(r2_count > 0, f"{kname} was not launched on R(2+1)D-50's path")
            kernels[-1]["r2plus1d_r50"] = {"launches": r2_count,
                                           **line_sums(rows, kname, "r2plus1d_r50")}
        if kname in FEATURES_LINE:
            # this slice's paths: features_train (SlowFast-R50, the row's
            # own site shapes) and remat_train (MViT-B 32x3, launches of
            # one micro-step under remat)
            phase = FEATURES_LINE[kname]
            f_count = launches[phase].get(kname, 0)
            check(f_count > 0, f"{kname} was not launched on {phase}")
            sub = {"path": phase, "launches": f_count}
            if phase == "features_train":
                sub.update(line_sums(rows, kname, "slowfast_r50"))
            kernels[-1]["train_features"] = sub
        for phase, knames in {**SLICE11_LINE, **DP_LINE, **FINETUNE_LINE,
                              **MODEL_AXIS_LINE, **PIPELINE_LINE,
                              **LIBRARY_LINE, **HANG_LINE,
                              **OBSERVE_LINE, **STREAM_LINE,
                              **FLEET_LINE}.items():
            if kname in knames:
                n = launches[phase].get(kname, 0)
                check(n > 0, f"{kname} was not launched on {phase}")
                kernels[-1][phase] = {"launches": n}
    emit("seconds", slowfast=slowfast_s, observe=observe_s,
         attention=t_r2plus1d - t_attention,
         r2plus1d=t_features - t_r2plus1d,
         features=t_real - t_features,
         real_video=t_slice11 - t_real,
         serving_defaults_and_preemption=t_stream - t_slice11,
         streaming=t_fleet - t_stream,
         fleet=t_slice12 - t_fleet,
         data_parallel=t_hang - t_slice12,
         hang_watch=t_slice13 - t_hang,
         finetune=t_slice14 - t_slice13,
         model_axis=t_slice15 - t_slice14,
         library_mesh=time.perf_counter() - t_slice15,
         total=time.perf_counter() - t_start,
         script_s=time.perf_counter() - T_START,
         script_limit_s=1200, nvidia_smi=smi,
         profile_retakes=PROFILE_RETAKES[0],
         incomplete_profiles=INCOMPLETE_PROFILES[0])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


R2_LINE = ("fused_pw_bn_act", "fused_conv_bn_act")
# the kernel rows on this slice's paths, and the phase whose launches each
# reports
FEATURES_LINE = {
    **{k: "features_train" for k in ("fused_pw_bn_act", "fused_pw_bn_act.bwd_dx",
                                      "fused_conv_bn_act", "fused_conv_bn_act.bwd_dx")},
    **{k: "remat_train" for k in ("depthwise3d_s1", "depthwise3d_s1.bwd_dx",
                                  "flash_attention", "flash_attention.bwd_dq",
                                  "flash_attention.bwd_dkv")}}


# the kernel rows on slice 11's paths, by the phase whose launches each
# sub-entry reports
SLICE11_LINE = {
    "edf_serve": ("fused_pw_bn_act", "fused_conv_bn_act"),
    "int8_serve": ("fused_pw_bn_act", "fused_conv_bn_act", "depthwise3d_s1",
                   "flash_attention"),
    "preempt_train": ("fused_pw_bn_act", "fused_pw_bn_act.bwd_dx",
                      "fused_conv_bn_act", "fused_conv_bn_act.bwd_dx")}


# the kernel rows on slice 12's path: one rank of dp_train's arm (c)
DP_LINE = {"dp_train": ("fused_pw_bn_act", "fused_pw_bn_act.bwd_dx",
                        "fused_conv_bn_act", "fused_conv_bn_act.bwd_dx")}


# the kernel rows on slice 13's paths, by the fine-tuning phase whose
# launches each sub-entry reports
FINETUNE_LINE = {
    "hub_finetune": ("fused_pw_bn_act", "fused_pw_bn_act.bwd_dx",
                     "fused_conv_bn_act", "fused_conv_bn_act.bwd_dx"),
    "hub_interp_finetune": ("depthwise3d_s1", "depthwise3d_s1.bwd_dx",
                            "flash_attention", "flash_attention.bwd_dq",
                            "flash_attention.bwd_dkv"),
    "hub_x3d": ("fused_pw_bn_act", "fused_pw_bn_act.bwd_dx",
                "fused_dw_bn_act", "fused_dw_bn_act.bwd_dx"),
    "mae_handoff": ("flash_attention", "flash_attention.bwd_dq",
                    "flash_attention.bwd_dkv")}


def line_sums(rows, kname: str, model: str) -> dict:
    """ms, plain_ms, bound_ms (and what bounds it) and library_ms of
    `kname`'s rows at `model`'s sites, each summed over its launches in one
    bucket-8 forward (a backward row: one B=8 micro-step)."""
    mine = [r for r in rows if r["kernel"] == kname and r["model"] == model]
    flop_ms = sum(r["flop_ms"] * r["per_forward"] for r in mine)
    byte_ms = sum(r["byte_ms"] * r["per_forward"] for r in mine)
    return {"ms": sum(r["kernel_ms"] * r["per_forward"] for r in mine),
            "plain_ms": sum(r["plain_ms"] * r["per_forward"] for r in mine),
            "bound_ms": sum(r["bound_ms"] * r["per_forward"] for r in mine),
            "bound_by": "operations" if flop_ms > byte_ms else "bytes",
            "library_ms": sum(r["library_ms"] * r["per_forward"] for r in mine)}


def depthwise_phases(torch, work: str, launches: dict):
    """Phases 11-17: X3D-M and CSN-R101 through the depthwise kernel. Fills
    `launches` with the main-path phases' counts; returns the kernel rows."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    # 11. weights, artifacts, the plain paths and their site shapes
    rng = np.random.default_rng(SEED + 10)
    t0 = time.perf_counter()
    art, x_state, x_clips, norm, n_params = make_artifact(torch, work, "x3d_m", rng)
    x_batch = bucket_batch(x_clips, BUCKET)
    x_plain = make_engine(torch, "x3d_m", x_state, norm, "xla")
    pw_sites = record_sites(torch, x_plain.model, lambda: x_plain.predict(x_batch))
    x_dw_sites = record_dw_sites(lambda: x_plain.predict(x_batch))
    x_plain_logits = x_plain.predict(x_batch)[:5]
    want = expected_forward_launches("x3d_m")
    check(len(pw_sites) == want["fused_pw_bn_act"]
          and len(x_dw_sites) == want["fused_dw_bn_act"],
          f"X3D-M sites {len(pw_sites)} pointwise / {len(x_dw_sites)} depthwise, "
          f"expected {want}")
    emit("x3d_weights", artifact=art, params=n_params, pointwise_sites=len(pw_sites),
         depthwise_sites=len(x_dw_sites), seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    _, c_state, c_clips, c_norm, c_params = make_artifact(
        torch, work, "csn_r101", rng, requests=CSN_BUCKET, bucket=CSN_BUCKET)
    c_batch = bucket_batch(c_clips, CSN_BUCKET)
    c_plain = make_engine(torch, "csn_r101", c_state, c_norm, "xla", bucket=CSN_BUCKET)
    c_pw_sites = record_sites(torch, c_plain.model, lambda: c_plain.predict(c_batch))
    c_dw_sites = record_dw_sites(lambda: c_plain.predict(c_batch))
    c_plain_logits = c_plain.predict(c_batch)
    c_want = expected_forward_launches("csn_r101")
    check(len(c_pw_sites) == c_want["fused_pw_bn_act"]
          and len(c_dw_sites) == c_want["fused_dw_bn_act"],
          f"CSN-R101 sites {len(c_pw_sites)} pointwise / {len(c_dw_sites)} "
          f"depthwise, expected {c_want}")
    emit("csn_weights", params=c_params, pointwise_sites=len(c_pw_sites),
         depthwise_sites=len(c_dw_sites), seconds=time.perf_counter() - t0)

    # 12. the depthwise kernel at every site shape, then the pointwise
    # kernel at X3D-M's sites
    t0 = time.perf_counter()
    rows = dw_kernel_phase(torch, "x3d_m", x_dw_sites)
    rows += dw_kernel_phase(torch, "csn_r101", c_dw_sites)
    emit("x3d_dw_dk", **dw_dk_ms(torch, x_dw_sites))
    rows += kernel_phase(torch, pw_sites, "x3d_m", DW_REPS)
    rows += kernel_phase(torch, c_pw_sites, "csn_r101", DW_REPS)
    emit("kernel_sums", **kernel_sums(rows))
    emit("kernels_seconds", seconds=time.perf_counter() - t0)

    # 13. x3d_serve: the main path for row 3, counters zeroed just before
    server, launches["x3d_serve"], fields = serve_phase(torch, art, x_clips,
                                                        x_plain_logits, "x3d_m")
    emit("x3d_serve", **fields)
    engines = {"kernels": server.engine, "plain": x_plain,
               "unfused_cudnn": make_engine(torch, "x3d_m", x_state, norm, "off"),
               "depthwise_impl_pallas": make_engine(torch, "x3d_m", x_state, norm,
                                                    "off", "pallas")}
    emit("x3d_timing", bucket=BUCKET,
         **{f"forward_ms_{k}": forward_ms(torch, e, x_batch) for k, e in engines.items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("x3d_profile", bucket=BUCKET, **profile_forward(torch, server.engine, x_batch))
    emit("x3d_profile_unfused_cudnn", bucket=BUCKET,
         **profile_forward(torch, engines["unfused_cudnn"], x_batch))

    # 14. x3d_depthwise_impl: the main path for row 4's forward
    shift = make_engine(torch, "x3d_m", x_state, norm, "off", "shift")
    fused.reset_launch_counts()
    got = engines["depthwise_impl_pallas"].predict(x_batch)
    launches["x3d_depthwise_impl"] = dict(fused.LAUNCHES)
    check_launches(launches["x3d_depthwise_impl"], expected_depthwise_impl_launches(),
                   1, "X3D-M depthwise_impl pallas")
    emit("x3d_depthwise_impl", launches=launches["x3d_depthwise_impl"],
         **hold_logits(got[:5], shift.predict(x_batch)[:5], "depthwise_impl pallas"))
    del server, engines, shift, x_plain
    free_cuda(torch)

    # 15. x3d_train: the main training path for rows 1 and 3, then for row 4
    train = train_phase(torch, work, X3D_TRAIN)
    launches["x3d_train"] = train["launches"]
    emit("x3d_train", **train)
    dw_train = depthwise_impl_train_phase(torch, work)
    launches["x3d_train_depthwise_impl"] = dw_train["launches"]
    emit("x3d_train_depthwise_impl", **dw_train)
    # 16. the backward through rows 1, 3 and 4 against plain autograd; times
    emit("x3d_train_parity", **x3d_train_parity_phase(torch))
    emit("x3d_train_timing", batch=X3D_TRAIN["batch"],
         fit_clips_per_sec=train["result"].get("clips_per_sec"),
         **train_timing_phase(torch, X3D_TRAIN, (
             ("auto", "conv"), ("off", "conv"), ("xla", "conv"), ("off", "pallas"))))

    # 17. csn_serve: one CSN-R101 bucket-4 forward through the kernels
    engine = make_engine(torch, "csn_r101", c_state, c_norm, "auto", bucket=CSN_BUCKET)
    fused.reset_launch_counts()
    got = engine.predict(c_batch)
    csn_launches = dict(fused.LAUNCHES)
    check_launches(csn_launches, expected_forward_launches("csn_r101"), 1, "CSN-R101")
    off = make_engine(torch, "csn_r101", c_state, c_norm, "off", bucket=CSN_BUCKET)
    emit("csn_serve", bucket=CSN_BUCKET, launches=csn_launches,
         **hold_logits(got, c_plain_logits, "CSN-R101"),
         forward_ms_kernels=forward_ms(torch, engine, c_batch, 3),
         forward_ms_plain=forward_ms(torch, c_plain, c_batch, 3),
         forward_ms_unfused_cudnn=forward_ms(torch, off, c_batch, 3))
    del engine, off, c_plain
    free_cuda(torch)
    return rows


def record_attn_sites(run):
    """[(q shape, k shape)] of every attention call that `run()` makes under
    `attention dense`, in call order, (B, N, H, D) each."""
    from pytorchvideo_accelerate_tpu_torch.ops import attention

    sites = []
    plain = attention.dense_attention

    def recording(q, k, v, scale=None, mask=None):
        sites.append((tuple(q.shape), tuple(k.shape)))
        return plain(q, k, v, scale, mask)

    attention.dense_attention = recording
    try:
        run()
    finally:
        attention.dense_attention = plain
    return sites


def record_pool_sites(torch, model, run):
    """[(NCDHW input shape, stride)] of every depthwise pool (`DepthwiseConv3D`)
    that `run()` goes through."""
    from pytorchvideo_accelerate_tpu_torch.ops.depthwise import DepthwiseConv3D

    sites = []
    handles = [m.register_forward_pre_hook(
        lambda mod, args: sites.append((tuple(args[0].shape), mod.stride)))
        for m in model.modules() if isinstance(m, DepthwiseConv3D)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return sites


def attn_bound(kname: str, b: int, nq: int, nk: int, h: int, d: int):
    """(flops, bytes) of one launch: per (b, h) the forward does 4 Nq Nk D
    FLOPs, dq 6x and dk/dv 8x that (their recompute of s included); each
    bf16 operand (q, k, v, dO) read once and each output (out, dq, dk, dv)
    written once, lse and delta 4 bytes a query row."""
    per_flop = nq * nk * d
    if kname == "flash_attention":
        flops, nbytes = 4 * per_flop, 2 * (2 * nq + 2 * nk) * d + 4 * nq
    elif kname.endswith("bwd_dq"):
        flops, nbytes = 6 * per_flop, 2 * (3 * nq + 2 * nk) * d + 8 * nq
    else:
        flops, nbytes = 8 * per_flop, 2 * (2 * nq + 4 * nk) * d + 8 * nq
    return float(b * h * flops), float(b * h * nbytes)


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from an `nvcc -Xptxas=-v` log."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def flash_build_facts(which: str, d: int) -> dict:
    """ptxas's report of the flash kernel `which` ("fwd", "dq" or "dkv") at
    head dim d, and what the runtime says of it (registers, local memory,
    dynamic shared memory, blocks per SM). No spills at D = 64 and 96."""
    from pytorchvideo_accelerate_tpu_torch.ops import _build
    from pytorchvideo_accelerate_tpu_torch.ops import flash_attention as fa

    tag = f"{which}_kernelILi{d}E"
    source = "flash_attention" if which == "fwd" else "flash_attention_bwd"
    report = [v for k, v in ptxas_report(_build.build_logs.get(
        source, "")).items() if tag in k]
    facts = {"ptxas": report[0] if report else None,
             "runtime": fa.kernel_attrs(which, d)}
    if d in (64, 96):
        spills = (report[0].get("spill_stores", 0) if report else 0) + \
            facts["runtime"]["local_bytes"]
        check(spills == 0, f"flash {which} kernel at D={d} spills: {facts}")
    return facts


def max_excess(got, want) -> tuple:
    """(max |got - want|, max of |got - want| - KERNEL_TOL * (1 + |want|),
    relative 2-norm error), both in f32."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return (err.max().item(), (err - KERNEL_TOL * (1 + want.abs())).max().item(),
            ((got - want).norm() / want.norm()).item())


def attn_kernel_phase(torch, model: str, sites, reps: int = ATTN_REPS):
    """The three flash kernels at every distinct attention site shape of
    `model`'s forward: the forward's out and lse against `flash_fwd_plain`,
    dq and dk/dv (from the plain forward's out and lse) against
    `flash_bwd_plain`, elementwise within KERNEL_TOL * (1 + |plain|); device
    times of each kernel launch, of the plain version (for both backward
    rows, `flash_bwd_plain`, which computes dq, dk and dv together) and of
    the library call: one bf16 `F.scaled_dot_product_attention` forward,
    and its backward (dq, dk and dv together) on both backward rows."""
    import torch.nn.functional as F

    from pytorchvideo_accelerate_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(SEED + 20)
    uniq = {}
    for i, key in enumerate(sites):
        uniq.setdefault(key, []).append(f"{model} attention site {i}")
    rows = []
    for (q_shape, k_shape), names in uniq.items():
        b, nq, h, d = q_shape
        nk = k_shape[1]

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda().bfloat16()

        q, k, v, dout = randn(b, nq, h, d), randn(b, nk, h, d), randn(b, nk, h, d), randn(b, nq, h, d)
        scale = d ** -0.5
        out, lse = fa._fwd_cuda(q, k, v, scale)
        p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale)
        grads = fa._bwd_cuda(q, k, v, p_out, p_lse, dout, scale, True, True)
        p_grads = fa.flash_bwd_plain(q, k, v, p_out, p_lse, dout, scale)
        torch.cuda.synchronize()
        errs = {"out": max_excess(out, p_out), "lse": max_excess(lse, p_lse)}
        errs.update(zip(("dq", "dk", "dv"), (max_excess(g, w) for g, w in zip(grads, p_grads))))
        for what, (_, excess, _) in errs.items():
            check(excess <= 0, f"{model} attention {q_shape} x {k_shape}: {what} "
                  f"errors {errs[what]} over {KERNEL_TOL}*(1+|plain|)")
        check(errs["lse"][0] <= LSE_TOL, f"{model} attention {q_shape} x {k_shape}: "
              f"lse error {errs['lse'][0]} over {LSE_TOL}")
        del out, lse, grads, p_grads
        # launch-only closures over preallocated outputs; the backward ones
        # go through the wrapper's launch plan (dk/dv splits, workspace)
        dims, delta = (b, h, nq, nk, d), fa.attention_delta(p_out, dout)
        o_buf, l_buf = torch.empty_like(q), torch.empty_like(p_lse)
        bufs = [tuple(torch.empty_like(t) for t in (q, k, v)) for _ in range(2)]
        dq, dk, dv = bufs[0]
        launch = {
            "flash_attention": lambda: fa._call(
                "flash_attention", (q, k, v, o_buf, l_buf), dims, (q, k, v), scale, q.device),
            "flash_attention.bwd_dq": lambda: fa.launch_dq(
                q, k, v, dout, p_lse, delta, dq, scale),
            "flash_attention.bwd_dkv": lambda: fa.launch_dkv(
                q, k, v, dout, p_lse, delta, dk, dv, scale)}
        # no atomics: two launches on the same inputs agree bitwise
        splits = [fa.launch_dkv(q, k, v, dout, p_lse, delta, g[1], g[2], scale)
                  for g in bufs]
        for g in bufs:
            fa.launch_dq(q, k, v, dout, p_lse, delta, g[0], scale)
        fwd_twice = [fa._fwd_cuda(q, k, v, scale) for _ in range(2)]
        torch.cuda.synchronize()
        bitwise = {w: torch.equal(bufs[0][i], bufs[1][i])
                   for i, w in enumerate(("dq", "dk", "dv"))}
        bitwise.update(out=torch.equal(fwd_twice[0][0], fwd_twice[1][0]),
                       lse=torch.equal(fwd_twice[0][1], fwd_twice[1][1]))
        del fwd_twice
        check(all(bitwise.values()), f"{model} attention {q_shape} x {k_shape}: two "
              f"launches differ {bitwise}")
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt)
        dlib = dout.transpose(1, 2)
        plain_bwd_ms = device_ms(torch, lambda: fa.flash_bwd_plain(
            q, k, v, p_out, p_lse, dout, scale), reps)
        lib_bwd_ms = device_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dlib, retain_graph=True), reps)
        timed = {
            "flash_attention": (
                device_ms(torch, launch["flash_attention"], reps),
                device_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, scale), reps),
                device_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt.detach(), kt.detach(), vt.detach()), reps), errs["out"]),
            "flash_attention.bwd_dq": (
                device_ms(torch, launch["flash_attention.bwd_dq"], reps),
                plain_bwd_ms, lib_bwd_ms, errs["dq"]),
            "flash_attention.bwd_dkv": (
                device_ms(torch, launch["flash_attention.bwd_dkv"], reps),
                plain_bwd_ms, lib_bwd_ms,
                max(errs["dk"], errs["dv"]))}
        bwd_ms = timed["flash_attention.bwd_dq"][0] + timed["flash_attention.bwd_dkv"][0]
        for kname, (kernel_ms, plain_ms, library_ms, err) in timed.items():
            flops, nbytes = attn_bound(kname, b, nq, nk, h, d)
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            row = {"kernel": kname, "model": model, "sites": names,
                   "per_forward": len(names), "q": list(q_shape), "k": list(k_shape),
                   "max_abs_err": err[0], "rel_err": err[2],
                   "tolerance": f"{KERNEL_TOL}*(1+|plain|)",
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops > t_bytes else "bytes",
                   "flop_ms": t_ops, "byte_ms": t_bytes,
                   "achieved_tflops": flops / kernel_ms / 1e9}
            if kname == "flash_attention":
                row.update(lse_max_abs_err=errs["lse"][0], lse_tolerance=LSE_TOL,
                           library_ratio=kernel_ms / library_ms,
                           bitwise_equal_two_launches=True,
                           build=flash_build_facts("fwd", d))
            else:
                which = "dkv" if kname.endswith("bwd_dkv") else "dq"
                row.update(plain_and_library_compute="dq, dk and dv together",
                           library_ratio=bwd_ms / library_ms,
                           bitwise_equal_two_launches=True,
                           build=flash_build_facts(which, d))
                if which == "dkv":
                    row.update(dk_dv_max_abs_err=[errs["dk"][0], errs["dv"][0]],
                               splits=splits[0])
            emit("kernels", **row)
            rows.append(row)
        del q, k, v, dout, p_out, p_lse, delta, o_buf, l_buf, dq, dk, dv, bufs
        del qt, kt, vt, lib_out, dlib, launch
        free_cuda(torch)
    return rows


def strided_pool_ms(torch, pool_sites, reps: int = ATTN_REPS) -> dict:
    """Device time of the strided MViT pools, each one bf16 cuDNN grouped
    `F.conv3d(groups=C)` as the model runs them (depthwise_impl pallas keeps
    only the stride-1 pools)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 21)
    total, n = 0.0, 0
    for shape, stride in pool_sites:
        if stride == (1, 1, 1):
            continue
        c = shape[1]
        x = torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda().bfloat16(
            ).contiguous(memory_format=torch.channels_last_3d)
        w = torch.from_numpy(rng.standard_normal((c, 1, 3, 3, 3), np.float32)).cuda().bfloat16()
        total += device_ms(torch, lambda: F.conv3d(x, w, None, stride, 1, 1, c), reps)
        n += 1
    return {"strided_pools": n, "strided_pool_grouped_conv_ms": total}


def transformer_weights(torch, work: str, name: str, rng):
    """A seeded, planted `name` artifact served through the flash kernels
    (and row 4 for MViT), the `attention dense` engine on its weights, the
    bucket-8 batch, the plain logits and the attention sites."""
    impl = "pallas" if name == "mvit_b" else "conv"
    t0 = time.perf_counter()
    art, state, clips, norm, n_params = make_artifact(torch, work, name, rng,
                                                      attention="pallas", impl=impl)
    batch = bucket_batch(clips, BUCKET)
    plain = make_engine(torch, name, state, norm, "off", attention="dense")
    sites = record_attn_sites(lambda: plain.predict(batch))
    want = expected_forward_launches(name)["flash_attention"]
    check(len(sites) == want, f"{name}: {len(sites)} attention sites, expected {want}")
    logits = plain.predict(batch)[:len(clips)]
    emit(f"{name.split('_')[0]}_weights", artifact=art, params=n_params,
         attention_sites=len(sites),
         distinct_sites=sorted({(s[0], s[1]) for s in sites}),
         seconds=time.perf_counter() - t0)
    return art, state, clips, norm, batch, plain, sites, logits


def mae_micro_step(torch, attention: str, x, seed: int = 0):
    """(model, fn) for a fresh seeded VideoMAE-B pretraining model in bf16
    under `attention`: fn() runs one micro-step (forward + backward) of the
    reconstruction loss on `x` under the mask of `mask_generator(SEED, 0,
    0)`, the same mask for every call and lowering, and returns the loss."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import mask_generator

    spec = dict(MAE_TRAIN, argv=["--model.attention", attention])
    cfg = parse_cli(train_argv("unused", "off", spec))
    model = create_model(cfg.model, "bf16", seed=seed, data_cfg=cfg.data).cuda().train()

    def fn():
        model.zero_grad(set_to_none=True)
        loss = model(x, generator=mask_generator(SEED, 0, 0))["loss"]
        loss.backward()
        return loss
    return model, fn


def micro_step_times(torch, fn, reps: int = 1) -> dict:
    """Host-clock ms of `reps` synchronised `fn()` calls after one warm-up
    call (2 before the transport-and-tracing phases), the peak device
    memory over them, and the memory live before them (held by the caller:
    weights, the batch, what earlier phases left)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return {"micro_step_ms": times,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "live_mem_gb_before": live / 1e9}


def videomae_train_timing(torch) -> dict:
    """One B=8 micro-step of the VideoMAE-B classifier through the flash
    kernels against `attention dense`: the launches of one micro-step (12
    forward, 12 dq, 12 dk/dv), ms per micro-step and peak memory of each,
    and the loss of both on the same batch and weights."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    batch = train_batch(torch, SEED + 33, VIDEOMAE_TRAIN)
    dense = dict(VIDEOMAE_TRAIN, argv=["--model.attention", "dense"])
    out = {"batch": VIDEOMAE_TRAIN["batch"]}
    for label, spec in (("flash", VIDEOMAE_TRAIN), ("dense", dense)):
        model, _, fn = micro_step_fn(torch, "off", batch, spec)
        out[f"loss_{label}"] = fn().item()
        out[label] = micro_step_times(torch, fn)
        if label == "flash":
            fused.reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            out["launches_per_micro_step"] = {k: v for k, v in fused.LAUNCHES.items() if v}
        del model, fn
        free_cuda(torch)
    want = {k: VIT_DEPTH for k in ("flash_attention", "flash_attention.bwd_dq",
                                   "flash_attention.bwd_dkv")}
    check(out["launches_per_micro_step"] == want,
          f"VideoMAE-B micro-step launches {out['launches_per_micro_step']}, expected {want}")
    out["loss_tolerance"] = LOGIT_TOL * (1 + abs(out["loss_dense"]))
    check(abs(out["loss_flash"] - out["loss_dense"]) <= out["loss_tolerance"],
          f"VideoMAE-B train loss {out}")
    del batch
    free_cuda(torch)
    return out


def attention_phases(torch, work: str, launches: dict):
    """Phases 18-25: MViT-B and VideoMAE-B (classifier and MAE pretraining)
    through the flash attention kernels. Fills `launches` with the
    main-path phases' counts; returns the kernel rows."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    # 18. weights, artifacts, the dense engines and their attention sites
    rng = np.random.default_rng(SEED + 30)
    m_art, _, m_clips, _, m_batch, m_plain, m_sites, m_logits = transformer_weights(
        torch, work, "mvit_b", rng)
    pool_sites = record_pool_sites(torch, m_plain.model, lambda: m_plain.predict(m_batch))
    rows = dw_pool_phase(torch, pool_sites)
    emit("kernel_sums", **kernel_sums(rows))
    v_art, _, v_clips, _, v_batch, v_plain, v_sites, v_logits = transformer_weights(
        torch, work, "videomae_b", rng)
    mae_x = torch.from_numpy(train_clips(np.random.default_rng(SEED + 31), MAE_TRAIN,
                                         MAE_TRAIN["batch"])["video"]).cuda()
    model, _ = mae_micro_step(torch, "dense", mae_x)
    with torch.no_grad():
        mae_sites = record_attn_sites(
            lambda: model(mae_x, generator=torch.Generator().manual_seed(0)))
    del model
    free_cuda(torch)
    check(len(mae_sites) == VIT_DEPTH + VIT_DECODER_DEPTH,
          f"MAE attention sites {len(mae_sites)}")

    # 19. the flash kernels at every distinct site shape
    t0 = time.perf_counter()
    rows += attn_kernel_phase(torch, "mvit_b", m_sites)
    rows += attn_kernel_phase(torch, "videomae_b", v_sites)
    rows += attn_kernel_phase(torch, "videomae_b_pretrain", mae_sites)
    emit("attention_kernels_seconds", seconds=time.perf_counter() - t0)

    # 20. mvit_serve: the main path for row 5, counters zeroed just before
    server, launches["mvit_serve"], fields = serve_phase(torch, m_art, m_clips,
                                                         m_logits, "mvit_b")
    emit("mvit_serve", **fields)
    emit("mvit_timing", bucket=BUCKET,
         forward_ms_flash=forward_ms(torch, server.engine, m_batch),
         forward_ms_dense=forward_ms(torch, m_plain, m_batch),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("mvit_profile", bucket=BUCKET, **profile_forward(torch, server.engine, m_batch),
         **strided_pool_ms(torch, pool_sites))
    del server, m_plain
    free_cuda(torch)

    # 21. videomae_serve
    server, launches["videomae_serve"], fields = serve_phase(torch, v_art, v_clips,
                                                             v_logits, "videomae_b")
    emit("videomae_serve", **fields)
    emit("videomae_timing", bucket=BUCKET,
         forward_ms_flash=forward_ms(torch, server.engine, v_batch),
         forward_ms_dense=forward_ms(torch, v_plain, v_batch),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("videomae_profile", bucket=BUCKET, **profile_forward(torch, server.engine, v_batch))
    del server, v_plain
    free_cuda(torch)

    # 22. mvit_train: the main training path for rows 5-7 (and row 4 at the
    # stride-1 K/V pools), counters zeroed just before fit()
    train = train_phase(torch, work, MVIT_TRAIN)
    launches["mvit_train"] = train["launches"]
    emit("mvit_train", **train)
    # 23. with the forward fixed, the backward through the kernels against
    # plain autograd; end to end, flash against dense; times and memory
    batch = train_batch(torch, SEED + 32, MVIT_TRAIN)
    dense = dict(MVIT_TRAIN, argv=["--model.attention", "dense",
                                   "--model.depthwise_impl", "shift"])
    e2e = {}
    for label, spec in (("flash", MVIT_TRAIN), ("dense", dense)):
        model, _, fn = micro_step_fn(torch, "off", batch, spec)
        e2e[label] = (fn().item(), torch.cat([p.grad.float().flatten()
                                              for p in model.parameters()]))
        del model, fn
        free_cuda(torch)
    (lf, gf), (ld, gd) = e2e["flash"], e2e["dense"]
    parity = {"loss_flash": lf, "loss_dense": ld, "loss_abs_err": abs(lf - ld),
              "loss_tolerance": LOGIT_TOL * (1 + abs(ld)),
              "grad_rel_err_end_to_end": rel_err(gf, gd), "rel_tolerance": LOGIT_TOL}
    del e2e, gf, gd
    check(parity["loss_abs_err"] <= parity["loss_tolerance"], f"MViT-B train loss {parity}")
    grad, update = fixed_forward_parity(torch, "off", batch, MVIT_TRAIN)
    parity.update(grad_rel_err_same_forward=grad, update_rel_err_same_forward=update)
    check(grad <= LOGIT_TOL and update <= LOGIT_TOL, f"MViT-B gradients {parity}")
    emit("mvit_train_parity", **parity)
    timing = {}
    for label, spec in (("flash", MVIT_TRAIN), ("dense", dense)):
        model, _, fn = micro_step_fn(torch, "off", batch, spec)
        timing[label] = micro_step_times(torch, fn)
        if label == "flash":
            timing["profile"] = profile_of(torch, fn, PROFILE_REPS, "micro_step")
        del model, fn
        free_cuda(torch)
    emit("mvit_train_timing", batch=MVIT_TRAIN["batch"],
         fit_clips_per_sec=train["result"].get("clips_per_sec"), **timing)
    del batch
    free_cuda(torch)
    emit("videomae_train_timing", **videomae_train_timing(torch))

    # 24. videomae_pretrain: MAE pretraining through the kernels
    train = train_phase(torch, work, MAE_TRAIN)
    launches["videomae_pretrain"] = train["launches"]
    emit("videomae_pretrain", **train)
    # 25. one micro-step under the same mask: flash against dense; times
    out = {}
    for attention in ("pallas", "dense"):
        model, fn = mae_micro_step(torch, attention, mae_x)
        loss = fn().item()
        out[attention] = (loss, torch.cat([p.grad.float().flatten()
                                           for p in model.parameters()]))
        out[f"timing_{attention}"] = micro_step_times(torch, fn)
        if attention == "pallas":
            fused.reset_launch_counts()
            fn()
            out["launches_per_micro_step"] = {k: v for k, v in fused.LAUNCHES.items() if v}
        del model, fn
        free_cuda(torch)
    (lf, gf), (ld, gd) = out.pop("pallas"), out.pop("dense")
    check(abs(lf - ld) <= LOGIT_TOL * (1 + abs(ld)), f"MAE loss {lf} vs {ld}")
    emit("videomae_pretrain_parity", loss_flash=lf, loss_dense=ld,
         loss_abs_err=abs(lf - ld), loss_tolerance=LOGIT_TOL * (1 + abs(ld)),
         grad_rel_err_end_to_end=rel_err(gf, gd), **out)
    del gf, gd, mae_x
    free_cuda(torch)
    return rows


def write_frame_cache(root: str, split: str, n: int, spec: dict, rng) -> dict:
    """A frame cache in `data/cache.py`'s format at `root/split`: `n` videos
    of seeded uint8 frames (noise around a per-video colour) at `spec`'s
    frame count, size and fps, labels drawn in the model's classes. Returns
    the index."""
    from pytorchvideo_accelerate_tpu_torch.data.cache import DATA_NAME, INDEX_NAME

    out = os.path.join(root, split)
    os.makedirs(out)
    t, (h, w) = spec["cache_frames"], spec["cache_size"]
    n_classes = classes(spec["name"])
    videos, offset = [], 0
    with open(os.path.join(out, DATA_NAME), "wb") as f:
        for i in range(n):
            base = rng.integers(48, 208, (1, 1, 1, 3))
            frames = (base + rng.integers(-48, 48, (t, h, w, 3))).astype(np.uint8)
            f.write(frames.tobytes())
            videos.append({"path": f"seeded/{split}/{i:03d}.mp4",
                           "label": int(rng.integers(0, n_classes)),
                           "offset": offset, "frames": t, "height": h, "width": w})
            offset += frames.nbytes
    index = {"fps": spec["cache_fps"], "short_side": min(h, w),
             "num_classes": n_classes, "videos": videos}
    with open(os.path.join(out, INDEX_NAME), "w") as f:
        json.dump(index, f)
    return index


def r2plus1d_phases(torch, work: str, launches: dict):
    """Phases 26-28: R(2+1)D-50 served and trained through the pointwise and
    conv kernels, trained from a frame cache. Fills `launches` with the
    main-path phases' counts; returns the kernel rows."""
    from pytorchvideo_accelerate_tpu_torch.models.common import ConvBNAct

    name = "r2plus1d_r50"
    # 26. weights, artifact, the plain path and its site shapes
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 40)
    art, state, clips, norm, n_params = make_artifact(torch, work, name, rng)
    batch = bucket_batch(clips, BUCKET)
    plain = make_engine(torch, name, state, norm, "xla")
    sites = record_sites(torch, plain.model, lambda: plain.predict(batch))
    plain_logits = plain.predict(batch)[:5]
    want = expected_forward_launches(name)
    n_pw = sum(1 for s in sites.values() if s[1][:3] == (1, 1, 1))
    unfused = [n for n, m in plain.model.named_modules()
               if isinstance(m, ConvBNAct) and not m.fuse]
    check(n_pw == want["fused_pw_bn_act"]
          and len(sites) - n_pw == want["fused_conv_bn_act"] and len(unfused) == 11,
          f"R(2+1)D-50 sites {n_pw} pointwise / {len(sites) - n_pw} conv / "
          f"{len(unfused)} unfused, expected {want} / 11")
    check(28.0e6 < n_params < 28.2e6, f"R(2+1)D-50 parameters {n_params}")
    emit("r2plus1d_weights", artifact=art, params=n_params, pointwise_sites=n_pw,
         conv_sites=len(sites) - n_pw, unfused_sites=unfused,
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    rows = kernel_phase(torch, sites, name, DW_REPS)
    emit("r2plus1d_kernels", **kernel_sums(rows)[name],
         seconds=time.perf_counter() - t0)

    # 27. r2plus1d_serve: this slice's serving path, counters zeroed just
    # before the server is built
    server, launches["r2plus1d_serve"], fields = serve_phase(
        torch, art, clips, plain_logits, name)
    emit("r2plus1d_serve", **fields)
    off = make_engine(torch, name, state, norm, "off")
    emit("r2plus1d_timing", bucket=BUCKET,
         forward_ms_kernels=forward_ms(torch, server.engine, batch),
         forward_ms_plain=forward_ms(torch, plain, batch),
         forward_ms_unfused_cudnn=forward_ms(torch, off, batch),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("r2plus1d_profile", bucket=BUCKET,
         **profile_forward(torch, server.engine, batch))
    del server, plain, off
    free_cuda(torch)

    # 28. r2plus1d_train: run.main from a frame cache, counters zeroed just
    # before fit()
    t0 = time.perf_counter()
    cache = os.path.join(work, "r2plus1d_cache")
    crng = np.random.default_rng(SEED + 41)
    for split, n in (("train", R2_TRAIN["videos"]), ("val", R2_TRAIN["val_videos"])):
        write_frame_cache(cache, split, n, R2_TRAIN, crng)
    cache_s = time.perf_counter() - t0
    spec = dict(R2_TRAIN, cache_dir=cache)
    train = train_phase(torch, work, spec)
    launches["r2plus1d_train"] = train["launches"]
    with open(os.path.join(work, f"trained_{name}_artifact", "meta.json")) as f:
        meta = json.load(f)
    check(meta["num_classes"] == classes(name),
          f"num_classes from the cache: {meta['num_classes']}")
    emit("r2plus1d_train", cache_s=cache_s,
         cache_bytes=sum(os.path.getsize(os.path.join(cache, s, "data.bin"))
                         for s in ("train", "val")),
         exported_num_classes=meta["num_classes"], **train)
    batch = train_batch(torch, SEED + 42, spec)
    e2e = {}
    for mode in ("auto", "xla"):
        model, _, fn = micro_step_fn(torch, mode, batch, spec)
        e2e[mode] = (fn().item(), torch.cat([p.grad.float().flatten()
                                             for p in model.parameters()]))
        del model, fn
        free_cuda(torch)
    (lk, gk), (lp, gp) = e2e["auto"], e2e["xla"]
    parity = {"loss_kernels": lk, "loss_plain": lp, "loss_abs_err": abs(lk - lp),
              "loss_tolerance": LOGIT_TOL * (1 + abs(lp)),
              "grad_rel_err_end_to_end": rel_err(gk, gp), "rel_tolerance": LOGIT_TOL}
    del e2e, gk, gp
    check(parity["loss_abs_err"] <= parity["loss_tolerance"],
          f"R(2+1)D-50 train loss {parity}")
    grad, update = fixed_forward_parity(torch, "auto", batch, spec)
    parity.update(grad_rel_err_same_forward=grad, update_rel_err_same_forward=update)
    check(grad <= LOGIT_TOL and update <= LOGIT_TOL, f"R(2+1)D-50 gradients {parity}")
    emit("r2plus1d_train_parity", **parity)
    del batch
    free_cuda(torch)
    emit("r2plus1d_train_timing", batch=spec["batch"],
         fit_clips_per_sec=train["result"].get("clips_per_sec"),
         fit_input_wait_frac=train["result"].get("input_wait_frac"),
         fit_epoch_train_s=train["result"].get("epoch_train_times"),
         **train_timing_phase(torch, spec))
    return rows


def spread(xs) -> dict:
    """Median and quartiles of `xs`."""
    q = np.percentile(np.asarray(xs, np.float64), [25, 50, 75])
    return {"median": float(q[1]), "p25": float(q[0]), "p75": float(q[2]),
            "n": len(xs)}


def overhead(base, other) -> dict:
    """`other` against `base`, paired by index (each pair timed side by side
    in one round): the spread of the differences in ms, the median one over
    the median of `base`, and `resolved`, whether the quartiles of the
    differences leave out 0 (else the spread covers the effect)."""
    diff = spread([o - b for b, o in zip(base, other)])
    return {"diff_ms": diff,
            "median_rel": diff["median"] / float(np.median(base)),
            "resolved": diff["p25"] > 0 or diff["p75"] < 0}


def armed_step_times(torch) -> dict:
    """ms of one optimizer step (B=8 x accumulation 2 of FEATURES_TRAIN's
    geometry, through the kernels) plain, with mixup/cutmix, and with
    mixup/cutmix and the guard's skip armed, on one model, batch and
    optimizer: ARMED_ROUNDS rounds of one synchronised step of each, the
    order turned every round, after two warm-up rounds (the second one
    finds the optimizer's state made). The costs are the paired per-round
    differences: mixed - plain, armed - mixed."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import make_train_step
    from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

    spec = FEATURES_TRAIN
    cfg = parse_cli(train_argv("unused", spec=spec))
    model = create_model(cfg.model, "bf16", seed=SEED, data_cfg=cfg.data).cuda()
    opt = build_optimizer(cfg.optim, 100, model.named_parameters())
    state = TrainState.create(model, opt, ema_decay=cfg.optim.ema_decay)
    micro = [train_batch(torch, SEED + 60 + i, spec) for i in range(spec["accum"])]
    batch = {k: torch.stack([m[k] for m in micro]) for k in micro[0]}
    del micro
    kinds = ("plain", "mix", "mix_guard")
    steps = {
        "plain": make_train_step(model, opt, accum_steps=spec["accum"],
                                 ema_decay=cfg.optim.ema_decay, dropout_seed=SEED),
        "mix": make_train_step(model, opt, accum_steps=spec["accum"],
                               ema_decay=cfg.optim.ema_decay, dropout_seed=SEED,
                               mixup_alpha=0.8, cutmix_alpha=1.0),
        "mix_guard": make_train_step(model, opt, accum_steps=spec["accum"],
                                     ema_decay=cfg.optim.ema_decay,
                                     dropout_seed=SEED, mixup_alpha=0.8,
                                     cutmix_alpha=1.0, guard_skip=True)}
    out = {k: [] for k in kinds}
    for r in range(ARMED_ROUNDS + 2):
        for k in kinds[r % 3:] + kinds[:r % 3]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            steps[k](state, batch)
            torch.cuda.synchronize()
            if r >= 2:
                out[k].append((time.perf_counter() - t) * 1e3)
    res = {f"step_ms_{k}": spread(v) for k, v in out.items()}
    res["mix_overhead"] = overhead(out["plain"], out["mix"])
    res["armed_guard_overhead"] = overhead(out["mix"], out["mix_guard"])
    res["step_ms_raw"] = out
    del steps, state, opt, model, batch
    free_cuda(torch)
    return res


def tracking_times(torch, work: str) -> dict:
    """fit()'s step time with jsonl tracking on and off, and with tracking
    on and the obs layer off: TRACKING_TRAIN's Trainers in the turns of
    TRACKING_ORDER, one process, each step's host-clock interval from its
    dispatch to the next one's (the loop reads each step's metrics one step
    late, so an interval is a step's time in the loop, its input wait and
    logging included), the first of each Trainer dropped; and each fit()'s
    clips/s. The "on" round's jsonl holds the obs keys, the "obs_off"
    round's none."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    out = {label: [] for label in TRACKING_ORDER}
    clips = {label: [] for label in TRACKING_ORDER}
    obs_keys = {}
    for i, label in enumerate(TRACKING_ORDER):
        logs = os.path.join(work, f"tracking_logs_{i}")
        extra = (["--tracking.with_tracking", "--tracking.trackers", "jsonl",
                  "--tracking.logging_dir", logs]
                 if label != "off" else [])
        if label == "obs_off":
            extra += ["--obs.enabled", "false"]
        tr = Trainer(parse_cli(train_argv(os.path.join(work, f"tracking_{i}"),
                                          spec=TRACKING_TRAIN) + extra))
        inner, stamps = tr.train_step, []

        def timed(state, batch, inner=inner, stamps=stamps):
            stamps.append(time.perf_counter())
            return inner(state, batch)

        tr.train_step = timed
        res = tr.fit()
        out[label] += list(np.diff(stamps)[1:] * 1e3)
        clips[label].append(res.get("clips_per_sec"))
        if label != "off":
            (name,) = os.listdir(logs)
            with open(os.path.join(logs, name)) as f:
                keys = set().union(*(json.loads(ln) for ln in f))
            obs_keys[label] = sorted(k for k in keys | set(res) if k.startswith("obs"))
        del tr, timed, inner
        free_cuda(torch)
    want = OBS_WINDOW_KEYS | OBS_EPOCH_KEYS | HEALTH_KEYS
    check(want <= set(obs_keys["on"]) and obs_keys["obs_off"] == [],
          f"obs keys with obs on {obs_keys['on']}, off {obs_keys['obs_off']}")
    res = {f"fit_step_ms_tracking_{k}": spread(v) for k, v in out.items()}
    # paired by position: the k-th steady step of an on run against the
    # k-th of the off run beside it
    res["tracking_overhead"] = overhead(out["off"], out["on"])
    res["obs_overhead"] = overhead(out["obs_off"], out["on"])
    res.update({f"fit_clips_per_sec_tracking_{k}": v for k, v in clips.items()})
    res["fit_clips_per_sec_obs_on"] = clips["on"]
    res["fit_clips_per_sec_obs_off"] = clips["obs_off"]
    res["fit_step_ms_raw"] = out
    return res


# the obs layer's keys a default (obs on) fit() logs: in its windows, on its
# epoch line, and the health gauges on its step lines
OBS_WINDOW_KEYS = {"obs/step_s", "obs/input_wait_s", "obs/h2d_s",
                   "obs/window_wall_s", "obs/unattributed_s"}
OBS_EPOCH_KEYS = {"obs_step_s", "obs_input_wait_frac", "obs_h2d_s"}
HEALTH_KEYS = {"obs/param_norm", "obs/update_ratio", "obs/nonfinite"}
# the health gauges against f32 norms the smoke recomputes, relative
HEALTH_REL = 1e-3


def health_reading(torch, state, before, m) -> dict:
    """Step metrics `m`'s health gauges against f32 norms recomputed from
    the parameters after the step and `before`, a copy taken before it."""
    after = [p.detach().float() for p in state.model.parameters()]
    pn = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(a) for a in after])))
    un = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(a - b) for a, b in zip(after, before)])))
    want_ratio = un / max(pn, 1e-12)
    got_pn, got_ratio = float(m["param_norm"]), float(m["update_ratio"])
    return {"param_norm": got_pn, "param_norm_f32": pn,
            "param_norm_rel_err": abs(got_pn - pn) / pn,
            "update_ratio": got_ratio, "update_ratio_f32": want_ratio,
            "update_ratio_rel_err": abs(got_ratio - want_ratio) / want_ratio,
            "nonfinite": float(m["nonfinite"])}


def ledger_reading(torch, ledger, state) -> dict:
    """The ledger's `train_state` against the bytes of the state's tensors
    (parameters, buffers, optimizer state, EMA), and its
    `pva_hbm_bytes_in_use` gauge against `torch.cuda.memory_allocated()`
    read just after it (no allocation between: both read the caching
    allocator's counter)."""
    tensors = (list(state.model.parameters()) + list(state.model.buffers())
               + [v for st in state.optimizer.opt.state.values() for v in st.values()
                  if torch.is_tensor(v)] + list((state.ema or {}).values()))
    in_use = ledger.registry.get("pva_hbm_bytes_in_use").value()
    allocated = torch.cuda.memory_allocated()
    snap = ledger.snapshot()
    return {"train_state_bytes": ledger.component_bytes("train_state"),
            "state_tensor_bytes": sum(t.numel() * t.element_size() for t in tensors),
            "pva_hbm_bytes_in_use": int(in_use), "memory_allocated": allocated,
            "pva_hbm_attributed_frac": ledger.registry.get(
                "pva_hbm_attributed_frac").value(),
            "components": snap["components"], "source": snap["source"],
            "peak_bytes": snap["peak_bytes"]}


def tree_bytes(torch, x) -> int:
    """Bytes of the tensors in a nested dict."""
    if isinstance(x, dict):
        return sum(tree_bytes(torch, v) for v in x.values())
    return x.numel() * x.element_size() if torch.is_tensor(x) else 0


def async_checkpoint_phase(torch, tr, train_step, out_dir: str) -> dict:
    """SlowFast-R50's full train state as fit() left it, saved once through
    an asynchronous Checkpointer and once through a synchronous one: the
    time each keeps the step thread (`save()`), and the async write until
    `wait()` returns. The async save restored is bitwise the sync one; then
    one `train_step` from each restore (the same batch): the loss within
    1e-6 relative (bitwise reported), the gradient norm within LOGIT_TOL
    (cuDNN's wgrad is not bitwise), the step counters alike."""
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer

    state = tr.state
    extra = {"kind": "step", "epoch": 0, "data_state": {"epoch": 0, "position": 0}}
    step = state.step
    out = {"state_bytes": tree_bytes(torch, state_leaves(state.state_dict()))}
    for label, use_async in (("async", True), ("sync", False)):
        ck = Checkpointer(os.path.join(out_dir, f"ckpt_{label}"), use_async=use_async)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(step, state, extra)
        t1 = time.perf_counter()
        ck.wait()
        out[label] = {"step_thread_s": t1 - t0, "until_wait_s": time.perf_counter() - t0,
                      "write_log": list(ck.write_log)}
        ck.close()
    files = {label: state_leaves(torch.load(
        os.path.join(out_dir, f"ckpt_{label}", str(step), "state.pt"),
        map_location="cpu", weights_only=True)) for label in ("async", "sync")}
    diff = unequal_leaves(torch, files["async"], files["sync"])
    check(not diff, f"the async checkpoint differs from the sync one at {diff[:4]}")
    batch = train_batch(torch, SEED + 62, FEATURES_TRAIN)
    batch = {k: torch.stack([v, v]) for k, v in batch.items()}  # accumulation 2
    resumed = {}
    for label in ("async", "sync"):
        _, got = Checkpointer(os.path.join(out_dir, f"ckpt_{label}")).restore(state)
        m = train_step(state, batch)
        resumed[label] = {"restored_step": got, "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]), "step_after": state.step}
    a, b = resumed["async"], resumed["sync"]
    check(abs(a["loss"] - b["loss"]) <= 1e-6 * abs(b["loss"])
          and a["restored_step"] == b["restored_step"] == step
          and a["step_after"] == b["step_after"] == step + 1
          and abs(a["grad_norm"] - b["grad_norm"]) <= LOGIT_TOL * abs(b["grad_norm"]),
          f"resumed from the async save {a}, from the sync one {b}")
    out.update(restored_bitwise=True, resumed=resumed,
               resumed_loss_bitwise=a["loss"] == b["loss"],
               async_step_thread_frac_of_sync=(out["async"]["step_thread_s"]
                                               / out["sync"]["step_thread_s"]))
    return out


def features_train_phase(torch, work: str, launches: dict) -> dict:
    """Phase 30. SlowFast-R50 at the reference geometry (32 frames at 256^2,
    bf16, B=8 x accumulation 2, 80 synthetic videos: 5 steps) through
    `Trainer` from run.py's parser with mixup 0.8 + cutmix 1.0, the EMA,
    the guard (LKG every step, rollback after 2 anomalies) and jsonl
    tracking every step. A wrapper around the train loader NaN-poisons its
    3rd and 4th batches (`poison_batch`). Checks: steps 3 and 4 report
    `skipped` 1; step 3 leaves the whole state (parameters, BN running
    averages, momentum, EMA) bitwise as it found it; observing step 4 the
    guard rolls back to its LKG of step 3, the restored state bitwise the
    ring's file, and the loader resumes at the 5th batch; fit() ends with a
    finite loss; launches exact (one forward and one dx per fused site per
    micro-step, the skipped and abandoned steps included, plus the eval
    forwards); the jsonl holds a start line, a line per logged step
    (train_loss_step, lr, grad_norm and the health gauges), the obs windows
    (`OBS_WINDOW_KEYS`), the epoch line (with `OBS_EPOCH_KEYS`) and an end
    line. With obs on (the default): step 1's `param_norm` within
    `HEALTH_REL` of an f32 norm of the parameters after it, its
    `update_ratio` within `HEALTH_REL` of one from a copy taken before it,
    `nonfinite` 0 on the healthy steps and 1 on the poisoned ones; before
    step 2 the ledger's `train_state` equals the bytes of the state's
    tensors and `pva_hbm_bytes_in_use` equals `torch.cuda.memory_allocated()`
    to the byte; the LKG ring's saves report their dispatch on the step
    thread and their whole write (`Checkpointer.write_log`). Then
    `async_checkpoint_phase` on the state fit() leaves. Counters zeroed
    just before fit(), read just after."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.obs import memory as obs_memory
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.reliability.guard import poison_batch
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    t0 = time.perf_counter()
    spec = FEATURES_TRAIN
    out_dir = os.path.join(work, "train_features")
    logs = os.path.join(out_dir, "logs")
    tr = Trainer(parse_cli(train_argv(out_dir, spec=spec)
                           + ["--tracking.logging_dir", logs]))
    seen = {"metrics": [], "positions": [], "takes": 0}
    inner = tr.train_prefetch

    class Poisoning:
        """The train prefetcher, its 3rd and 4th batches NaN-poisoned."""

        def pop_wait(self):
            return inner.pop_wait()

        def epoch(self, *a, **k):
            it = inner.epoch(*a, **k)
            try:
                for batch in it:
                    seen["takes"] += 1
                    seen["positions"].append(tr.train_loader.state.to_dict())
                    yield (poison_batch(batch) if seen["takes"] in POISONED_TAKES
                           else batch)
            finally:
                it.close()

    tr.train_prefetch = Poisoning()
    real_step, real_rollback = tr.train_step, tr._guard_rollback
    lkg_ckpt = tr.train_guard._checkpointer()  # its write_log outlives close()

    def step(state, batch):
        call = len(seen["metrics"]) + 1
        if call == POISONED_TAKES[0]:
            seen["before"] = cpu_state(state)
        if call == 1:
            seen["health_pre"] = [p.detach().float().clone()
                                  for p in state.model.parameters()]
        if call == 2:
            seen["ledger"] = ledger_reading(torch, obs_memory.get_ledger(), state)
        m = real_step(state, batch)
        seen["metrics"].append(m)
        if call == 1:
            seen["health"] = health_reading(torch, state, seen.pop("health_pre"), m)
        if call == POISONED_TAKES[0]:
            seen["after"] = cpu_state(state)
        return m

    def rollback(action):
        real_rollback(action)
        seen["rollback"] = (action, cpu_state(tr.state),
                            tr.train_loader.state.to_dict())

    tr.train_step, tr._guard_rollback = step, rollback
    fused.reset_launch_counts()
    t_fit = time.perf_counter()
    result = tr.fit()
    fit_s = time.perf_counter() - t_fit
    launches["features_train"] = counts = dict(fused.LAUNCHES)

    skipped = [m["skipped"].item() for m in seen["metrics"]]
    losses = [m["loss"].item() for m in seen["metrics"]]
    want_skipped = [1.0 if i + 1 in POISONED_TAKES else 0.0
                    for i in range(len(skipped))]
    check(skipped == want_skipped, f"skipped per step {skipped}")
    step_keep = unequal_leaves(
        torch, {k: v for k, v in seen["after"].items() if k != "step"},
        {k: v for k, v in seen["before"].items() if k != "step"})
    check(not step_keep and seen["after"]["step"] == seen["before"]["step"] + 1,
          f"the skipped step changed {step_keep[:4]}")
    check("rollback" in seen, "the guard did not roll back")
    action, restored, resumed = seen["rollback"]
    guard = tr.train_guard
    lkg_file = state_leaves(torch.load(
        os.path.join(out_dir, "guard_lkg", str(action.lkg_step), "state.pt"),
        map_location="cpu", weights_only=True))
    ring_diff = unequal_leaves(torch, restored, lkg_file)
    check(action.lkg_step == POISONED_TAKES[0] and guard.rollbacks == 1
          and guard.skips == 1 and not ring_diff,
          f"rollback to {action.lkg_step}, rollbacks {guard.rollbacks}, skips "
          f"{guard.skips}, restored state differs from the ring at {ring_diff[:4]}")
    check(resumed == {"epoch": 0, "position": POISONED_TAKES[1]}
          and seen["positions"][-1] == {"epoch": 0,
                                        "position": POISONED_TAKES[1] + 1},
          f"loader after the rollback {resumed}, positions {seen['positions']}")
    n_steps = spec["videos"] // (spec["batch"] * spec["accum"])
    check(len(seen["metrics"]) == n_steps + 1 and result["steps"] == n_steps - 1,
          f"steps dispatched {len(seen['metrics'])}, state step {result['steps']}")
    check(np.isfinite(result["train_loss"]), f"fit() loss {result['train_loss']}")
    micro = len(seen["metrics"]) * spec["accum"]
    evals = -(-max(spec["videos"] // 4, 4) // spec["batch"])
    per_forward = expected_forward_launches("slowfast_r50")
    want = {k: per_forward.get(k.split(".")[0], 0)
            * (micro if is_backward(k) else micro + evals) for k in SOURCES}
    check(counts == want, f"features_train launches {counts}, expected {want}")

    (log_name,) = os.listdir(logs)
    with open(os.path.join(logs, log_name)) as f:
        lines = [json.loads(ln) for ln in f]
    step_lines = [ln for ln in lines if "train_loss_step" in ln]
    epoch_lines = [ln for ln in lines if "train_loss_epoch" in ln]
    obs_lines = [ln for ln in lines if "train_loss_step" not in ln
                 and any(k.startswith("obs/") for k in ln)]
    check(lines[0].get("event") == "start" and lines[-1].get("event") == "end"
          and [ln["step"] for ln in step_lines] == [1, 2, 3, 4, 4]
          and all({"lr", "grad_norm", *HEALTH_KEYS} <= set(ln) for ln in step_lines)
          and len(epoch_lines) == 1
          and len(lines) == len(step_lines) + len(obs_lines) + 3,
          f"jsonl lines {[sorted(ln) for ln in lines]}")
    obs_keys = set().union(*obs_lines) if obs_lines else set()
    check(OBS_WINDOW_KEYS <= obs_keys and OBS_EPOCH_KEYS <= set(epoch_lines[0]),
          f"obs keys {sorted(obs_keys)}, epoch line {sorted(epoch_lines[0])}")
    nonfinite = [ln["obs/nonfinite"] for ln in step_lines]
    check(nonfinite == [0.0, 0.0, 1.0, 1.0, 0.0],
          f"nonfinite per logged step {nonfinite}")
    health, ledger = seen["health"], seen["ledger"]
    check(health["param_norm_rel_err"] <= HEALTH_REL
          and health["update_ratio_rel_err"] <= HEALTH_REL
          and health["nonfinite"] == 0.0, f"health gauges of step 1: {health}")
    check(ledger["train_state_bytes"] == ledger["state_tensor_bytes"]
          and ledger["pva_hbm_bytes_in_use"] == ledger["memory_allocated"],
          f"ledger before step 2: {ledger}")
    lkg_writes = list(lkg_ckpt.write_log)
    check(len(lkg_writes) >= 2 and all("write_s" in w for w in lkg_writes),
          f"LKG writes {lkg_writes}")
    bundle = guard.last_rollback["bundle"]
    fields = {
        "fit_s": fit_s, "result": result, "losses": losses, "skipped": skipped,
        "launches": counts, "expected_launches": want,
        "micro_steps": micro, "eval_forwards": evals,
        "rollback": guard.last_rollback, "lkg_ring": guard.ring_steps(),
        "replay_bundle_files": sorted(os.listdir(bundle)) if bundle else [],
        "jsonl_lines": len(lines), "restored_bitwise_ring": True,
        "skipped_step_state_bitwise": True, "health_step1": health,
        "health_rel_tolerance": HEALTH_REL, "nonfinite_per_step": nonfinite,
        "ledger_before_step2": ledger, "obs_keys": sorted(obs_keys),
        "epoch_obs": {k: epoch_lines[0][k] for k in sorted(OBS_EPOCH_KEYS)},
        "lkg_save": {"dispatch_s": spread([w["dispatch_s"] for w in lkg_writes]),
                     "fence_s": spread([w["fence_s"] for w in lkg_writes]),
                     "write_s": spread([w["write_s"] for w in lkg_writes]),
                     "saves": lkg_writes}}
    fields["async_checkpoint"] = async_checkpoint_phase(torch, tr, real_step, out_dir)
    # the wrappers and the bound `_guard_rollback` close a cycle through the
    # Trainer: drop them all, so its state (and the guard's snapshot) go now
    del (tr, seen, restored, lkg_file, step, rollback, real_step, real_rollback,
         guard, action, inner, lkg_ckpt)
    free_cuda(torch)

    # the same micro-step with a fixed mix (a mixup and a cutmix draw)
    # through the kernels and through plain PyTorch, the forward held fixed
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import MixDraw

    batch = train_batch(torch, SEED + 61)
    for label, draw in (("mixup", MixDraw(False, 0.7)),
                        ("cutmix", MixDraw(True, 0.6, 0.3, 0.7))):
        grad, update = fixed_forward_parity(torch, "auto", batch, SLOWFAST_TRAIN,
                                            mix=draw)
        check(grad <= LOGIT_TOL and update <= LOGIT_TOL,
              f"{label} gradients {grad}, update {update}")
        fields.update({f"{label}_draw": str(draw),
                       f"{label}_grad_rel_err_same_forward": grad,
                       f"{label}_update_rel_err_same_forward": update})
    fields["rel_tolerance"] = LOGIT_TOL
    del batch
    free_cuda(torch)
    fields.update(armed_step_times(torch))
    fields.update(tracking_times(torch, work))
    fields["seconds"] = time.perf_counter() - t0
    return fields


def remat_train_phase(torch, launches: dict) -> dict:
    """Phase 31. hub mvit_base_32x3 (32 frames x stride 3 at 224^2, drop
    path 0.3, `attention pallas, depthwise_impl pallas`, bf16): B=4
    micro-steps with `--model.remat` and without, on the same weights,
    batch and drop-path seeds, cuDNN deterministic. Per run: ms per
    micro-step, peak memory, the launches of one micro-step (counters
    zeroed just before it; under remat the forward kernels run again in the
    backward: 2 x 16 flash forwards, 2 x 4 `depthwise3d_s1`; 16 dq, 16 dk/dv
    and 4 depthwise dx either way). The loss must be bitwise equal; the
    gradients equal bitwise or within 1e-2 (relative 2-norm), and the phase
    says which held. A run without remat that does not fit prints its OOM
    and the largest batch that fits."""
    from pytorchvideo_accelerate_tpu_torch.models.common import SeededDropout
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    t0 = time.perf_counter()
    free_cuda(torch)
    out = {"live_mem_gb_at_start": torch.cuda.memory_allocated() / 1e9}
    batch = train_batch(torch, SEED + 70, REMAT_TRAIN)
    mvit = expected_mvit_launches()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out.update(batch=REMAT_TRAIN["batch"], cudnn_deterministic=True)
    runs = {}
    try:
        for label, extra in (("remat", ["--model.remat"]), ("no_remat", [])):
            spec = dict(REMAT_TRAIN, argv=REMAT_TRAIN["argv"] + extra)
            model = fn = oom = None
            try:
                model, _, fn = micro_step_fn(torch, "off", batch, spec)
                for i, d in enumerate(m for m in model.modules()
                                      if isinstance(m, SeededDropout)):
                    d.reseed(SEED + 1000 + i)  # the same drop paths
                fused.reset_launch_counts()
                loss = fn()
                torch.cuda.synchronize()
                counts = {k: v for k, v in fused.LAUNCHES.items() if v}
                runs[label] = (loss.item(), torch.cat(
                    [p.grad.float().flatten() for p in model.parameters()]))
                timed = micro_step_times(torch, fn)
            except torch.cuda.OutOfMemoryError as e:
                oom = str(e).splitlines()[0]
            if oom is not None:  # the traceback's tensors are released here
                model = fn = None
                free_cuda(torch)
                out[f"{label}_oom"] = oom
                out[f"{label}_largest_batch"] = largest_batch(torch, spec)
                continue
            scale = 2 if label == "remat" else 1
            want = {"flash_attention": scale * mvit["flash_attention"],
                    "flash_attention.bwd_dq": mvit["flash_attention"],
                    "flash_attention.bwd_dkv": mvit["flash_attention"],
                    "depthwise3d_s1": scale * mvit["depthwise3d_s1"],
                    "depthwise3d_s1.bwd_dx": mvit["depthwise3d_s1"]}
            check(counts == want, f"{label} launches {counts}, expected {want}")
            out[label] = {"launches_per_micro_step": counts, **timed}
            if label == "remat":
                launches["remat_train"] = counts
            del model, fn
            free_cuda(torch)
        out["drop_path0"] = remat_without_drop_path(torch, batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check("remat" in out, "the remat micro-step did not run")
    if "no_remat" in runs:
        (lr_, gr), (ln_, gn) = runs["remat"], runs["no_remat"]
        out["loss_remat"], out["loss_no_remat"] = lr_, ln_
        check(lr_ == ln_, f"remat loss {lr_} != {ln_}")
        out["grad_bitwise"] = bool(torch.equal(gr, gn))
        out["grad_rel_err"] = rel_err(gr, gn)
        check(out["grad_bitwise"] or out["grad_rel_err"] <= KERNEL_TOL,
              f"remat gradient differs by {out['grad_rel_err']}")
        out["peak_mem_saved_gb"] = (out["no_remat"]["peak_mem_gb"]
                                    - out["remat"]["peak_mem_gb"])
    del runs, batch
    free_cuda(torch)
    out["seconds"] = time.perf_counter() - t0
    return out


def remat_without_drop_path(torch, batch) -> dict:
    """One micro-step of `remat_train`'s model with and without remat, every
    drop path at rate 0 (no generator to rewind in the recompute): the loss
    and gradient gap that remains is the recompute's own, not the drop-path
    masks'. Reported, not held: it tells the two suspects of remat's
    gradient gap apart."""
    from pytorchvideo_accelerate_tpu_torch.models.common import DropPath

    runs = {}
    for label, extra in (("remat", ["--model.remat"]), ("no_remat", [])):
        spec = dict(REMAT_TRAIN, argv=REMAT_TRAIN["argv"] + extra)
        model, _, fn = micro_step_fn(torch, "off", batch, spec)
        for m in model.modules():
            if isinstance(m, DropPath):
                m.rate = 0.0
        loss = fn()
        torch.cuda.synchronize()
        runs[label] = (loss.item(), torch.cat(
            [p.grad.float().flatten() for p in model.parameters()]))
        del model, fn, loss
        free_cuda(torch)
    (lr_, gr), (ln_, gn) = runs["remat"], runs["no_remat"]
    check(np.isfinite(lr_) and np.isfinite(ln_), f"drop path 0 losses {lr_} {ln_}")
    return {"loss_remat": lr_, "loss_no_remat": ln_, "loss_bitwise": lr_ == ln_,
            "grad_bitwise": bool(torch.equal(gr, gn)), "grad_rel_err": rel_err(gr, gn)}


def largest_batch(torch, spec: dict) -> int:
    """The largest batch below `spec`'s whose micro-step fits, 0 if none."""
    for b in range(spec["batch"] - 1, 0, -1):
        small = dict(spec, batch=b)
        fits = True
        try:
            model, _, fn = micro_step_fn(torch, "off",
                                         train_batch(torch, SEED + 71, small), small)
            fn()
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            fits = False
        model = fn = None
        free_cuda(torch)
        if fits:
            return b
    return 0


def real_video_route(torch, work: str) -> dict:
    """Phase 29. With cv2 on this machine: 4 mp4s written with cv2 (seeded
    frames, 48x64, 30 fps), cached by the port's `build_cache`, and one
    clip read back through `FrameCache` byte-equal to `decode_span`.
    Without it: `Trainer` on a `--data_dir` tree raises
    `NoVideoDecoderError`, and its message names the frame-cache route."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.data import decode
    from pytorchvideo_accelerate_tpu_torch.data.cache import FrameCache, build_cache
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    root = os.path.join(work, "real_videos")
    rng = np.random.default_rng(SEED + 50)
    cv2 = decode.cv2
    paths = [os.path.join(root, split, cls, "v0.mp4")
             for split in ("train", "val") for cls in ("a", "b")]
    for path in paths:
        os.makedirs(os.path.dirname(path))
    if cv2 is None:
        for path in paths:  # scanned, never decoded
            open(path, "wb").close()
        try:
            Trainer(parse_cli(["--data_dir", root, "--model.name", "r2plus1d_r50",
                               "--output_dir", os.path.join(work, "no_cv2")]))
        except decode.NoVideoDecoderError as e:
            msg = str(e)
        else:
            msg = ""
        check("--data.cache_dir" in msg and "data.cache build" in msg,
              f"without cv2, --data_dir raised {msg!r}")
        return {"route": "no_cv2", "cv2": None, "error": msg}
    for path in paths:
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (64, 48))
        check(w.isOpened(), f"cv2 cannot write {path}")
        for _ in range(24):
            w.write(rng.integers(0, 256, (48, 64, 3), np.uint8))
        w.release()
    index = build_cache(os.path.join(root, "train"), os.path.join(work, "real_cache"),
                        num_workers=2)
    cache = FrameCache(os.path.join(work, "real_cache"))
    got = cache.read(0, 0.2, 0.5).copy()  # a view of the memmap until copied
    cache.close()
    want = decode.decode_span(index["videos"][0]["path"], 0.2, 0.5)
    check(got.shape == want.shape and bool((got == want).all()),
          "cached clip differs from decode_span")
    return {"route": "cv2", "cv2": cv2.__version__, "videos": len(index["videos"]),
            "clip_shape": list(got.shape), "byte_equal": True,
            "quarantine": quarantine_route(torch, work, root)}


def quarantine_route(torch, work: str, root: str) -> dict:
    """A list manifest of the route's two train mp4s and one corrupt
    `.mp4`, trained on the card for 2 epochs of one batch (tiny3d, plain
    lowering: this checks the data path) with `--guard.enabled
    --guard.quarantine_budget 1`: fit() finishes, the sidecar names the
    corrupt file, and in the second epoch the source is never asked for its
    index and the file is never opened."""
    from pytorchvideo_accelerate_tpu_torch import run as trun
    from pytorchvideo_accelerate_tpu_torch.data import decode
    from pytorchvideo_accelerate_tpu_torch.data import pipeline

    bad = os.path.join(root, "train", "a", "corrupt.mp4")
    with open(bad, "wb") as f:
        f.write(b"not a video container" * 8)
    lists = {}
    for split, names in (("train", ["train/a/v0.mp4", "train/b/v0.mp4",
                                    "train/a/corrupt.mp4"]),
                         ("val", ["val/a/v0.mp4", "val/b/v0.mp4"])):
        lists[split] = os.path.join(work, f"quarantine_{split}.txt")
        with open(lists[split], "w") as f:
            f.writelines(f"{n} {i % 2}\n" for i, n in enumerate(names))
    out = os.path.join(work, "quarantine_run")
    seen, asked = [], []
    epoch_of = [None]
    real_get, real_probe, real_span = (pipeline.VideoClipSource.get,
                                       decode.probe, decode.decode_span)

    def get(self, index, epoch):
        if self.training:
            asked.append((epoch, index))
            epoch_of[0] = epoch
        return real_get(self, index, epoch)

    def probe(path):
        seen.append((epoch_of[0], os.path.basename(path)))
        return real_probe(path)

    def span(path, *a, **k):
        seen.append((epoch_of[0], os.path.basename(path)))
        return real_span(path, *a, **k)

    pipeline.VideoClipSource.get, decode.probe, decode.decode_span = get, probe, span
    try:
        result = trun.main([
            "--data_dir", root, "--data.train_list", lists["train"],
            "--data.val_list", lists["val"], "--model.name", "tiny3d",
            "--model.fused_kernels", "xla", "--num_frames", "4",
            "--sampling_rate", "2", "--data.crop_size", "32",
            "--data.min_short_side_scale", "48",
            "--data.max_short_side_scale", "48", "--batch_size", "3",
            "--num_epochs", "2", "--num_workers", "2", "--guard.enabled",
            "--guard.quarantine_budget", "1", "--reliability.decode_retries",
            "1", "--output_dir", out])
    finally:
        pipeline.VideoClipSource.get, decode.probe, decode.decode_span = (
            real_get, real_probe, real_span)
    with open(os.path.join(out, "quarantine.json")) as f:
        sidecar = json.load(f)
    bad_index = 2
    check(result["steps"] == 2 and np.isfinite(result["train_loss"])
          and list(sidecar["quarantined"]) == [bad]
          and result["quarantined_clips"] == 1,
          f"quarantine run {result}, sidecar {sidecar}")
    check((0, bad_index) in asked and (1, bad_index) not in asked
          and (1, "corrupt.mp4") not in seen and (0, "corrupt.mp4") in seen,
          f"asked {asked}, opened {seen}")
    return {"steps": result["steps"], "train_loss": result["train_loss"],
            "sidecar": sidecar, "asked": asked,
            "opened_corrupt_in_epochs": sorted({e for e, n in seen
                                                if n == "corrupt.mp4"})}


# --- slice 11: the serving defaults (EDF scheduler, int8, /metrics,
# /drain) and the preemption grace path --------------------------------------
# run.py preempted by SIGTERM on full-width SlowFast-R50 at the reference
# geometry: 6 steps of B=4, a checkpoint every 3 steps, one epoch. SGD at
# lr 0.01: at 0.1 the seeded run diverges (a CPU rehearsal at 8x64^2: loss
# 7.0 -> 107.6 in 3 steps), and a diverging run amplifies the last-bit
# differences between two runs of cuDNN's wgrad beyond any loss tolerance.
# The log of step n prints after step n + 1 is dispatched, just before that
# step's checkpoint and the guard's poll: a SIGTERM sent on it stops the run
# at step n + 1 when that step saves (the save outlasts the signal's
# delivery), else at n + 2. With checkpoints every 2 steps every stop lands
# on a boundary, where the grace path finds the step on disk and saves
# nothing; every 3, a signal at step 3's line stops at 4 or 5, off the
# boundary, so the `preempt` save itself runs
PREEMPT_TRAIN = dict(SLOWFAST_TRAIN, batch=4, accum=1, epochs=1, videos=24,
                     ckpt_every=3, lr=TRANSFORMER_LR)
PREEMPT_AT_LINE = 3  # SIGTERM once the child's log shows this step
# the gate of the JAX package's int8 serving (tests/test_zquant.py): top-1
# agreement with fp serving, held; its absolute logit bound, reported. It
# was set on a tiny trained net whose logits are O(0.1); at the planted
# logits here (|logit| up to 6) int8's rounding alone, in weights
# byte-equal to the JAX package's, moves full-width logits further (CPU
# runs at reduced geometry: 0.052-0.070; the card: 0.106 for SlowFast-R50)
INT8_ATOL, INT8_TOP1 = 5e-2, 0.75
# what is held instead of the absolute bound: the largest int8 logit
# difference from fp within INT8_REL * (1 + the largest |fp logit|), a bound
# that scales with the logits as int8's rounding error does (an H100 80GB:
# 0.106 at |fp| 6.0 and 0.056 at 10.3, against bounds of 0.35 and 0.57)
INT8_REL = 5e-2
# a child process running run.main, as `python -m ...run` does, that prints
# its result and launch counts last
TRAIN_CHILD = (
    "import json, sys\n"
    "import chip_smoke\n"
    "chip_smoke.await_go(sys.argv[1])\n"
    "from pytorchvideo_accelerate_tpu_torch import run\n"
    "from pytorchvideo_accelerate_tpu_torch.ops import fused\n"
    "result = run.main(sys.argv[2:])\n"
    "print('CHILD_RESULT ' + json.dumps({'result': result, "
    "'launches': dict(fused.LAUNCHES)}, default=str), flush=True)\n")


def await_go(go: str) -> None:
    """In a child started ahead of its turn (the smoke starts a phase's
    child processes together, each waiting for the one before it): load
    the card's context, cuBLAS and cuDNN while the parent's earlier work
    runs, then wait for the parent's `go` file. The child leaves when its
    parent has gone (a failed phase ends the smoke)."""
    import torch

    parent = os.getppid()
    x = torch.ones(1, 8, 2, 4, 4, device="cuda")
    y = torch.nn.functional.conv3d(x, torch.ones(8, 8, 1, 1, 1, device="cuda"))
    (y.flatten(1) @ y.flatten(1).t()).sum().item()
    del x, y
    while not os.path.exists(go):
        if os.getppid() != parent:
            sys.exit(1)
        time.sleep(0.2)


def go(path: str) -> None:
    """Let the child processes waiting on `path` run (`await_go`)."""
    open(path, "w").close()


def kill_waiting(groups) -> None:
    """Kill the child processes of `groups` (lists of Popen) still alive:
    those started ahead of a turn that a failure ended."""
    for procs in groups:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def http(url: str, body: bytes = None, timeout: float = 600.0, headers=None):
    """(status, headers, body bytes, client ms) of a GET (no body) or POST,
    error statuses included."""
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, headers, data = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, headers, data = e.code, e.headers, e.read()
    return status, headers, data, (time.perf_counter() - t0) * 1e3


def with_keys(body: bytes, **keys) -> bytes:
    """A JSON object body with `keys` added in front (the clip lists stay
    as they were serialised once)."""
    if not keys:
        return body
    return json.dumps(keys)[:-1].encode() + b"," + body[1:]


def metric_value(text: str, series: str) -> float:
    """The value of `series` (name and labels) in Prometheus text."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    raise KeyError(series)


def quantiles(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99)),
            "n": len(xs)} if len(xs) else {"n": 0}


# realtime requests of edf_serve, one at a time (4 before the library-mesh
# phase)
EDF_REALTIME = 2


def edf_serve_phase(torch, work: str, art: str, clips, plain_logits,
                    launches: dict) -> dict:
    """Phase 33. The SlowFast-R50 artifact of phase 3 served by
    `build_server` with no `--serve.scheduler` flag (the EDF scheduler):
    8 batch-class requests sent concurrently (the 5 request clips and 3 of
    them again), `EDF_REALTIME` realtime requests one at a time, then one realtime
    request whose `deadline_ms` is half the scheduler's measured service
    time of bucket 1. Checks: every answered request's logits against the
    plain path (5e-2 * (1 + |plain|), top-1 on decisive rows); the
    short-deadline request answers 503 + Retry-After and is the one shed in
    /stats and /metrics; /metrics counts and the latency histogram's count
    equal the requests answered; 41 pointwise and 51 conv launches per
    forward (counters zeroed just before the server is built, the warm-up
    forwards included); POST /drain turns /healthz to 503. With obs on (the
    default): /metrics carries `pva_hbm_bytes{component="model_weights:
    slowfast_r50"}`, the engine's resident bytes; GET /history answers 200
    with series for the request counters (polled until the server's
    ticker has ticked after the requests); a server built with
    `--obs.enabled false` (bucket 1 only, after the counters are read)
    answers 503 on /history. Slice 19 (tracing armed at a head-sampling
    rate, `EDF_TRACE_RATE`, that the seed's draws sample none of the
    phase's requests at, so the one that carries a `traceparent` is the
    one traced): before the last realtime request, POST /profile?seconds=S
    (S = `EDF_PROFILE_S`, or twice the realtime request before it plus 1 s
    where that is longer: the window must outlast the request's JSON
    parse) answers 202 and a second one at once 409; that request carries a `traceparent` and gets back
    `x-pva-trace-id` equal to its trace id; the published window holds at
    least one bucket forward's launches of rows 1 and 2; /stats
    `slowest_traces` names the trace, and the ring, dumped by
    `InferenceServer.drain`, holds its `http_predict` (a child of the
    caller's span), `sched_wait` and `device_dispatch`."""
    from pytorchvideo_accelerate_tpu_torch import obs
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.serving.server import build_server

    bodies = request_bodies(clips)
    out = os.path.join(work, "edf_serve")
    remote = obs.trace.TraceContext("%032x" % (SEED + 19), "%016x" % (SEED + 19))
    order = [i % len(clips) for i in range(BUCKET)]
    free_cuda(torch)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    # the batch class coalesces for up to max_wait_ms: long enough for the 8
    # concurrent requests' JSON to parse, and their deadline beyond it
    server = build_server(parse_cli([
        "--serve.checkpoint", art, "--serve.port", "0",
        "--serve.max_wait_ms", "20000", "--serve.batch_deadline_ms", "60000",
        "--obs.trace_sample_rate", str(EDF_TRACE_RATE), "--output_dir", out]))
    check(isinstance(server.batcher, Scheduler),
          f"default front is {type(server.batcher).__name__}, not the Scheduler")
    server.start()
    try:
        build_s = time.perf_counter() - t0
        host, port = server.address
        base = f"http://{host}:{port}"
        with ThreadPoolExecutor(max_workers=BUCKET) as pool:
            batch_resp = list(pool.map(
                lambda i: http(base + "/predict", with_keys(bodies[i], priority="batch")),
                order))
        rt_resp = [http(base + "/predict", with_keys(bodies[i], priority="realtime"))
                   for i in range(EDF_REALTIME - 1)]
        # the last realtime request inside a profile window, traced: the
        # window outlasts the request's client time (its JSON parse)
        window_s = max(EDF_PROFILE_S, round(2 * rt_resp[-1][3] / 1e3 + 1, 1))
        prof = http(base + f"/profile?seconds={window_s}", b"")
        busy = http(base + f"/profile?seconds={window_s}", b"")
        rt_resp.append(http(base + "/predict", with_keys(
            bodies[EDF_REALTIME - 1], priority="realtime"),
            headers={"traceparent": obs.trace.format_traceparent(remote)}))
        obs.profiler.get_profiler().join(timeout=120)
        svc_ms = server.batcher._estimate_s(1) * 1e3
        deadline_ms = max(svc_ms / 2, 1.0)
        shed = http(base + "/predict", with_keys(bodies[4], priority="realtime",
                                                 deadline_ms=deadline_ms))
        stats = json.loads(http(base + "/stats")[2])
        metrics = http(base + "/metrics")[2].decode()
        history = history_after(base, len(batch_resp) + len(rt_resp))
        drain_code, _, drain_body, _ = http(base + "/drain", b"{}")
        health_code = http(base + "/healthz")[0]
    finally:
        server.drain(grace_s=10)  # closes, and dumps the trace ring
        obs.trace.disable_tracing()
    counts = dict(fused.LAUNCHES)
    answered = batch_resp + rt_resp
    check(all(r[0] == 200 for r in answered),
          f"edf_serve HTTP codes {[r[0] for r in answered]}")
    payloads = [json.loads(r[2]) for r in answered]
    served = np.stack([np.asarray(p["logits"], np.float32) for p in payloads])
    want = plain_logits[order + list(range(EDF_REALTIME))]
    held = hold_logits(served, want, "edf_serve")
    check(shed[0] == 503 and int(shed[1]["Retry-After"]) >= 1,
          f"short-deadline request answered {shed[0]}")
    n = len(answered)
    check(stats["shed"] == 1.0 and stats["requests"] == n,
          f"/stats shed {stats['shed']}, requests {stats['requests']} (answered {n})")
    check(metric_value(metrics, 'pva_serving_shed_total{state="deadline"}') == 1.0
          and metric_value(metrics, "pva_serving_requests_total") == n
          and metric_value(metrics, "pva_serving_request_latency_seconds_count") == n,
          "/metrics counts differ from the requests answered and shed")
    check(drain_code == 200 and json.loads(drain_body)["draining"]
          and health_code == 503, f"/drain {drain_code}, then /healthz {health_code}")
    observed = edf_observe_checks(out, prof, busy, rt_resp[-1], stats, remote)
    observed["window_s"] = window_s
    forwards = len(server.engine.buckets) + int(stats["batches"])
    check_launches(counts, expected_forward_launches("slowfast_r50"), forwards,
                   "edf_serve")
    launches["edf_serve"] = counts
    weights = metric_value(metrics, 'pva_hbm_bytes{component="model_weights:slowfast_r50"}')
    check(weights == resident_bytes(server.engine.model),
          f"ledger weights {weights}, resident {resident_bytes(server.engine.model)}")
    off = build_server(parse_cli([
        "--serve.checkpoint", art, "--serve.port", "0", "--serve.max_batch_size", "1",
        "--obs.enabled", "false"])).start()
    try:
        host, port = off.address
        history_off = http(f"http://{host}:{port}/history")[0]
    finally:
        off.close()
    check(history_off == 503, f"/history with obs off answered {history_off}")
    server_ms = [p["latency_ms"] for p in payloads]
    return dict(
        model="slowfast_r50", server_build_s=build_s, buckets=list(server.engine.buckets),
        requests={"batch": len(batch_resp), "realtime": len(rt_resp), "shed": 1},
        batch_http=[r[0] for r in batch_resp], realtime_http=[r[0] for r in rt_resp],
        shed_http=shed[0], shed_retry_after=shed[1]["Retry-After"],
        shed_error=json.loads(shed[2])["error"],
        bucket1_service_ms_ewma=svc_ms, shed_deadline_ms=deadline_ms,
        client_ms={"batch": quantiles([r[3] for r in batch_resp]),
                   "realtime": quantiles([r[3] for r in rt_resp])},
        server_ms={"batch": quantiles(server_ms[:len(batch_resp)]),
                   "realtime": quantiles(server_ms[len(batch_resp):])},
        forwards=forwards, scheduler_batches=stats["batches"],
        bucket_fill=stats["batch_fill_ratio"], launches=counts,
        launches_per_forward={k: v / forwards for k, v in counts.items() if v},
        stats=stats, drain_http=drain_code, healthz_after_drain=health_code,
        hbm_weight_bytes=weights, hbm_bytes_in_use=metric_value(
            metrics, "pva_hbm_bytes_in_use"),
        hbm_attributed_frac=metric_value(metrics, "pva_hbm_attributed_frac"),
        history=history, history_obs_off_http=history_off, observe=observed,
        **held)


def edf_observe_checks(out: str, prof, busy, traced, stats: dict, remote) -> dict:
    """edf_serve's slice-19 checks (its docstring) on the /profile replies,
    the traced request's reply, /stats and the dumped trace ring."""
    check(prof[0] == 202 and json.loads(prof[2])["capturing"] and busy[0] == 409,
          f"POST /profile answered {prof[0]}, then {busy[0]}")
    tag = json.loads(prof[2])["tag"]
    echo = traced[1]["x-pva-trace-id"]
    check(echo == remote.trace_id, f"x-pva-trace-id {echo}, sent {remote.trace_id}")
    window = window_launches(os.path.join(out, f"profile_{tag}", "trace.json"))
    got = {k: window["kernels_by_class"].get(k, 0) for k in SITES_PER_FORWARD}
    check(all(got[k] >= n for k, n in SITES_PER_FORWARD.items()),
          f"the /profile window's kernels {got}, expected at least "
          f"{SITES_PER_FORWARD}; the window: {window}, the request's client "
          f"ms {traced[3]}")
    slowest = [s["trace_id"] for s in stats.get("slowest_traces", [])]
    check(remote.trace_id in slowest, f"/stats slowest_traces {slowest}")
    with open(os.path.join(out, "trace_ring.json")) as f:
        ring = json.load(f)["traceEvents"]
    mine = {e["name"]: e["args"] for e in ring
            if e["args"]["trace_id"] == remote.trace_id}
    check({"http_predict", "sched_wait", "device_dispatch"} <= set(mine)
          and mine["http_predict"].get("parent_id") == remote.span_id,
          f"the traced request's events {mine}")
    return {"profile_http": prof[0], "profile_busy_http": busy[0], "tag": tag,
            "window": {"launches": got, **window}, "trace_id": echo,
            "trace_events": sorted(mine), "slowest_traces": slowest,
            "ring_events": len(ring)}


# the request counters a served /history carries series for
HISTORY_KEYS = ("pva_serving_requests_total", "pva_serving_batches_total")


def history_after(base: str, answered: int, timeout_s: float = 10.0) -> dict:
    """GET /history?keys=HISTORY_KEYS until its last requests tick counts
    `answered` (the server's ticker ticks once a second); its occupancy and
    the series' lengths and last values."""
    deadline = time.perf_counter() + timeout_s
    while True:
        code, _, body, _ = http(base + "/history?keys=" + ",".join(HISTORY_KEYS))
        body = json.loads(body)
        series = body.get("series", {})
        req = series.get(HISTORY_KEYS[0]) or [[0, 0]]
        if code == 200 and req[-1][1] >= answered and all(series.get(k) for k in HISTORY_KEYS):
            break
        check(time.perf_counter() < deadline, f"/history {code}: {body}")
        time.sleep(0.25)
    return {"http": code, "occupancy": body["occupancy"],
            "series_points": {k: len(v) for k, v in series.items()},
            "last": {k: v[-1][1] for k, v in series.items()},
            "alerts_active": body.get("alerts_active")}


# the streaming phase: sessions (streaming/engine.py) on three families
STREAM_SESSIONS = 4  # arm (a): SlowFast-R50 sessions over HTTP
STREAM_ENGINE_SESSIONS = 2  # arms (b)-(d): sessions a ring kind
# frames per advance: SlowFast-R50 a multiple of alpha, VideoMAE-B of its
# tubelet (2), MViT-B aligned to its (3,7,7)/(2,4,4) stem with a halo of 1
STREAM_STRIDE = {"slowfast_r50": 8, "videomae_b": 2, "mvit_b": 4}
# ring wraparounds each family advances through (MViT-B: one; SlowFast-R50
# over HTTP: one and a quarter, 5 advances, so the last 4 are steady ones;
# its JSON parse sets the arm's time: cut from 2 wraps to make room)
STREAM_WRAPS = {"slowfast_r50": 1.25, "videomae_b": 2, "mvit_b": 1}
# arm (a)'s session budget: a SlowFast-R50 session's rings are 32 + 8
# frames of 256^2 u8 (7.86 MB), so 4 fit and a 5th is refused (503)
STREAM_BUDGET_MB = 32
# session budgets of the engine arms: room for their 2 sessions (a
# VideoMAE-B K/V session is 62.6 MB in bf16, 33.9 MB in int8)
STREAM_ENGINE_BUDGET_MB = {"tokens": 64, "causal": 130, "causal_int8": 70, "stem": 32}
STREAM_TIMING_REPS = 3  # advance / full_recompute calls timed a family
# the kernel rows stream_serve runs: rows 1-2 in SlowFast-R50's dual rings,
# row 4 in MViT-B's pools, row 5 in VideoMAE-B's token ring and MViT-B
STREAM_LINE = {"stream_serve": ("fused_pw_bn_act", "fused_conv_bn_act",
                                "depthwise3d_s1", "flash_attention")}
# ASCII of 0..255 right-aligned in 3 characters (JSON whitespace pads)
_DIGITS = np.array([list(f"{i:3d}".encode()) for i in range(256)], np.uint8)


def json_u8(arr) -> bytes:
    """The JSON nested list of a uint8 array, built with numpy: each value
    padded to 3 characters with spaces, otherwise `json.dumps(arr.tolist())`
    (a window's list of 6.3M values takes a second that way)."""
    x = _DIGITS[np.asarray(arr)]
    for _ in range(np.ndim(arr)):
        sep = np.full(x.shape[:-1] + (1,), ord(","), np.uint8)
        sep[..., -1, :] = ord("]")
        x = np.concatenate([x, sep], axis=-1).reshape(x.shape[:-2] + (-1,))
        x = np.concatenate([np.full(x.shape[:-1] + (1,), ord("["), np.uint8), x], axis=-1)
    return x.tobytes()


def stream_body(sid: str, **fields) -> bytes:
    """A /stream body: `sid`, u8 arrays ("window", "frames") and scalars."""
    parts = [b'"session":' + json.dumps(sid).encode()]
    for k, v in fields.items():
        parts.append(json.dumps(k).encode() + b":"
                     + (json_u8(v) if isinstance(v, np.ndarray) else json.dumps(v).encode()))
    return b"{" + b",".join(parts) + b"}"


def stream_clips(rng, name: str, n: int, advances: int) -> tuple:
    """(windows (n, T, H, W, 3), new frames (advances, n, stride, H, W, 3))
    of u8 frames at `name`'s geometry; for the transformers noise around a
    per-session colour (`u8_clips`), so the sessions' pooled features
    differ."""
    frames, crop = GEOMETRY[name]
    stride = STREAM_STRIDE[name]
    shape = (n, frames + advances * stride, crop, crop, 3)
    if is_transformer(name):
        clip = (rng.integers(48, 208, (n, 1, 1, 1, 3))
                + rng.integers(-48, 48, shape)).astype(np.uint8)
    else:
        clip = rng.integers(0, 256, shape, np.uint8)
    news = clip[:, frames:].reshape(n, advances, stride, crop, crop, 3)
    return clip[:, :frames], news.transpose(1, 0, 2, 3, 4, 5)


def count_steps(se) -> list:
    """Count the streaming engine's device steps (one model forward each)
    from now on: [count], updated in place."""
    steps = [0]
    call = se._call

    def counted(*args, **kwargs):
        steps[0] += 1
        return call(*args, **kwargs)

    se._call = counted
    return steps


def hold_stream(got, want, what: str) -> float:
    """Stream logits within LOGIT_TOL * (1 + |oracle|) of their oracle."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    check(got.shape == want.shape and bool(np.isfinite(got).all()),
          f"{what}: logits shape {got.shape} (oracle {want.shape}) or non-finite")
    err = np.abs(got - want)
    check(bool((err <= LOGIT_TOL * (1 + np.abs(want))).all()),
          f"{what}: logits differ from the oracle by up to {err.max()}")
    return float(err.max())


def stream_facts(se, name: str, stride: int, mem, adv_s, full_s) -> dict:
    """One family's report: the memory over the last 4 steady advances
    (byte-equal), advance against full_recompute ms at one bucket, the H2D
    bytes of each, ring bytes per session."""
    frames, crop = GEOMETRY[name]
    geom = se.geom_key(frames, crop, crop, 3, se.input_dtype)
    check(len(set(mem[-4:])) == 1,
          f"{name}: memory_allocated() moved across steady advances: {mem[-4:]}")
    pool = se._pools[geom]
    full_h2d = se.full_h2d_bytes(geom)
    if se.kind == "dual":  # /predict ships the slow pathway too
        full_h2d += se.full_h2d_bytes(geom) // se._tok_meta["alpha"]
    return {"kind": se.kind, "trunk": se.trunk, "stride": stride,
            "memory_allocated_last4": mem[-4:],
            "advance_ms": [1e3 * t for t in adv_s],
            "full_recompute_ms": [1e3 * t for t in full_s],
            "advance_over_full": float(np.median(adv_s) / np.median(full_s)),
            "h2d_bytes_advance": se.advance_h2d_bytes(geom, stride),
            "h2d_bytes_full_window": full_h2d,
            "ring_bytes_per_session": se.ring_bytes(geom),
            "ring_bytes_measured_per_row": pool["measured_bytes"] // (pool["cap"] + 1),
            "pool_sessions": pool["cap"], "keys": len(se.compiled_stream_keys())}


def stream_timing(se, items_fn, windows_fn) -> tuple:
    """STREAM_TIMING_REPS synchronised advances (`items_fn()` a launch's
    items, each call new frames) and as many `full_recompute`s of the
    windows the sessions then hold (`windows_fn()`) at the same bucket:
    (advance seconds, full seconds)."""
    adv, full = [], []
    for _ in range(STREAM_TIMING_REPS):
        items = items_fn()
        t0 = time.perf_counter()
        out = se.advance_batch(items)
        adv.append(time.perf_counter() - t0)
        check(not any(isinstance(o, Exception) for o in out), f"timed advance: {out}")
    for _ in range(STREAM_TIMING_REPS):
        windows = windows_fn()
        t0 = time.perf_counter()
        se.full_recompute(windows)
        full.append(time.perf_counter() - t0)
    return adv, full


def stream_http_arm(torch, work: str) -> tuple:
    """Arm (a): the SlowFast-R50 artifact of phase 3 through `build_server`
    with `--serve.streaming true --serve.scheduler edf
    --serve.stream_strides 8`: 4 sessions established over /stream with
    their 32 x 256^2 windows, then 5 advances each (a wraparound of the
    fast ring and one more), a round's 4 sent at once; `memory_allocated()` after each
    round. Then /predict of one window, an advance for an unknown session
    with no window (409), a 5th session past the budget (503 +
    Retry-After). Every response against `full_recompute` of the window the
    client holds; /predict against that window's establish; 41 pointwise
    and 51 conv launches per forward (counters zeroed just before the
    server is built: its warm-up forwards, the stream steps and /predict).
    Returns (the launches, the arm's fields)."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.serving.server import build_server
    from pytorchvideo_accelerate_tpu_torch.streaming import StreamingEngine

    name = "slowfast_r50"
    art = ARTIFACTS[name][0]
    stride, n = STREAM_STRIDE[name], STREAM_SESSIONS
    advances = int(STREAM_WRAPS[name] * GEOMETRY[name][0] // stride)
    wins, news = stream_clips(np.random.default_rng(SEED + 20), name, n, advances)
    sids = [f"sf{i}" for i in range(n)]
    t0 = time.perf_counter()
    est_bodies = [stream_body(sid, window=wins[i], stride=stride,
                              deadline_ms=60000) for i, sid in enumerate(sids)]
    adv_bodies = [[stream_body(sid, frames=news[k, i], deadline_ms=60000)
                   for i, sid in enumerate(sids)] for k in range(advances)]
    predict_body = (b'{"deadline_ms":60000,"slow":' + json_u8(wins[0][::ALPHA])
                    + b',"fast":' + json_u8(wins[0]) + b"}")
    encode_s = time.perf_counter() - t0
    free_cuda(torch)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    server = build_server(parse_cli([
        "--serve.checkpoint", art, "--serve.port", "0", "--serve.streaming", "true",
        "--serve.scheduler", "edf", "--serve.stream_strides", str(stride),
        "--serve.stream_session_budget_mb", str(STREAM_BUDGET_MB),
        "--output_dir", os.path.join(work, "stream_serve")]))
    se = server.batcher.engine
    check(isinstance(se, StreamingEngine) and se.kind == "dual"
          and se._ring_names == ("raw", "slow"),
          f"stream engine {type(se).__name__} kind {getattr(se, 'kind', None)}")
    steps = count_steps(se)
    server.start()
    mem, rounds = [], []
    try:
        build_s = time.perf_counter() - t0
        host, port = server.address
        base = f"http://{host}:{port}"
        health = json.loads(http(base + "/healthz")[2])
        t1 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n) as pool:
            rounds.append(list(pool.map(lambda b: http(base + "/stream", b), est_bodies)))
            for k in range(advances):
                rounds.append(list(pool.map(lambda b: http(base + "/stream", b),
                                            adv_bodies[k])))
                torch.cuda.synchronize()
                mem.append(torch.cuda.memory_allocated())
        http_s = time.perf_counter() - t1
        predicted = http(base + "/predict", predict_body)
        unknown = http(base + "/stream", stream_body("sf-unknown", frames=news[0, 0],
                                                     deadline_ms=60000))
        over = http(base + "/stream", est_bodies[0].replace(b'"sf0"', b'"sf-extra"'))
        stats = json.loads(http(base + "/stats")[2])
        svc_ms = {b: 1e3 * t for b, t in server.batcher._svc.items()}
    finally:
        server.close()
    counts = dict(fused.LAUNCHES)
    codes = [[r[0] for r in rnd] for rnd in rounds]
    check(all(c == 200 for rnd in codes for c in rnd) and predicted[0] == 200,
          f"stream_serve (a): HTTP codes {codes}, /predict {predicted[0]} "
          f"{predicted[2][:300]!r}; service EWMA ms {svc_ms}")
    check(health.get("streaming") is True, f"/healthz streaming {health.get('streaming')}")
    check(unknown[0] == 409, f"unknown session without a window answered {unknown[0]}")
    check(over[0] == 503 and int(over[1]["Retry-After"]) >= 1,
          f"a session past the budget answered {over[0]}")
    buckets = len(se.buckets)
    # engine.warmup and warmup_stream (establish + advance) at every
    # bucket, the stream steps, /predict
    forwards = buckets + 2 * buckets + steps[0] + 1
    check_launches(counts, expected_forward_launches(name), forwards, "stream_serve (a)")
    logits = [np.stack([np.asarray(json.loads(r[2])["logits"], np.float32) for r in rnd])
              for rnd in rounds]
    history = np.concatenate([wins] + [news[k] for k in range(advances)], axis=1)
    frames = GEOMETRY[name][0]
    errs = []
    for k, got in enumerate(logits):  # k = 0: the establishes
        end = frames + k * stride
        errs.append(hold_stream(got, se.full_recompute(history[:, end - frames:end]),
                                f"stream_serve (a) round {k}"))
    p_err = hold_stream(json.loads(predicted[2])["logits"], logits[0][0],
                        "stream_serve (a) /predict against the establish")
    rng = np.random.default_rng(SEED + 21)
    cur = [history[:, -frames:]]

    def items():
        f = rng.integers(0, 256, (n, stride) + wins.shape[2:], np.uint8)
        cur[0] = np.concatenate([cur[0][:, stride:], f], axis=1)
        return [{"sid": sid, "frames": f[i]} for i, sid in enumerate(sids)]

    adv_s, full_s = stream_timing(se, items, lambda: cur[0])
    fields = dict(
        model=name, sessions=n, advances=advances, server_build_s=build_s,
        encode_s=encode_s, http_s=http_s, stream_steps=steps[0], forwards=forwards,
        launches=counts, http_codes=codes, predict_http=predicted[0],
        unknown_http=unknown[0], unknown_error=json.loads(unknown[2])["error"],
        over_budget_http=over[0], over_budget_retry_after=over[1]["Retry-After"],
        over_budget_error=json.loads(over[2])["error"],
        logit_max_abs_err_by_round=errs, predict_vs_establish_max_abs_err=p_err,
        logit_tolerance=f"{LOGIT_TOL}*(1+|full_recompute|)",
        client_ms=quantiles([r[3] for rnd in rounds[1:] for r in rnd]),
        server_ms=quantiles([json.loads(r[2])["latency_ms"] for rnd in rounds[1:] for r in rnd]),
        scheduler_batches=stats["batches"], bucket_fill=stats["batch_fill_ratio"],
        service_ewma_ms=svc_ms,
        **stream_facts(se, name, stride, mem, adv_s, full_s))
    del server, se
    free_cuda(torch)
    return counts, fields


def drive_stream(torch, se, name: str, n: int, seed: int, history_oracle: bool,
                 per_forward: dict, what: str) -> tuple:
    """Establish `n` sessions on `se`, then advance them through
    STREAM_WRAPS[name] ring wraparounds, a launch of all `n` an advance;
    counters zeroed just before, `memory_allocated()` after each advance.
    Then each launch's logits against the oracle of the windows (or, with
    `history_oracle`, the whole histories) the client holds, the launches
    against `per_forward` per step, and the family's timing. Returns
    (launches, fields, the sessions' ids, their current windows)."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    frames, crop = GEOMETRY[name]
    stride = STREAM_STRIDE[name]
    advances = STREAM_WRAPS[name] * frames // stride
    rng = np.random.default_rng(seed)
    wins, news = stream_clips(rng, name, n, advances)
    sids = [f"{what}{i}" for i in range(n)]

    def run(items):
        out = se.advance_batch(items)
        bad = [o for o in out if isinstance(o, Exception)]
        if bad:
            raise bad[0]
        return np.stack(out)

    free_cuda(torch)
    fused.reset_launch_counts()
    steps = count_steps(se)
    outs = [run([{"sid": sid, "window": wins[i], "stride": stride}
                 for i, sid in enumerate(sids)])]
    mem = []
    for k in range(advances):
        outs.append(run([{"sid": sid, "frames": news[k, i]} for i, sid in enumerate(sids)]))
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
    counts = dict(fused.LAUNCHES)
    check_launches(counts, per_forward, steps[0], f"stream_serve {what}")
    history = np.concatenate([wins] + [news[k] for k in range(advances)], axis=1)
    errs = []
    for k, got in enumerate(outs):
        end = frames + k * stride
        want = (se.full_recompute_history(history[:, :end], frames) if history_oracle
                else se.full_recompute(history[:, end - frames:end]))
        errs.append(hold_stream(got, want, f"stream_serve {what} step {k}"))
    cur = [history[:, -frames:]]

    def items():
        f = stream_clips(rng, name, n, 1)[1][0]
        cur[0] = np.concatenate([cur[0][:, stride:], f], axis=1)
        return [{"sid": sid, "frames": f[i]} for i, sid in enumerate(sids)]

    adv_s, full_s = stream_timing(se, items, lambda: cur[0])
    fields = dict(sessions=n, advances=advances, stream_steps=steps[0], launches=counts,
                  logit_max_abs_err_by_step=errs,
                  oracle="full_recompute_history" if history_oracle else "full_recompute",
                  logit_tolerance=f"{LOGIT_TOL}*(1+|oracle|)",
                  **stream_facts(se, name, stride, mem, adv_s, full_s))
    return counts, fields, sids, cur[0]


def stream_engines_arms(torch) -> tuple:
    """Arms (b)-(d) on the engines, the artifacts of phase 18. (b)
    VideoMAE-B (16 x 224^2, tubelet (2,16,16)): the token ring under
    `attention pallas` (12 flash launches per step), then a `--model.attn_mask
    causal` engine under `attention dense` with `trunk="causal"` K/V rings
    in bf16 and with int8 weights and K/V (no kernel launch: the masked
    attention runs on the dense route); 2 sessions each, stride 2, two
    wraparounds, the token ring held against `full_recompute`, the K/V rings
    against `full_recompute_history`. (c) MViT-B 16x4's stem ring under
    `attention pallas, depthwise_impl pallas`: 2 sessions, stride 4, one
    wraparound, against `full_recompute_history`; 16 flash and 4
    `depthwise3d_s1` launches per step. (d) the hot swap: a green VideoMAE-B
    token engine on other seeded weights, `prepare_carry_from` the token
    engine of (b) with its 2 sessions live, `Scheduler.swap_engine`, then
    an advance of each sent with no window against green's
    `full_recompute`. Returns (the launches summed, the fields)."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.streaming import StreamingEngine
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import load_inference

    n = STREAM_ENGINE_SESSIONS
    data = serve_cfg(parse_cli, "off").data
    norm = (data.mean, data.std)
    total = {k: 0 for k in SOURCES}
    out = {}

    def add(counts):
        for k in total:
            total[k] += counts.get(k, 0)

    def stream(engine, budget: str, name: str = "", **kw):
        # one ledger component (`stream_rings:<name>`) an engine
        return StreamingEngine(engine, session_budget_mb=STREAM_ENGINE_BUDGET_MB[budget],
                               name=f"smoke-{name or budget}", **kw)

    v_state = load_inference(ARTIFACTS["videomae_b"][0])[0]
    tokens = stream(make_engine(torch, "videomae_b", v_state, norm, "off",
                                attention="pallas"), "tokens")
    check(tokens.kind == "tokens" and tokens._ring_names == ("raw", "tok"),
          f"videomae_b ring {tokens.kind} {tokens._ring_names}")
    counts, out["videomae_b_tokens"], sids, cur = drive_stream(
        torch, tokens, "videomae_b", n, SEED + 22, False,
        expected_forward_launches("videomae_b"), "tok")
    add(counts)
    for label, quant in (("causal", "off"), ("causal_int8", "int8")):
        kv = stream(make_engine(torch, "videomae_b", v_state, norm, "off",
                                quantization=quant, attn_mask="causal"),
                    label, trunk="causal")
        check(kv._ring_names == (("raw", "tok", "kv", "kv_scale", "hid") if quant == "int8"
                                 else ("raw", "tok", "kv", "hid")), f"{label} rings {kv._ring_names}")
        # the masked trunk runs on the dense route: no kernel launches
        counts, out[f"videomae_b_kv_{label}"], _, _ = drive_stream(
            torch, kv, "videomae_b", n, SEED + 23, True, {}, label)
        out[f"videomae_b_kv_{label}"]["kv_dtype"] = str(next(iter(kv._pools.values()))["kv"].dtype)
        del kv
        free_cuda(torch)

    # (d) the hot swap, with (b)'s token sessions live
    cfg = serve_cfg(parse_cli, "off", "videomae_b", attention="pallas")
    green_state = seeded_state_dict(create_model(cfg.model, "bf16", data_cfg=cfg.data),
                                    np.random.default_rng(SEED + 24))
    green = stream(make_engine(torch, "videomae_b", green_state, norm, "off",
                               attention="pallas"), "tokens", "green")
    sched = Scheduler(tokens, max_queue=16, realtime_deadline_ms=60000.0)
    try:
        t0 = time.perf_counter()
        prepared = green.prepare_carry_from(tokens)
        prepare_s = time.perf_counter() - t0
        blackout_s = sched.swap_engine(green)
        check(sched.current_engine() is green
              and all(green.table.get(sid) is not None for sid in sids),
              "hot swap: the sessions were not carried")
        rng = np.random.default_rng(SEED + 25)
        f = stream_clips(rng, "videomae_b", n, 1)[1][0]
        cur = np.concatenate([cur[:, STREAM_STRIDE["videomae_b"]:], f], axis=1)
        fused.reset_launch_counts()
        steps = count_steps(green)
        futs = [sched.submit({"video": f[i]}, session={"sid": sid})  # no window
                for i, sid in enumerate(sids)]
        got = np.stack([fut.result(timeout=300) for fut in futs])
        counts = dict(fused.LAUNCHES)
    finally:
        sched.close()
    check_launches(counts, expected_forward_launches("videomae_b"), steps[0],
                   "stream_serve hot swap")
    add(counts)
    want = green.full_recompute(cur)
    blue_want = tokens.full_recompute(cur)
    out["hot_swap"] = dict(
        sessions_carried=len(sids), prepared_steps=prepared, prepare_s=prepare_s,
        blackout_ms=1e3 * blackout_s, stream_steps=steps[0], launches=counts,
        logit_max_abs_err=hold_stream(got, want, "stream_serve hot swap"),
        green_vs_blue_max_abs_diff=float(np.abs(want - blue_want).max()))
    check(out["hot_swap"]["green_vs_blue_max_abs_diff"] > LOGIT_TOL,
          "hot swap: green's weights give blue's logits")
    del tokens, green, sched
    free_cuda(torch)

    # (c) MViT-B's stem ring
    m_state = load_inference(ARTIFACTS["mvit_b"][0])[0]
    stem = stream(make_engine(torch, "mvit_b", m_state, norm, "off", impl="pallas",
                              attention="pallas"), "stem")
    check(stem.kind == "stem" and stem._ring_names == ("raw", "stem"),
          f"mvit_b ring {stem.kind} {stem._ring_names}")
    counts, out["mvit_b_stem"], _, _ = drive_stream(
        torch, stem, "mvit_b", n, SEED + 26, True, expected_mvit_launches(), "stem")
    add(counts)
    del stem
    free_cuda(torch)
    return total, out


def stream_serve_phase(torch, work: str, launches: dict) -> dict:
    """Phase 44, the streaming path: arm (a) over HTTP (`stream_http_arm`),
    arms (b)-(d) on the engines (`stream_engines_arms`). `launches
    ["stream_serve"]` sums the arms' main-path launches."""
    t0 = time.perf_counter()
    counts, http_fields = stream_http_arm(torch, work)
    t_http = time.perf_counter() - t0
    engine_counts, fields = stream_engines_arms(torch)
    launches["stream_serve"] = {k: counts.get(k, 0) + engine_counts.get(k, 0)
                                for k in SOURCES}
    return dict(slowfast_r50_http=http_fields, **fields,
                launches=launches["stream_serve"], http_arm_s=t_http,
                seconds=time.perf_counter() - t0)


# --- phase 45: the serving fleet ----------------------------------------------

# the tier's defaults (config.py FleetConfig): 50 rps for 5 s, health polled
# every 0.5 s, p99 SLO 1500 ms
FLEET_MODEL = "slowfast_r50"
FLEET_REPLICAS = 2
FLEET_SWAP_LOAD_S = 8.0  # arm (b): the load outlasts both replicas' swaps
FLEET_KILL_LOAD_S = 3.0  # arm (c): the load around a replica's close
FLEET_DEADLINE_MS = 10000  # the load's deadline: nothing sheds that can be served
FLEET_ADVANCES = 2  # arm (d): advances a session before its holder closes
FLEET_BURST = 40  # arm (e): requests in flight when the autoscaler reads
# arm (e): the autoscaler's SLO; idle below half of it. The pooled windows
# hold every arm's latencies, so the backlog alone decides here
FLEET_CONTROL_SLO_MS = 10000.0
# the kernel rows fleet_serve runs: rows 1-2 in every replica's forward
FLEET_LINE = {"fleet_serve": ("fused_pw_bn_act", "fused_conv_bn_act")}


def count_forwards(torch):
    """Count SlowFast-R50 forwards on the card from now on (every engine's,
    the stream steps' and the oracles'): ([count], the hook's handle)."""
    from pytorchvideo_accelerate_tpu_torch.models.slowfast import SlowFast

    n = [0]

    def hook(module, args):
        if isinstance(module, SlowFast):
            n[0] += 1

    return n, torch.nn.modules.module.register_module_forward_pre_hook(hook)


def fleet_replica(torch, art: str, name: str, device: str):
    """One replica as `build_server --serve.streaming true
    --serve.stream_strides 8` makes its front, in process: the engine from
    `art` on `device`, every bucket warmed for the served geometry, a
    `StreamingEngine` (32 MB of rings) with its stride-8 steps warmed, an
    EDF `Scheduler` over it."""
    from pytorchvideo_accelerate_tpu_torch.fleet.pool import LocalReplica
    from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
    from pytorchvideo_accelerate_tpu_torch.models import model_input_spec
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine
    from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats
    from pytorchvideo_accelerate_tpu_torch.streaming import StreamingEngine

    stats = ServingStats(window=4096)
    engine = InferenceEngine.from_artifact(art, device=device, stats=stats)
    spec = model_input_spec(engine.artifact_config.model, engine.artifact_config.data)
    engine.warmup({k: np.zeros(s[1:], engine.input_dtype) for k, s in spec.items()})
    se = StreamingEngine(engine, session_budget_mb=STREAM_BUDGET_MB,
                         name=f"fleet-{name}")
    _, t, h, w, c = spec["fast"]
    se.warmup_stream(t, h, w, c, STREAM_STRIDE[FLEET_MODEL])
    sched = Scheduler(se, stats=stats, realtime_deadline_ms=FLEET_DEADLINE_MS,
                      batch_deadline_ms=FLEET_DEADLINE_MS)
    return LocalReplica(name, sched), spec


def fleet_load(router, clips, seed: int, duration_s: float, rps: float):
    """An open-loop `LoadGen` at `rps` against `router`: each arrival one of
    the 5 planted clips through `heavy_tail_clip_factory` (1, 2 or 4 views),
    realtime with FLEET_DEADLINE_MS. Returns (report, [(clip index, submit
    time, future)])."""
    from pytorchvideo_accelerate_tpu_torch.fleet.loadgen import (
        LoadGen,
        heavy_tail_clip_factory,
    )

    factories = [heavy_tail_clip_factory(c) for c in clips]
    last, sent = [0], []

    def factory(rng):
        last[0] = int(rng.integers(len(clips)))
        return factories[last[0]](rng)

    def submit(clip, **kw):
        f = router.submit(clip, **kw)
        sent.append((last[0], time.perf_counter(), f))
        return f

    report = LoadGen(submit, rate_rps=rps, duration_s=duration_s, seed=seed,
                     clip_factory=factory, deadline_ms=FLEET_DEADLINE_MS,
                     grace_s=60.0).run()
    return report, sent


def near(got, want) -> bool:
    return bool(np.isfinite(got).all()
                and (np.abs(got - want) <= LOGIT_TOL * (1 + np.abs(want))).all())


def hold_fleet(sent, oracles: dict, what: str, after=None, must=None) -> dict:
    """Every completed response of `sent` within LOGIT_TOL * (1 + |oracle|)
    of one of `oracles` (name -> (5, classes) plain-path logits) for its
    clip, with that oracle's top-1; those submitted after `after` of
    oracle `must`. Returns the count per oracle and the largest error."""
    by, err = {k: 0 for k in oracles}, 0.0
    for idx, ts, f in sent:
        if f.exception() is not None:
            continue
        got = np.asarray(f.result(), np.float32)
        kind = next((k for k, o in oracles.items() if near(got, o[idx])), None)
        check(kind is not None, f"{what}: a response of clip {idx} matches no oracle "
              f"(max err {[float(np.abs(got - o[idx]).max()) for o in oracles.values()]})")
        check(int(got.argmax()) == int(oracles[kind][idx].argmax()),
              f"{what}: top-1 {int(got.argmax())} is not {kind}'s")
        if after is not None and ts > after:
            check(kind == must, f"{what}: a response after the swap is {kind}'s")
        by[kind] += 1
        err = max(err, float(np.abs(got - oracles[kind][idx]).max()))
    return {"responses_by_oracle": by, "logit_max_abs_err": err}


def routed(router) -> dict:
    return {labels["replica"]: v for labels, v in router._c_routed.samples()
            if labels.get("pool") == router.pool.name}


def stop_http(srv) -> None:
    """Stop an InferenceServer's HTTP front only: its batcher (the router)
    and the replicas behind it stay up."""
    srv.httpd.shutdown()
    srv.httpd.server_close()
    srv._thread.join(timeout=10.0)


def fleet_serve_phase(torch, work: str, plain_logits, launches: dict) -> dict:
    """Phase 45, the serving fleet (`fleet/`): two full-width SlowFast-R50
    replicas (`fleet_replica`: streaming fronts, EDF) restored from the
    phase-3 artifact (blue) behind a `ReplicaPool` (health polled every
    0.5 s) and a `Router`; green is a second export on other seeded weights,
    its head planted on the same 5 clips. The launch counters and the
    forward count are zeroed just before each arm; every arm holds 41
    pointwise and 51 conv launches per forward it ran. (a) load: an
    open-loop `LoadGen` at 50 rps for 5 s (`fleet_load`): zero failures,
    `assert_slo` at p99 1500 ms, every response blue's within 5e-2 * (1 +
    |plain|), the split per replica; one /predict through an
    `InferenceServer` whose batcher is the router. (b) `hot_swap` of both
    replicas to green 0.5 s into an 8 s load: zero failures, each response
    blue's or green's (and green's once the swap returned), the blackout
    per replica. (c) replica r0's scheduler closed 1 s into a 3 s load: zero
    failures, the pool lists it down within one poll, a fresh replica (on
    green) added back takes traffic. (e) `Autoscaler.step()` with 40
    requests in flight spawns a third replica, one step idle drains one,
    the last is never drained; `ModelBudget.footprint_source` reads
    "measured"; the ledger publishes `pva_hbm_drift_frac` for the ring
    pools. (d) two streaming sessions (stride 8) through the router: every
    advance on the replica holding its ring, each response against
    `full_recompute` of the client's window; the holder of one closed, its
    next advance re-establishes on the other, held the same way. On one
    card the replicas share `cuda:0`."""
    from pytorchvideo_accelerate_tpu_torch import obs
    from pytorchvideo_accelerate_tpu_torch.config import FleetConfig
    from pytorchvideo_accelerate_tpu_torch.fleet.control import Autoscaler, ModelBudget
    from pytorchvideo_accelerate_tpu_torch.fleet.hotswap import hot_swap
    from pytorchvideo_accelerate_tpu_torch.fleet.loadgen import assert_slo
    from pytorchvideo_accelerate_tpu_torch.fleet.pool import ReplicaPool
    from pytorchvideo_accelerate_tpu_torch.fleet.router import Router
    from pytorchvideo_accelerate_tpu_torch.obs import memory as obs_memory
    from pytorchvideo_accelerate_tpu_torch.obs.registry import Registry
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.serving.server import InferenceServer
    from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats

    t_phase = time.perf_counter()
    fc = FleetConfig()
    name = FLEET_MODEL
    art, clips = ARTIFACTS[name]
    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{i % n_cards}" for i in range(FLEET_REPLICAS + 2)]
    free_cuda(torch)
    # green: other seeded weights, planted on the same clips; its plain path
    # (fused_kernels xla) is green's oracle, phase 3's plain logits blue's
    green_art, green_state, _, norm, _ = make_artifact(
        torch, work, name, np.random.default_rng(SEED + 45), clips=clips,
        tag="_green")
    plain = make_engine(torch, name, green_state, norm, "xla")
    oracles = {"blue": np.asarray(plain_logits, np.float32),
               "green": plain.predict(bucket_batch(clips, BUCKET))[:len(clips)]}
    del plain, green_state
    free_cuda(torch)
    check(not any(near(oracles["blue"][i], oracles["green"][i]) for i in range(len(clips))),
          "fleet_serve: blue's and green's oracles are not apart")
    ledger = obs_memory.configure(registry=Registry(), recorder=obs.get_recorder())
    out = {"replica_devices": devices[:FLEET_REPLICAS], "cards": n_cards}
    totals = {k: 0 for k in SOURCES}
    forwards, hook = count_forwards(torch)

    def arm_start():
        torch.cuda.synchronize()
        fused.reset_launch_counts()
        forwards[0] = 0

    def arm_end(what: str) -> dict:
        torch.cuda.synchronize()
        counts = dict(fused.LAUNCHES)
        check_launches(counts, expected_forward_launches(name), forwards[0],
                       f"fleet_serve ({what})")
        for k in SOURCES:
            totals[k] += counts[k]
        return {"forwards": forwards[0], "launches": {k: counts[k] for k in FLEET_LINE["fleet_serve"]}}

    t0 = time.perf_counter()
    reps, spec = [], None
    for i in range(FLEET_REPLICAS):
        rep, spec = fleet_replica(torch, art, f"r{i}", devices[i])
        reps.append(rep)
    # one registry: the autoscaler reads the pool's gauge off the router's
    reg = Registry()
    pool = ReplicaPool(reps, health_interval_s=fc.health_interval_s,
                       registry=reg, name="smoke")
    router = Router(pool, registry=reg)
    out["build_s"] = time.perf_counter() - t0
    try:
        # (a) the load, then one /predict through the HTTP front
        arm_start()
        rep_a, sent = fleet_load(router, clips, SEED + 451, fc.loadgen_duration_s,
                                 fc.loadgen_rps)
        violations = assert_slo(rep_a, slo_p99_ms=fc.slo_p99_ms)
        check(rep_a["failed"] == 0 and not violations,
              f"fleet_serve (a): {violations} {rep_a}")
        held_a = hold_fleet(sent, {"blue": oracles["blue"]}, "fleet_serve (a)")
        srv = InferenceServer(reps[0].scheduler.current_engine().engine, router,
                              ServingStats(), expected_spec=spec).start()
        try:
            host, port = srv.address
            resp = http(f"http://{host}:{port}/predict",
                        with_keys(request_bodies(clips)[0], deadline_ms=60000))
        finally:
            stop_http(srv)
        check(resp[0] == 200, f"fleet_serve (a): /predict through the router {resp[0]}")
        got = np.asarray(json.loads(resp[2])["logits"], np.float32)
        check(near(got, oracles["blue"][0]), "fleet_serve (a): /predict is not blue's")
        out["a_load"] = {**rep_a, **held_a, "slo_violations": violations,
                         "routed": routed(router), "predict_client_ms": resp[3],
                         **arm_end("a")}

        # (b) hot swap to green under load
        arm_start()
        box = {}

        def swapper():
            time.sleep(0.5)
            box["swap"] = hot_swap(reps, green_art)
            box["t"] = time.perf_counter()

        th = threading.Thread(target=swapper, daemon=True)
        th.start()
        rep_b, sent = fleet_load(router, clips, SEED + 452, FLEET_SWAP_LOAD_S,
                                 fc.loadgen_rps)
        th.join(timeout=300)
        check("swap" in box, "fleet_serve (b): hot_swap did not return")
        post = [(i, time.perf_counter(), router.submit(c, deadline_ms=FLEET_DEADLINE_MS))
                for i, c in enumerate(clips)]
        for _, _, f in post:
            f.result(timeout=60)
        check(rep_b["failed"] == 0, f"fleet_serve (b): {rep_b}")
        held_b = hold_fleet(sent + post, oracles, "fleet_serve (b)",
                            after=box["t"], must="green")
        check(held_b["responses_by_oracle"]["green"] >= len(post),
              f"fleet_serve (b): {held_b}")
        out["b_hot_swap"] = {**rep_b, **held_b, "swap": box["swap"],
                             "swap_blackout_ms": box["swap"]["per_replica_ms"],
                             "routed": routed(router), **arm_end("b")}

        # (c) a replica closed under load; a fresh one added back
        arm_start()
        kill = {}

        def killer():
            time.sleep(1.0)
            kill["t"] = time.perf_counter()
            reps[0].scheduler.close()
            while reps[0] in pool.routable() and time.perf_counter() - kill["t"] < 30:
                time.sleep(0.01)
            kill["down_after_s"] = time.perf_counter() - kill["t"]

        th = threading.Thread(target=killer, daemon=True)
        th.start()
        rep_c, sent = fleet_load(router, clips, SEED + 453, FLEET_KILL_LOAD_S,
                                 fc.loadgen_rps)
        th.join(timeout=60)
        check(rep_c["failed"] == 0, f"fleet_serve (c): {rep_c}")
        check(kill.get("down_after_s", 1e9) <= fc.health_interval_s + 0.1,
              f"fleet_serve (c): the pool listed r0 down after {kill}")
        held_c = hold_fleet(sent, {"green": oracles["green"]}, "fleet_serve (c)")
        before = routed(router).get("r2", 0.0)
        fresh, _ = fleet_replica(torch, green_art, "r2", devices[FLEET_REPLICAS])
        pool.add_replica(fresh)
        again = [(i % len(clips), 0.0, router.submit(clips[i % len(clips)],
                                                     deadline_ms=FLEET_DEADLINE_MS))
                 for i in range(8)]
        for _, _, f in again:
            f.result(timeout=60)
        fresh_n = routed(router).get("r2", 0.0) - before
        check(fresh_n > 0, "fleet_serve (c): the fresh replica took no traffic")
        hold_fleet(again, {"green": oracles["green"]}, "fleet_serve (c) fresh")
        out["c_route_around"] = {**rep_c, **held_c, **kill, "fresh_routed": fresh_n,
                                 "retried": router._c_retried.value(pool="smoke"),
                                 "routable": [r.name for r in pool.routable()],
                                 **arm_end("c")}

        # (e) control: the autoscaler, the budget's source, the drift gauge
        arm_start()
        pool.remove_replica(reps[0])  # the corpse of (c)
        spawned = []

        def spawn():
            rep, _ = fleet_replica(torch, green_art, f"r{3 + len(spawned)}",
                                   devices[len(spawned) % len(devices)])
            spawned.append(rep.name)
            return rep

        scaler = Autoscaler(router, spawn_fn=spawn, reap_fn=lambda r: None,
                            min_replicas=1, max_replicas=FLEET_REPLICAS + 1,
                            slo_p99_ms=FLEET_CONTROL_SLO_MS, cooldown_s=0.0,
                            ewma_alpha=1.0, drain_grace_s=30.0)
        burst = [router.submit(clips[i % len(clips)], deadline_ms=FLEET_DEADLINE_MS)
                 for i in range(FLEET_BURST)]
        up = scaler.step()
        members_up = [r.name for r in pool.replicas]
        for f in burst:
            f.result(timeout=120)
        while router.queue_depth():
            time.sleep(0.01)
        down = scaler.step()
        members_down = [r.name for r in pool.routable()]
        last = scaler._drain_one(pool.routable()[:1])
        check(up == "up" and len(members_up) == FLEET_REPLICAS + 1,
              f"fleet_serve (e): under backlog {up}, members {members_up}")
        check(down == "down" and len(members_down) == FLEET_REPLICAS,
              f"fleet_serve (e): idle {down}, routable {members_down}")
        check(last is False, "fleet_serve (e): the last replica was drained")
        budget = ModelBudget(10_000.0)
        budget.register(name, 1.0)
        source = budget.footprint_source(name)
        check(source == "measured" and ledger.source() == "measured",
              f"fleet_serve (e): the budget reads {source}, the ledger {ledger.source()}")
        drift = {k: v for k, v in ledger.drift().items() if k.startswith("stream_rings:")}
        text = ledger.registry.render()
        check(drift and all(f'pva_hbm_drift_frac{{component="{k}"}}' in text for k in drift),
              f"fleet_serve (e): no drift gauge for the ring pools ({drift})")
        out["e_control"] = {"backlog_step": up, "members_after_up": members_up,
                            "idle_step": down, "routable_after_down": members_down,
                            "drained_last": last, "spawned": spawned,
                            "history": [{k: v for k, v in e.items() if k != "t"}
                                        for e in scaler.history],
                            "footprint_source": source,
                            "footprint_mb": budget.footprint_mb(name),
                            "drift_frac": drift, **arm_end("e")}

        # (d) session affinity over the two routable replicas
        arm_start()
        stride = STREAM_STRIDE[name]
        frames = GEOMETRY[name][0]
        wins, news = stream_clips(np.random.default_rng(SEED + 454), name, 2,
                                  FLEET_ADVANCES + 1)
        sids = ["fleet-s0", "fleet-s1"]
        live = {sid: wins[i] for i, sid in enumerate(sids)}

        def holder(sid):
            return [r for r in pool.routable()
                    if r.scheduler.current_engine().table.get(sid) is not None]

        def advance(k):
            futs = []
            for i, sid in enumerate(sids):
                if k < 0:
                    clip, env = {}, {"sid": sid, "window": live[sid], "stride": stride}
                else:
                    live[sid] = np.concatenate([live[sid][stride:], news[k, i]])
                    clip = {"video": news[k, i]}
                    env = {"sid": sid, "window": live[sid], "stride": stride}
                futs.append(router.submit(clip, session=env, deadline_ms=FLEET_DEADLINE_MS))
            res = [np.asarray(f.result(timeout=60), np.float32) for f in futs]
            errs = []
            for sid, got in zip(sids, res):
                hold = holder(sid)
                check(len(hold) == 1 and router._affinity.get(sid) == hold[0].name,
                      f"fleet_serve (d): {sid} held by {[r.name for r in hold]}, "
                      f"pinned to {router._affinity.get(sid)}")
                want = hold[0].scheduler.current_engine().full_recompute(live[sid][None])[0]
                errs.append(hold_stream(got[None], want[None], f"fleet_serve (d) {sid}"))
            return errs

        errs = advance(-1)
        pins = [dict(router._affinity)]
        for k in range(FLEET_ADVANCES):
            errs += advance(k)
            pins.append(dict(router._affinity))
        check(all(p == pins[0] for p in pins), f"fleet_serve (d): affinity moved {pins}")
        gone = next(r for r in pool.routable() if r.name == pins[0][sids[0]])
        gone.scheduler.close()
        errs += advance(FLEET_ADVANCES)
        moved = dict(router._affinity)
        check(moved[sids[0]] != gone.name, f"fleet_serve (d): {sids[0]} stayed on {gone.name}")
        out["d_affinity"] = {"pins": pins, "closed": gone.name, "after_close": moved,
                             "logit_max_abs_err": max(errs), **arm_end("d")}
    finally:
        hook.remove()
        router.close()
        obs_memory.configure(enabled=False)
        free_cuda(torch)
    launches["fleet_serve"] = totals
    out["launches"] = {k: totals[k] for k in FLEET_LINE["fleet_serve"]}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def resident_bytes(model) -> int:
    """Bytes of a module's parameters and buffers on the card."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers())
               if t.is_cuda)


def forward_peak_gb(torch, engine, batch) -> float:
    """Device memory a bucket forward adds at its peak over what is live."""
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine.predict(batch)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - live) / 1e9


def int8_serve_phase(torch, work: str, launches: dict) -> dict:
    """Phase 34. int8 artifacts of SlowFast-R50 (phase 3's) and MViT-B
    (`attention pallas, depthwise_impl pallas`, phase 18's), baked with the
    port's `export_inference(quantization="int8")`, each served by
    `build_server` (EDF): one /predict, then bucket-8 forwards of the
    request clips on the server's engine. Checks per model: the launches
    (counters zeroed just before the server is built) are the fp forward's
    per forward (rows 1 and 2, or rows 4 and 5); the int8 logits against
    the plain path on the same int8 weights (`fused_kernels xla`, or
    `attention dense`) to the serving tolerance, 5e-2 * (1 + |plain|), with
    top-1 on decisive rows; against the fp artifact's kernel path, top-1
    agreement >= 0.75 (the JAX package's gate) and the largest logit
    difference within `INT8_REL` * (1 + the largest |fp logit|), reported
    beside the JAX gate's absolute 5e-2; an engine that quantizes
    the fp artifact on the fly gives bitwise the baked engine's logits.
    Reports resident weight bytes, the forward's peak memory and forward
    ms, int8 against fp (in turns fp, int8, int8, fp)."""
    from pytorchvideo_accelerate_tpu_torch.config import config_from_dict, parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine
    from pytorchvideo_accelerate_tpu_torch.serving.server import build_server
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import (
        export_inference,
        load_inference,
    )

    out, total = {}, {}
    for name in ("slowfast_r50", "mvit_b"):
        t0 = time.perf_counter()
        art, clips = ARTIFACTS[name]
        batch = bucket_batch(clips, BUCKET)
        state, meta = load_inference(art)
        cfg = config_from_dict(meta["config"])
        model = create_model(cfg.model, cfg.mixed_precision, data_cfg=cfg.data)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        q_art = export_inference(os.path.join(work, f"{name}_int8_artifact"), model,
                                 cfg, meta={"num_classes": classes(name), "model": name},
                                 quantization="int8")
        del model, state
        free_cuda(torch)
        per_forward = expected_forward_launches(name)
        fused.reset_launch_counts()
        server = build_server(parse_cli(["--serve.checkpoint", q_art,
                                         "--serve.port", "0"]))
        server.start()
        try:
            host, port = server.address
            code, _, data, _ = http(f"http://{host}:{port}/predict",
                                    request_bodies(clips)[0])
            stats = json.loads(http(f"http://{host}:{port}/stats")[2])
        finally:
            server.close()
        q_engine = server.engine
        check(code == 200 and q_engine.quantization == "int8",
              f"{name} int8 /predict {code}, engine {q_engine.quantization}")
        q_logits = q_engine.predict(batch)
        counts = dict(fused.LAUNCHES)
        forwards = len(q_engine.buckets) + int(stats["batches"]) + 1
        check_launches(counts, per_forward, forwards, f"{name} int8_serve")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        fp = InferenceEngine.from_artifact(art)
        fused.reset_launch_counts()
        fp_logits = fp.predict(batch)
        check_launches(dict(fused.LAUNCHES), per_forward, 1, f"{name} fp forward")
        fly = InferenceEngine.from_artifact(art, quantization="int8")
        fly_logits = fly.predict(batch)
        check(np.array_equal(fly_logits, q_logits),
              f"{name}: on-the-fly int8 logits differ from the baked artifact's: "
              f"max {np.abs(fly_logits - q_logits).max()}")
        del fly
        free_cuda(torch)
        n = len(clips)
        plain = make_engine(torch, name, load_inference(art)[0], (cfg.data.mean, cfg.data.std),
                            "off" if name == "mvit_b" else "xla", quantization="int8")
        held = hold_logits(q_logits[:n], plain.predict(batch)[:n], f"{name} int8")
        del plain
        free_cuda(torch)
        q, f = q_logits[:n], fp_logits[:n]
        err = np.abs(q - f)
        agree = float((q.argmax(1) == f.argmax(1)).mean())
        check(agree >= INT8_TOP1, f"{name}: int8 top-1 agreement {agree}")
        rel_bound = INT8_REL * (1.0 + float(np.abs(f).max()))
        check(err.max() <= rel_bound,
              f"{name}: int8 logits {err.max()} from fp, bound {rel_bound}")
        ms = {"fp": [], "int8": []}
        for label in ("fp", "int8", "int8", "fp"):
            ms[label] += forward_ms(torch, fp if label == "fp" else q_engine, batch)
        out[name] = dict(
            int8_artifact=q_art, launches=counts, forwards=forwards,
            launches_per_forward={k: v / forwards for k, v in counts.items() if v},
            int8_vs_plain_int8=held,
            int8_max_abs_err=float(err.max()), int8_top1_agreement=agree,
            int8_gate={"top1": INT8_TOP1, "atol": INT8_ATOL,
                       "atol_held": bool(err.max() <= INT8_ATOL),
                       "rel": INT8_REL, "rel_bound": rel_bound},
            fp_logit_absmax=float(np.abs(f).max()),
            on_the_fly_bitwise=True,
            resident_weight_bytes={"int8": resident_bytes(q_engine.model),
                                   "fp": resident_bytes(fp.model)},
            forward_peak_gb={"int8": forward_peak_gb(torch, q_engine, batch),
                             "fp": forward_peak_gb(torch, fp, batch)},
            forward_ms=ms, seconds=time.perf_counter() - t0)
        del fp, q_engine, server
        free_cuda(torch)
    launches["int8_serve"] = total
    return out


def read_child(proc, on_line=None, timeout_s: float = 600.0):
    """The child's output lines (read until it exits), the step losses it
    printed and its final CHILD_RESULT record; `on_line(line)` sees each
    line as it comes."""
    import threading

    lines, losses, record = [], {}, None
    timer = threading.Timer(timeout_s, proc.kill)  # a hung child ends here
    timer.start()
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if on_line is not None:
                on_line(line)
            if line.startswith("step ") and ": loss=" in line:
                step = int(line.split()[1].rstrip(":"))
                losses[step] = float(line.split("loss=")[1].split()[0])
            elif line.startswith("CHILD_RESULT "):
                record = json.loads(line[len("CHILD_RESULT "):])
        proc.wait()
    finally:
        timer.cancel()
    return lines, losses, record


def train_child(argv):
    return subprocess.Popen([sys.executable, "-u", "-c", TRAIN_CHILD, *argv],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def preempt_train_phase(torch, work: str, launches: dict) -> dict:
    """Phase 35. `run.main` in a child process on full-width SlowFast-R50
    (32 frames at 256^2, B=4, 6 steps, a checkpoint every 3): unbroken
    once; then again, with SIGTERM sent once its log shows step 3, and
    resumed with `--resume_from_checkpoint auto`. The preempted child exits
    0 with `preempted: true`, stops off a checkpointing boundary (see
    `PREEMPT_TRAIN`), leaves a checkpoint of kind "preempt" at the step it
    finished and the loader position of that step, and an
    `emergency_checkpoint.json` naming the step, and a `flight_record.json`
    whose last "preempt" events are the SIGTERM's and the emergency
    save's; the resumed child
    ends at the unbroken run's step count, each step's loss within 5e-2 *
    (1 + |loss|) of the unbroken run's (cuDNN's strided wgrad is not
    bitwise across runs), and the launches of the two children add up to
    the unbroken run's, each exact. Reports the seconds from SIGTERM to
    exit and the emergency save's."""
    spec = PREEMPT_TRAIN
    per_forward = expected_forward_launches(spec["name"])
    want = expected_train_launches(spec, per_forward)
    free_cuda(torch)

    # the three children start together; each runs when the one before it
    # has ended (`await_go`)
    started = {}
    for tag, out, extra in (("unbroken", "unbroken", ()), ("preempted", "preempted", ()),
                            ("resumed", "preempted", ["--resume_from_checkpoint", "auto"])):
        os.makedirs(os.path.join(work, out), exist_ok=True)
        gate = os.path.join(work, out, f"go_{tag}")
        started[tag] = (gate, train_child(
            [gate] + train_argv(os.path.join(work, out), spec=spec) + list(extra)))

    def run_child(tag, on_line=None):
        gate, proc = started[tag]
        go(gate)
        lines, losses, record = read_child(proc, lambda ln: on_line(proc, ln)
                                           if on_line else None)
        return proc, lines, losses, record

    try:
        return preempt_checks(work, spec, want, per_forward, run_child, launches)
    finally:
        kill_waiting([[proc] for _, proc in started.values()])


def preempt_checks(work: str, spec: dict, want: dict, per_forward: dict,
                   run_child, launches: dict) -> dict:
    """preempt_train's children in turn (`run_child(tag, on_line)`) and
    what it holds of each."""
    import signal

    t0 = time.perf_counter()
    proc, lines, base_losses, base = run_child("unbroken")
    check(proc.returncode == 0 and base is not None,
          f"unbroken run rc {proc.returncode}: {lines[-20:]}")
    check(base["result"]["steps"] == want["steps"] and sorted(base_losses)
          == list(range(1, want["steps"] + 1)),
          f"unbroken run steps {base['result']['steps']}, losses {base_losses}")
    check(all(base["launches"][k] == want[k] for k in SOURCES),
          f"unbroken launches {base['launches']}, expected {want}")
    unbroken_s = time.perf_counter() - t0

    out = os.path.join(work, "preempted")
    sent = {}

    def on_line(p, line):
        if not sent and line.startswith(f"step {PREEMPT_AT_LINE}:"):
            sent["t"] = time.perf_counter()
            p.send_signal(signal.SIGTERM)

    proc, lines, first, rec = run_child("preempted", on_line=on_line)
    exit_s = time.perf_counter() - sent.get("t", time.perf_counter())
    check("t" in sent, f"the child's log never showed step {PREEMPT_AT_LINE}")
    check(proc.returncode == 0 and rec is not None and rec["result"]["preempted"],
          f"preempted run rc {proc.returncode}: {lines[-20:]}")
    with open(os.path.join(out, "emergency_checkpoint.json")) as f:
        emergency = json.load(f)
    k = rec["result"]["steps"]
    check(emergency["step"] == k and emergency["reason"] == "SIGTERM"
          and 0 < k < want["steps"],
          f"emergency record {emergency}, preempted at step {k}")
    with open(os.path.join(out, "checkpoints", str(k), "extra.json")) as f:
        extra = json.load(f)
    check(k % spec["ckpt_every"] != 0 and extra["kind"] == "preempt"
          and extra["data_state"] == {"epoch": 0, "position": k},
          f"checkpoint of step {k}: {extra['kind']} at {extra['data_state']}")
    check(sorted(first) == list(range(1, k + 1)), f"preempted run's steps {sorted(first)}")
    with open(os.path.join(out, "flight_record.json")) as f:
        flight = [e for e in json.load(f)["events"] if e["kind"] == "preempt"]
    check([e["name"] for e in flight][-2:] == ["SIGTERM", "emergency checkpoint saved"]
          and flight[-1]["step"] == k, f"flight record's preempt events {flight}")
    saved = [ln for ln in lines if ln.startswith("preempted (SIGTERM)")]
    check(len(saved) == 1, f"no grace-path line in {lines[-10:]}")
    save_s = float(saved[0].split(" in ")[1].split()[0])
    pre = {kk: per_forward.get(kk.split(".")[0], 0) * k for kk in SOURCES}
    check(all(rec["launches"][kk] == pre[kk] for kk in SOURCES),
          f"preempted launches {rec['launches']}, expected {pre}")

    t1 = time.perf_counter()
    proc, lines, rest, res = run_child("resumed")
    resume_s = time.perf_counter() - t1
    check(proc.returncode == 0 and res is not None and not res["result"]["preempted"]
          and res["result"]["steps"] == base["result"]["steps"],
          f"resumed run rc {proc.returncode}: {lines[-20:]}")
    check(sorted(rest) == list(range(k + 1, want["steps"] + 1)),
          f"resumed run's steps {sorted(rest)} after step {k}")
    check(all(rec["launches"][kk] + res["launches"][kk] == want[kk] for kk in SOURCES),
          f"launches {rec['launches']} + {res['launches']}, unbroken {want}")
    losses = {**first, **rest}
    diffs = {s: abs(losses[s] - base_losses[s]) for s in base_losses}
    check(all(diffs[s] <= 5e-2 * (1 + abs(base_losses[s])) for s in diffs),
          f"losses {losses} against the unbroken run's {base_losses}")
    launches["preempt_train"] = {kk: rec["launches"][kk] + res["launches"][kk]
                                 for kk in SOURCES}
    return dict(
        model=spec["name"], batch=spec["batch"], steps=want["steps"],
        checkpointing_steps=spec["ckpt_every"], sigterm_after_log_line=PREEMPT_AT_LINE,
        preempted_at_step=k, checkpoint_kind=extra["kind"],
        flight_record_preempt_events=flight,
        loader_state=extra["data_state"], emergency_record=emergency,
        sigterm_to_exit_s=exit_s, emergency_save_s=save_s,
        resume_s=resume_s, unbroken_s=unbroken_s,
        losses_unbroken=[base_losses[s] for s in sorted(base_losses)],
        losses_preempted_resumed=[losses[s] for s in sorted(losses)],
        loss_max_abs_diff=max(diffs.values()),
        launches={"preempted": rec["launches"], "resumed": res["launches"],
                  "unbroken": base["launches"]})


# --- dp_train: data parallelism across processes (slice 12) -----------------

# SlowFast-R50 at full width (32x256^2, bf16, 700 classes), synthetic
# clips, SGD at lr 0.01, mixing off: a global batch of 8 clips a step in
# every arm, 6 steps (48 videos), a checkpoint every 4 steps, eval of 12
# val clips (4 steps leave the preempted arm, which stopped at step 2 or 3,
# one step from the run's end). The head's dropout is off: a rank keeps its rows of the
# global batch's mask, but its rows hold other clips than the same rows
# of one process's batch (the loader deals clip i to rank i % world), so
# with dropout on the arms would train on other masks. The preempted run's SIGTERM goes to rank 1 once rank 0's log
# shows step 1: the ranks stop together at step 2 or 3, off the boundary
DP_TRAIN = dict(SLOWFAST_TRAIN, batch=8, accum=1, epochs=1, videos=48,
                ckpt_every=4, lr=TRANSFORMER_LR, argv=["--model.dropout_rate", "0"])
DP_SIGTERM_AFTER_LINE = 1
DP_CHILD_TIMEOUT_S = 300.0
# arm (c) under the hang watch: rank 1 sleeps DP_HANG_DELAY_S inside the
# barrier of its last checkpoint fence (after every timed step); each rank's
# watchdog (DP_HANG_TIMEOUT_S, below the group's DP_CHILD_TIMEOUT_S) must
# attribute its wedge to that barrier
DP_HANG_TIMEOUT_S = 10
DP_HANG_DELAY_S = 25.0
DP_HANG_BARRIER = "name=checkpoint_close"
# a child of the dp_train phase: `mode` none (no group), nccl1 (a one-rank
# NCCL group the child makes itself), gloo (two ranks on one card, joined
# by `initialize_distributed(backend="gloo")`) or env (the launcher's PVA_*
# env: NCCL, one card a rank), with "+hang" the hang watch of arm (c)
# (`dp_child`); it prints its record last
DP_CHILD = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke\n"
    "chip_smoke.dp_child(sys.argv[2:])\n")


def dp_state_hash(model) -> str:
    """sha256 of the parameters and floating buffers, bytes on the host."""
    import hashlib

    h = hashlib.sha256()
    for t in list(model.parameters()) + [b for b in model.buffers()
                                         if b.is_floating_point()]:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_fit(torch, argv, dump_dir: str) -> dict:
    """`run.main`'s fit() of `argv` through a Trainer whose step is timed
    (synchronised around each optimizer step), counted (every
    `torch.distributed.all_reduce` inside a step, and its bytes) and
    fingerprinted (`dp_state_hash` after each step); the first step's
    gradient (this rank's before the all-reduce, and after it) goes to
    `dump_dir`. After fit(), every rank restores the last checkpoint and
    fingerprints it again. The launch counters are zeroed after the
    Trainer is built, just before fit()."""
    import torch.distributed as dist

    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.parallel import distributed as pdist
    from pytorchvideo_accelerate_tpu_torch.trainer import steps as steps_mod
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    trainer = Trainer(parse_cli(argv))
    rank = pdist.process_index()
    params = list(trainer.model.parameters())
    rec = {"step_ms": [], "losses": [], "hashes": [], "allreduce_calls": [],
           "allreduce_bytes": []}
    in_step = {"on": False, "calls": 0, "bytes": 0}
    all_reduce = dist.all_reduce

    def counting(tensor, *a, **kw):
        if in_step["on"]:
            in_step["calls"] += 1
            in_step["bytes"] += tensor.numel() * tensor.element_size()
        return all_reduce(tensor, *a, **kw)

    dist.all_reduce = counting
    mean_ = steps_mod.all_reduce_mean_

    def spying_mean(tensors, group=None):
        if len(rec["step_ms"]) == 0 and "local" not in rec:
            rec["local"] = True  # the first call of the first step: the gradient
            torch.save(torch.cat([t.float().flatten() for t in tensors]).cpu(),
                       os.path.join(dump_dir, f"grad_local_rank{rank}.pt"))
        mean_(tensors, group=group)

    steps_mod.all_reduce_mean_ = spying_mean
    step = trainer.train_step

    def timed(state, batch):
        torch.cuda.synchronize()
        in_step.update(on=True, calls=0, bytes=0)
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        in_step["on"] = False
        rec["allreduce_calls"].append(in_step["calls"])
        rec["allreduce_bytes"].append(in_step["bytes"])
        rec["losses"].append(float(m["loss"]))
        if len(rec["step_ms"]) == 1:
            torch.save(torch.cat([p.grad.float().flatten() for p in params]).cpu(),
                       os.path.join(dump_dir, f"grad_rank{rank}.pt"))
            rec["head_grad"] = trainer.model.head.proj.weight.grad.float().cpu()
            torch.save(rec.pop("head_grad"),
                       os.path.join(dump_dir, f"head_grad_rank{rank}.pt"))
        rec["hashes"].append(dp_state_hash(trainer.model))
        return m

    trainer.train_step = timed
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = trainer.fit()
    finally:
        steps_mod.all_reduce_mean_ = mean_
        dist.all_reduce = all_reduce
    rec["fit_s"] = time.perf_counter() - t0
    rec["launches"] = dict(fused.LAUNCHES)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["result"] = result
    rec["rank"], rec["world"] = rank, pdist.process_count()
    if trainer.watchdog is not None:
        rec["watchdog"] = watchdog_record(trainer, rank)
    if not result["preempted"]:
        live = dp_state_hash(trainer.model)
        latest = trainer.checkpointer.latest_step()
        trainer.checkpointer.restore(trainer.state, step=latest)
        rec["restored_step"] = latest
        rec["restore_bitwise"] = dp_state_hash(trainer.model) == live
    return rec


def watchdog_record(trainer, rank: int) -> dict:
    """What a Trainer's hang watchdog saw: its stall count, the components
    and attributions of its last stall, and the watchdog and fault events
    of this rank's flight record file (empty when nothing was dumped)."""
    from pytorchvideo_accelerate_tpu_torch.obs.flight_recorder import rank_file_name

    wd = trainer.watchdog
    path = os.path.join(trainer.cfg.checkpoint.output_dir, rank_file_name(rank))
    events = []
    if os.path.exists(path):
        with open(path) as f:
            events = [e for e in json.load(f)["events"]
                      if e["kind"] in ("watchdog", "fault")]
    return {"stall_count": wd.stall_count, "last_stalled": wd.last_stalled,
            "last_attribution": dict(wd.last_attribution), "flight": events}


def dp_child(args) -> None:
    """A dp_train child: `mode rank world address dump_dir run-args...`; a
    mode ending in "+hang" (arm (c)) installs a collective-schedule recorder
    after joining, arms rank 1's `collective.sync` delay (`DP_HANG_*`), and
    adds the schedule and the fired faults to the record."""
    import torch

    mode, rank, world, address, dump_dir, *argv = args
    rank, world = int(rank), int(world)
    hang = mode.endswith("+hang")
    mode = mode.split("+")[0]
    from pytorchvideo_accelerate_tpu_torch.parallel import distributed as pdist
    from pytorchvideo_accelerate_tpu_torch.parallel import schedule_recorder as srec
    from pytorchvideo_accelerate_tpu_torch.parallel.hangcheck import host_tag
    from pytorchvideo_accelerate_tpu_torch.reliability import faults

    if mode == "nccl1":
        torch.cuda.set_device(0)
        torch.distributed.init_process_group(
            "nccl", init_method=f"tcp://{address}", world_size=1, rank=0)
    elif mode == "gloo":
        pdist.initialize_distributed(address, world, rank, backend="gloo",
                                     timeout_s=DP_CHILD_TIMEOUT_S)
    if hang:
        srec.install_schedule_recorder(srec.CollectiveScheduleRecorder(host_tag()))
        if rank == 1:
            faults.arm(faults.FaultPlan(SEED, [faults.FaultSpec(
                "collective.sync", kind="delay", delay_s=DP_HANG_DELAY_S,
                path_substr=DP_HANG_BARRIER, max_fires=1)]))
    await_go(os.path.join(dump_dir, "go"))
    rec = dp_fit(torch, argv, dump_dir)
    if hang:
        rec["schedule"] = srec.current_recorder().schedules()
        rec["fired"] = faults.fault_history()
    print("CHILD_RESULT " + json.dumps(rec, default=str), flush=True)


def dp_spawn(mode: str, rank: int, world: int, address: str, dump_dir: str,
             argv, env=None):
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-u", "-c", DP_CHILD, root, mode, str(rank), str(world),
         address, dump_dir, *argv],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, **(env or {})})


def dp_start(mode: str, world: int, out: str, batch: int, hang: bool = False) -> list:
    """Start `world` ranks of `mode` on the same global batch (`batch` a
    rank), dumping under `out`, with `hang` under the hang watch
    (`dp_child`); they wait for `dp_finish` (`await_go`)."""
    from pytorchvideo_accelerate_tpu_torch.launch import find_free_port

    os.makedirs(out, exist_ok=True)
    address = f"127.0.0.1:{find_free_port()}"
    argv = train_argv(out, spec=dict(DP_TRAIN, batch=batch))
    if hang:
        mode, argv = mode + "+hang", argv + ["--obs.watchdog_timeout_s",
                                             str(DP_HANG_TIMEOUT_S)]
    return [dp_spawn(mode, r, world, address, out, argv) for r in range(world)]


def dp_group(mode: str, world: int, out: str, batch: int, on_line=None) -> list:
    """`dp_start`, then `dp_finish`."""
    return dp_finish(dp_start(mode, world, out, batch), mode, out, on_line)


def dp_finish(procs: list, mode: str, out: str, on_line=None) -> list:
    """Let the ranks `dp_start` started under `out` run; returns each
    rank's (proc, lines, losses, record), rank order. `on_line(procs,
    line)` sees rank 0's lines as they come."""
    import threading

    world = len(procs)
    go(os.path.join(out, "go"))
    got = [None] * world

    def read(r):
        cb = (lambda ln: on_line(procs, ln)) if (on_line and r == 0) else None
        got[r] = (procs[r],) + read_child(procs[r], cb, timeout_s=DP_CHILD_TIMEOUT_S)

    threads = [threading.Thread(target=read, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r, (proc, lines, _, record) in enumerate(got):
        check(proc.returncode == 0 and record is not None,
              f"dp_train {mode} rank {r} rc {proc.returncode}: {lines[-25:]}")
    return got


def dp_expected(world: int) -> dict:
    """Each rank's launches of one DP_TRAIN fit() at `world` ranks of
    8 / world clips: 6 micro-steps, and ceil((12 val clips // world) /
    (8 / world)) = 2 eval forwards at world 1 and 2 alike."""
    per_forward = expected_forward_launches("slowfast_r50")
    b = DP_TRAIN["batch"] // world
    micro = DP_TRAIN["videos"] // DP_TRAIN["batch"]
    evals = -(-(max(DP_TRAIN["videos"] // 4, 4) // world) // b)
    return {k: per_forward.get(k.split(".")[0], 0) * (micro if is_backward(k)
                                                        else micro + evals)
            for k in SOURCES}


def dp_arm_fields(torch, recs, want: dict, ref=None) -> dict:
    """The checks every arm holds (exact launches on every rank, ranks
    bitwise equal after every step, the restore bitwise, the losses of
    the global batch against the reference's) and its report."""
    for rec in recs:
        check(all(rec["launches"].get(k, 0) == n for k, n in want.items()),
              f"rank {rec['rank']} launches {rec['launches']}, expected {want}")
        check(rec["restore_bitwise"], f"rank {rec['rank']}: the restore of step "
              f"{rec['restored_step']} is not bitwise the live state")
    check(all(r["hashes"] == recs[0]["hashes"] for r in recs),
          "the ranks' parameters and BN running averages differ after a step")
    check(all(r["losses"] == recs[0]["losses"] for r in recs),
          "the ranks report different global losses")
    out = {"world": recs[0]["world"], "batch_per_rank": DP_TRAIN["batch"] // recs[0]["world"],
           "steps": len(recs[0]["losses"]), "losses": recs[0]["losses"],
           "step_ms": spread(recs[0]["step_ms"][1:]),
           "step_ms_all": recs[0]["step_ms"],
           "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in recs],
           "clips_per_sec": recs[0]["result"].get("clips_per_sec"),
           "clips_per_sec_per_card": recs[0]["result"].get("clips_per_sec_per_card"),
           "fit_s": recs[0]["fit_s"], "launches_per_rank": recs[0]["launches"],
           "restore_bitwise": True, "ranks_bitwise_every_step": True}
    calls = recs[0]["allreduce_calls"]
    if calls and calls[0]:
        out["allreduces_per_micro_step"] = calls[0] / DP_TRAIN["accum"]
        out["allreduce_bytes_per_micro_step"] = recs[0]["allreduce_bytes"][0] / DP_TRAIN["accum"]
    if ref is not None:
        diffs = [abs(a - b) for a, b in zip(recs[0]["losses"], ref["losses"])]
        check(len(diffs) == len(ref["losses"])
              and all(d <= LOGIT_TOL * (1 + abs(b)) for d, b in zip(diffs, ref["losses"])),
              f"losses {recs[0]['losses']} against one process's {ref['losses']}")
        out["loss_max_abs_diff_vs_one_process"] = max(diffs)
        out["step_ms_ratio_vs_one_process"] = (out["step_ms"]["median"]
                                               / spread(ref["step_ms"][1:])["median"])
    return out


def dp_train_phase(torch, work: str, launches: dict) -> dict:
    """Phase 36. Data-parallel training of full-width SlowFast-R50 through
    `run.main`'s Trainer, the same global batch of 8 clips a step in every
    arm: (a) one process, no group; (b) a one-rank NCCL group (the
    data-parallel path: sync BatchNorm, the gradient all-reduce, rank-0
    checkpoints and the agreement collectives, at world 1); (c) two ranks
    of 4 clips sharing the card over gloo; (d) two ranks over NCCL on two
    cards through `launch.py`, when the machine has them. Held: exact
    launches of rows 1-2b on every rank; the ranks' parameters and BN
    running averages bitwise equal after every step; the last checkpoint
    restoring bitwise on every rank; the losses within 5e-2 * (1 + |loss|)
    of (a)'s; (b)'s first step, whose forward is (a)'s (same batch, same
    kernels, the one-rank all-reduces copies), within 1e-2 * (1 + |loss|);
    (c)'s all-reduced first gradient bitwise the mean of the ranks' own,
    and its head gradient within 5e-2 of (a)'s (the whole bf16 gradient at
    init is chaotic under the two arms' different rounding, as in
    train_parity: reported, not held). Then (c) again with SIGTERM to rank
    1 alone: both ranks stop at one step off the checkpoint boundary, exit
    0, and leave one "preempt" checkpoint (its reason "peer" in rank 0's
    emergency record). Reports the optimizer-step ms
    (steps 2-6, synchronised), the all-reduces a micro-step and their
    bytes, peak memory per rank."""
    t0 = time.perf_counter()
    free_cuda(torch)
    out = {"model": "slowfast_r50", "global_batch": DP_TRAIN["batch"],
           "steps": DP_TRAIN["videos"] // DP_TRAIN["batch"], "lr": DP_TRAIN["lr"]}
    arms = {}
    # (a) and (b) run as children too: the smoke's own process never joins
    # a group, so the phases after this one run as before. Every arm's
    # ranks start now and wait for their turn (`await_go`)
    plan = (("a_one_process", "none", 1), ("b_nccl_one_rank", "nccl1", 1),
            ("c_gloo_two_ranks", "gloo", 2), ("c_preempted", "gloo", 2))
    started = {name: dp_start(mode, world, os.path.join(work, f"dp_{name}"),
                              DP_TRAIN["batch"] // world,
                              hang=name == "c_gloo_two_ranks")
               for name, mode, world in plan}
    try:
        return dp_checks(torch, work, started, plan, out, arms, launches, t0)
    finally:
        kill_waiting(started.values())


def dp_checks(torch, work: str, started: dict, plan, out: dict, arms: dict,
              launches: dict, t0: float) -> dict:
    """dp_train's arms in turn (`dp_finish` of each of `started`) and what
    it holds of each."""
    import signal

    for name, mode, world in plan[:3]:
        d = os.path.join(work, f"dp_{name}")
        got = dp_finish(started.pop(name), mode, d)
        arms[name] = (d, [g[3] for g in got])
        if name == "c_gloo_two_ranks":
            hang = dp_hang_hold(got)
        free_cuda(torch)
    ref = arms["a_one_process"][1][0]
    KEPT["dp_one_process"] = arms["a_one_process"]
    KEPT["dp_two_ranks"] = arms["c_gloo_two_ranks"]
    for name, (d, recs) in arms.items():
        world = recs[0]["world"]
        out[name] = dp_arm_fields(torch, recs, dp_expected(world),
                                  None if name == "a_one_process" else ref)
    b = arms["b_nccl_one_rank"][1][0]
    check(abs(b["losses"][0] - ref["losses"][0]) <= 1e-2 * (1 + abs(ref["losses"][0])),
          f"(b) first-step loss {b['losses'][0]} against (a)'s {ref['losses'][0]}")
    out["b_nccl_one_rank"]["first_loss_abs_diff"] = abs(b["losses"][0] - ref["losses"][0])
    # (c)'s first gradient: the all-reduce, then against (a)
    dc, da = arms["c_gloo_two_ranks"][0], arms["a_one_process"][0]
    local = [torch.load(os.path.join(dc, f"grad_local_rank{r}.pt")) for r in range(2)]
    reduced = torch.load(os.path.join(dc, "grad_rank0.pt"))
    check(torch.equal(reduced, (local[0] + local[1]) / 2),
          "(c) the all-reduced gradient is not the ranks' mean")
    g_a = torch.load(os.path.join(da, "grad_rank0.pt"))
    h_c = torch.load(os.path.join(dc, "head_grad_rank0.pt"))
    h_a = torch.load(os.path.join(da, "head_grad_rank0.pt"))
    out["c_gloo_two_ranks"].update(
        gradient_elements=reduced.numel(), gradient_bytes=4 * reduced.numel(),
        allreduced_gradient_is_rank_mean=True,
        head_grad_rel_err_vs_one_process=rel_err(h_c, h_a),
        grad_rel_err_vs_one_process_end_to_end=rel_err(reduced, g_a),
        grad_rel_err_between_ranks_local=rel_err(local[0], local[1]))
    check(out["c_gloo_two_ranks"]["head_grad_rel_err_vs_one_process"] <= LOGIT_TOL,
          f"(c) head gradient against (a): {out['c_gloo_two_ranks']}")
    out["c_gloo_two_ranks"]["hang_watch"] = hang
    del local, reduced, g_a

    # (c) preempted: SIGTERM to rank 1 alone
    d = os.path.join(work, "dp_c_preempted")
    sent = {}

    def on_line(procs, line):
        if not sent and line.startswith(f"step {DP_SIGTERM_AFTER_LINE}:"):
            sent["t"] = time.perf_counter()
            procs[1].send_signal(signal.SIGTERM)

    got = dp_finish(started.pop("c_preempted"), "gloo", d, on_line=on_line)
    exit_s = time.perf_counter() - sent.get("t", time.perf_counter())
    check("t" in sent, f"rank 0's log never showed step {DP_SIGTERM_AFTER_LINE}")
    recs = [g[3] for g in got]
    k = recs[0]["result"]["steps"]
    check(all(r["result"]["preempted"] and r["result"]["steps"] == k for r in recs),
          f"preempted ranks: {[r['result'] for r in recs]}")
    check(all(r["hashes"] == recs[0]["hashes"] for r in recs),
          "preempted ranks differ after a step")
    ckpts = sorted(int(s) for s in os.listdir(os.path.join(d, "checkpoints")) if s.isdigit())
    with open(os.path.join(d, "checkpoints", str(k), "extra.json")) as f:
        extra = json.load(f)
    with open(os.path.join(d, "emergency_checkpoint.json")) as f:
        emergency = json.load(f)
    check(0 < k < out["steps"] and k % DP_TRAIN["ckpt_every"] != 0
          and ckpts == [k] and extra["kind"] == "preempt"
          and extra["data_state"] == {"epoch": 0, "position": k}
          and emergency["step"] == k,
          f"preempted at step {k}: checkpoints {ckpts}, {extra}, {emergency}")
    want = dp_expected(2)
    per_forward = expected_forward_launches("slowfast_r50")
    pre = {kk: per_forward.get(kk.split(".")[0], 0) * k for kk in SOURCES}
    check(all(r["launches"].get(kk, 0) == pre[kk] for r in recs for kk in SOURCES),
          f"preempted launches {[r['launches'] for r in recs]}, expected {pre}")
    # the same two-rank run again up to the SIGTERM: its first gradient and
    # losses against (c)'s show what a rerun of one step varies by
    c_losses = arms["c_gloo_two_ranks"][1][0]["losses"]
    out["c_preempted"] = dict(
        sigterm_to="rank 1", after_rank0_log_line=DP_SIGTERM_AFTER_LINE,
        stopped_at_step=k, checkpoints=ckpts, checkpoint_kind=extra["kind"],
        emergency_reason=emergency["reason"], sigterm_to_exit_s=exit_s,
        launches_per_rank=recs[0]["launches"],
        grad_rel_err_vs_c=rel_err(torch.load(os.path.join(d, "grad_rank0.pt")),
                                  torch.load(os.path.join(dc, "grad_rank0.pt"))),
        losses=recs[0]["losses"], losses_equal_c=recs[0]["losses"] == c_losses[:k])
    KEPT["dp_rerun"] = d

    # (d) NCCL across two cards, through the launcher
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        out["d_nccl_two_cards"] = dp_launched_arm(torch, work, ref)
    else:
        emit("dp_train_d", run=False,
             why=f"NCCL across cards needs two cards; this machine has {n_cards} "
                 "(NCCL refuses two ranks on one card)")
    launches["dp_train"] = arms["c_gloo_two_ranks"][1][1]["launches"]
    out["seconds"] = time.perf_counter() - t0
    return out


def dp_hang_hold(got: list) -> dict:
    """Arm (c)'s hang watch, held on both ranks: at least one stall, every
    stall after rank 1's armed fault and of the `collective` component
    alone, the stall line naming rank r's `barrier ... name=checkpoint_close`
    (the same op on both ranks), a watchdog stall event in each flight
    record and the `collective.sync` delay event in rank 1's alone; the
    ranks' merged schedules diffed (`diff_schedules`): no divergence, and
    one `step_dispatch` a step after the first. Returns the report."""
    from pytorchvideo_accelerate_tpu_torch.parallel import schedule_recorder as srec

    recs, lines = [g[3] for g in got], [g[1] for g in got]
    fired = recs[1]["fired"]
    check(recs[0]["fired"] == [] and [(f["point"], f["kind"]) for f in fired]
          == [("collective.sync", "delay")], f"(c) fired faults: {fired}")
    fault_ts = fired[0]["ts"]
    out = {"timeout_s": DP_HANG_TIMEOUT_S, "delay_s": DP_HANG_DELAY_S,
           "fault_hit": fired[0]["hit"]}
    for r, (rec, ls) in enumerate(zip(recs, lines)):
        w = rec["watchdog"]
        want = f"barrier host={r}/2 {DP_HANG_BARRIER}"
        wedged = [ln for ln in ls if "collective wedged inside '" in ln]
        stalls = [e for e in w["flight"] if (e["kind"], e["name"]) == ("watchdog", "stall")]
        faults_ = [e for e in w["flight"] if e["kind"] == "fault"]
        check(w["stall_count"] >= 1 and wedged
              and all(f"wedged inside '{want}'" in ln for ln in wedged),
              f"(c) rank {r} watchdog {w['stall_count']} stalls, lines {wedged}")
        check(stalls and all(e["stalled"] == ["collective"] and e["ts"] >= fault_ts
                             for e in stalls),
              f"(c) rank {r} stall events {stalls} (the fault at {fault_ts})")
        check([(e["name"], e["fault_kind"]) for e in faults_]
              == ([("collective.sync", "delay")] if r == 1 else []),
              f"(c) rank {r} fault events {faults_}")
        detail, age = w["last_attribution"]["collective"]
        out[f"rank{r}"] = {"stall_count": w["stall_count"], "wedged_inside": detail,
                           "stall_age_s": age, "stall_after_fault_s":
                           [e["ts"] - fault_ts for e in stalls]}
    merged = {**recs[0]["schedule"], **recs[1]["schedule"]}
    report = srec.diff_schedules(merged)
    check(sorted(merged) == ["host=0/2", "host=1/2"] and not report["diverged"],
          srec.format_divergence(report))
    counts = srec.op_counts(merged["host=0/2"])
    steps = len(recs[0]["losses"])
    check(counts.get("step_dispatch") == steps - 1,
          f"(c) step_dispatch sections {counts}, expected {steps - 1}")
    out.update(schedule_diverged=False, schedule_lengths=report["lengths"],
               schedule_op_counts=counts)
    return out


def dp_launched_arm(torch, work: str, ref: dict) -> dict:
    """(d): `launch.py --num_processes 2` of a dp child per card over NCCL
    (the launcher's PVA_* env), held as (c)."""
    import threading

    d = os.path.join(work, "dp_d_nccl_two_cards")
    os.makedirs(d, exist_ok=True)
    script = os.path.join(d, "dp_launched.py")
    root = os.path.dirname(os.path.abspath(__file__))
    with open(script, "w") as f:
        f.write("import os, sys\n"
                f"sys.path.insert(0, {root!r})\n"
                "import chip_smoke\n"
                "chip_smoke.dp_child(['env', os.environ['PVA_PROCESS_ID'], "
                "os.environ['PVA_NUM_PROCESSES'], '', sys.argv[1]] + sys.argv[2:])\n")
    argv = train_argv(d, spec=dict(DP_TRAIN, batch=DP_TRAIN["batch"] // 2))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "pytorchvideo_accelerate_tpu_torch.launch",
         "--num_processes", "2", "--timeout", str(DP_CHILD_TIMEOUT_S), "--",
         script, d, *argv], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines, records = [], []
    timer = threading.Timer(DP_CHILD_TIMEOUT_S + 30, proc.kill)
    timer.start()
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            body = line.split("] ", 1)[1] if line.startswith("[rank ") else line
            if body.startswith("CHILD_RESULT "):
                records.append(json.loads(body[len("CHILD_RESULT "):]))
        proc.wait()
    finally:
        timer.cancel()
    check(proc.returncode == 0 and len(records) == 2,
          f"(d) launch rc {proc.returncode}: {lines[-25:]}")
    records.sort(key=lambda r: r["rank"])
    return dp_arm_fields(torch, records, dp_expected(2), ref)


# --- slice 18: the debug flags and the device probe on one Trainer --------------

# SlowFast-R50 at the reference geometry, B=8, one micro-step a step: 2 clean
# steps, then the 3rd dispatch poisoned by a `step.dispatch` "nan" plan
HANG_TRAIN = dict(SLOWFAST_TRAIN, batch=8, accum=1, epochs=1, videos=24, ckpt_every=0)
HANG_ARGV = ["--debug_nans", "--debug_asserts", "--device_init_timeout", "120",
             "--obs.watchdog_timeout_s", "30"]
HANG_NAN_HIT = 2
# the kernel rows on slice 18's in-process path
HANG_LINE = {"hang_watch": ("fused_pw_bn_act", "fused_pw_bn_act.bwd_dx",
                            "fused_conv_bn_act", "fused_conv_bn_act.bwd_dx")}


def hang_watch_phase(torch, work: str, launches: dict) -> dict:
    """Phase 42. A full-width SlowFast-R50 Trainer with `HANG_ARGV`: the
    device probe's child reported the card (its seconds reported); the
    counters zeroed just before fit(), read before the 3rd dispatch: the 2
    clean steps' launches exact, no stall; the 3rd dispatch, poisoned by
    the armed `step.dispatch` "nan", raises FloatingPointError naming a
    module of the forward (and launches nothing: the stem, a plain conv,
    traps it); then the first batch with a label of rank 2 raises
    AssertionError out of the step with no launch and the step count
    unchanged. Reports the synchronised step ms under the debug flags
    beside train_timing's B=8 micro-step (not held: anomaly mode and a host
    read per module are slow by design)."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.reliability import faults
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    t0 = time.perf_counter()
    free_cuda(torch)
    trainer = Trainer(parse_cli(train_argv(os.path.join(work, "hang_watch"),
                                           spec=HANG_TRAIN) + HANG_ARGV))
    built_s = time.perf_counter() - t0
    probe = trainer.device_probe
    check(probe is not None and probe["ok"] and probe["stdout"].startswith("cuda "),
          f"the device probe: {probe}")
    step = trainer.train_step
    seen = {"ms": [], "first": None, "launches": None}

    def timed(state, batch):
        if len(seen["ms"]) == HANG_NAN_HIT:
            seen["launches"] = dict(fused.LAUNCHES)  # the clean steps'
        if seen["first"] is None:
            seen["first"] = batch
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        seen["ms"].append((time.perf_counter() - t) * 1e3)
        return m

    trainer.train_step = timed
    faults.arm(faults.FaultPlan(SEED, [faults.FaultSpec(
        "step.dispatch", kind="nan", at_hits=(HANG_NAN_HIT,))]))
    fused.reset_launch_counts()
    raised = None
    try:
        trainer.fit()
    except FloatingPointError as e:
        raised = str(e)
    finally:
        faults.disarm()
    after = dict(fused.LAUNCHES)
    check(raised is not None and "NaN in the output of module " in raised,
          f"the poisoned step raised {raised!r}, not FloatingPointError")
    check(len(seen["ms"]) == HANG_NAN_HIT and seen["launches"] is not None,
          f"clean steps {seen['ms']}")
    want = expected_train_launches(dict(HANG_TRAIN, videos=HANG_NAN_HIT * HANG_TRAIN["batch"],
                                        val_videos=0),
                                   expected_forward_launches("slowfast_r50"))
    check(all(seen["launches"][k] == want[k] for k in SOURCES),
          f"hang_watch launches {seen['launches']}, expected {want}")
    check(trainer.watchdog.stall_count == 0,
          f"{trainer.watchdog.stall_count} stalls: {trainer.watchdog.last_attribution}")
    launches["hang_watch"] = seen["launches"]
    nan_step_launches = {k: after[k] - seen["launches"][k] for k in SOURCES
                         if after[k] != seen["launches"][k]}
    good = seen.pop("first")
    bad = dict(good, label=good["label"][:, None])
    s0 = trainer.state.step
    fused.reset_launch_counts()
    asserted = None
    try:
        step(trainer.state, bad)
    except AssertionError as e:
        asserted = str(e)
    check(asserted is not None and "label of shape" in asserted
          and not any(fused.LAUNCHES.values()) and trainer.state.step == s0,
          f"the malformed batch: {asserted!r}, launches {fused.LAUNCHES}, step "
          f"{trainer.state.step} (was {s0})")
    del trainer, good, bad, step
    free_cuda(torch)
    return {"model": "slowfast_r50", "batch": HANG_TRAIN["batch"], "flags": HANG_ARGV,
            "probe_s": probe["elapsed_s"], "probe_stdout": probe["stdout"],
            "trainer_build_s": built_s, "clean_steps": HANG_NAN_HIT,
            "launches": launches["hang_watch"], "stall_count": 0,
            "step_ms_debug_flags": seen["ms"],
            "train_timing_micro_step_ms_auto": KEPT.get("train_timing_micro_step_ms"),
            "nan_raised": raised, "nan_step_launches": nan_step_launches,
            "malformed_batch_raised": asserted,
            "seconds": time.perf_counter() - t0}


# --- slice 19: the process transport, tracing and the profiler ------------------

# a full-width SlowFast-R50 Trainer, B=8, 4 steps of synthetic clips (8 val
# clips: one eval forward) through the process transport, with the
# run-relative profile window of steps 1 and 2 and every step traced
OBSERVE_TRAIN = dict(SLOWFAST_TRAIN, batch=8, accum=1, epochs=1, videos=32, ckpt_every=0)
OBSERVE_WINDOW = (1, 3)
OBSERVE_ARGV = ["--data.transport", "process",
                "--obs.profile_steps", "%d..%d" % OBSERVE_WINDOW,
                "--obs.trace_sample_rate", "1.0"]
OBSERVE_LINE = {"observe_train": ("fused_pw_bn_act", "fused_pw_bn_act.bwd_dx",
                                  "fused_conv_bn_act", "fused_conv_bn_act.bwd_dx")}
# the transport arm: one epoch of 16 fp32 clips in batches of 8, 8 workers
TRANSPORT_CLIPS, TRANSPORT_WORKERS = 16, 8
# edf_serve's POST /profile window, seconds (at least; longer where the
# realtime request before it took longer than half of it), and its
# head-sampling rate
EDF_PROFILE_S = 2
EDF_TRACE_RATE = 0.001


def window_launches(trace_json: str) -> dict:
    """Device kernels by class (`KERNEL_CLASSES`) in a profile window's
    Chrome trace (`obs/profiler.py`: events of category "kernel"), and the
    CPU ops it holds by thread."""
    with open(trace_json) as f:
        events = json.load(f)["traceEvents"]
    kernels, cpu_tids = {}, {}
    for e in events:
        if e.get("cat") == "kernel":
            cls = next((c for c, keys in KERNEL_CLASSES
                        if any(k in e["name"] for k in keys)), "other")
            kernels[cls] = kernels.get(cls, 0) + 1
        elif e.get("cat") == "cpu_op":
            cpu_tids[str(e.get("tid"))] = cpu_tids.get(str(e.get("tid")), 0) + 1
    return {"kernels_by_class": kernels, "cpu_ops_by_tid": cpu_tids,
            "events": len(events), "mb": os.path.getsize(trace_json) / 1e6}


def same_bytes(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)))


class CudaTouchingSource:
    """A clip source whose samples touch the card: in a forked worker torch
    raises, and the error must come back in-band."""

    num_classes = 1

    def __len__(self):
        return 1

    def get(self, index, epoch):
        import torch

        return {"x": torch.zeros(1, device="cuda").cpu().numpy()}


def transport_phase(torch, work: str) -> dict:
    """Phase 8b. The process transport at full width: the Trainer's train
    transforms (32 frames at 256^2, PackPathway, fp32) over synthetic
    clips, B=8, `TRANSPORT_CLIPS` clips, `TRANSPORT_WORKERS` workers: the
    native library built (no fallback to threads: `transport` stays
    "process"), the workers forked, one epoch's batches byte-equal to the
    thread transport's; each transport's clips/s over its epoch (a reading);
    a worker that touches CUDA after the fork fails in-band with torch's
    "Cannot re-initialize CUDA in forked subprocess"."""
    from pytorchvideo_accelerate_tpu_torch import native
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.data.pipeline import (
        ClipLoader,
        SyntheticClipSource,
    )
    from pytorchvideo_accelerate_tpu_torch.data.transforms import make_transform
    from pytorchvideo_accelerate_tpu_torch.native.shm_loader import ShmWorkerPool

    t0 = time.perf_counter()
    check(native.load() is not None,
          f"the native loader library did not build: {native.load_error()}")
    d = parse_cli(train_argv(work, spec=OBSERVE_TRAIN)).data
    tf = make_transform(training=True, num_frames=d.num_frames, is_slowfast=True,
                        slowfast_alpha=ALPHA, min_short_side_scale=d.min_short_side_scale,
                        max_short_side_scale=d.max_short_side_scale,
                        crop_size=d.crop_size, mean=d.mean, std=d.std,
                        horizontal_flip_p=d.horizontal_flip_p, output_dtype="float32")
    source = SyntheticClipSource(tf, num_videos=TRANSPORT_CLIPS,
                                 num_classes=NUM_CLASSES, seed=SEED)
    batches, seconds, pool = {}, {}, {}
    for transport in ("thread", "process"):
        loader = ClipLoader(source, OBSERVE_TRAIN["batch"], shuffle=True, seed=SEED,
                            num_workers=TRANSPORT_WORKERS, transport=transport)
        check(loader.transport == transport,
              f"the {transport} transport runs as {loader.transport}")
        try:
            t = time.perf_counter()
            batches[transport] = list(loader.epoch(0))
            seconds[transport] = time.perf_counter() - t
            if transport == "process":
                p = loader._shm_pool
                pool = {"forks": p.forks, "slot_bytes": p.slot_bytes,
                        "slots_per_worker": p.slots_per_worker,
                        "ring_bytes": p.forks * p.slots_per_worker * p.slot_bytes}
        finally:
            loader.close()
    n = TRANSPORT_CLIPS // OBSERVE_TRAIN["batch"]
    check(len(batches["thread"]) == len(batches["process"]) == n,
          f"batches {len(batches['thread'])} / {len(batches['process'])}, expected {n}")
    check(pool["forks"] == TRANSPORT_WORKERS, f"forked workers {pool['forks']}")
    for i, (a, b) in enumerate(zip(batches["thread"], batches["process"])):
        check(set(a) == set(b) and all(same_bytes(a[k], b[k]) for k in a),
              f"batch {i} of the process transport differs from the thread "
              "transport's: max |diff| " + str({
                  k: float(np.abs(np.asarray(a[k], np.float64) - b[k]).max())
                  for k in a}))
    sample_mb = sum(v[0].nbytes for v in batches["process"][0].values()) / 1e6
    del batches
    torch.cuda.init()  # the parent's CUDA context, as in every later phase
    cuda_pool = ShmWorkerPool(CudaTouchingSource(), num_workers=1, slot_bytes=4096,
                              timeout_ms=60_000)
    in_band = None
    try:
        list(cuda_pool.map_epoch([0], 0))
    except RuntimeError as e:
        in_band = str(e)
    check(in_band is not None and "Cannot re-initialize CUDA in forked subprocess"
          in in_band, f"a worker touching CUDA: {in_band!r}")
    return {"model": "slowfast_r50", "clips": TRANSPORT_CLIPS,
            "batch": OBSERVE_TRAIN["batch"], "workers": TRANSPORT_WORKERS,
            "dtype": "float32", "batches_byte_equal": n, "sample_mb": sample_mb,
            **pool, "epoch_s": seconds,
            "clips_per_sec": {k: TRANSPORT_CLIPS / v for k, v in seconds.items()},
            "cuda_in_child": in_band.strip().splitlines()[-1],
            "seconds": time.perf_counter() - t0}


def observe_train_phase(torch, work: str, launches: dict) -> dict:
    """Phase 8c. A full-width SlowFast-R50 Trainer (B=8, 4 steps, one eval
    forward) with `OBSERVE_ARGV`: both loaders on the process transport
    (their workers forked: `ShmWorkerPool._spawn` counted), every loss
    finite, the launches exact (counters zeroed just before fit()); the
    profile window `profile_steps_1_3/` published (no dot-prefixed
    temporary directory left) whose trace holds rows 1 + 1b and 2 + 2b's
    launches of its micro-steps exactly ((41 + 41) and (51 + 51) each);
    `trace_ring.json` one `train_step` root per step with its `gstep`, an
    `h2d` span inside a step's trace; `pva-torch-trace` (the module's CLI)
    merging the ring with the flight record, its summary counting both
    files' events and the 4 traces."""
    from pytorchvideo_accelerate_tpu_torch import obs
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.native import shm_loader
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    t0 = time.perf_counter()
    free_cuda(torch)
    out = os.path.join(work, "observe_train")
    forks = []
    spawn = shm_loader.ShmWorkerPool._spawn

    def counted(pool, indices, epoch):
        spawn(pool, indices, epoch)
        forks.append(len(pool._pids))

    shm_loader.ShmWorkerPool._spawn = counted
    try:
        trainer = Trainer(parse_cli(train_argv(out, spec=OBSERVE_TRAIN) + OBSERVE_ARGV))
        transports = (trainer.train_loader.transport, trainer.val_loader.transport)
        check(transports == ("process", "process"),
              f"the loaders run {transports}: a fallback to threads")
        step, losses = trainer.train_step, []

        def recording(state, batch):
            m = step(state, batch)
            losses.append(m["loss"])
            return m

        trainer.train_step = recording
        fused.reset_launch_counts()
        t_fit = time.perf_counter()
        res = trainer.fit()
        fit_s = time.perf_counter() - t_fit
        counts = dict(fused.LAUNCHES)
        flight = obs.get_recorder().dump()
    finally:
        shm_loader.ShmWorkerPool._spawn = spawn
        obs.trace.disable_tracing()
        obs.profiler.configure(enabled=False)
    losses = [float(x) for x in losses]
    steps = OBSERVE_TRAIN["videos"] // OBSERVE_TRAIN["batch"]
    check(len(losses) == steps and all(np.isfinite(losses)), f"losses {losses}")
    want = expected_train_launches(OBSERVE_TRAIN, expected_forward_launches("slowfast_r50"))
    check(all(counts[k] == want[k] for k in SOURCES),
          f"observe_train launches {counts}, expected {want}")
    launches["observe_train"] = counts
    check(len(forks) == 2 and all(f == trainer.train_loader.num_workers for f in forks),
          f"forked workers per epoch pass {forks}")
    check(not any("process transport unavailable" in json.dumps(e)
                  for e in obs.get_recorder().snapshot()),
          "the flight recorder holds a fallback to threads")
    tag = "steps_%d_%d" % OBSERVE_WINDOW
    listed = sorted(os.listdir(out))
    check(f"profile_{tag}" in listed and not any(p.startswith(".profile_tmp")
                                                 for p in listed),
          f"output dir {listed}")
    window = window_launches(os.path.join(out, f"profile_{tag}", "trace.json"))
    micro = (OBSERVE_WINDOW[1] - OBSERVE_WINDOW[0]) * OBSERVE_TRAIN["accum"]
    want_window = {k: 2 * n * micro for k, n in SITES_PER_FORWARD.items()}
    got_window = {k: window["kernels_by_class"].get(k, 0) for k in want_window}
    check(got_window == want_window,
          f"the profile window's kernels {got_window}, expected {want_window} "
          f"({micro} micro-steps, forward + dx)")
    ring_path = os.path.join(out, "trace_ring.json")
    with open(ring_path) as f:
        ring = json.load(f)["traceEvents"]
    roots = [e for e in ring if e["name"] == "train_step"]
    check([e["args"]["gstep"] for e in roots] == list(range(steps))
          and all("parent_id" not in e["args"] for e in roots),
          f"train_step roots {[e['args'] for e in roots]}")
    ids = {e["args"]["trace_id"] for e in roots}
    h2d = [e for e in ring if e["name"] == "h2d" and e["args"]["trace_id"] in ids]
    check(len(h2d) >= 1, "no h2d span inside a train_step trace")
    merged = os.path.join(out, "merged.json")
    cli = subprocess.run([sys.executable, "-m",
                          "pytorchvideo_accelerate_tpu_torch.obs.tracetool",
                          "--out", merged, ring_path, flight],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(cli.returncode == 0, f"pva-torch-trace exit {cli.returncode}: {cli.stderr[-500:]}")
    summary = json.loads(cli.stdout.strip().splitlines()[-1])
    with open(flight) as f:
        n_flight = len(json.load(f)["events"])
    check(summary["events"] == len(ring) + n_flight and summary["traces"] == len(ids)
          and summary["pids"] == [os.getpid()],
          f"pva-torch-trace summary {summary}, ring {len(ring)} + flight {n_flight} "
          f"events, {len(ids)} traces")
    del trainer, step
    free_cuda(torch)
    return {"model": "slowfast_r50", "batch": OBSERVE_TRAIN["batch"], "steps": steps,
            "flags": OBSERVE_ARGV, "losses": losses, "launches": counts,
            "forks_per_epoch_pass": forks, "fit_s": fit_s,
            "fit_clips_per_sec": res.get("clips_per_sec"),
            "input_wait_frac": res.get("input_wait_frac"),
            "window": {"tag": tag, "micro_steps": micro, "launches": got_window,
                       **window},
            "trace_ring_events": len(ring), "train_step_roots": len(roots),
            "h2d_in_step_traces": len(h2d), "tracetool_summary": summary,
            "seconds": time.perf_counter() - t0}


# --- slice 13: fine-tuning from pretrained weights ------------------------------

# full-width checkpoints in the hub layout (every key and shape of the real
# one: tests/hub_manifests.py), values from a numpy seed; each converted by
# the CLI and fine-tuned through run.py with `--model.pretrained`. SlowFast-R50
# at train_phase's shape, 3 steps of B=8 x 4 (24 val clips); hub
# mvit_base_16x4 (T=8) into mvit_b_32x3 (T=16) under remat as remat_train
# runs it, 2 steps of B=4; X3D-S (13 frames at 160^2), 2 steps of B=8;
# VideoMAE-B pretrained 2 steps with a checkpoint at the end, exported, then
# fine-tuned 2 steps
HUB_FINETUNE = dict(SLOWFAST_TRAIN, accum=4, epochs=1, videos=96, ckpt_every=0)
HUB_INTERP = dict(REMAT_TRAIN, epochs=1, videos=8, ckpt_every=0,
                  argv=REMAT_TRAIN["argv"] + ["--model.remat"])
HUB_X3D = dict(X3D_TRAIN, name="x3d_s", epochs=1, videos=16, ckpt_every=0)
MAE_PRETRAIN = dict(MAE_TRAIN, ckpt_every=2)
MAE_FINETUNE = dict(VIDEOMAE_TRAIN, ckpt_every=0)
# the loaded position table against the plain resize of the file's on the
# card: f32 trilinear weights of the same 8 taps in another order
POS_TOL = 1e-6


def hub_state_dict(torch, name: str, rng) -> dict:
    """A full-width hub checkpoint of `name` (a key of tests/hub_manifests.py
    MANIFESTS) as float32 tensors: conv and linear weights He-normal (fan-in:
    every dimension but the first), a residual branch's last BN scale
    (`norm_c`) x RESIDUAL_BN_SCALE and a transformer block's `attn.proj` /
    `mlp.fc2` x RESIDUAL_PROJ_SCALE (as the seeded serving weights), norm
    scales in [0.5, 1], BN running variances in [0.5, 1.5], every other
    tensor (biases, running means, position tables) 0.02 normal;
    `num_batches_tracked` 0."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from hub_manifests import MANIFESTS

    sd = {}
    for key, shape in MANIFESTS[name]().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=torch.int64)
            continue
        if key.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("weight") and len(shape) >= 2:
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
            if key.endswith(("attn.proj.weight", "mlp.fc2.weight")):
                v *= RESIDUAL_PROJ_SCALE
        elif key.endswith("weight"):
            v = rng.uniform(0.5, 1.0, shape)
            if key.endswith("norm_c.weight"):
                v *= RESIDUAL_BN_SCALE
        else:
            v = rng.standard_normal(shape) * 0.02
        sd[key] = torch.from_numpy(v.astype(np.float32))
    return sd


def write_hub_checkpoint(torch, name: str, d: str, seed: int,
                         wrap: bool = False) -> dict:
    """`hub_state_dict(name)` saved as `<d>/<name>.pth` (under a
    `model_state` key with `wrap`, as pytorchvideo's own checkpoints hold
    it), then converted by the CLI into `<d>/<name>.npz`. Returns the paths,
    the seconds of each, the converted tensors by port key and their count
    (MViT's joint position table replaces its three separable ones)."""
    from pytorchvideo_accelerate_tpu_torch.models import convert

    os.makedirs(d, exist_ok=True)
    pth, npz = os.path.join(d, f"{name}.pth"), os.path.join(d, f"{name}.npz")
    t0 = time.perf_counter()
    sd = hub_state_dict(torch, name, np.random.default_rng(seed))
    torch.save({"model_state": sd} if wrap else sd, pth)
    t1 = time.perf_counter()
    convert.main([pth, npz])
    t2 = time.perf_counter()
    tree = convert.load_converted(npz)
    n = len(convert.flatten_tree(tree))
    return {"pth": pth, "npz": npz, "write_s": t1 - t0, "convert_s": t2 - t1,
            "file_mb": os.path.getsize(pth) / 1e6, "tensors": n,
            "file": {k: torch.from_numpy(v)
                     for k, v in convert.state_dict_from_jax(tree).items()}}


def host_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def finetune_fit(torch, argv, pretrain: bool = False) -> dict:
    """`run.main(argv)`, the launch counters zeroed and the peak memory reset
    just before it, both read just after. `loop.load_pretrained` is wrapped
    to keep its report and time it; the train step to copy the model's state
    to the host before the first step (the state after init) and to time
    each step (synchronised before and after). Returns those, the final
    state and the parameter names."""
    from pytorchvideo_accelerate_tpu_torch import run as trun
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.trainer import loop

    step_name = "make_pretrain_step" if pretrain else "make_train_step"
    real_load, real_make = loop.load_pretrained, getattr(loop, step_name)
    seen = {"report": None, "load_s": None, "init": None, "step_ms": [],
            "losses": []}

    def load(path, model, family=""):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = real_load(path, model, family)
        torch.cuda.synchronize()
        seen["load_s"] = time.perf_counter() - t0
        seen["report"] = report
        return report

    def make(model, optimizer, **kw):
        step = real_make(model, optimizer, **kw)
        seen["model"] = model

        def timed(state, batch):
            if seen["init"] is None:
                seen["init"] = host_state(model)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            seen["step_ms"].append(1e3 * (time.perf_counter() - t0))
            seen["losses"].append(m["loss"].item())
            return m
        return timed

    loop.load_pretrained = load
    setattr(loop, step_name, make)
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = trun.main(argv)
    finally:
        loop.load_pretrained = real_load
        setattr(loop, step_name, real_make)
    seen["fit_s"] = time.perf_counter() - t0
    seen["launches"] = dict(fused.LAUNCHES)
    seen["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    model = seen.pop("model")
    seen["final"] = host_state(model)
    seen["params"] = [n for n, _ in model.named_parameters()]
    del model
    free_cuda(torch)
    check(all(np.isfinite(v) for v in seen["losses"]),
          f"non-finite fine-tuning loss {seen['losses']}")
    check(result["steps"] == len(seen["losses"]),
          f"steps {result['steps']}, timed {len(seen['losses'])}")
    seen["result"] = result
    return seen


def fit_fields(run: dict) -> dict:
    """What a phase reports of one `finetune_fit`."""
    ms = run["step_ms"]
    return {"fit_s": run["fit_s"], "load_s": run["load_s"], "step_ms": ms,
            "step_ms_median_after_first": float(np.median(ms[1:] or ms)),
            "losses": run["losses"], "peak_mem_gb": run["peak_mem_gb"],
            "launches": {k: v for k, v in run["launches"].items() if v},
            "report_counts": {k: len(v) for k, v in (run["report"] or {}).items()}}


def bitwise_mismatches(torch, got: dict, want: dict, keys) -> list:
    """The keys of `keys` at which two state dicts differ (bitwise)."""
    return unequal_leaves(torch, {k: got[k] for k in keys},
                          {k: want[k] for k in keys})


def hub_finetune_phase(torch, work: str, launches: dict) -> dict:
    """Phase 37. The reference's recipe: a full-width `slowfast_r50` hub
    checkpoint (K400 head, `model_state` wrapper) converted by the CLI,
    then 3 optimizer steps of SlowFast-R50 on 700-class clips at
    train_phase's shape with `--model.pretrained --model.pretrained_path
    X.npz --freeze_backbone`. Held: every backbone tensor loaded, the head's
    `proj` kernel and bias mismatched (kept fresh), nothing else; the state
    after init the file's tensors bitwise; after the steps every frozen
    parameter bitwise unchanged and every head parameter moved; launches
    exact (rows 1, 1b, 2, 2b; counters zeroed just before fit()); the `.pth`
    loaded directly into a fresh model bitwise the `.npz` route. Then the
    same fine-tune without `--freeze_backbone`, for its step time."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models import convert, create_model

    t0 = time.perf_counter()
    d = os.path.join(work, "hub_finetune")
    hub = write_hub_checkpoint(torch, "slowfast_r50", d, SEED + 130, wrap=True)
    spec = HUB_FINETUNE
    argv = train_argv(os.path.join(d, "frozen"), spec=spec) + [
        "--model.pretrained", "--model.pretrained_path", hub["npz"],
        "--freeze_backbone"]
    frozen = finetune_fit(torch, argv)
    report, init, final = frozen["report"], frozen["init"], frozen["final"]
    head = ["params/head/proj/bias", "params/head/proj/kernel"]
    check(sorted(report["mismatched"]) == head and report["kept"] == []
          and report["interpolated"] == []
          and len(report["loaded"]) == hub["tensors"] - len(head),
          f"report {({k: v[:4] for k, v in report.items()})}")
    check(sorted(hub["file"]) == sorted(init), "the file's keys are not the model's")
    body = [k for k in hub["file"] if not k.startswith("head.")]
    bad = bitwise_mismatches(torch, init, hub["file"], body)
    check(not bad, f"state after init differs from the file at {bad[:4]}")
    moved = [n for n in frozen["params"] if not n.startswith("head.")
             and not torch.equal(final[n], init[n])]
    still = [n for n in frozen["params"] if n.startswith("head.")
             and torch.equal(final[n], init[n])]
    check(not moved and not still, f"frozen moved {moved[:4]}, head still {still}")
    want = expected_train_launches(spec, expected_forward_launches("slowfast_r50"))
    check(all(frozen["launches"][k] == want[k] for k in SOURCES),
          f"launches {frozen['launches']}, expected {want}")
    launches["hub_finetune"] = frozen["launches"]

    unfrozen = finetune_fit(torch, argv[:-1])  # without --freeze_backbone
    check(all(unfrozen["launches"][k] == want[k] for k in SOURCES),
          f"unfrozen launches {unfrozen['launches']}, expected {want}")

    cfg = parse_cli(argv)
    model = create_model(cfg.model, cfg.mixed_precision, seed=cfg.seed,
                         data_cfg=cfg.data).cuda()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    direct = convert.load_pretrained(hub["pth"], model, "slowfast_r50")
    torch.cuda.synchronize()
    pth_load_s = time.perf_counter() - t1
    check(direct == report, "the .pth load reports otherwise than the .npz load")
    bad = bitwise_mismatches(torch, host_state(model), init, init)
    check(not bad, f".pth load differs from the .npz load at {bad[:4]}")
    del model
    free_cuda(torch)
    return {"checkpoint": "slowfast_r50 (tests/hub_manifests.py), K400 head",
            "file_mb": hub["file_mb"], "tensors": hub["tensors"],
            "write_s": hub["write_s"], "convert_s": hub["convert_s"],
            "pth_load_s": pth_load_s, "mismatched": report["mismatched"],
            "frozen": fit_fields(frozen), "unfrozen": fit_fields(unfrozen),
            "expected_launches": want, "frozen_bitwise": True,
            "pth_equals_npz_bitwise": True,
            "seconds": time.perf_counter() - t0}


def hub_interp_finetune_phase(torch, work: str, launches: dict) -> dict:
    """Phase 38. A full-width hub `mvit_b` (16x4: a (8, 56, 56) position
    grid) converted by the CLI and fine-tuned as `mvit_b_32x3` (32 frames,
    a (16, 56, 56) grid) under `--model.remat`, `attention pallas,
    depthwise_impl pallas`, 2 steps of B=4. Held: the report interpolates
    `pos_embed` (8, 56, 56) -> (16, 56, 56), mismatches only the head; the
    loaded table within POS_TOL of the plain resize (`F.interpolate`,
    trilinear, align_corners False) of the file's table on the card; every
    other leaf the file's bitwise; launches exact (rows 4, 4b, 5, 6, 7,
    forwards twice a micro-step under remat)."""
    import torch.nn.functional as F

    t0 = time.perf_counter()
    d = os.path.join(work, "hub_interp_finetune")
    hub = write_hub_checkpoint(torch, "mvit_b", d, SEED + 131)
    spec = HUB_INTERP
    argv = train_argv(os.path.join(d, "run"), spec=spec) + [
        "--model.pretrained", "--model.pretrained_path", hub["npz"]]
    run = finetune_fit(torch, argv)
    report, init = run["report"], run["init"]
    check(sorted(hub["file"]) == sorted(init), "the file's keys are not the model's")
    frames = GEOMETRY[spec["name"]][0]
    grid = tuple(init["pos_embed"].shape[1:4])
    check(grid == (frames // 2, 56, 56), f"pos_embed grid {grid}")
    check(report["interpolated"] == [f"params/pos_embed (8, 56, 56)->{grid}"]
          and sorted(report["mismatched"]) == ["params/head/bias", "params/head/kernel"]
          and report["kept"] == [],
          f"report {({k: v[:4] for k, v in report.items()})}")
    table = hub["file"]["pos_embed"].cuda()
    plain = F.interpolate(table.permute(0, 4, 1, 2, 3), size=grid,
                          mode="trilinear", align_corners=False).permute(0, 2, 3, 4, 1)
    pos_err = (init["pos_embed"].cuda() - plain).abs().max().item()
    check(pos_err <= POS_TOL, f"pos_embed {pos_err} from the plain resize")
    body = [k for k in hub["file"] if not k.startswith("head.") and k != "pos_embed"]
    bad = bitwise_mismatches(torch, init, hub["file"], body)
    check(not bad, f"state after init differs from the file at {bad[:4]}")
    per_forward = expected_mvit_launches()
    want = expected_train_launches(spec, per_forward)
    for k in SOURCES:  # under remat each forward kernel runs again in the backward
        if not is_backward(k):
            want[k] += per_forward.get(k, 0) * want["micro_steps"]
    check(all(run["launches"][k] == want[k] for k in SOURCES),
          f"launches {run['launches']}, expected {want}")
    launches["hub_interp_finetune"] = run["launches"]
    return {"checkpoint": "mvit_b 16x4 (tests/hub_manifests.py) into mvit_b_32x3",
            "file_mb": hub["file_mb"], "tensors": hub["tensors"],
            "write_s": hub["write_s"], "convert_s": hub["convert_s"],
            "interpolated": report["interpolated"],
            "pos_embed_max_abs_err": pos_err, "pos_tol": POS_TOL,
            "run": fit_fields(run), "expected_launches": want,
            "seconds": time.perf_counter() - t0}


def hub_x3d_phase(torch, work: str, launches: dict) -> dict:
    """Phase 39. A full-width hub `x3d_s` checkpoint converted by the CLI
    and fine-tuned as X3D-S (13 frames at 160^2, bf16), 2 steps of B=8.
    Held: only the head's `proj` mismatched, every other leaf the file's
    bitwise; launches exact (rows 1, 1b, 3, 3b)."""
    t0 = time.perf_counter()
    d = os.path.join(work, "hub_x3d")
    hub = write_hub_checkpoint(torch, "x3d_s", d, SEED + 132)
    spec = HUB_X3D
    argv = train_argv(os.path.join(d, "run"), spec=spec) + [
        "--model.pretrained", "--model.pretrained_path", hub["npz"]]
    run = finetune_fit(torch, argv)
    report, init = run["report"], run["init"]
    check(sorted(report["mismatched"]) == ["params/proj/bias", "params/proj/kernel"]
          and report["kept"] == [] and report["interpolated"] == [],
          f"report {({k: v[:4] for k, v in report.items()})}")
    check(sorted(hub["file"]) == sorted(init), "the file's keys are not the model's")
    body = [k for k in hub["file"] if not k.startswith("proj.")]
    bad = bitwise_mismatches(torch, init, hub["file"], body)
    check(not bad, f"state after init differs from the file at {bad[:4]}")
    want = expected_train_launches(spec, expected_forward_launches("x3d_m"))
    check(all(run["launches"][k] == want[k] for k in SOURCES),
          f"launches {run['launches']}, expected {want}")
    launches["hub_x3d"] = run["launches"]
    return {"checkpoint": "x3d_s (tests/hub_manifests.py), K400 head",
            "file_mb": hub["file_mb"], "tensors": hub["tensors"],
            "write_s": hub["write_s"], "convert_s": hub["convert_s"],
            "run": fit_fields(run), "expected_launches": want,
            "seconds": time.perf_counter() - t0}


def mae_handoff_phase(torch, work: str, launches: dict) -> dict:
    """Phase 40. BASELINE config 5's handoff: VideoMAE-B MAE pretraining
    (B=8, 16 frames at 224^2) for 2 steps with a checkpoint at the end;
    `pva-torch-convert CKPT_DIR out.npz`; then the VideoMAE-B classifier 2
    steps with `--model.pretrained`. Held: the export is the pretraining
    run's final model state bitwise (params and BN statistics, no optimizer
    state); every encoder leaf of the classifier loaded, bitwise the
    exported one; nothing mismatched; the rest (the head, fc_norm) kept
    fresh; launches exact in both runs (rows 5, 6, 7)."""
    from pytorchvideo_accelerate_tpu_torch.models import convert

    t0 = time.perf_counter()
    d = os.path.join(work, "mae_handoff")
    pre = finetune_fit(torch, train_argv(os.path.join(d, "pre"), spec=MAE_PRETRAIN),
                       pretrain=True)
    want_pre = expected_train_launches(
        MAE_PRETRAIN, expected_forward_launches("videomae_b_pretrain"))
    check(all(pre["launches"][k] == want_pre[k] for k in SOURCES),
          f"pretrain launches {pre['launches']}, expected {want_pre}")
    npz = os.path.join(d, "mae.npz")
    t1 = time.perf_counter()
    convert.main([os.path.join(d, "pre", "checkpoints"), npz])
    export_s = time.perf_counter() - t1
    exported = {k: torch.from_numpy(v) for k, v in
                convert.state_dict_from_jax(convert.load_converted(npz)).items()}
    check(sorted(exported) == sorted(pre["final"]), "the export's keys are not "
          "the pretraining model's")
    bad = bitwise_mismatches(torch, exported, pre["final"], exported)
    check(not bad, f"export differs from the final state at {bad[:4]}")

    argv = train_argv(os.path.join(d, "ft"), spec=MAE_FINETUNE) + [
        "--model.pretrained", "--model.pretrained_path", npz]
    ft = finetune_fit(torch, argv)
    report, init = ft["report"], ft["init"]
    encoder = [k for k in init if k.startswith("encoder.")]
    check(len(report["loaded"]) == len(encoder) and report["mismatched"] == []
          and report["interpolated"] == [] and "params/head/kernel" in report["kept"]
          and all(p.startswith("params/encoder/") for p in report["loaded"])
          and not any(p.startswith("params/encoder/") for p in report["kept"]),
          f"report {({k: v[:4] for k, v in report.items()})}")
    bad = bitwise_mismatches(torch, init, exported, encoder)
    check(not bad, f"encoder after init differs from the export at {bad[:4]}")
    want = expected_train_launches(MAE_FINETUNE, expected_forward_launches("videomae_b"))
    check(all(ft["launches"][k] == want[k] for k in SOURCES),
          f"fine-tune launches {ft['launches']}, expected {want}")
    launches["mae_handoff"] = ft["launches"]
    return {"export_s": export_s, "export_mb": os.path.getsize(npz) / 1e6,
            "exported_tensors": len(exported), "kept": report["kept"],
            "pretrain": fit_fields(pre), "finetune": fit_fields(ft),
            "expected_launches": want, "seconds": time.perf_counter() - t0}



# --- the model axis of the train mesh ---------------------------------------

# full-width MViT-B 16x4 and VideoMAE-B (16 frames at 224^2, 1568 tokens), a
# global batch of 4 a step, 3 steps and one eval forward, bf16, dropout and
# drop path 0, a checkpoint at the last step; each arm two ranks sharing the
# card over gloo at (data, model) = (1, 2), against one process on the same
# global batch
MA_TRAIN = dict(X3D_TRAIN, batch=4, videos=12, ckpt_every=3, lr=TRANSFORMER_LR)
MA_DROP = ["--model.dropout_rate", "0"]
MA_PIPE = ["--parallel.pipeline_stages", "2"]
MA_ARMS = {  # arm: (model, attention, extra flags)
    "a_mvit_tp": ("mvit_b", "pallas", ["--model.depthwise_impl", "pallas"]),
    "b_videomae_tp": ("videomae_b", "pallas", []),
    "c_videomae_ulysses": ("videomae_b", "ulysses", []),
    "d_videomae_ring": ("videomae_b", "ring", []),
    # the pipeline stages (P = 2 over the model axis, M = 2 P = 4 microbatches
    # of one clip): the encoder's 12 blocks cut 6 | 6, the MAE decoder's 4
    # cut 2 | 2
    "f_videomae_pipe": ("videomae_b", "pallas", MA_PIPE),
    "g_mae_pipe": ("videomae_b_pretrain", "pallas", MA_PIPE),
}
MA_REFS = {"mvit_b": MA_ARMS["a_mvit_tp"], "videomae_b": MA_ARMS["b_videomae_tp"],
           "videomae_b_pretrain": ("videomae_b_pretrain", "pallas", [])}
MA_STAGES, MA_MICRO = 2, 4
MA_GRAD_TOL = 5e-2  # relative 2-norm of the gathered first-step gradient
MA_CHILD = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke\n"
    "chip_smoke.ma_child(sys.argv[2:])\n")
# the kernel rows on the model axis's path: one rank of model_axis_train's arm (a)
MODEL_AXIS_LINE = {"model_axis_train": ("depthwise3d_s1", "depthwise3d_s1.bwd_dx",
                                        "flash_attention", "flash_attention.bwd_dq",
                                        "flash_attention.bwd_dkv")}
# the kernel rows on the pipeline's path: one stage rank of model_axis_train's
# arm (f)
PIPELINE_LINE = {"model_axis_train_pipeline": ("flash_attention", "flash_attention.bwd_dq",
                                               "flash_attention.bwd_dkv")}


def ma_argv(out: str, name: str, attention: str, extra, model: int) -> list:
    """run.py's argv of one arm: `MA_TRAIN` at `name`'s geometry, bf16,
    head dropout 0, `--mesh.model model` (MViT-B's drop path, which has no
    flag, is set to 0 by `ma_fit`)."""
    spec = dict(MA_TRAIN, name=name, argv=["--model.attention", attention,
                                           *extra, *MA_DROP])
    return train_argv(out, spec=spec) + ["--mesh.model", str(model)]


def state_hash(tree) -> str:
    """sha256 over the tensors of a nested state (sorted keys), bytes on
    the host."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif torch.is_tensor(x):
            h.update(x.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())

    walk(tree)
    return h.hexdigest()


_COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all_single", "batch_isend_irecv")


def ma_fit(torch, argv, dump_dir: str, keep: bool = False):
    """One arm's `run.main`-style fit of `argv` in this process (a rank, or
    the one-process reference): MViT's drop path set to 0; the counters
    zeroed just before fit(); each optimizer step synchronised and timed,
    its collectives counted with their bytes, and this rank's replicated
    leaves (neither tensor- nor fsdp-sharded) and all its parameters
    hashed after it; the first step's gradient, gathered over the fsdp and
    tensor groups, written by rank 0 (a flat f32 vector in parameter
    order). After fit(): the launches, the ring blocks, peak memory, the
    parameters, optimizer-state elements and state bytes (parameters,
    optimizer state, EMA) this rank holds, its mesh coordinates, and the
    hash of the gathered state (a collective). `keep`: return (record,
    trainer), the trainer kept for a restore."""
    import torch.distributed as dist

    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.models.common import DropPath
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.parallel import distributed as pdist
    from pytorchvideo_accelerate_tpu_torch.parallel import pipeline as ppipe
    from pytorchvideo_accelerate_tpu_torch.parallel import ring_attention
    from pytorchvideo_accelerate_tpu_torch.parallel.sharding import full_state_dict
    from pytorchvideo_accelerate_tpu_torch.parallel.tensor_parallel import param_kinds
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    os.makedirs(dump_dir, exist_ok=True)
    t_build = time.perf_counter()
    trainer = Trainer(parse_cli(argv))
    build_s = time.perf_counter() - t_build
    for m in trainer.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    model, axis = trainer.model, trainer.model_axis
    rank = pdist.process_index()
    kinds = param_kinds(model)
    replicated = [p for n, p in model.named_parameters() if not kinds[n]]
    n_params = len(list(model.parameters()))
    rec = {"step_ms": [], "losses": [], "rep_hashes": [], "local_hashes": [],
           "collectives": [], "stage_transfers": []}
    count = {"on": False}
    real = {n: getattr(dist, n) for n in _COLLECTIVES}

    def counting(name):
        def call(*a, **kw):
            if count["on"]:
                t = a[0] if a else None
                nbytes = 0
                if name == "batch_isend_irecv":
                    nbytes = sum(op.tensor.numel() * op.tensor.element_size()
                                 for op in t)
                elif name == "reduce_scatter_tensor":
                    nbytes = a[1].numel() * a[1].element_size()
                elif torch.is_tensor(t):
                    nbytes = t.numel() * t.element_size()
                count[name] = count.get(name, 0) + 1
                count[name + "_bytes"] = count.get(name + "_bytes", 0) + nbytes
            return real[name](*a, **kw)
        return call

    for n in _COLLECTIVES:
        setattr(dist, n, counting(n))
    step = trainer.train_step

    def timed(state, batch):
        torch.cuda.synchronize()
        for k in list(count):
            if k != "on":
                del count[k]
        count["on"] = True
        ppipe.reset_transfers()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        count["on"] = False
        rec["collectives"].append({k: v for k, v in count.items() if k != "on"})
        rec["stage_transfers"].append(dict(ppipe.TRANSFERS))
        rec["losses"].append(float(m["loss"]))
        rec["rep_hashes"].append(state_hash([p.data for p in replicated]))
        rec["local_hashes"].append(
            rec["rep_hashes"][-1] if len(replicated) == n_params
            else state_hash([p.data for p in model.parameters()]))
        if len(rec["step_ms"]) == 1:
            grads = full_state_dict({n: p.grad for n, p in model.named_parameters()},
                                    axis)
            if rank == 0:
                torch.save(torch.cat([g.float().flatten() for g in grads.values()]).cpu(),
                           os.path.join(dump_dir, "grad.pt"))
                if "head.proj.weight" in grads:  # the ResNet families' head
                    torch.save(grads["head.proj.weight"].float().cpu(),
                               os.path.join(dump_dir, "head_grad.pt"))
        return m

    trainer.train_step = timed
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    ring_attention.RING_BLOCKS[0] = 0
    t0 = time.perf_counter()
    try:
        result = trainer.fit()
    finally:
        for n in _COLLECTIVES:
            setattr(dist, n, real[n])
    rec["fit_s"] = time.perf_counter() - t0
    rec["trainer_build_s"] = build_s
    rec["launches"] = dict(fused.LAUNCHES)
    rec["ring_blocks"] = ring_attention.RING_BLOCKS[0]
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["params_this_rank"] = sum(p.numel() for p in model.parameters())
    opt_state = [v for st in trainer.state.optimizer.opt.state.values()
                 for v in st.values() if torch.is_tensor(v) and v.dim()]
    ema = list(trainer.state.ema.values()) if trainer.state.ema else []
    rec["opt_elements_this_rank"] = sum(v.numel() for v in opt_state)
    rec["state_bytes_this_rank"] = {
        "params": sum(p.numel() * p.element_size() for p in model.parameters()),
        "optimizer": sum(v.numel() * v.element_size() for v in opt_state),
        "ema": sum(v.numel() * v.element_size() for v in ema)}
    rec["fsdp_leaves"] = len(axis.fsdp_plan)
    rec["coords"] = (pdist.library_coords(rank, pdist.library_shape())
                     if pdist.library_shape() else None)
    rec["mode"] = axis.mode
    plan = trainer.pipeline_plan
    rec["pipeline"] = plan and {
        "stages": plan.stages, "microbatches": plan.microbatches,
        "bubble_frac_analytic": ppipe.analytic_bubble_frac(plan.stages, plan.microbatches),
        "perf_keys": {k: v for k, v in result.items() if k.startswith("pipeline_")}}
    rec["rank"], rec["world"] = rank, pdist.process_count()
    rec["result"] = result
    rec["checkpoint"] = os.path.join(trainer.checkpointer.directory,
                                     str(trainer.checkpointer.latest_step()))
    rec["gathered_state_hash"] = state_hash(trainer.state.state_dict())
    if keep:
        return rec, trainer
    del trainer, model, replicated
    free_cuda(torch)
    return rec


def ma_child(args) -> None:
    """A model_axis_train child: `mode rank world address dump_dir arms`,
    `arms` a JSON list of [tag, argv]; each arm's fit in turn, one record
    line each (gloo: two ranks on one card; env: the launcher's PVA_* env
    over NCCL, one card a rank)."""
    import torch

    mode, rank, world, address, dump_dir, arms = args
    rank, world = int(rank), int(world)
    # as the smoke's own process (the one-process references) runs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pytorchvideo_accelerate_tpu_torch.parallel import distributed as pdist

    if mode == "gloo":
        pdist.initialize_distributed(address, world, rank, backend="gloo",
                                     timeout_s=DP_CHILD_TIMEOUT_S)
        await_go(os.path.join(dump_dir, "go"))
    for tag, argv in json.loads(arms):
        rec = ma_fit(torch, argv, os.path.join(dump_dir, tag))
        print("CHILD_RESULT " + json.dumps({"tag": tag, **rec}, default=str), flush=True)


def ma_start(mode: str, world: int, out: str, arms) -> list:
    """Start `world` ranks of `mode` that will run `arms` ([(tag, argv)])
    in turn under `out`; they wait for `ma_finish` (`await_go`)."""
    from pytorchvideo_accelerate_tpu_torch.launch import find_free_port

    os.makedirs(out, exist_ok=True)
    address = f"127.0.0.1:{find_free_port()}"
    root = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen(
        [sys.executable, "-u", "-c", MA_CHILD, root, mode, str(r), str(world),
         address, out, json.dumps(arms)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def ma_group(mode: str, world: int, out: str, arms, before=None) -> dict:
    """`world` ranks of `mode` running `arms` ([(tag, argv)]) in turn;
    returns {tag: [each rank's record]}. `before()` runs in this process
    while the ranks start (their imports, the group's join, the card's
    libraries), and the ranks run the arms only after it returned (so the
    arms' timing shares the card with nothing of it)."""
    procs = ma_start(mode, world, out, arms)
    try:
        if before is not None:
            before()
    except BaseException:
        kill_waiting([procs])
        raise
    return ma_finish(procs, mode, out, arms)


def ma_finish(procs: list, mode: str, out: str, arms) -> dict:
    """Let the ranks `ma_start` started under `out` run their `arms`;
    returns {tag: [each rank's record]}."""
    import threading

    world = len(procs)
    go(os.path.join(out, "go"))
    got = [None] * world

    def read(r):
        lines, records = [], []
        timer = threading.Timer(DP_CHILD_TIMEOUT_S * len(arms), procs[r].kill)
        timer.start()
        try:
            for line in procs[r].stdout:
                lines.append(line.rstrip("\n"))
                if line.startswith("CHILD_RESULT "):
                    records.append(json.loads(line[len("CHILD_RESULT "):]))
            procs[r].wait()
        finally:
            timer.cancel()
        got[r] = (lines, records)

    threads = [threading.Thread(target=read, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r, (lines, records) in enumerate(got):
        check(procs[r].returncode == 0 and len(records) == len(arms),
              f"model_axis_train {mode} rank {r} rc {procs[r].returncode}: {lines[-25:]}")
    return {tag: [got[r][1][i] for r in range(world)]
            for i, (tag, _) in enumerate(arms)}


def ma_restore_hash(torch, trainer, ckpt: str) -> tuple:
    """The hash of one process's state (`trainer`'s, the one-process
    reference's) after `Checkpointer.restore` of the step directory `ckpt`,
    and the seconds the restore took."""
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer

    t0 = time.perf_counter()
    Checkpointer(os.path.dirname(ckpt)).restore(trainer.state,
                                                step=int(os.path.basename(ckpt)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return state_hash(trainer.state.state_dict()), seconds


def ma_expected(name: str, attention: str, extra=()) -> dict:
    """Each rank's launches of one arm's fit(): its model's kernels per
    forward (a ring arm's attention launches none) over 3 micro-steps and
    1 eval forward, backward rows over the micro-steps; and the ring's
    online-softmax blocks (2 a ring attention call at cp 2). A pipelined
    arm (`MA_PIPE` in `extra`): a stage rank's micro-step runs its half of
    each stack once a microbatch, forward and backward, and eval runs the
    whole model unpipelined."""
    if "--parallel.pipeline_stages" in extra:
        want = expected_train_launches(dict(MA_TRAIN, name=name), {})
        blocks = VIT_DEPTH + (VIT_DECODER_DEPTH if name.endswith("_pretrain") else 0)
        per_micro = blocks // MA_STAGES * MA_MICRO
        eval_forward = expected_forward_launches(name)["flash_attention"]
        out = {k: 0 for k in SOURCES}
        out["flash_attention"] = (per_micro * want["micro_steps"]
                                  + eval_forward * want["eval_forwards"])
        out["flash_attention.bwd_dq"] = out["flash_attention.bwd_dkv"] = (
            per_micro * want["micro_steps"])
        return {**out, "ring_blocks": 0}
    per_forward = expected_forward_launches(name)
    if attention == "ring":
        per_forward = {k: v for k, v in per_forward.items() if k != "flash_attention"}
    want = expected_train_launches(dict(MA_TRAIN, name=name), per_forward)
    forwards = want["micro_steps"] + want["eval_forwards"]
    blocks = 2 * VIT_DEPTH * forwards if attention == "ring" else 0
    return {**{k: want[k] for k in SOURCES}, "ring_blocks": blocks}


def model_axis_train_phase(torch, work: str, launches: dict) -> dict:
    """Phase 41. The train mesh's model axis on full-width MViT-B 16x4 and
    VideoMAE-B through `run.main`'s Trainer: the one-process references of
    MViT-B, VideoMAE-B and VideoMAE-B pretraining (in this process, which
    joins no group), then the arms (a) MViT-B tensor-parallel, (b)
    VideoMAE-B tensor-parallel, (c) VideoMAE-B Ulysses, (d) VideoMAE-B
    ring, (f) VideoMAE-B and (g) its MAE pretraining in 2 pipeline stages
    (`--parallel.pipeline_stages 2`, 4 microbatches), each two ranks at
    (1, 2) sharing the card over gloo (one child group running them in
    turn), every run on the same global batch of 4 clips a step, 3 steps.
    Held per arm: the losses within 5e-2 * (1 + |loss|) of one process's;
    the first step's gathered gradient (the same weights and clips) within
    5e-2 relative 2-norm of one process's; the replicated leaves bitwise
    equal across the ranks after every step (a pipelined arm's: every
    leaf); exact launches a rank (rows 4-7 for (a), 5-7 for (b), (c), (f)
    and (g), none for (d), whose ring blocks are counted); the checkpoint
    written at (1, 2) restored in one process bitwise the gathered state.
    (e) runs (a) over NCCL on two cards where the machine has them, and
    ring and Ulysses there over NCCL against one card (`ma_nccl_cp`); (h)
    runs (f) there. Reports step ms against one process, peak memory and
    parameters a rank, the collectives a micro-step with their bytes, and
    for (f), (g) the plan, the analytic bubble and the stage transfers a
    micro-step (`parallel/pipeline.py TRANSFERS`)."""
    t0 = time.perf_counter()
    free_cuda(torch)
    d = os.path.join(work, "model_axis")
    refs, ref_trainers = {}, {}

    def references():
        for name, (_, att, extra) in MA_REFS.items():
            rec, ref_trainers[name] = ma_fit(
                torch, ma_argv(os.path.join(d, "one", name), name, att, extra, 1),
                os.path.join(d, "one", name), keep=True)
            refs[name] = [rec]
        free_cuda(torch)

    arms = ma_group("gloo", 2, os.path.join(d, "two"), [
        (tag, ma_argv(os.path.join(d, "two", tag), name, att, extra, 2))
        for tag, (name, att, extra) in MA_ARMS.items()], before=references)
    free_cuda(torch)
    out = {"global_batch": MA_TRAIN["batch"], "steps": 3, "mesh": [1, 2],
           "transport": "gloo, two ranks on one card"}
    for name, (ref,) in refs.items():
        want = ma_expected(name, "pallas")
        got = {**{k: ref["launches"].get(k, 0) for k in SOURCES},
               "ring_blocks": ref["ring_blocks"]}
        check(got == want, f"one-process {name} launches {got}, expected {want}")
    for tag, (name, att, extra) in MA_ARMS.items():
        recs, ref = arms[tag], refs[name][0]
        want = ma_expected(name, att, extra)
        for rec in recs:
            got = {**{k: rec["launches"].get(k, 0) for k in SOURCES},
                   "ring_blocks": rec["ring_blocks"]}
            check(got == want, f"{tag} rank {rec['rank']} launches {got}, expected {want}")
        check(recs[0]["rep_hashes"] == recs[1]["rep_hashes"],
              f"{tag}: the ranks' replicated leaves differ after a step")
        check(recs[0]["losses"] == recs[1]["losses"], f"{tag}: the ranks' losses differ")
        diffs = [abs(a - b) for a, b in zip(recs[0]["losses"], ref["losses"])]
        check(len(diffs) == 3 and all(x <= LOGIT_TOL * (1 + abs(b))
                                      for x, b in zip(diffs, ref["losses"])),
              f"{tag} losses {recs[0]['losses']} against one process's {ref['losses']}")
        g = torch.load(os.path.join(d, "two", tag, "grad.pt"))
        g_ref = torch.load(os.path.join(d, "one", name, "grad.pt"))
        grad_err = rel_err(g, g_ref)
        check(grad_err <= MA_GRAD_TOL, f"{tag} first-step gradient rel err {grad_err}")
        restored, restore_s = ma_restore_hash(torch, ref_trainers[name],
                                              recs[0]["checkpoint"])
        check(restored == recs[0]["gathered_state_hash"] == recs[1]["gathered_state_hash"],
              f"{tag}: the (1, 2) checkpoint restored in one process is not the "
              "gathered state")
        step_ms = spread(recs[0]["step_ms"][1:])
        coll = recs[0]["collectives"][-1]
        out[tag] = {
            "model": name, "attention": att, "mode": recs[0]["mode"],
            "losses": recs[0]["losses"], "losses_one_process": ref["losses"],
            "loss_max_abs_diff_vs_one_process": max(diffs),
            "grad_rel_err_vs_one_process": grad_err,
            "replicated_bitwise_every_step": True, "restore_bitwise": True,
            "restore_s": restore_s,
            "launches_per_rank": {k: v for k, v in recs[0]["launches"].items() if v},
            "ring_blocks_per_rank": recs[0]["ring_blocks"],
            "step_ms": step_ms, "step_ms_all": recs[0]["step_ms"],
            "step_ms_one_process": spread(ref["step_ms"][1:]),
            "step_ms_ratio_vs_one_process": (step_ms["median"]
                                             / spread(ref["step_ms"][1:])["median"]),
            "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in recs],
            "peak_mem_gb_one_process": ref["peak_mem_gb"],
            "params_per_rank": recs[0]["params_this_rank"],
            "params_one_process": ref["params_this_rank"],
            "collectives_per_micro_step": coll,
            "fit_s": recs[0]["fit_s"], "trainer_build_s": recs[0]["trainer_build_s"]}
        if recs[0]["pipeline"]:
            check(recs[0]["local_hashes"] == recs[1]["local_hashes"],
                  f"{tag}: the stage ranks' parameters differ after a step")
            out[tag].update(
                pipeline=recs[0]["pipeline"],
                stage_transfers_per_micro_step=[r["stage_transfers"][-1] for r in recs],
                params_bitwise_every_step=True)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        out["e_mvit_tp_nccl_two_cards"] = ma_launched_arm(torch, d, refs["mvit_b"][0])
        out["e_nccl_context_parallel"] = ma_nccl_cp(os.path.join(d, "cp"))
        name, att, extra = MA_ARMS["f_videomae_pipe"]
        out["h_pipeline_nccl_two_cards"] = launched_arm(
            torch, os.path.join(d, "nccl_pipe"), "h",
            ma_argv(os.path.join(d, "nccl_pipe", "h"), name, att, extra, 2),
            ma_expected(name, att, extra), refs[name][0])
    else:
        emit("model_axis_train_e", run=False,
             why=f"NCCL across cards needs two cards; this machine has {n_cards} "
                 "(NCCL refuses two ranks on one card): arm (e) and the "
                 "pipeline's arm (h), (f) over NCCL")
    # the VideoMAE-B reference serves library_mesh_train's arm (b)
    KEPT["ma_refs"] = (refs, {"videomae_b": ref_trainers["videomae_b"]},
                       os.path.join(d, "one", "videomae_b", "grad.pt"))
    del ref_trainers
    free_cuda(torch)
    out["references_s"] = {name: (ref["fit_s"], ref["trainer_build_s"])
                           for name, (ref,) in refs.items()}
    launches["model_axis_train"] = arms["a_mvit_tp"][0]["launches"]
    launches["model_axis_train_pipeline"] = arms["f_videomae_pipe"][0]["launches"]
    out["seconds"] = time.perf_counter() - t0
    return out


def ma_launched_arm(torch, d: str, ref: dict) -> dict:
    """(e): arm (a) through `launch.py --num_processes 2`, one card a rank
    over NCCL (the launcher's PVA_* env), held as (a)."""
    out = os.path.join(d, "nccl")
    name, att, extra = MA_ARMS["a_mvit_tp"]
    return launched_arm(torch, out, "e", ma_argv(os.path.join(out, "e"), name, att,
                                                 extra, 2), ma_expected(name, att), ref)


def launched_arm(torch, out: str, tag: str, argv, want: dict, ref: dict) -> dict:
    """Arm `tag` (`ma_fit` of `argv`) through `launch.py --num_processes 2`,
    one card a rank over NCCL (the launcher's PVA_* env): launches a rank
    `want`, the replicated leaves bitwise across the ranks after every
    step, the losses within 5e-2 * (1 + |loss|) of `ref`'s."""
    records = launched_records(out, tag, argv)
    for rec in records:
        got = {**{k: rec["launches"].get(k, 0) for k in SOURCES},
               "ring_blocks": rec["ring_blocks"]}
        check(got == want, f"({tag}) rank {rec['rank']} launches {got}, expected {want}")
    check(records[0]["rep_hashes"] == records[1]["rep_hashes"],
          f"({tag}) the ranks' replicated leaves differ after a step")
    diffs = [abs(a - b) for a, b in zip(records[0]["losses"], ref["losses"])]
    check(all(x <= LOGIT_TOL * (1 + abs(b)) for x, b in zip(diffs, ref["losses"])),
          f"({tag}) losses {records[0]['losses']} against one process's {ref['losses']}")
    return {"losses": records[0]["losses"], "loss_max_abs_diff_vs_one_process": max(diffs),
            "step_ms": spread(records[0]["step_ms"][1:]),
            "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in records],
            "collectives_per_micro_step": records[0]["collectives"][-1]}


def launched_records(out: str, tag: str, argv) -> list:
    """`ma_fit` of `argv` through `launch.py --num_processes 2`, one card a
    rank over NCCL, its dump under `out/tag`; the two ranks' records in
    rank order."""
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(out, exist_ok=True)
    script = os.path.join(out, "ma_launched.py")
    with open(script, "w") as f:
        f.write("import json, os, sys\n"
                f"sys.path.insert(0, {root!r})\n"
                "import chip_smoke\n"
                "chip_smoke.ma_child(['env', os.environ['PVA_PROCESS_ID'], "
                "os.environ['PVA_NUM_PROCESSES'], '', sys.argv[1], sys.argv[2]])\n")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "pytorchvideo_accelerate_tpu_torch.launch",
         "--num_processes", "2", "--timeout", str(DP_CHILD_TIMEOUT_S), "--",
         script, out, json.dumps([[tag, argv]])], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines, records = [], []
    timer = threading.Timer(DP_CHILD_TIMEOUT_S + 30, proc.kill)
    timer.start()
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            body = line.split("] ", 1)[1] if line.startswith("[rank ") else line
            if body.startswith("CHILD_RESULT "):
                records.append(json.loads(body[len("CHILD_RESULT "):]))
        proc.wait()
    finally:
        timer.cancel()
    check(proc.returncode == 0 and len(records) == 2,
          f"({tag}) launch rc {proc.returncode}: {lines[-25:]}")
    return sorted(records, key=lambda r: r["rank"])


# --- the library mesh: fsdp x tensor x context ----------------------------------

# (a) SlowFast-R50 at (data, fsdp, tensor, context) = (1, 2, 1, 1) on
# dp_train's geometry and argv (DP_TRAIN: a global batch of 8, 4 clips a
# batch shard, 6 steps, head dropout 0), against dp_train's one-process arm
# (the same run.py flags but the mesh's and the shard's batch: reused, not
# run again); (b) VideoMAE-B at (1, 1, 2, 2) with `--model.attention
# ulysses` (tensor parallelism splits the 12 heads 6 a tensor rank, Ulysses
# gives each context rank 3 of those over all 1568 tokens) on
# model_axis_train's geometry (MA_TRAIN: a global batch of 4, 3 steps),
# against that phase's one-process VideoMAE-B; two and four gloo ranks
# sharing the one card. (c) is (a) over NCCL, one card a rank
LM_ARMS = {  # arm: its (data, fsdp, tensor, context)
    "a_slowfast_fsdp": (1, 2, 1, 1),
    "b_videomae_tp_ulysses": (1, 1, 2, 2),
}
# parameters a rank by the JAX package's `param_sharding` (fsdp 2 over
# SlowFast-R50's 43 leaves of >= 2^16 elements; tensor 2 over VideoMAE-B's
# qkv / proj / mlp), as tests/test_torch_library_mesh.py holds the rule;
# SGD keeps one momentum element a parameter element
LM_PARAMS_PER_RANK = {"a_slowfast_fsdp": 18_083_972, "b_videomae_tp_ulysses": 44_275_132}
# the kernel rows on the library mesh's path: one rank of each arm
LIBRARY_LINE = {
    "library_mesh_train_a": ("fused_pw_bn_act", "fused_pw_bn_act.bwd_dx",
                             "fused_conv_bn_act", "fused_conv_bn_act.bwd_dx"),
    "library_mesh_train_b": ("flash_attention", "flash_attention.bwd_dq",
                             "flash_attention.bwd_dkv")}


def lm_argv(out: str, arm: str) -> list:
    """run.py's argv of one library-mesh arm (the mesh's flags last)."""
    mesh = [f for name, n in zip(("fsdp", "tensor", "context"), LM_ARMS[arm][1:])
            if n > 1 for f in (f"--mesh.{name}", str(n))]
    if arm.startswith("a_"):
        spec = dict(DP_TRAIN, batch=DP_TRAIN["batch"] // 2)
    else:
        spec = dict(MA_TRAIN, name="videomae_b",
                    argv=["--model.attention", "ulysses", *MA_DROP])
    return train_argv(out, spec=spec) + mesh


def lm_references(torch, d: str, arms=tuple(LM_ARMS)) -> dict:
    """{arm: {"ref": the one-process record, "grad": the file of the first
    gradient to hold against, "trainer": a one-process trainer for the
    restore; SlowFast-R50's also "one_grad", "head" (one process's whole and
    head gradients), "dp2" (dp_train's two-rank record) and "rerun" (the
    first gradient of dp_train's preempted two-rank arm, a second run of
    the same step, or None)}, for each of `arms`: dp_train's arms (a) and
    (c) and model_axis_train's VideoMAE-B when those phases ran in this
    process (else run here). SlowFast-R50's whole first gradient is held
    against dp_train's two ranks (the same batch shards: one process's is
    chaotic against it in bf16 at init, ~0.95 relative), its head's
    against one process."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    refs = {}
    if "a_slowfast_fsdp" in arms:
        for key, arm, mode, world in (("dp_one_process", "dp_a_one_process", "none", 1),
                                      ("dp_two_ranks", "dp_c_gloo_two_ranks", "gloo", 2)):
            if key not in KEPT:
                out = os.path.join(d, arm)
                got = dp_group(mode, world, out, DP_TRAIN["batch"] // world)
                KEPT[key] = (out, [g[3] for g in got])
        dp_dir, (dp_rec,) = KEPT.pop("dp_one_process")
        dp2_dir, dp2_recs = KEPT.pop("dp_two_ranks")
        rerun = KEPT.pop("dp_rerun", None)
        # the one-process SlowFast-R50 that restores arm (a)'s checkpoint
        sf = Trainer(parse_cli(train_argv(os.path.join(d, "restore_a"),
                                          spec=DP_TRAIN)))
        refs["a_slowfast_fsdp"] = {
            "ref": dp_rec, "grad": os.path.join(dp2_dir, "grad_rank0.pt"),
            "trainer": sf, "one_grad": os.path.join(dp_dir, "grad_rank0.pt"),
            "head": os.path.join(dp_dir, "head_grad_rank0.pt"), "dp2": dp2_recs[0],
            "rerun": rerun and os.path.join(rerun, "grad_rank0.pt")}
    if "b_videomae_tp_ulysses" in arms:
        if "ma_refs" not in KEPT:
            name, att, extra = MA_REFS["videomae_b"]
            out = os.path.join(d, "one", name)
            rec, trainer = ma_fit(torch, ma_argv(out, name, att, extra, 1), out, keep=True)
            KEPT["ma_refs"] = ({name: [rec]}, {name: trainer}, os.path.join(out, "grad.pt"))
        ma_refs, trainers, vm_grad = KEPT.pop("ma_refs")
        refs["b_videomae_tp_ulysses"] = {
            "ref": ma_refs["videomae_b"][0], "trainer": trainers["videomae_b"],
            "grad": vm_grad}
    return refs


def lm_expected(arm: str) -> dict:
    """Each rank's launches of one arm's fit(): (a) those of a dp_train
    rank of 4 clips; (b) those of one process (every rank trains the whole
    global batch, on its 3 heads)."""
    if arm.startswith("a_"):
        return {**dp_expected(2), "ring_blocks": 0}
    return ma_expected("videomae_b", "ulysses")


def lm_hold(torch, arm: str, recs: list, ref: dict, dump: str) -> dict:
    """The checks of one library-mesh arm on its ranks' `ma_fit` records
    (`recs`, rank order; their first gradients under `dump`) against its
    references `ref` (`lm_references`), and its report (see
    `library_mesh_train_phase`); arm (c) is held as (a)."""
    base = "a_slowfast_fsdp" if arm.startswith("c_") else arm
    one = ref["ref"]
    want = lm_expected(base)
    for rec in recs:
        got_l = {**{k: rec["launches"].get(k, 0) for k in SOURCES},
                 "ring_blocks": rec["ring_blocks"]}
        check(got_l == want, f"{arm} rank {rec['rank']} launches {got_l}, "
              f"expected {want}")
        n = LM_PARAMS_PER_RANK[base]
        check(rec["params_this_rank"] == n and rec["opt_elements_this_rank"] == n,
              f"{arm} rank {rec['rank']}: {rec['params_this_rank']} parameters, "
              f"{rec['opt_elements_this_rank']} optimizer elements, expected {n}")
        check(sum(rec["state_bytes_this_rank"].values()) == 4 * 2 * n,
              f"{arm} rank {rec['rank']} state bytes {rec['state_bytes_this_rank']}")
    check(all(r["rep_hashes"] == recs[0]["rep_hashes"] for r in recs),
          f"{arm}: the ranks' replicated leaves differ after a step")
    for r in recs:
        peers = [q for q in recs if q["coords"][1:3] == r["coords"][1:3]]
        check(all(q["local_hashes"] == r["local_hashes"] for q in peers),
              f"{arm}: ranks holding the same shards differ after a step")
    check(all(r["losses"] == recs[0]["losses"] for r in recs),
          f"{arm}: the ranks' losses differ")
    steps = len(one["losses"])
    diffs = [abs(a - b) for a, b in zip(recs[0]["losses"], one["losses"])]
    check(len(recs[0]["losses"]) == steps
          and all(x <= LOGIT_TOL * (1 + abs(b)) for x, b in zip(diffs, one["losses"])),
          f"{arm} losses {recs[0]['losses']} against one process's {one['losses']}")
    g = torch.load(os.path.join(dump, "grad.pt"))
    grad_err = rel_err(g, torch.load(ref["grad"]))
    check(grad_err <= MA_GRAD_TOL, f"{arm} first-step gradient rel err {grad_err}")
    extra = {}
    if "head" in ref:  # SlowFast-R50: the head against one process
        dp2 = ref["dp2"]
        h = torch.load(os.path.join(dump, "head_grad.pt"))
        extra["head_grad_rel_err_vs_one_process"] = rel_err(h, torch.load(ref["head"]))
        check(extra["head_grad_rel_err_vs_one_process"] <= MA_GRAD_TOL,
              f"{arm} head gradient against one process: {extra}")
        extra["grad_rel_err_vs_one_process_reported"] = rel_err(
            g, torch.load(ref["one_grad"]))
        # the witness: two runs of the same two-rank data-parallel step
        extra["grad_rel_err_data_parallel_rerun"] = (
            rel_err(torch.load(ref["rerun"]), torch.load(ref["grad"]))
            if ref.get("rerun") else None)
        extra["losses_data_parallel_two_ranks"] = dp2["losses"]
        extra["losses_bitwise_data_parallel_two_ranks"] = recs[0]["losses"] == dp2["losses"]
        extra["step_ms_ratio_vs_data_parallel_two_ranks"] = (
            spread(recs[0]["step_ms"][1:])["median"] / spread(dp2["step_ms"][1:])["median"])
    restored, restore_s = ma_restore_hash(torch, ref["trainer"], recs[0]["checkpoint"])
    check(restored == recs[0]["gathered_state_hash"]
          and all(r["gathered_state_hash"] == restored for r in recs),
          f"{arm}: the checkpoint restored in one process is not the gathered state")
    step_ms = spread(recs[0]["step_ms"][1:])
    ref_ms = spread(one["step_ms"][1:])
    return {
        "mesh": dict(zip(("data", "fsdp", "tensor", "context"), LM_ARMS[base])),
        "world": recs[0]["world"], "mode": recs[0]["mode"],
        "fsdp_leaves": recs[0]["fsdp_leaves"],
        "losses": recs[0]["losses"], "losses_one_process": one["losses"],
        "loss_max_abs_diff_vs_one_process": max(diffs),
        ("grad_rel_err_vs_data_parallel_two_ranks" if "head" in ref
         else "grad_rel_err_vs_one_process"): grad_err, **extra,
        "replicated_bitwise_every_step": True, "shard_copies_bitwise_every_step": True,
        "restore_bitwise": True, "restore_s": restore_s,
        "launches_per_rank": {k: v for k, v in recs[0]["launches"].items() if v},
        "params_per_rank": recs[0]["params_this_rank"],
        "opt_elements_per_rank": recs[0]["opt_elements_this_rank"],
        "state_bytes_per_rank": recs[0]["state_bytes_this_rank"],
        "step_ms": step_ms, "step_ms_all": recs[0]["step_ms"],
        "step_ms_one_process": ref_ms,
        "step_ms_ratio_vs_one_process": step_ms["median"] / ref_ms["median"],
        "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in recs],
        "peak_mem_gb_one_process": one.get("peak_mem_gb"),
        "collectives_per_micro_step": recs[0]["collectives"][-1],
        "fit_s": recs[0]["fit_s"]}


def lm_nccl_arm(torch, d: str, ref: dict) -> dict:
    """(c): arm (a) through `launch.py --num_processes 2`, one card a rank
    over NCCL, held by `lm_hold` as (a) is."""
    out = os.path.join(d, "nccl")
    recs = launched_records(out, "c", lm_argv(os.path.join(out, "run"), "a_slowfast_fsdp"))
    return lm_hold(torch, "c_slowfast_fsdp_nccl_two_cards", recs, ref,
                   os.path.join(out, "c"))


def library_mesh_train_phase(torch, work: str, launches: dict) -> dict:
    """Phase 42. The library mesh through `run.main`'s Trainer: (a)
    SlowFast-R50 fsdp 2, (b) VideoMAE-B tensor 2 x context 2 (Ulysses), as
    `LM_ARMS` says, each a gloo group on the one card; (c) (a) over NCCL on
    two cards where the machine has them. Held per arm (`lm_hold`): the
    ranks' losses equal and within 5e-2 * (1 + |loss|) of one process's;
    the first step's gradient gathered over fsdp and tensor within 5e-2
    relative 2-norm of one process's; the replicated leaves bitwise equal
    across the ranks, and every shard across the ranks that hold a copy of
    it (equal fsdp and tensor coordinates), after every step; parameters
    and optimizer-state elements a rank the JAX rule's
    (`LM_PARAMS_PER_RANK`), and its state bytes 4 bytes each (no full copy
    of a sharded leaf outlives a step); exact launches a rank; the
    checkpoint the arm wrote restored in one process bitwise the gathered
    state. Reports step ms against one process, peak memory a rank, the
    state bytes a rank and the collectives a micro-step with their bytes."""
    t0 = time.perf_counter()
    free_cuda(torch)
    d = os.path.join(work, "library_mesh")
    # both arms' ranks start now and wait for their turn (`await_go`)
    plan = {arm: [(arm, lm_argv(os.path.join(d, arm, "run"), arm))] for arm in LM_ARMS}
    started = {arm: ma_start("gloo", int(np.prod(shape)), os.path.join(d, arm), plan[arm])
               for arm, shape in LM_ARMS.items()}
    try:
        refs = lm_references(torch, d)
        out = {}
        for arm in LM_ARMS:
            free_cuda(torch)
            got = ma_finish(started.pop(arm), "gloo", os.path.join(d, arm), plan[arm])
            out[arm] = lm_hold(torch, arm, got[arm], refs[arm], os.path.join(d, arm, arm))
            launches[f"library_mesh_train_{arm[0]}"] = got[arm][0]["launches"]
    finally:
        kill_waiting(started.values())
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        free_cuda(torch)
        out["c_slowfast_fsdp_nccl_two_cards"] = lm_nccl_arm(torch, d, refs["a_slowfast_fsdp"])
    else:
        emit("library_mesh_train_c", run=False,
             why=f"NCCL across cards needs two cards; this machine has {n_cards} "
                 "(NCCL refuses two ranks on one card)")
    for ref in refs.values():
        ref["trainer"].close()
    del refs
    free_cuda(torch)
    out["seconds"] = time.perf_counter() - t0
    return out


# the ring and Ulysses shapes (e) holds over NCCL: VideoMAE-B's attention
# (B=2, 1568 tokens, 12 heads of 64) and a ragged MViT-like pair (Nq 391,
# Nk 97, 8 heads of 96)
MA_CP_SHAPES = {"videomae": (2, 1568, 1568, 12, 64), "ragged": (2, 391, 97, 8, 96)}
MA_CP_CHILD = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke\n"
    "chip_smoke.ma_cp_child()\n")


def ma_cp_child() -> None:
    """One rank of (e)'s context-parallel check, joined by the launcher's
    PVA_* env (NCCL, one card a rank): ring in f32 against `dense_attention`
    and Ulysses in bf16 (the flash kernels on each rank's heads) against one
    card's `flash_attention`, outputs and the gradients of q, k, v, on the
    seeded `MA_CP_SHAPES`; then `gather_list` of one tensor a rank. Rank 0
    prints its record."""
    import torch

    from pytorchvideo_accelerate_tpu_torch.ops.attention import dense_attention
    from pytorchvideo_accelerate_tpu_torch.ops.flash_attention import flash_attention
    from pytorchvideo_accelerate_tpu_torch.parallel import distributed as pdist
    from pytorchvideo_accelerate_tpu_torch.parallel import ring_attention as ring
    from pytorchvideo_accelerate_tpu_torch.parallel.collectives import gather_list
    from pytorchvideo_accelerate_tpu_torch.parallel.ulysses import ulysses_attention

    pdist.initialize_distributed(timeout_s=DP_CHILD_TIMEOUT_S)
    world = pdist.process_count()
    pdist.initialize_mesh(world)
    group = pdist.model_group()
    dev = torch.device("cuda", pdist.local_device_index())
    out = {"world": world, "backend": torch.distributed.get_backend(group)}

    def run(fn, q, k, v, ct):
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        o = fn(q, k, v)
        (o.float() * ct).sum().backward()
        return o.detach().float(), [t.grad.float() for t in (q, k, v)]

    def err(a, b):
        return float((a - b).abs().max())

    rng = np.random.default_rng(SEED)
    for tag, (b, nq, nk, h, d) in MA_CP_SHAPES.items():
        def mk(n):
            return torch.from_numpy(rng.standard_normal((b, n, h, d), np.float32)).to(dev)

        q, k, v, ct = mk(nq), mk(nk), mk(nk), mk(nq)
        for name, local, ref, dtype in (
                ("ring", ring.ring_attention, dense_attention, torch.float32),
                ("ulysses", ulysses_attention, flash_attention, torch.bfloat16)):
            args = [t.to(dtype) for t in (q, k, v)]
            want_o, want_g = run(ref, *args, ct)
            got_o, got_g = run(lambda *a: ring.cp_attention(*a, local, group), *args, ct)
            out[f"{tag}/{name}"] = {"out": err(got_o, want_o),
                                    "grads": [err(g, w) for g, w in zip(got_g, want_g)],
                                    "scale": float(want_o.abs().max())}
    x = torch.full((3, 5), float(pdist.process_index()), device=dev)
    out["gather"] = [float(t.mean()) for t in gather_list(x, group)]
    if pdist.is_main_process():
        print("CHILD_RESULT " + json.dumps(out), flush=True)


def ma_nccl_cp(d: str) -> dict:
    """(e)'s context-parallel check: `ma_cp_child` on two cards through
    `launch.py`. Held: ring within 1e-5 of dense in f32 (gradients 1e-4);
    Ulysses within 1e-2 * (1 + max |out|) of one card's flash attention in
    bf16; the gather in rank order."""
    root = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(d, "ma_cp.py")
    os.makedirs(d, exist_ok=True)
    with open(script, "w") as f:
        f.write(MA_CP_CHILD)
    proc = subprocess.run(
        [sys.executable, "-u", "-m", "pytorchvideo_accelerate_tpu_torch.launch",
         "--num_processes", "2", "--timeout", str(DP_CHILD_TIMEOUT_S), "--",
         script, root], cwd=root, capture_output=True, text=True,
        timeout=DP_CHILD_TIMEOUT_S + 30)
    lines = (proc.stdout + proc.stderr).splitlines()
    rec = next((json.loads(ln[len("CHILD_RESULT "):]) for ln in lines
                if ln.startswith("CHILD_RESULT ")), None)
    check(proc.returncode == 0 and rec is not None,
          f"(e) context-parallel check rc {proc.returncode}: {lines[-25:]}")
    for tag in MA_CP_SHAPES:
        r, u = rec[f"{tag}/ring"], rec[f"{tag}/ulysses"]
        check(r["out"] <= 1e-5 and max(r["grads"]) <= 1e-4, f"(e) ring {tag}: {r}")
        tol = KERNEL_TOL * (1 + u["scale"])
        check(u["out"] <= tol and max(u["grads"]) <= tol, f"(e) ulysses {tag}: {u}")
    check(rec["gather"] == [0.0, 1.0], f"(e) gather {rec['gather']}")
    return rec


def model_axis_e_main() -> int:
    """Arm (e) alone, for a machine of two or more cards: the kernels'
    build, the one-process MViT-B reference, (a) over NCCL through the
    launcher, the NCCL ring / Ulysses check; one JSON line."""
    import torch

    from pytorchvideo_accelerate_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    _build.build()
    with tempfile.TemporaryDirectory(prefix="pva_model_axis_e_") as w:
        name, att, extra = MA_ARMS["a_mvit_tp"]
        ref = ma_fit(torch, ma_argv(os.path.join(w, "one"), name, att, extra, 1),
                     os.path.join(w, "one"))
        out = {"nvidia_smi": smi, "cards": torch.cuda.device_count(),
               "one_process_step_ms": spread(ref["step_ms"][1:]),
               "e_mvit_tp_nccl_two_cards": ma_launched_arm(torch, w, ref),
               "e_nccl_context_parallel": ma_nccl_cp(os.path.join(w, "cp"))}
    print(json.dumps(out, default=str), flush=True)
    return 0


def library_mesh_c_main() -> int:
    """Arm (c) of library_mesh_train alone, for a machine of two or more
    cards: the kernels' build, arm (a)'s references (one process, and two
    gloo ranks of plain data parallelism), (c) over NCCL through the
    launcher; one JSON line."""
    import torch

    from pytorchvideo_accelerate_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    _build.build()
    with tempfile.TemporaryDirectory(prefix="pva_library_mesh_c_") as w:
        refs = lm_references(torch, w, arms=("a_slowfast_fsdp",))
        ref = refs["a_slowfast_fsdp"]
        out = {"nvidia_smi": smi, "cards": torch.cuda.device_count(),
               "c_slowfast_fsdp_nccl_two_cards": lm_nccl_arm(torch, w, ref)}
        ref["trainer"].close()
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
