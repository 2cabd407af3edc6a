"""One rank of the port's data-parallel tests (imports no JAX), and
`run_group`, which the tests call to start WORLD of them and read their
results.

    python tests/_torch_dp_worker.py SCENARIO RANK WORLD DIR

joins a gloo group of WORLD processes on a FileStore under DIR (no TCP
port to race for), runs SCENARIO and writes what it saw to
DIR/SCENARIO.rank<RANK>.pt for the test to read. The scenario `env` joins
through `initialize_distributed` and the launcher's `PVA_*` env instead.
Every group has a 90 s collective deadline, so a hang fails fast.
"""

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pytorchvideo_accelerate_tpu_torch.parallel import collectives as coll  # noqa: E402
from pytorchvideo_accelerate_tpu_torch.parallel import distributed as pdist  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=90)


def join(rank: int, world: int, d: str) -> None:
    store = dist.FileStore(os.path.join(d, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)


# --- scenarios --------------------------------------------------------------


def collectives(rank, world, d):
    out = {}
    out["allgather"] = coll.host_allgather({"x": np.arange(3) + 10 * rank,
                                            "f": [np.float32(rank + 0.5)]})
    out["broadcast"] = coll.host_broadcast(
        {"n": np.full((2, 2), rank + 1, np.int64), "s": f"run-{rank}-é",
         "b": bytes([rank] * (3 + rank)), "scalar": 7 * (rank + 1)})
    out["reduce_sum"] = coll.host_reduce_sum({"count": np.array([rank + 1, 2])})
    out["any_rank1"] = pdist.any_process(rank == 1)
    out["any_none"] = pdist.any_process(False)
    bf = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) + rank * 100
    out["exchange_bf16"] = coll.exchange(bf, world - 1 - rank).float()
    out["exchange_int"] = coll.exchange(torch.tensor([rank, 5]), world - 1 - rank)
    ts = [torch.full((3,), float(rank)), torch.full((2, 2), 2.0 * rank),
          torch.full((2,), rank, dtype=torch.float64)]
    coll.all_reduce_mean_(ts)
    out["mean"] = ts
    bt = [torch.full((2,), float(rank + 1)), torch.full((1,), rank + 3)]
    coll.broadcast_(bt)
    out["broadcast_"] = bt
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = coll.all_reduce_sum(x)
    (y * (rank + 1)).sum().backward()
    out["sum_fwd"], out["sum_grad"] = y.detach(), x.grad
    pdist.check_desync(1.25, name="equal")
    pdist.check_desync(float("nan"), name="all_nan")
    try:
        pdist.check_desync(1.0 + rank, name="perturbed")
        out["desync"] = ""
    except RuntimeError as e:
        out["desync"] = str(e)
    pdist.sync_global_devices()
    return out


def env(rank, world, d):
    # the launcher's contract: PVA_* set by the test, no arguments
    got = pdist.initialize_distributed(cpu=True, timeout_s=90)
    again = pdist.initialize_distributed(cpu=True)
    return {"joined": got, "again": again, "rank": pdist.process_index(),
            "world": pdist.process_count(), "backend": dist.get_backend(),
            "main": pdist.is_main_process(),
            "name": coll.host_broadcast(f"from-{rank}")}


def _step_model(d, patch_stats: bool):
    from pytorchvideo_accelerate_tpu_torch import models as tmodels
    from pytorchvideo_accelerate_tpu_torch.config import ModelConfig, OptimConfig
    from pytorchvideo_accelerate_tpu_torch.models import common as tcommon
    from pytorchvideo_accelerate_tpu_torch.models.convert import state_dict_from_jax
    from pytorchvideo_accelerate_tpu_torch.trainer import optim as toptim
    from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps
    from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

    if patch_stats:  # the control: each rank's own batch statistics
        tcommon._all_reduce_stats = lambda moments: moments
    spec = np.load(os.path.join(d, "spec.npz"))
    flat = {k[len("w/"):]: spec[k] for k in spec.files if k.startswith("w/")}
    model = tmodels.create_model(
        ModelConfig(name="slowfast_t", num_classes=int(spec["num_classes"]),
                    fused_kernels="auto", dropout_rate=0.0), "fp32")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           state_dict_from_jax(flat).items()})
    cfg = OptimConfig(lr=0.05, momentum=0.9, weight_decay=1e-3,
                      schedule="cosine", warmup_steps=1)
    opt = toptim.build_optimizer(cfg, 4, model.named_parameters())
    state = TrainState.create(model, opt)
    step = tsteps.make_train_step(model, opt, accum_steps=2)
    return spec, model, state, step


def train_step(rank, world, d):
    """(ii): one optimizer step of slowfast_t, accumulation 2, on this
    rank's share of the global batch; then the control without the
    statistics' all-reduce."""
    out = {}
    for tag in ("sync", "control"):
        spec, model, state, step = _step_model(d, patch_stats=tag == "control")
        b = spec["slow"].shape[1] // world
        rows = slice(rank * b, (rank + 1) * b)
        batch = {k: torch.from_numpy(spec[k][:, rows].copy())
                 for k in ("slow", "fast", "label")}
        metrics = step(state, batch)
        out[tag] = {
            "loss": float(metrics["loss"]), "accuracy": float(metrics["accuracy"]),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            "state": {k: v.numpy().copy() for k, v in model.state_dict().items()}}
    return out


def mix(rank, world, d):
    """(vii): mixing on this rank's share against the global batch's flip;
    and the dropout, drop-path and MAE tube masks of this rank's rows."""
    from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps

    spec = np.load(os.path.join(d, "mix.npz"))
    b = spec["x"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    x = torch.from_numpy(spec["x"][rows].copy()).to(torch.bfloat16)
    labels = torch.from_numpy(spec["labels"][rows].copy())
    w = torch.from_numpy(spec["w"])
    mixed = tsteps.mix_batch({"video": x, "label": labels}, w)
    logits = torch.from_numpy(spec["logits"][rows].copy())
    loss, correct, count = tsteps.mixed_loss(
        logits, labels, w.mean(), torch.ones(b), 0.1)
    from pytorchvideo_accelerate_tpu_torch.models.common import DropPath, SeededDropout

    drops = {}
    for cls, shape in ((SeededDropout, (b, 5)), (DropPath, (b, 3, 2))):
        m = cls(0.5).train()
        m.reseed(1234)
        drops[cls.__name__] = m(torch.ones(shape)).numpy()
    from pytorchvideo_accelerate_tpu_torch.models.videomae import tube_mask_indices

    keep, masked = tube_mask_indices(torch.Generator().manual_seed(7), b, 2, 4, 4, 0.75)
    drops["tube_keep"], drops["tube_masked"] = keep.numpy(), masked.numpy()
    return {"video": mixed["video"].float().numpy(),
            "flipped_labels": tsteps.flip_global(labels).numpy(),
            "loss": float(loss), "correct": float(correct), "dropout": drops}


def cuda_step(rank, world, d):
    """One tiny3d train step through the card's kernels (bf16, `auto`) on
    this rank's share of the global batch; two ranks share card 0 over
    gloo."""
    from pytorchvideo_accelerate_tpu_torch.ops import fused

    out = _tiny3d_card_step(os.path.join(d, "cuda.npz"), rank, world)
    out["launches"] = dict(fused.LAUNCHES)
    return out


def _tiny3d_card_step(spec_path, rank, world):
    """(loss, state after the step) of one tiny3d SGD step on the card over
    rows [rank * B / world, (rank + 1) * B / world) of the spec's batch."""
    from pytorchvideo_accelerate_tpu_torch.config import ModelConfig, OptimConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import make_train_step
    from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = np.load(spec_path)
    b = spec["x"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    model = create_model(ModelConfig(name="tiny3d", num_classes=5, fused_kernels="auto",
                                     dropout_rate=0.0), "bf16", seed=1).cuda()
    opt = build_optimizer(OptimConfig(lr=0.01), 4, model.named_parameters())
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    batch = {"video": torch.from_numpy(spec["x"][rows].copy()).cuda().to(torch.bfloat16),
             "label": torch.from_numpy(spec["labels"][rows].copy()).cuda()}
    m = step(state, batch)
    torch.cuda.synchronize()
    return {"loss": float(m["loss"]),
            "state": {k: v.float().cpu().numpy() for k, v in model.state_dict().items()}}


def mvit_tp_forward(rank, world, d, model_count=None):
    """Arm (a)'s forward on the card: full-width MViT-B 16x4 (bf16,
    attention and depthwise pallas, seed 0, drop path and dropout off, eval
    mode) cut for this rank at (1, world) (`model_count=1`: one process,
    the whole model), over the clips of DIR/mvit.npz; its logits and the
    launches."""
    from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.ops import fused
    from pytorchvideo_accelerate_tpu_torch.parallel.tensor_parallel import layout

    count = world if model_count is None else model_count
    if count > 1:
        pdist.initialize_mesh(count)
    clips = torch.from_numpy(np.load(os.path.join(d, "mvit.npz"))["x"]).cuda()
    axis = layout("mvit_b", "pallas", count, rank % count)
    model = create_model(ModelConfig(name="mvit_b", num_classes=7, dropout_rate=0.0,
                                     attention="pallas", depthwise_impl="pallas"),
                         "bf16", seed=0, data_cfg=DataConfig(num_frames=16, crop_size=224),
                         model_axis=axis).cuda().eval()
    fused.reset_launch_counts()
    with torch.no_grad():
        logits = model(clips.to(torch.bfloat16))
    torch.cuda.synchronize()
    return {"logits": logits.float().cpu().numpy(), "launches": dict(fused.LAUNCHES),
            "params": sum(p.numel() for p in model.parameters()), "mode": axis.mode}


# --- the Trainer: eval, resume, the guard's skip, preemption ------------------


def _argv(d, name, extra=()):
    return ["--cpu", "--synthetic", "--model.name", "tiny3d", "--num_frames", "4",
            "--data.crop_size", "32", "--data.min_short_side_scale", "32",
            "--data.max_short_side_scale", "40", "--batch_size", "2",
            "--gradient_accumulation_steps", "2", "--data.num_workers", "1",
            "--mixed_precision", "fp32", "--lr", "0.05",
            "--output_dir", os.path.join(d, name), *extra]


_LAST = [None]  # the last Trainer `_fit` built
_GRAD_NORMS = []  # every step's grad_norm, in order


def _fit(argv, on_step=None, wrap_epoch=None):
    """run.main's Trainer.fit() for `argv`, each step's (loss, skipped)
    recorded; `on_step(trainer, step)` runs after each step,
    `wrap_epoch(trainer, epoch_fn)` may wrap the train prefetcher."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    trainer = Trainer(parse_cli(argv))
    _LAST[0] = trainer
    seen = []
    step_fn = trainer.train_step

    def step(state, batch):
        m = step_fn(state, batch)
        seen.append((state.step, float(m["loss"]), float(m.get("skipped", 0.0))))
        _GRAD_NORMS.append(float(m["grad_norm"]))
        if on_step is not None:
            on_step(trainer, state.step)
        return m

    trainer.train_step = step
    if wrap_epoch is not None:
        trainer.train_prefetch.epoch = wrap_epoch(trainer.train_prefetch.epoch)
    result = trainer.fit()
    state = {k: v.numpy().copy() for k, v in trainer.model.state_dict().items()}
    return result, seen, state


def trainer(rank, world, d):
    from pytorchvideo_accelerate_tpu_torch import run as trun
    from pytorchvideo_accelerate_tpu_torch.reliability.guard import poison_batch
    from pytorchvideo_accelerate_tpu_torch.reliability.preemption import get_guard

    out = {}
    # (iii) eval at world 2 on 5 val clips (synthetic: videos // 4), 3 a rank
    ev = _argv(d, "eval", ["--data.synthetic_num_videos", "20", "--num_epochs", "1",
                           "--batch_size", "3", "--gradient_accumulation_steps", "1",
                           "--data.limit_train_batches", "0"])
    out["eval"] = trun.main(ev + ["--eval_only"])
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    t = Trainer(parse_cli(ev))
    out["eval_weights"] = {k: v.numpy().copy() for k, v in t.model.state_dict().items()}
    t.close()

    # (iv) unbroken, then preempted on rank 0 after step 2 and resumed
    base = ["--data.synthetic_num_videos", "16", "--num_epochs", "2",
            "--checkpointing_steps", "3"]
    out["unbroken"] = _fit(_argv(d, "unbroken", base))

    def request_at_2(trainer, step):
        if step == 2 and rank == 0:
            get_guard().request("test")

    out["preempted"] = _fit(_argv(d, "resume", base), on_step=request_at_2)
    out["resumed"] = _fit(_argv(d, "resume", base + ["--resume_from_checkpoint", "auto"]))
    out["exported"] = trun.main(_argv(d, "resume", base + [
        "--resume_from_checkpoint", "auto",
        "--export_inference", os.path.join(d, "artifact")]))

    # (v) a NaN planted in rank 1's second batch only, the guard armed
    def poison_rank1(epoch_fn):
        def epoch(*a, **kw):
            for i, batch in enumerate(epoch_fn(*a, **kw)):
                yield poison_batch(batch) if (rank == 1 and i == 1) else batch
        return epoch

    out["nan"] = _fit(_argv(d, "nan", ["--data.synthetic_num_videos", "24",
                                       "--num_epochs", "1", "--guard.enabled",
                                       "--guard.rollback_after", "3"]),
                      wrap_epoch=lambda fn: poison_rank1(fn))
    return out


def pretrained(rank, world, d):
    """A tiny3d Trainer loading DIR/hub.pth with `--model.pretrained`, each
    rank seeded apart (so their fresh heads differ before the broadcast):
    its state after init and its load report."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    t = Trainer(parse_cli(_argv(d, "pretrained", [
        "--seed", str(rank), "--model.pretrained",
        "--model.pretrained_path", os.path.join(d, "hub.pth")])))
    out = {"state": {k: v.numpy().copy() for k, v in t.model.state_dict().items()},
           "report": t.pretrained_report}
    t.close()
    return out


# --- the model axis: tensor and context parallelism ----------------------------


def _np(t):
    return t.detach().cpu().numpy().copy()


def model_axis(rank, world, d):
    """The cases of DIR/model_axis.json on the (world / model, model) mesh:
    each a seeded twin (`w/` leaves of its spec, the flax layout) split
    for this rank, its train-mode forward on this data slice, then one SGD
    step; the gathered gradient and state, and this rank's replicated
    leaves. A case with `control` runs with the row-parallel all-reduce
    patched out."""
    import json

    from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig, OptimConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.models.convert import state_dict_from_jax
    from pytorchvideo_accelerate_tpu_torch.parallel import tensor_parallel as tp
    from pytorchvideo_accelerate_tpu_torch.parallel.sharding import gather_state_dict
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import make_train_step
    from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

    with open(os.path.join(d, "model_axis.json")) as f:
        spec_all = json.load(f)
    pdist.initialize_mesh(spec_all["model"])
    reduce = tp.reduce_from_model
    out = {}
    for case in spec_all["cases"]:
        spec = np.load(os.path.join(d, case["spec"]))
        flat = {k[2:]: spec[k] for k in spec.files if k.startswith("w/")}
        model = create_model(
            ModelConfig(name=case["name"], num_classes=int(spec["num_classes"]),
                        dropout_rate=0.0, attention=case["attention"]), "fp32",
            data_cfg=DataConfig(num_frames=spec["video"].shape[1],
                                crop_size=spec["video"].shape[2]))
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                               state_dict_from_jax(flat).items()})
        axis = tp.layout(case["name"], case["attention"], pdist.model_count(),
                         pdist.model_index())
        tp.apply_model_axis(model, axis)
        if case.get("control"):
            tp.reduce_from_model = lambda x, group: x
        try:
            opt = build_optimizer(OptimConfig(**spec_all["optim"]), 4,
                                  model.named_parameters(),
                                  sharded=tp.param_kinds(model))
            state = TrainState.create(model, opt)
            step = make_train_step(model, opt)
            b = spec["video"].shape[0] // pdist.data_count()
            rows = slice(pdist.data_index() * b, (pdist.data_index() + 1) * b)
            batch = {"video": torch.from_numpy(spec["video"][rows].copy()),
                     "label": torch.from_numpy(spec["label"][rows].copy())}
            with torch.no_grad():
                logits = model(batch["video"])
            m = step(state, batch)
        finally:
            tp.reduce_from_model = reduce
        grads = {n: p.grad for n, p in model.named_parameters()}
        full_g = gather_state_dict(grads, axis.plan, pdist.model_group())
        full_s = state.state_dict()["model"]
        out[case["tag"]] = {
            "mode": axis.mode, "plan": sorted(axis.plan),
            "logits": _np(logits), "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "accuracy": float(m["accuracy"]),
            "grads": {k: _np(v) for k, v in full_g.items()},
            "state": {k: _np(v) for k, v in full_s.items()},
            "replicated": {k: _np(v) for k, v in model.state_dict().items()
                           if k not in axis.plan},
            "n_params": sum(p.numel() for p in model.parameters())}
    return out


def cp_attention(rank, world, d):
    """Every case of DIR/cp.npz (q, k, v, a cotangent) through ring and
    ulysses over a model axis of all `world` ranks: the output and the
    gradients of q, k and v, and the ring blocks this rank ran."""
    from pytorchvideo_accelerate_tpu_torch.parallel import ring_attention as tring
    from pytorchvideo_accelerate_tpu_torch.parallel.ulysses import ulysses_attention

    pdist.initialize_mesh(world)
    spec = np.load(os.path.join(d, "cp.npz"))
    out = {}
    for tag in sorted({k.split("/")[0] for k in spec.files}):
        for name, fn in (("ring", tring.ring_attention), ("ulysses", ulysses_attention)):
            q, k, v = (torch.from_numpy(spec[f"{tag}/{x}"]).requires_grad_()
                       for x in "qkv")
            before = tring.RING_BLOCKS[0]
            o = tring.cp_attention(q, k, v, fn, pdist.model_group())
            (o * torch.from_numpy(spec[f"{tag}/ct"])).sum().backward()
            out[f"{tag}/{name}"] = {"out": _np(o), "dq": _np(q.grad),
                                    "dk": _np(k.grad), "dv": _np(v.grad),
                                    "blocks": tring.RING_BLOCKS[0] - before}
    return out


def _ma_argv(d, name, extra=()):
    return ["--cpu", "--synthetic", "--num_frames", "4", "--data.crop_size", "32",
            "--data.min_short_side_scale", "32", "--data.max_short_side_scale", "40",
            "--data.num_workers", "1", "--mixed_precision", "fp32",
            "--data.synthetic_num_videos", "8", "--num_epochs", "1",
            "--output_dir", os.path.join(d, name), *extra]


def replicated(rank, world, d):
    """slowfast_t at (1, world), the conv family replicated over the model
    axis (world 1: one rank): the batches each rank was given, its losses
    and its final state."""
    from pytorchvideo_accelerate_tpu_torch.parallel.tensor_parallel import model_axis_of

    seen_batches = []

    def wrap(epoch_fn):
        def epoch(*a, **kw):
            for batch in epoch_fn(*a, **kw):
                seen_batches.append({k: _np(v) for k, v in batch.items()})
                yield batch
        return epoch

    argv = _ma_argv(d, f"replicated{world}", [
        "--model.name", "slowfast_t", "--batch_size", "2", "--mesh.model", str(world),
        "--model.dropout_rate", "0", "--optim.lr", "0.01"])
    result, seen, state = _fit(argv, wrap_epoch=wrap)
    return {"result": result, "seen": seen, "state": state, "batches": seen_batches,
            "mode": model_axis_of(_LAST[0].model).mode}



def ckpt(rank, world, d):
    """mvit_t at (1, 2), tensor-parallel, adamw + EMA + the clip: a fit of 2
    steps with a checkpoint each, an export; then a fresh Trainer restoring
    the (1, 1) checkpoint under DIR/one (written by the test): its shards
    and its gathered state."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    extra = ["--model.name", "mvit_t", "--batch_size", "2", "--mesh.model", "2",
             "--model.dropout_rate", "0", "--optim.optimizer", "adamw",
             "--optim.lr", "0.01", "--optim.ema_decay", "0.9",
             "--optim.grad_clip_norm", "0.5", "--checkpointing_steps", "1"]
    out = {}
    result, seen, state = _fit(_ma_argv(d, "two", extra))
    t = _LAST[0]
    out["fit"] = {"result": result, "seen": seen,
                  "grad_norms": list(_GRAD_NORMS),
                  "full": t.state.state_dict()}
    t.export_inference(os.path.join(d, "two_art"))
    t2 = Trainer(parse_cli(_ma_argv(d, "one", extra + ["--resume_from_checkpoint", "auto"])))
    t2._maybe_resume()
    out["restored"] = {"shards": {k: v.clone() for k, v in t2.model.state_dict().items()},
                       "full": t2.state.state_dict(),
                       "opt_local": t2.state.optimizer.state_dict(),
                       "ema_local": {k: v.clone() for k, v in t2.state.ema.items()},
                       "plan": t2.model_axis.plan, "index": t2.model_axis.index}
    t2.close()
    return out



# --- the library mesh: fsdp x tensor x context ---------------------------------


def _inputs(spec, rows, accum):
    """The clip tensors and labels of `rows` of the spec's global batch
    (dim 1 under accumulation)."""
    take = (lambda a: a[:, rows]) if accum > 1 else (lambda a: a[rows])
    keys = [k for k in ("video", "slow", "fast", "label") if k in spec.files]
    return {k: torch.from_numpy(take(spec[k]).copy()) for k in keys}


def _library_case(case, spec_all, d):
    """One case of DIR/library.json: the seeded twin on the case's (data,
    fsdp, tensor, context) mesh, this rank's batch shard, one SGD step."""
    from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig, OptimConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.models.convert import state_dict_from_jax
    from pytorchvideo_accelerate_tpu_torch.parallel import fsdp
    from pytorchvideo_accelerate_tpu_torch.parallel import tensor_parallel as tp
    from pytorchvideo_accelerate_tpu_torch.parallel.sharding import full_state_dict
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import make_train_step
    from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

    _, f, t, c = case["shape"]
    pdist.initialize_library_mesh(f, t, c)
    spec = np.load(os.path.join(d, case["spec"]))
    flat = {k[2:]: spec[k] for k in spec.files if k.startswith("w/")}
    clip = spec["video"] if "video" in spec.files else spec["fast"]
    accum = int(spec["accum"])
    model = create_model(
        ModelConfig(name=case["name"], num_classes=int(spec["num_classes"]),
                    dropout_rate=0.0, attention=case["attention"], fused_kernels="auto",
                    remat=case.get("remat", False)),
        "fp32", data_cfg=DataConfig(num_frames=clip.shape[-4], crop_size=clip.shape[-3]))
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           state_dict_from_jax(flat).items()})
    axis = tp.layout(case["name"], case["attention"], t, pdist.tensor_index(),
                     library=True, fsdp_count=f, fsdp_index=pdist.fsdp_index(),
                     fsdp_min_size=case["min_size"])
    tp.apply_model_axis(model, axis)
    kinds = tp.param_kinds(model)
    opt = build_optimizer(OptimConfig(**spec_all["optim"]), 4, model.named_parameters(),
                          sharded=kinds)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, accum_steps=accum)
    b = spec["label"].shape[-1] // pdist.batch_count()
    rows = slice(pdist.batch_index() * b, (pdist.batch_index() + 1) * b)
    batch = _inputs(spec, rows, accum)
    fsdp.GATHERS[0] = 0
    m = step(state, batch)
    grads = {n: p.grad for n, p in model.named_parameters()}
    leftover = [n for mod in model.modules() for n in mod._parameters if n in mod.__dict__]
    opt_numel = sum(v.numel() for st in opt.opt.state.values()
                    for v in st.values() if torch.is_tensor(v) and v.dim())
    return {
        "mode": axis.mode, "plan": sorted(axis.plan), "fsdp_plan": dict(axis.fsdp_plan),
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "accuracy": float(m["accuracy"]),
        "grads": {k: _np(v) for k, v in full_state_dict(grads, axis).items()},
        "state": {k: _np(v) for k, v in state.state_dict()["model"].items()},
        "replicated": {k: _np(v) for k, v in model.state_dict().items()
                       if not kinds.get(k)},
        "n_params": sum(p.numel() for p in model.parameters()),
        "opt_numel": opt_numel, "gathers": fsdp.GATHERS[0], "leftover": leftover,
        "coords": pdist.library_coords(pdist.process_index(), tuple(case["shape"]))}


def library(rank, world, d):
    """The cases of DIR/library.json (a case with `control` runs with the
    sum of the gather's reduce-scatter patched out: each rank keeps its own
    slice of its own gradient); then, with `fit` in the json, run.main's
    Trainer at (1, world, 1, 1): a fresh fit with a checkpoint every step
    and an export, and a resume of the (1, 1) checkpoints under DIR/resume;
    then plain data parallelism at world `world` resuming those under
    DIR/resume_dp."""
    import json

    with open(os.path.join(d, "library.json")) as f:
        spec_all = json.load(f)
    out = {}
    rs = coll.reduce_scatter
    for case in spec_all["cases"]:
        if case.get("control"):
            coll.reduce_scatter = lambda x, dim, group: x.chunk(
                dist.get_world_size(group), dim)[dist.get_rank(group)].contiguous()
        try:
            out[case["tag"]] = _library_case(case, spec_all, d)
        finally:
            coll.reduce_scatter = rs
    pdist.reset_mesh()
    if "batches" in spec_all:
        # run.main's Trainer on the library mesh: the first train batch
        from pytorchvideo_accelerate_tpu_torch.config import parse_cli
        from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

        t = Trainer(parse_cli(_ma_argv(d, "batches", spec_all["batches"])))
        batch = next(iter(t.train_prefetch.epoch(0)))
        out["batches"] = {"batch": {k: _np(v) for k, v in batch.items()},
                          "mode": t.model_axis.mode, "shape": t.mesh_shape}
        t.close()
        pdist.reset_mesh()
    if "fit" in spec_all:
        extra = spec_all["fit"] + ["--mesh.fsdp", str(world)]
        _GRAD_NORMS.clear()
        result, seen, _ = _fit(_ma_argv(d, "lib", extra))
        t = _LAST[0]
        lkg = t.train_guard.lkg_dir
        out["fit"] = {"result": result, "seen": seen, "full": t.state.state_dict(),
                      "lkg": {s: torch.load(os.path.join(lkg, str(s), "state.pt"),
                                            weights_only=True)
                              for s in t.train_guard.ring_steps()},
                      "fsdp_plan": dict(t.model_axis.fsdp_plan),
                      "n_params": sum(p.numel() for p in t.model.parameters()),
                      "ema_numel": sum(v.numel() for v in t.state.ema.values())}
        t.export_inference(os.path.join(d, "lib_art"))
        resume = _ma_argv(d, "resume", extra + ["--resume_from_checkpoint", "auto"])
        from pytorchvideo_accelerate_tpu_torch.config import parse_cli
        from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

        t = Trainer(parse_cli(resume))
        t._maybe_resume()
        restored = t.state.state_dict()
        t.close()
        result, seen, _ = _fit(resume)
        out["resumed"] = {"result": result, "seen": seen, "restored": restored}
        # the same checkpoint resumed by plain data parallelism at world 2
        _, seen_dp, _ = _fit(_ma_argv(d, "resume_dp", spec_all["fit"] + [
            "--resume_from_checkpoint", "auto"]))
        out["resumed_dp"] = seen_dp
    return out


def health_case(fsdp_count: int = 1) -> dict:
    """One SGD step of slowfast_t (seeded init, fp32, accumulation 2) with
    the health gauges on: in one process (fsdp_count 1, no group) or as
    this rank of a library mesh of (1, fsdp_count, 1, 1), this rank's
    batch shard of the same global batch of 4 clips. Returns the gauges
    and the loss as floats."""
    from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig, OptimConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.parallel import tensor_parallel as tp
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import make_train_step
    from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

    model = create_model(ModelConfig(name="slowfast_t", num_classes=5, dropout_rate=0.0,
                                     fused_kernels="auto"),
                         "fp32", seed=3, data_cfg=DataConfig(num_frames=8, crop_size=32))
    if fsdp_count > 1:
        pdist.initialize_library_mesh(fsdp_count, 1, 1)
        axis = tp.layout("slowfast_t", "auto", 1, 0, library=True,
                         fsdp_count=fsdp_count, fsdp_index=pdist.fsdp_index())
        tp.apply_model_axis(model, axis)
    kinds = tp.param_kinds(model)
    opt = build_optimizer(OptimConfig(lr=0.01, warmup_steps=0), 4,
                          model.named_parameters(), sharded=kinds)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, accum_steps=2, health_metrics=True)
    rng = np.random.default_rng(11)
    glob = {"slow": rng.standard_normal((2, 4, 2, 32, 32, 3), np.float32),
            "fast": rng.standard_normal((2, 4, 8, 32, 32, 3), np.float32),
            "label": rng.integers(0, 5, (2, 4)).astype(np.int64)}
    b = 4 // fsdp_count
    lo = (pdist.batch_index() if fsdp_count > 1 else 0) * b
    m = step(state, {k: torch.from_numpy(v[:, lo:lo + b].copy()) for k, v in glob.items()})
    out = {k: float(m[k]) for k in ("loss", "param_norm", "update_ratio", "nonfinite")}
    out["fsdp_leaves"] = sum(1 for k in kinds.values() if k & tp.FSDP)
    return out


def health(rank, world, d):
    """`health_case` at fsdp `world`."""
    return health_case(world)


def unwind(rank, world, d):
    """Rank 0 raises before step 2, after step 1's asynchronous save was
    dispatched and before it was fenced; rank 1 goes on into step 2's
    gradient all-reduce. Rank 0's fit fences its writes without the rank
    barrier (which rank 1 never reaches) and re-raises its own error; rank
    1's all-reduce then fails as rank 0 leaves. Each rank writes its result
    and exits here: the group's closing barrier would never meet."""
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer

    def fail_before_2(epoch_fn):
        def epoch(*a, **kw):
            for i, batch in enumerate(epoch_fn(*a, **kw)):
                if i == 1 and rank == 0:
                    raise RuntimeError("rank 0 step failure")
                yield batch
        return epoch

    argv = _argv(d, "unwind", ["--data.synthetic_num_videos", "16", "--num_epochs", "1",
                               "--checkpointing_steps", "1"])
    t0 = time.monotonic()
    try:
        _fit(argv, wrap_epoch=fail_before_2)
        error = None
    except Exception as e:  # noqa: BLE001 - the result
        error = e
    out = {"error": repr(error), "seconds": time.monotonic() - t0,
           "notes": getattr(error, "__notes__", []),
           "steps": Checkpointer(os.path.join(d, "unwind", "checkpoints")).all_steps()}
    torch.save(out, os.path.join(d, f"unwind.rank{rank}.pt"))
    sys.stdout.flush()
    os._exit(0)


# --- pipeline stages (tests/test_torch_pipeline.py) --------------------------


def _count_stage_calls(counts):
    """Wrap dist's collectives to count this rank's calls per (name, group
    ranks); returns the originals for `_restore_calls`."""
    real = {}
    for name in ("broadcast", "all_reduce", "batch_isend_irecv"):
        real[name] = getattr(dist, name)

        def call(*a, _name=name, **kw):
            group = kw.get("group")
            if _name == "batch_isend_irecv":
                group = a[0][0].group
            key = (_name, tuple(pdist.group_ranks(group)))
            counts[key] = counts.get(key, 0) + 1
            return real[_name](*a, **kw)
        setattr(dist, name, call)
    return real


def _restore_calls(real):
    for name, fn in real.items():
        setattr(dist, name, fn)


def _pipe_model(d, case, plan, attention="dense"):
    """The case's seeded twin (`w/` leaves of DIR/<name>.npz) built with
    `plan`."""
    from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig
    from pytorchvideo_accelerate_tpu_torch.models import create_model
    from pytorchvideo_accelerate_tpu_torch.models.convert import state_dict_from_jax

    spec = np.load(os.path.join(d, f"{case['name']}.npz"))
    flat = {k[2:]: spec[k] for k in spec.files if k.startswith("w/")}
    model = create_model(
        ModelConfig(name=case["name"], num_classes=int(spec["num_classes"]),
                    dropout_rate=0.0, attention=attention,
                    remat=bool(case.get("remat"))), "fp32",
        data_cfg=DataConfig(num_frames=spec["video"].shape[1],
                            crop_size=spec["video"].shape[2]), pipeline=plan)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           state_dict_from_jax(flat).items()})
    return spec, model


def _rows(x, index, count):
    b = x.shape[0] // count
    return torch.from_numpy(np.ascontiguousarray(x[index * b:(index + 1) * b]))


def _inject_mask(spec):
    """The port's tube mask replaced by this batch shard's rows of the
    spec's global `keep` / `masked` indices; returns the function to put
    back."""
    from pytorchvideo_accelerate_tpu_torch.models import videomae as tvideomae

    def mask(generator, batch, t, h, w, ratio, device=None):
        return tuple(_rows(spec[k], pdist.batch_index(), pdist.batch_count()).to(device)
                     for k in ("keep", "masked"))
    real, tvideomae.tube_mask_indices = tvideomae.tube_mask_indices, mask
    return real


def _pipe_blocks(d, case, plan):
    """(b): `pipeline_blocks` over the encoder blocks of the videomae_t
    twin (under remat with `remat`) on this data shard's rows of
    DIR/blocks.npz's tokens, the loss sum(y * ct), the gradients reduced
    as the step reduces them."""
    from pytorchvideo_accelerate_tpu_torch.parallel import pipeline as pl
    from pytorchvideo_accelerate_tpu_torch.parallel.tensor_parallel import (
        param_kinds,
        partial_params,
    )
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import reduce_grads

    _, model = _pipe_model(d, {"name": "videomae_t", "remat": case.get("remat")}, plan)
    enc = model.encoder
    spec = np.load(os.path.join(d, "blocks.npz"))
    x = _rows(spec["x"], pdist.data_index(), pdist.data_count()).requires_grad_()
    ct = _rows(spec["ct"], pdist.data_index(), pdist.data_count())
    counts = {}
    pl.reset_transfers()
    real = _count_stage_calls(counts)
    try:
        y = pl.pipeline_blocks(enc.blocks(), x, plan)
        (y * ct).sum().backward()
    finally:
        _restore_calls(real)
    transfers = dict(pl.TRANSFERS)
    live = [(n, p.grad) for n, p in enc.named_parameters() if p.grad is not None]
    reduce_grads(live, param_kinds(enc), set(partial_params(enc)))
    return {"y": _np(y), "dx": _np(x.grad), "counts": counts, "transfers": transfers,
            "grads": {n: _np(g) for n, g in live if n.startswith("block")}}


def _pipe_step(d, case, plan):
    """(c), (g): one step of the case's model built with `plan` on this
    data shard's rows (the tube mask injected), SGD of the spec's optim;
    `nan`: the first clip poisoned, under `guard_skip`."""
    import json

    from pytorchvideo_accelerate_tpu_torch.config import OptimConfig
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
        make_pretrain_step,
        make_train_step,
    )
    from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

    with open(os.path.join(d, "pipeline.json")) as f:
        optim = json.load(f)["optim"]
    spec, model = _pipe_model(d, case, plan)
    opt = build_optimizer(OptimConfig(**optim), 4, model.named_parameters())
    state = TrainState.create(model, opt)
    guard = bool(case.get("nan"))
    video = _rows(spec["video"], pdist.batch_index(), pdist.batch_count())
    if guard and pdist.batch_index() == 0:
        video[0, 0, 0, 0] = float("nan")
    from pytorchvideo_accelerate_tpu_torch.models import videomae as tvideomae

    batch, mask = {"video": video}, tvideomae.tube_mask_indices
    if case["name"].endswith("_pretrain"):
        mask = _inject_mask(spec)
        step = make_pretrain_step(model, opt, pipeline=plan, guard_skip=guard)
    else:
        batch["label"] = _rows(spec["label"], pdist.batch_index(), pdist.batch_count())
        step = make_train_step(model, opt, pipeline=plan, guard_skip=guard)
    before = {k: _np(v) for k, v in model.state_dict().items()}
    counts = {}
    real = _count_stage_calls(counts)
    try:
        m = step(state, batch)
    finally:
        _restore_calls(real)
        tvideomae.tube_mask_indices = mask
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "skipped": float(m.get("skipped", 0.0)),
            "accuracy": float(m.get("accuracy", 0.0)), "counts": counts,
            "grads": {n: _np(p.grad) for n, p in model.named_parameters()},
            "before": before, "state": {k: _np(v) for k, v in model.state_dict().items()},
            "opt": {f"{i}/{k}": _np(v) for i, st in enumerate(opt.opt.state.values())
                    for k, v in st.items() if torch.is_tensor(v)}}


def _pipe_fold(d, case, plan):
    """(d): videomae_t, accumulation 2, the pipelined step (the micro axis
    folded) against the unpipelined step on the same weights and batch."""
    import json

    from pytorchvideo_accelerate_tpu_torch.config import OptimConfig
    from pytorchvideo_accelerate_tpu_torch.trainer.optim import build_optimizer
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import make_train_step
    from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

    with open(os.path.join(d, "pipeline.json")) as f:
        optim = json.load(f)["optim"]
    out = {}
    for tag, p in (("pipelined", plan), ("plain", None)):
        spec, model = _pipe_model(d, case, p)
        opt = build_optimizer(OptimConfig(**optim), 4, model.named_parameters())
        state = TrainState.create(model, opt)
        step = make_train_step(model, opt, accum_steps=2, pipeline=p)
        batch = {k: torch.from_numpy(spec[k].reshape((2, -1) + spec[k].shape[1:]).copy())
                 for k in ("video", "label")}
        m = step(state, batch)
        out[tag] = {"loss": float(m["loss"]),
                    "state": {k: _np(v) for k, v in model.state_dict().items()}}
    return out


def _pipe_mvit(d, case, plan):
    """(e): a uniform MViT (no stage starts, no drop path) pipelined
    against the same weights unpipelined: output and input gradient on
    the seeded clips of DIR/mvit_u.npz, the gradients reduced."""
    import copy

    from pytorchvideo_accelerate_tpu_torch.models import init_like_jax
    from pytorchvideo_accelerate_tpu_torch.models.mvit import MViT
    from pytorchvideo_accelerate_tpu_torch.parallel.tensor_parallel import (
        param_kinds,
        partial_params,
    )
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import reduce_grads

    spec = np.load(os.path.join(d, "mvit_u.npz"))
    plain = MViT(4, input_grid=spec["x"].shape[1:4], embed_dim=16, depth=4, num_heads=2,
                 stage_starts=(), drop_path_rate=0.0, dropout_rate=0.0)
    init_like_jax(plain, torch.Generator().manual_seed(0))
    piped = copy.deepcopy(plain)
    piped.set_pipeline(plan)
    out = {}
    for tag, m in (("plain", plain), ("pipelined", piped)):
        x = torch.from_numpy(spec["x"]).requires_grad_()
        y = m(x)
        (y * torch.from_numpy(spec["ct"])).sum().backward()
        live = [(n, p.grad) for n, p in m.named_parameters() if p.grad is not None]
        reduce_grads(live, param_kinds(m), set(partial_params(m)))
        out[tag] = {"y": _np(y), "dx": _np(x.grad), "grads": {n: _np(g) for n, g in live}}
    return out


def _pipe_library(d, case, plan):
    """(f): videomae_t on the (1, 1, 2, 2) library mesh, pipelined over
    `tensor` with ring attention over `context`, against the dense
    unpipelined twin: logits, and the gradients of sum(logits * ct)."""
    from pytorchvideo_accelerate_tpu_torch.parallel.tensor_parallel import (
        param_kinds,
        partial_params,
    )
    from pytorchvideo_accelerate_tpu_torch.trainer.steps import reduce_grads

    out = {}
    for tag, p, att in (("dense", None, "dense"), ("ring_pipelined", plan, "ring")):
        spec, model = _pipe_model(d, case, p, attention=att)
        y = model(torch.from_numpy(spec["video"]))
        (y * torch.from_numpy(spec["ct"])).sum().backward()
        live = [(n, g.grad) for n, g in model.named_parameters() if g.grad is not None]
        if p is not None:
            reduce_grads(live, param_kinds(model), set(partial_params(model)))
        out[tag] = {"y": _np(y), "grads": {n: _np(g) for n, g in live}}
    return out


def _pipe_trainer(d, case, plan):
    """(h): run.main's Trainer at (1, 2) with `--parallel.pipeline_stages
    2` (videomae_t_pretrain, a checkpoint every step): each step's loss and
    this rank's parameters after it, the fit's result and its full state."""
    del plan
    argv = _ma_argv(d, case["tag"], case["argv"])
    states = []

    def keep(trainer, step):
        states.append({k: _np(v) for k, v in trainer.model.state_dict().items()})
    result, seen, _ = _fit(argv, on_step=keep)
    t = _LAST[0]
    full = {k: _np(v) for k, v in t.state.state_dict()["model"].items()}
    ckpt = os.path.join(t.checkpointer.directory, str(t.checkpointer.latest_step()))
    t.close()
    return {"result": result, "seen": seen, "states": states, "full": full, "ckpt": ckpt,
            "mode": t.model_axis.mode}


_PIPE_KINDS = {"blocks": _pipe_blocks, "step": _pipe_step, "fold": _pipe_fold,
               "mvit": _pipe_mvit, "library": _pipe_library, "trainer": _pipe_trainer}


def pipeline(rank, world, d):
    """The cases of DIR/pipeline.json for this world size in turn, each on
    its grid (`model`: the (world / model, model) train mesh; `library`: the
    (data, fsdp, tensor, context) mesh) with its plan; a case with
    `control` runs with the stage-group sum patched out (the trunk blocks'
    gradients reduced as replicated ones)."""
    import json

    from pytorchvideo_accelerate_tpu_torch.parallel import pipeline as pl
    from pytorchvideo_accelerate_tpu_torch.parallel import tensor_parallel as tp

    with open(os.path.join(d, "pipeline.json")) as f:
        cases = [c for c in json.load(f)["cases"] if c["world"] == world]
    staged = tp.staged_params
    out = {}
    for case in cases:
        if "library" in case:
            pdist.initialize_library_mesh(*case["library"][1:])
            shape = tuple(case["library"])
        else:
            pdist.initialize_mesh(case["model"])
            shape = (world // case["model"], case["model"])
        plan = pl.make_plan(shape, case.get("stages", 2), microbatches=case.get("micro", 2),
                            cp_axis_name="context" if "library" in case else None)
        if case.get("control"):
            tp.staged_params = lambda model: []
        try:
            out[case["tag"]] = _PIPE_KINDS[case["kind"]](d, case, plan)
        finally:
            tp.staged_params = staged
    return out


def pipeline_restore(rank, world, d):
    """(h) at (1, 1): a fresh Trainer of the test's one-process argv
    restoring the (1, 2) pipelined checkpoint DIR/ckpt.txt names; its
    state."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    with open(os.path.join(d, "ckpt.txt")) as f:
        ckpt = f.read().strip()
    t = Trainer(parse_cli(_ma_argv(d, "restore11", [
        "--model.name", "videomae_t_pretrain", "--batch_size", "4"])))
    Checkpointer(os.path.dirname(ckpt)).restore(t.state, step=int(os.path.basename(ckpt)))
    return {k: _np(v) for k, v in t.state.state_dict()["model"].items()}


# the hang watch at world 2: rank 1 sleeps HANG_DELAY_S inside the barrier of
# the last checkpoint fence (`Checkpointer.close`), rank 0 waits in it; each
# watchdog, at HANG_TIMEOUT_S, attributes its rank's wedge
HANG_TIMEOUT_S, HANG_DELAY_S = 1.5, 4.0
HANG_BARRIER = "name=checkpoint_close"


def hangwatch(rank, world, d):
    import json

    from pytorchvideo_accelerate_tpu_torch.parallel import schedule_recorder as srec
    from pytorchvideo_accelerate_tpu_torch.parallel.hangcheck import host_tag
    from pytorchvideo_accelerate_tpu_torch.reliability import faults

    recorder = srec.CollectiveScheduleRecorder(host_tag())
    srec.install_schedule_recorder(recorder)
    if rank == 1:
        faults.arm(faults.FaultPlan(0, [faults.FaultSpec(
            "collective.sync", kind="delay", delay_s=HANG_DELAY_S,
            path_substr=HANG_BARRIER, max_fires=1)]))
    argv = _argv(d, "hang", ["--data.synthetic_num_videos", "16", "--num_epochs", "1",
                             "--checkpointing_steps", "2",
                             "--obs.watchdog_timeout_s", str(HANG_TIMEOUT_S)])
    result, seen, _ = _fit(argv)
    wd = _LAST[0].watchdog
    name = "flight_record.json" if rank == 0 else f"flight_record.rank{rank}.json"
    with open(os.path.join(d, "hang", name)) as f:
        flight = json.load(f)["events"]
    return {"result": result, "stall_count": wd.stall_count,
            "last_stalled": wd.last_stalled,
            "attribution": dict(wd.last_attribution),
            "schedule": recorder.schedules(), "fired": faults.fault_history(),
            "flight": [e for e in flight if e["kind"] in ("watchdog", "fault")]}


def run_group(scenario: str, d, world: int = 2, env=None,
              timeout_s: float = 150.0) -> list:
    """Start `world` spawned ranks of `scenario` over directory `d`; fail
    if any exits non-zero or the group outlives `timeout_s` (all ranks are
    killed then); returns each rank's result, rank order."""
    full_env = {**os.environ, "OMP_NUM_THREADS": "2", **(env or {})}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario,
                               str(r), str(world), str(d)],
                              env={**full_env, **({"PVA_PROCESS_ID": str(r)}
                                                  if scenario == "env" else {})},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"{scenario}: the group outlived {timeout_s} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{scenario} rank {r} rc {p.returncode}:\n{out[-4000:]}"
    return [torch.load(os.path.join(str(d), f"{scenario}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


SCENARIOS = {"collectives": collectives, "env": env, "train_step": train_step,
             "mix": mix, "trainer": trainer, "cuda_step": cuda_step,
             "pretrained": pretrained, "model_axis": model_axis,
             "cp_attention": cp_attention, "replicated": replicated, "ckpt": ckpt,
             "mvit_tp_forward": mvit_tp_forward, "library": library,
             "health": health, "unwind": unwind, "pipeline": pipeline,
             "pipeline_restore": pipeline_restore, "hangwatch": hangwatch}


def main() -> None:
    name, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.manual_seed(0)
    if name != "env":
        join(rank, world, d)
    out = SCENARIOS[name](rank, world, d)
    torch.save(out, os.path.join(d, f"{name}.rank{rank}.pt"))
    pdist.sync_global_devices()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
