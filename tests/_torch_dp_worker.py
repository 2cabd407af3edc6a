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


# --- the Trainer: eval, resume, the guard's skip, preemption ------------------


def _argv(d, name, extra=()):
    return ["--cpu", "--synthetic", "--model.name", "tiny3d", "--num_frames", "4",
            "--data.crop_size", "32", "--data.min_short_side_scale", "32",
            "--data.max_short_side_scale", "40", "--batch_size", "2",
            "--gradient_accumulation_steps", "2", "--data.num_workers", "1",
            "--mixed_precision", "fp32", "--lr", "0.05",
            "--output_dir", os.path.join(d, name), *extra]


def _fit(argv, on_step=None, wrap_epoch=None):
    """run.main's Trainer.fit() for `argv`, each step's (loss, skipped)
    recorded; `on_step(trainer, step)` runs after each step,
    `wrap_epoch(trainer, epoch_fn)` may wrap the train prefetcher."""
    from pytorchvideo_accelerate_tpu_torch.config import parse_cli
    from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

    trainer = Trainer(parse_cli(argv))
    seen = []
    step_fn = trainer.train_step

    def step(state, batch):
        m = step_fn(state, batch)
        seen.append((state.step, float(m["loss"]), float(m.get("skipped", 0.0))))
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
             "pretrained": pretrained}


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
