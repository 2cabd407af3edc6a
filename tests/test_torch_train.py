"""The port's training against the JAX package's, on the CPU in float32.

The same numpy-seeded weights and clips go through the JAX package's flax
models and `make_train_step` (one-device mesh) and through the port's
models and steps; dropout is 0 on both sides (the two frameworks cannot
draw the same random bits). Tolerances, each stated where it is used:

- one forward + backward: loss and new BN running averages atol 1e-5 (f32,
  different summation order), every gradient within 1e-4 * (1 + max|g|) of
  its leaf (sums over thousands of rows) for tiny3d. slowfast_t's fast
  pathway is 2 to 16 channels wide, and batch statistics of the narrow
  channels that the ReLUs nearly silence amplify the two frameworks' f32
  rounding (each side alone agrees with a float64 run of the port to
  ~5e-4 at some leaves, on alternating sides as the weights change): there
  every gradient is held within 1e-2 * (1 + max|g|) of its leaf and the
  whole gradient within 5e-3 relative (measured: 2.8e-3 and 2.6e-3);
- optimizer steps (SGD with momentum, coupled weight decay, cosine with
  warmup; adamw; clipping; freeze_backbone; EMA): loss, grad_norm and lr
  rtol 1e-4, params and BN running averages atol 2e-5 after 1 step and
  1e-4 after 3 (each step's lr-scaled update carries the gradient's error).

The port's fused sites run `fused_kernels auto` here, i.e. the custom
autograd Functions (`ops/fused.py`) with the plain versions inside, so
these tests go through the port's own backward.
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.config import MeshConfig as JMeshConfig
from pytorchvideo_accelerate_tpu.config import ModelConfig as JModelConfig
from pytorchvideo_accelerate_tpu.config import OptimConfig as JOptimConfig
from pytorchvideo_accelerate_tpu.models import common as jcommon
from pytorchvideo_accelerate_tpu.parallel.mesh import make_mesh
from pytorchvideo_accelerate_tpu.parallel.sharding import shard_batch
from pytorchvideo_accelerate_tpu.trainer import optim as joptim
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState as JState
from pytorchvideo_accelerate_tpu_torch import models as tmodels
from pytorchvideo_accelerate_tpu_torch import run as trun
from pytorchvideo_accelerate_tpu_torch.config import ModelConfig, OptimConfig, parse_cli
from pytorchvideo_accelerate_tpu_torch.models import common as tcommon
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    jax_train_state_from_port,
    load_train_state,
    state_dict_from_jax,
    train_state_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.serving.engine import InferenceEngine
from pytorchvideo_accelerate_tpu_torch.trainer import optim as toptim
from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps
from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer
from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

NUM_CLASSES = 5
CROP = 32


def _clips(name, batch, seed, frames=4, lead=()):
    rng = np.random.default_rng(seed)
    if name.startswith("slowfast"):
        return {"slow": rng.standard_normal(lead + (batch, frames // 4 or 1, CROP, CROP, 3), np.float32),
                "fast": rng.standard_normal(lead + (batch, frames, CROP, CROP, 3), np.float32)}
    return {"video": rng.standard_normal(lead + (batch, frames, CROP, CROP, 3), np.float32)}


def _labels(batch, seed, lead=()):
    return np.random.default_rng(seed + 100).integers(
        0, NUM_CLASSES, lead + (batch,)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _seeded_flat(name):
    """He-scaled kernels, BN affine near identity, random running stats,
    head std 1/sqrt(in): the flax tree as flat numpy leaves."""
    model = jmodels.create_model(
        JModelConfig(name=name, num_classes=NUM_CLASSES), "fp32")
    x = {k: v[:1] for k, v in _clips(name, 1, 0).items()}
    inp = (x["slow"], x["fast"]) if "slow" in x else x["video"]
    spec = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), inp)
    tree = jax.eval_shape(
        lambda i: model.init(jax.random.PRNGKey(0), i, train=False), spec)
    rng = np.random.default_rng(7)
    flat = {}
    for key, leaf in flatten_tree(tree).items():
        shape = leaf.shape
        if key.endswith("kernel") and len(shape) == 5:
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:4]))
        elif key.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif key.endswith("scale") or key.endswith("var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # other biases, means
            v = rng.standard_normal(shape) * 0.1
        flat[key] = v.astype(np.float32)
    return flat


def _jax_model(name, fused):
    return jmodels.create_model(
        JModelConfig(name=name, num_classes=NUM_CLASSES, fused_kernels=fused,
                     dropout_rate=0.0), "fp32")


def _torch_model(name, fused):
    model = tmodels.create_model(
        ModelConfig(name=name, num_classes=NUM_CLASSES, fused_kernels=fused,
                    dropout_rate=0.0), "fp32")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           state_dict_from_jax(_seeded_flat(name)).items()})
    return model


def _inputs_t(clips):
    t = {k: torch.from_numpy(v) for k, v in clips.items()}
    return (t["slow"], t["fast"]) if "slow" in t else t["video"]


def _inputs_j(clips):
    return (clips["slow"], clips["fast"]) if "slow" in clips else clips["video"]


def _close_per_leaf(got: dict, want: dict, rel: float):
    """Each leaf within rel * (1 + max|want|)."""
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = np.asarray(got[k])
        assert g.shape == w.shape, k
        tol = rel * (1.0 + np.abs(w).max())
        assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max(), tol)


# --- one forward + backward --------------------------------------------------


# slowfast_t runs batch 8: its slow res5 sees 1x1x1 per clip at this crop,
# and batch statistics over 2 values would amplify f32 rounding ~100x
@pytest.mark.parametrize("name,jax_fused,port_fused,batch,leaf_tol", [
    ("tiny3d", "pallas", "auto", 2, 1e-4),   # JAX custom VJPs (interpret) vs the port's
    ("slowfast_t", "off", "off", 8, 1e-2),   # unfused conv -> batch-stat BN -> act
    ("slowfast_t", "xla", "auto", 8, 1e-2),  # fused train tail, both backwards
])
def test_train_forward_backward_matches_jax(name, jax_fused, port_fused, batch,
                                            leaf_tol):
    clips, labels = _clips(name, batch, 1), _labels(batch, 1)
    tree = unflatten_tree(_seeded_flat(name))
    jm = _jax_model(name, jax_fused)

    def jloss(params):
        logits, upd = jm.apply(
            {"params": params, "batch_stats": tree["batch_stats"]},
            _inputs_j(clips), train=True, mutable=["batch_stats"])
        loss, _, _ = jsteps._loss_and_metrics(
            logits, jnp.asarray(labels), jnp.ones(batch, jnp.float32), 0.1)
        return loss, upd["batch_stats"]

    (jl, jstats), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        tree["params"])

    tm = _torch_model(name, port_fused).train()
    logits = tm(_inputs_t(clips))
    loss, _, _ = tsteps._loss_and_metrics(
        logits, torch.from_numpy(labels), torch.ones(batch), 0.1)
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5)
    want_g = state_dict_from_jax({"params": jax.device_get(jgrads)})
    got_g = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    _close_per_leaf(got_g, want_g, leaf_tol)
    err = sum(float(((got_g[k] - want_g[k]) ** 2).sum()) for k in want_g)
    ref = sum(float((want_g[k] ** 2).sum()) for k in want_g)
    assert (err / ref) ** 0.5 <= (1e-5 if leaf_tol < 1e-3 else 5e-3)
    want_s = state_dict_from_jax({"batch_stats": jax.device_get(jstats)})
    got_s = {k: v.numpy() for k, v in tm.state_dict().items() if k in want_s}
    _close_per_leaf(got_s, want_s, 1e-5)


@pytest.mark.parametrize("fused", ["pallas", "off"])
def test_conv_bn_act_train_mode_matches_flax(fused):
    """One ConvBNAct in train mode, fused tail (`fused_train_norm_act`) or
    the unfused conv -> BN -> act: output, new running stats, grads of the
    input and every parameter."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 5, 6, 12)).astype(np.float32)
    ct = rng.standard_normal((2, 3, 5, 6, 10)).astype(np.float32)
    jm = jcommon.ConvBNAct(10, (3, 1, 1), fused=fused)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.3 + (a.ndim == 1),
                              jnp.float32), variables["params"])
    stats = jax.tree.map(lambda a: a, variables["batch_stats"])

    def jfn(x, params):
        y, upd = jm.apply({"params": params, "batch_stats": stats}, x,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jdx, jdp) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(x), params)

    tm = tcommon.ConvBNAct(12, 10, (3, 1, 1),
                           fused="auto" if fused == "pallas" else "off").train()
    sd = state_dict_from_jax({"params": jax.device_get(params),
                              "batch_stats": jax.device_get(stats)})
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
    y = tm(xt)
    (y * torch.from_numpy(ct).permute(0, 4, 1, 2, 3)).sum().backward()

    np.testing.assert_allclose(y.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(jdx), atol=1e-4)
    want_g = state_dict_from_jax({"params": jax.device_get(jdp)})
    _close_per_leaf({n: p.grad.numpy() for n, p in tm.named_parameters()},
                    want_g, 1e-4)
    want_s = state_dict_from_jax({"batch_stats": jax.device_get(jstats)})
    _close_per_leaf({k: tm.state_dict()[k].numpy() for k in want_s}, want_s,
                    1e-5)


def test_batch_norm_stats_are_flax_fast_variance():
    x = np.random.default_rng(2).standard_normal((3, 4, 5, 6)).astype(np.float32) + 3.0
    jm, jv = jcommon.batch_norm_stats(jnp.asarray(x))
    tm, tv = tcommon.batch_norm_stats(torch.from_numpy(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


# --- optimizer steps against make_train_step --------------------------------


def _mesh1():
    return make_mesh(JMeshConfig(data=1), devices=jax.devices()[:1])


def _opt_cfgs(**kw):
    base = dict(lr=0.05, momentum=0.9, weight_decay=1e-3, schedule="cosine",
                warmup_steps=1)
    base.update(kw)
    return JOptimConfig(**base), OptimConfig(**base)


def _run_both(n_steps, accum=2, total=4, ema=0.0, freeze=False, **opt_kw):
    """n_steps optimizer steps of tiny3d on both sides from the same
    weights and batches; returns (per-step metrics j/t, final j state, t
    state, t model)."""
    name = "tiny3d"
    jcfg, tcfg = _opt_cfgs(**opt_kw)
    jm = _jax_model(name, "off")
    tree = unflatten_tree(_seeded_flat(name))
    jfilter = type(jm).backbone_param_filter
    tx = joptim.build_optimizer(jcfg, total, backbone_filter=jfilter,
                                freeze_backbone=freeze)
    jstate = JState.create(jax.tree.map(jnp.asarray, tree["params"]),
                           jax.tree.map(jnp.asarray, tree["batch_stats"]), tx,
                           ema=ema > 0)
    mesh = _mesh1()
    jstep = jsteps.make_train_step(jm, tx, mesh, accum_steps=accum,
                                   lr_schedule=joptim.build_lr_schedule(jcfg, total),
                                   ema_decay=ema)
    tm = _torch_model(name, "auto")
    topt = toptim.build_optimizer(tcfg, total, tm.named_parameters(),
                                  backbone_filter=type(tm).backbone_param_filter,
                                  freeze_backbone=freeze)
    tstate = TrainState.create(tm, topt, ema_decay=ema)
    tstep = tsteps.make_train_step(tm, topt, accum_steps=accum, ema_decay=ema)
    jmetrics, tmetrics = [], []
    for i in range(n_steps):
        clips = _clips(name, 2, 10 + i, lead=(accum,))
        labels = _labels(2, 10 + i, lead=(accum,))
        batch = {**clips, "label": labels}
        jstate, jm_i = jstep(jstate, shard_batch(mesh, batch, micro_dim=True),
                             jax.random.key(i))
        jmetrics.append({k: float(v) for k, v in jm_i.items()})
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tm_i = tstep(tstate, tb)
        tmetrics.append({k: float(v) for k, v in tm_i.items()})
    return jmetrics, tmetrics, jstate, tstate


def _assert_states_close(jstate, tstate, atol):
    want = state_dict_from_jax({"params": jax.device_get(jstate.params),
                                "batch_stats": jax.device_get(jstate.batch_stats)})
    got = {k: v.detach().numpy() for k, v in tstate.model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=k)


def _assert_metrics_close(jmetrics, tmetrics):
    for jm_i, tm_i in zip(jmetrics, tmetrics):
        for k in ("loss", "grad_norm", "lr", "accuracy"):
            np.testing.assert_allclose(tm_i[k], jm_i[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("n_steps,atol", [(1, 2e-5), (3, 1e-4)])
def test_sgd_steps_with_accumulation_match_jax(n_steps, atol):
    jmetrics, tmetrics, jstate, tstate = _run_both(n_steps)
    _assert_metrics_close(jmetrics, tmetrics)
    assert tstate.step == int(jstate.step) == n_steps
    _assert_states_close(jstate, tstate, atol)


def test_adamw_clip_and_freeze_backbone_step_matches_jax():
    jmetrics, tmetrics, jstate, tstate = _run_both(
        1, optimizer="adamw", grad_clip_norm=0.5, freeze=True,
        weight_decay=0.05)
    _assert_metrics_close(jmetrics, tmetrics)
    _assert_states_close(jstate, tstate, 2e-5)
    # the backbone did not move (no update, no weight decay)
    seeded = state_dict_from_jax(_seeded_flat("tiny3d"))
    for k, v in tstate.model.state_dict().items():
        if not k.startswith("head.") and "running" not in k:
            np.testing.assert_array_equal(v.numpy(), seeded[k])


def test_adamw_state_from_the_card_resumes_on_the_cpu():
    """On the card AdamW is `capturable` (its step counts beside the
    params). A state saved there loads into a CPU optimizer as a plain
    AdamW, its counts on the host, and steps exactly as the optimizer it
    was saved from."""
    def adamw():
        tm = _torch_model("tiny3d", "auto")
        return tm, toptim.build_optimizer(OptimConfig(optimizer="adamw"), 4,
                                          tm.named_parameters())

    def update(tm, opt, step):
        for p in tm.parameters():
            p.grad = torch.full_like(p, 0.01 * (step + 1))
        opt.step(step)

    tm, opt = adamw()
    update(tm, opt, 0)
    saved = copy.deepcopy(opt.state_dict())  # as a checkpoint holds it
    for group in saved["param_groups"]:
        group["capturable"] = True  # as the card writes it
    tm2, opt2 = adamw()
    tm2.load_state_dict(tm.state_dict())
    opt2.load_state_dict(saved)
    assert not opt2.opt.param_groups[0]["capturable"]
    assert all(not st["step"].is_cuda for st in opt2.opt.state.values())
    update(tm, opt, 1)
    update(tm2, opt2, 1)
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)


def test_ema_step_matches_jax():
    jmetrics, tmetrics, jstate, tstate = _run_both(1, ema=0.9)
    want = state_dict_from_jax({"params": jax.device_get(jstate.ema_params)})
    _close_per_leaf({k: v.numpy() for k, v in tstate.ema.items()}, want, 2e-5)


def test_ema_decay_of_one_is_rejected():
    tm = _torch_model("tiny3d", "auto")
    opt = toptim.build_optimizer(OptimConfig(), 4, tm.named_parameters())
    with pytest.raises(ValueError, match="ema_decay"):
        TrainState.create(tm, opt, ema_decay=1.0)


def test_step_two_from_a_jax_state_carried_across():
    """Step 1 on the JAX side, its state carried into the port with
    `train_state_from_jax` (params, batch_stats, SGD momentum, step), then
    step 2 on both sides from that same state."""
    name, accum, total = "tiny3d", 2, 4
    jcfg, tcfg = _opt_cfgs()
    jm = _jax_model(name, "off")
    tree = unflatten_tree(_seeded_flat(name))
    tx = joptim.build_optimizer(jcfg, total)
    sched = joptim.build_lr_schedule(jcfg, total)
    mesh = _mesh1()
    jstep = jsteps.make_train_step(jm, tx, mesh, accum_steps=accum,
                                   lr_schedule=sched)
    jstate = JState.create(jax.tree.map(jnp.asarray, tree["params"]),
                           jax.tree.map(jnp.asarray, tree["batch_stats"]), tx)
    batches = [{**_clips(name, 2, 30 + i, lead=(accum,)),
                "label": _labels(2, 30 + i, lead=(accum,))} for i in range(2)]
    jstate, _ = jstep(jstate, shard_batch(mesh, batches[0], micro_dim=True),
                      jax.random.key(0))
    trace = jax.device_get(jstate.opt_state[1][0].trace)
    carried = train_state_from_jax(jax.device_get(jstate.params),
                                   jax.device_get(jstate.batch_stats),
                                   int(jstate.step), momentum=trace)

    tm = _torch_model(name, "auto")
    topt = toptim.build_optimizer(tcfg, total, tm.named_parameters())
    tstate = TrainState.create(tm, topt)
    load_train_state(tstate, carried)
    back = jax_train_state_from_port(tstate)
    assert back["step"] == 1
    for a, b in zip(jax.tree.leaves(back["momentum"]), jax.tree.leaves(trace)):
        np.testing.assert_array_equal(a, np.asarray(b))

    jstate, jm2 = jstep(jstate, shard_batch(mesh, batches[1], micro_dim=True),
                        jax.random.key(1))
    tm2 = tsteps.make_train_step(tm, topt, accum_steps=accum)(
        tstate, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    _assert_metrics_close([{k: float(v) for k, v in jm2.items()}],
                          [{k: float(v) for k, v in tm2.items()}])
    _assert_states_close(jstate, tstate, 2e-5)


@pytest.mark.parametrize("kw", [dict(schedule="cosine", warmup_steps=3),
                                dict(schedule="cosine", warmup_steps=0),
                                dict(schedule="constant", warmup_steps=2)])
def test_lr_schedule_matches_optax(kw):
    jcfg, tcfg = _opt_cfgs(**kw)
    js = joptim.build_lr_schedule(jcfg, 10)
    ts = toptim.build_lr_schedule(tcfg, 10)
    for step in range(12):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-9)


def test_global_norm_matches_optax():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in [(3, 4), (5,), (2, 2, 2)]]
    want = float(optax.global_norm([jnp.asarray(a) for a in leaves]))
    got = toptim.global_norm([torch.from_numpy(a) for a in leaves]).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --- eval step -------------------------------------------------------------


def test_eval_step_masked_tail_and_two_views_match_jax():
    name = "tiny3d"
    clips = _clips(name, 3, 40, lead=())
    clips = {k: np.stack([v, v[:, ::-1]], axis=1) for k, v in clips.items()}
    labels = _labels(3, 40)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    batch = {**clips, "label": labels, "mask": mask}
    tree = unflatten_tree(_seeded_flat(name))
    jm = _jax_model(name, "off")
    tx = optax.sgd(0.1)
    jstate = JState.create(jax.tree.map(jnp.asarray, tree["params"]),
                           jax.tree.map(jnp.asarray, tree["batch_stats"]), tx)
    want = jsteps.make_eval_step(jm, _mesh1(), label_smoothing=0.1)(
        jstate, shard_batch(_mesh1(), batch))
    tm = _torch_model(name, "auto")
    tstate = TrainState.create(
        tm, toptim.build_optimizer(OptimConfig(), 4, tm.named_parameters()))
    got = tsteps.make_eval_step(tm, label_smoothing=0.1)(
        tstate, {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in batch.items()})
    assert not tm.training
    for k in ("loss_sum", "correct", "correct5", "count"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(got["count"]) == 2.0


def test_topk_correct_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 6).astype(np.int32)
    mask = np.array([1, 1, 1, 0, 1, 1], np.float32)
    want = float(jsteps._topk_correct(jnp.asarray(logits), jnp.asarray(labels),
                                      jnp.asarray(mask)))
    got = float(tsteps._topk_correct(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(mask)))
    assert got == want


# --- init, learning, checkpoints, the entry point --------------------------


def test_init_draws_like_jax():
    """lecun-normal conv kernels (truncated at 2 sigma, variance 1/fan_in),
    BN ones/zeros, head normal(0.01) with a zero bias: initial CE of a
    fresh model near ln(classes) (within 0.25: the head's 256 inputs are
    O(1) after the last ReLU, so the logits' std is ~0.2)."""
    tm = tmodels.create_model(ModelConfig(name="tiny3d", num_classes=NUM_CLASSES,
                                          dropout_rate=0.0), "fp32", seed=3)
    w = tm.res4.block0.conv_b.conv.weight.detach().numpy()
    fan_in = np.prod(w.shape[1:])
    np.testing.assert_allclose(w.std(), np.sqrt(1.0 / fan_in), rtol=0.05)
    assert np.abs(w).max() <= 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978 + 1e-6
    head = tm.head.proj
    assert abs(head.weight.std().item() - 0.01) < 2e-3
    assert not head.bias.detach().any()
    assert (tm.stem.norm.weight.detach() == 1).all()
    again = tmodels.create_model(ModelConfig(name="tiny3d",
                                             num_classes=NUM_CLASSES), "fp32", seed=3)
    for (k, a), b in zip(tm.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    clips = _clips("tiny3d", 4, 3)
    tm.train()
    loss, _, _ = tsteps._loss_and_metrics(tm(_inputs_t(clips)),
                                          torch.from_numpy(_labels(4, 3)),
                                          torch.ones(4), 0.0)
    assert abs(loss.item() - np.log(NUM_CLASSES)) < 0.25
    # X3D: its `proj` is a bare flax Dense (lecun-normal, zero bias), its SE
    # convs carry zero biases, a depthwise kernel's fan-in is its 27 taps
    x3d = tmodels.create_model(ModelConfig(name="x3d_s", num_classes=400),
                               "fp32", seed=3)
    for w, fan_in in ((x3d.proj.weight, 2048), (x3d.head_conv.weight, 432),
                      (x3d.res4_block0.conv_b.weight, 27),
                      (x3d.res4_block0.se.fc1.weight, 216)):
        np.testing.assert_allclose(w.detach().std().item(), np.sqrt(1.0 / fan_in),
                                   rtol=0.1)
    for b in (x3d.proj.bias, x3d.res4_block0.se.fc1.bias,
              x3d.res4_block0.se.fc2.bias):
        assert not b.detach().any()


def test_loss_decreases_on_a_learnable_batch():
    tm = tmodels.create_model(ModelConfig(name="tiny3d", num_classes=4,
                                          dropout_rate=0.0,
                                          fused_kernels="auto"), "fp32")
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, 8)
    video = rng.standard_normal((8, 4, CROP, CROP, 3)).astype(np.float32) * 0.1
    video += labels[:, None, None, None, None] * 0.5
    batch = {"video": torch.from_numpy(video),
             "label": torch.from_numpy(labels.astype(np.int32))}
    opt = toptim.build_optimizer(OptimConfig(lr=0.05, weight_decay=0.0), 50,
                                 tm.named_parameters())
    state = TrainState.create(tm, opt)
    step = tsteps.make_train_step(tm, opt)
    losses = [float(step(state, batch)["loss"]) for _ in range(8)]
    assert losses[-1] < losses[0] * 0.8, losses
    assert state.step == 8


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    tm = _torch_model("tiny3d", "auto")
    opt = toptim.build_optimizer(OptimConfig(), 4, tm.named_parameters())
    state = TrainState.create(tm, opt, ema_decay=0.5)
    step = tsteps.make_train_step(tm, opt, accum_steps=1, ema_decay=0.5)
    step(state, {**{k: torch.from_numpy(v) for k, v in _clips("tiny3d", 2, 50).items()},
                 "label": torch.from_numpy(_labels(2, 50))})
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    extra = {"kind": "step", "data_state": {"epoch": 0, "position": 3}}
    ck.save(1, state, extra)
    saved = {k: v.clone() for k, v in tm.state_dict().items()}
    mom = {n: opt.opt.state[p]["momentum_buffer"].clone()
           for n, p in tm.named_parameters()}
    ema = {k: v.clone() for k, v in state.ema.items()}

    tm2 = tmodels.create_model(ModelConfig(name="tiny3d", num_classes=NUM_CLASSES,
                                           fused_kernels="auto"), "fp32", seed=9)
    opt2 = toptim.build_optimizer(OptimConfig(), 4, tm2.named_parameters())
    state2 = TrainState.create(tm2, opt2, ema_decay=0.5)
    got_extra, got_step = ck.restore(state2)
    assert got_step == 1 and state2.step == 1 and got_extra == extra
    for k, v in tm2.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for n, p in tm2.named_parameters():
        assert torch.equal(opt2.opt.state[p]["momentum_buffer"], mom[n]), n
    for k, v in state2.ema.items():
        assert torch.equal(v, ema[k]), k
    for s in (2, 3):
        ck.save(s, state, extra)
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3


_RUN = ["--cpu", "--synthetic", "--model.name", "tiny3d", "--num_frames", "4",
        "--data.crop_size", "32", "--data.min_short_side_scale", "32",
        "--data.max_short_side_scale", "40", "--batch_size", "2",
        "--gradient_accumulation_steps", "2", "--num_epochs", "2",
        "--data.synthetic_num_videos", "8", "--num_workers", "2",
        "--model.fused_kernels", "auto", "--data.eval_num_clips", "2"]


def test_run_fits_checkpoints_resumes_and_exports(tmp_path):
    out = str(tmp_path / "run")
    res = trun.main(_RUN + ["--checkpointing_steps", "2", "--output_dir", out])
    assert res["steps"] == 4 and np.isfinite(res["train_loss"])
    assert {"clips_per_sec", "steps_per_sec", "input_wait_frac",
            "val_accuracy", "val_accuracy_top5",
            "epoch_train_times"} <= set(res)
    ck = Checkpointer(os.path.join(out, "checkpoints"))
    assert ck.all_steps() == [2, 4]
    # a resumed run with more epochs continues from step 4 and its loader
    # position (epoch 2)
    res2 = trun.main(_RUN + ["--num_epochs", "3", "--output_dir", out,
                             "--resume_from_checkpoint", "auto"])
    assert res2["steps"] == 6
    art = str(tmp_path / "art")
    trun.main(_RUN + ["--output_dir", out, "--resume_from_checkpoint", "auto",
                      "--export_inference", art])
    # slice 1's engine serves it, and agrees with the trainer's eval forward
    tr = Trainer(parse_cli(_RUN + ["--output_dir", out,
                                   "--resume_from_checkpoint", "auto"]))
    tr._maybe_resume()
    assert tr.state.step == 6
    clips = {k: v[:2] for k, v in _clips("tiny3d", 2, 60).items()}
    tr.model.eval()
    with torch.no_grad():
        want = tr.model(_inputs_t(clips)).numpy()
    tr.close()
    eng = InferenceEngine.from_artifact(art, device="cpu", max_batch_size=2)
    np.testing.assert_allclose(eng.predict(clips), want, atol=1e-5)


# one eval view, fp32: the CPU's bf16 grouped conv3d weight gradient is
# wrong (errors larger than the gradient itself at MViT's pools), which
# took a bf16 run of mvit_t to a non-finite loss; the card runs cuDNN
_TRANSFORMER_RUN = (_RUN[:_RUN.index("--data.eval_num_clips")]
                    + ["--mixed_precision", "fp32"])


def test_run_pretrains_videomae_checkpoints_and_resumes(tmp_path):
    """`run.main` on `videomae_t_pretrain`: 2 optimizer steps of the MAE
    objective (no labels) with a checkpoint each, a resume that continues
    the step count, and the reconstruction loss as the eval metric; u8
    clips are refused (the MAE target is the raw clip)."""
    argv = _TRANSFORMER_RUN + ["--model.name", "videomae_t_pretrain",
                               "--num_epochs", "1", "--gradient_accumulation_steps",
                               "1", "--data.synthetic_num_videos", "4",
                               "--model.attention", "pallas",
                               "--checkpointing_steps", "1",
                               "--output_dir", str(tmp_path / "pre")]
    res = trun.main(argv)
    assert res["steps"] == 2 and np.isfinite(res["train_loss"])
    assert np.isfinite(res["val_recon_loss"]) and "val_accuracy" not in res
    ck = Checkpointer(str(tmp_path / "pre" / "checkpoints"))
    assert ck.all_steps() == [1, 2]
    res2 = trun.main(argv + ["--num_epochs", "2", "--resume_from_checkpoint", "auto"])
    assert res2["steps"] == 4
    assert set(trun.main(argv + ["--eval_only"])) == {"val_recon_loss"}
    with pytest.raises(ValueError, match="u8"):
        Trainer(parse_cli(argv + ["--data.host_cast", "u8"]))


def test_run_fits_mvit_t(tmp_path):
    res = trun.main(_TRANSFORMER_RUN + [
        "--model.name", "mvit_t", "--num_epochs", "1",
        "--model.attention", "pallas", "--model.depthwise_impl", "pallas",
        "--output_dir", str(tmp_path / "mvit")])
    assert res["steps"] == 2 and np.isfinite(res["train_loss"])
    assert 0.0 <= res["val_accuracy"] <= 1.0


def test_write_config_and_eval_only(tmp_path):
    path = str(tmp_path / "cfg.json")
    assert trun.main(_RUN + ["--write_config", path]) == {"config_written": path}
    res = trun.main(["--config", path, "--eval_only", "--output_dir",
                     str(tmp_path / "e")])
    assert set(res) == {"val_accuracy", "val_accuracy_top5", "val_loss"}


def test_trainer_without_cpu_flag_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    argv = [a for a in _RUN if a != "--cpu"]
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(parse_cli(argv))


@pytest.mark.parametrize("extra", [
    ["--data.dataplane_workers", "2"],
    ["--mesh.data", "2"], ["--model.pretrained_path", "w.npz"],
    ["--data.transport", "process"]])
def test_unported_options_raise(extra):
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(parse_cli(_RUN + extra))


@pytest.mark.parametrize("extra", [
    ["--guard.enabled"], ["--optim.mixup_alpha", "0.2"],
    ["--model.name", "videomae_t_pretrain", "--model.remat"]])
def test_ported_training_options_train(extra, tmp_path):
    """The guard, mixup and remat train one step on the CPU."""
    res = trun.main(_TRANSFORMER_RUN + extra + [
        "--num_epochs", "1", "--data.limit_train_batches", "1",
        "--output_dir", str(tmp_path / "run")])
    assert res["steps"] == 1 and np.isfinite(res["train_loss"])


@pytest.mark.parametrize("extra", [
    ["--data.synthetic", "false", "--data.cache_dir", "/nonexistent"],
    ["--data.synthetic", "false", "--data_dir", "/nonexistent"]],
    ids=["missing_cache_dir", "missing_data_dir"])
def test_real_data_routes_raise_what_jax_raises(extra, tmp_path):
    """The real-data routes are ported: a missing cache directory or
    data_dir raises in the port exactly what the JAX Trainer raises."""
    from pytorchvideo_accelerate_tpu.config import parse_cli as jparse_cli
    from pytorchvideo_accelerate_tpu.trainer.loop import Trainer as JTrainer

    argv = _RUN + ["--output_dir", str(tmp_path)] + extra
    with pytest.raises(FileNotFoundError) as got:
        Trainer(parse_cli(argv))
    with pytest.raises(FileNotFoundError) as want:
        JTrainer(jparse_cli(argv))
    assert str(got.value) == str(want.value) and "/nonexistent" in str(got.value)


@pytest.mark.parametrize("extra,env", [
    (["--num_processes", "2"], {}),
    (["--coordinator_address", "localhost:1234"], {}),
    (["--process_id", "0"], {}),
    ([], {"PVA_COORDINATOR_ADDRESS": "localhost:1234"}),
    ([], {"PVA_NUM_PROCESSES": "2"}),
    ([], {"PVA_PROCESS_ID": "1"})])
def test_multi_process_jobs_raise(extra, env, monkeypatch):
    """A job of several processes, set by flag or by the launcher's PVA_*
    env, is refused naming the multi-GPU item, not trained as independent
    replicas that share one output_dir."""
    for key in ("PVA_COORDINATOR_ADDRESS", "PVA_NUM_PROCESSES", "PVA_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        Trainer(parse_cli(_RUN + extra))


@pytest.mark.parametrize("extra,line", [
    (["--debug_nans"], "debug_nans is not ported yet"),
    (["--debug_asserts"], "debug_asserts is not ported yet"),
    (["--profile"], "profile is not ported yet"),
    (["--model.pretrained"], "training from scratch. Convert a checkpoint")])
def test_debug_and_pathless_pretrained_flags_print_one_line(extra, line, capsys,
                                                            tmp_path):
    res = trun.main(_RUN + extra + ["--num_epochs", "1",
                                    "--output_dir", str(tmp_path / "run")])
    assert res["steps"] == 2 and np.isfinite(res["train_loss"])
    said = [ln for ln in capsys.readouterr().out.splitlines() if line in ln]
    assert len(said) == 1 and said[0].startswith("pytorchvideo_accelerate_tpu_torch:")


def test_default_single_process_config_raises_and_prints_no_flag_line(
        capsys, monkeypatch):
    """The default run (num_processes 0, no PVA_* env) trains as before:
    only the obs.* line that the default config has always printed."""
    for key in ("PVA_COORDINATOR_ADDRESS", "PVA_NUM_PROCESSES", "PVA_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    Trainer(parse_cli(_RUN)).close()
    said = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("pytorchvideo_accelerate_tpu_torch:")]
    assert len(said) == 1 and "obs.* telemetry" in said[0]
