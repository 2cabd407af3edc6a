"""Pipeline stages in the port (`parallel/pipeline.py`) against the JAX
package's (`tests/test_zpipeline.py`), on the CPU in float32.

Ranks run as gloo processes spawned by `tests/_torch_dp_worker.py`
(scenario `pipeline`, its cases in DIR/pipeline.json; `pipeline_restore`
at (1, 1)); the JAX side runs on the conftest's CPU devices on the same
mesh. Weights are the seeded twins of `tests/test_torch_mvit_videomae.py`
(videomae_t, videomae_t_pretrain; 4 frames at 32x32). Held:

- (a) `stage_cuts`, `analytic_bubble_frac`, `make_plan` (auto M, its
  errors), `validate_homogeneous_blocks`, the batch check of
  `pipeline_blocks` and `stage_tag`: the JAX values and texts for the same
  inputs;
- (b) `pipeline_blocks` over videomae_t's encoder blocks at (1, 2) (also
  under remat) and (2, 2) against the blocks in sequence: forward atol 1e-5, the input's and
  the blocks' gradients (reduced as the step reduces them) within 1e-5 *
  (1 + max|g|); each stage group's ranks make the same collectives;
- (c) one pretraining step of videomae_t_pretrain and one supervised step
  of videomae_t at (2, 2), P = 2, against the JAX pipelined step on the
  same mesh: loss atol 1e-5, each gradient leaf within 1e-2 * (1 + max|g|)
  of `jax.grad`'s, params atol 2e-5 (the bounds of
  `tests/test_torch_model_axis.py` (iv)); the tube mask is seeded numpy
  indices injected into both sides; every rank's parameters bitwise equal
  after the step;
- (d) the fold at G = 2: the pipelined step against the unpipelined step's
  accumulation, the JAX test's bounds: the loss bitwise, the params within
  1e-6 (the port's are bitwise too here: each microbatch of the fold is
  one micro-step's rows);
- (e) a uniform MViT pipelined against plain (output atol 1e-5); the
  three `pipeline_cut_check` refusals, the conv-family refusal and a band
  mask's, in the JAX text; pipeline x fsdp refused (NotImplementedError);
- (f) videomae_t on the (1, 1, 2, 2) library mesh, pipelined over `tensor`
  with ring attention over `context`, against the dense unpipelined twin:
  logits atol 1e-5 (JAX `test_cp_pipeline_composition_on_library_mesh`);
- (g) the guard's skip under the pipelined step: every leaf kept on every
  stage rank;
- (h) run.main's Trainer at (1, 2) with `--parallel.pipeline_stages 2`: the
  ranks' parameters bitwise equal after every step, losses and parameters
  within 1e-5 / 2e-5 of one process's unpipelined run, and its checkpoint
  restored bitwise at (1, 1) and in one process;
- (i) the control, with the stage-group sum patched out (each trunk
  block's gradient averaged like a replicated one): (b) and (h) fail.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dp_worker import _fit, _ma_argv, run_group
from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.config import MeshConfig as JMeshConfig
from pytorchvideo_accelerate_tpu.config import ModelConfig as JModelConfig
from pytorchvideo_accelerate_tpu.config import OptimConfig as JOptimConfig
from pytorchvideo_accelerate_tpu.models import videomae as jvideomae
from pytorchvideo_accelerate_tpu.models.mvit import MViT as JMViT
from pytorchvideo_accelerate_tpu.parallel import pipeline as jpl
from pytorchvideo_accelerate_tpu.parallel.mesh import make_mesh, make_train_mesh
from pytorchvideo_accelerate_tpu.parallel.sharding import shard_batch, shard_state
from pytorchvideo_accelerate_tpu.trainer import optim as joptim
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState as JState
from pytorchvideo_accelerate_tpu_torch import models as tmodels
from pytorchvideo_accelerate_tpu_torch.config import ModelConfig, parse_cli
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    state_dict_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.models.mvit import MViT
from pytorchvideo_accelerate_tpu_torch.models.videomae import tube_mask_indices
from pytorchvideo_accelerate_tpu_torch.parallel import pipeline as tpl
from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer
from test_torch_mvit_videomae import CROP, FRAMES, NUM_CLASSES, _port_model, _seeded_flat

OPT = dict(lr=0.05, momentum=0.9, weight_decay=1e-3, schedule="cosine",
           warmup_steps=1)
GLOBAL_BATCH = 8
TRAINER_ARGV = ["--model.name", "videomae_t_pretrain", "--batch_size", "4",
                "--checkpointing_steps", "1"]
PIPE_ARGV = TRAINER_ARGV + ["--mesh.model", "2", "--parallel.pipeline_stages", "2"]


def _msg(fn, *a, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


# --- (a) the plan, the cuts, the checks: pure ---------------------------------


@pytest.mark.parametrize("n,p", [(12, 2), (12, 3), (4, 4), (6, 4), (5, 1), (4, 0)])
def test_stage_cuts_and_bubble_match_jax(n, p):
    if p >= 1 and n % p == 0:
        assert tpl.stage_cuts(n, p) == jpl.stage_cuts(n, p)
    else:
        assert _msg(tpl.stage_cuts, n, p) == _msg(jpl.stage_cuts, n, p)
    for m in (1, 2, 4, 8):
        assert tpl.analytic_bubble_frac(p, m) == jpl.analytic_bubble_frac(p, m)


def _jmesh(shape):
    if len(shape) == 2:
        return make_train_mesh(JMeshConfig(data=shape[0], model=shape[1]),
                               devices=jax.devices()[:shape[0] * shape[1]])
    d, f, t, c = shape
    return make_mesh(JMeshConfig(data=d, fsdp=f, tensor=t, context=c),
                     devices=jax.devices()[:d * f * t * c])


@pytest.mark.parametrize("shape,stages,kw", [
    ((2, 2), 2, dict(microbatches=3)), ((2, 2), 2, dict(accum_steps=4)),
    ((2, 2), 2, {}), ((1, 4), 4, {}), ((2, 2), 4, {}),
    ((2, 2), 2, dict(cp_axis_name="model")), ((2, 2), 2, dict(microbatches=-1)),
    ((1, 1, 2, 2), 2, dict(microbatches=2, cp_axis_name="context")),
    ((2, 1, 2, 1), 2, {}), ((2, 1, 1, 2), 2, {})])
def test_make_plan_matches_jax(shape, stages, kw):
    mesh = _jmesh(shape)
    try:
        want = jpl.make_plan(mesh, stages, **kw)
    except ValueError as e:
        assert _msg(tpl.make_plan, shape, stages, **kw) == str(e)
        return
    got = tpl.make_plan(shape, stages, **kw)
    assert (got.stages, got.microbatches, got.axis, got.cp_axis) == (
        want.stages, want.microbatches, want.axis, want.cp_axis)
    assert got.covers(4) == want.covers(4) and got.covers(3) == want.covers(3)


class _Leaf(torch.nn.Module):
    def __init__(self, name, shape, dtype=torch.float32):
        super().__init__()
        self.register_parameter(name, torch.nn.Parameter(torch.zeros(shape, dtype=dtype)))


def test_homogeneity_checks_match_jax():
    cases = [
        ([("w", (4, 4)), ("w", (4, 8))], [{"w": jnp.zeros((4, 4))}, {"w": jnp.zeros((4, 8))}]),
        ([("w", (4, 4)), ("v", (4, 4))], [{"w": jnp.zeros((4, 4))}, {"v": jnp.zeros((4, 4))}]),
        ([("w", (4,)), ("w", (4,), torch.bfloat16)],
         [{"w": jnp.zeros((4,))}, {"w": jnp.zeros((4,), jnp.bfloat16)}]),
    ]
    for port, ref in cases:
        blocks = [_Leaf(*c) for c in port]
        assert (_msg(tpl.validate_homogeneous_blocks, blocks)
                == _msg(jpl.validate_homogeneous_blocks, ref))
    assert _msg(tpl.validate_homogeneous_blocks, []) == _msg(
        jpl.validate_homogeneous_blocks, [])
    tpl.validate_homogeneous_blocks([_Leaf("w", (2, 2)), _Leaf("w", (2, 2))])


def test_stage_tag_matches_jax():
    # one JAX process holds every device of the mesh; a port process is one rank
    for shape in ((2, 2), (4, 1), (1, 4)):
        assert tpl.stage_tag(shape, range(4)) == jpl.stage_tag(_jmesh(shape))
    assert [tpl.stage_tag((2, 2), [r]) for r in range(4)] == ["0/2", "1/2", "0/2", "1/2"]
    assert tpl.stage_tag((1, 1, 2, 2), [3]) == "1/2"
    assert tpl.stage_tag((1, 1, 2, 2), [3], axis="context") == "1/2"


# --- the gloo groups ----------------------------------------------------------


def _spec(d, name, seed):
    rng = np.random.default_rng(seed)
    video = rng.standard_normal((GLOBAL_BATCH, FRAMES, CROP, CROP, 3)).astype(np.float32)
    label = rng.integers(0, NUM_CLASSES, GLOBAL_BATCH).astype(np.int32)
    keep, masked = tube_mask_indices(torch.Generator().manual_seed(7), GLOBAL_BATCH,
                                     2, 4, 4, 0.9)
    np.savez(d / f"{name}.npz", num_classes=NUM_CLASSES, video=video, label=label,
             keep=keep.numpy(), masked=masked.numpy(),
             ct=rng.standard_normal((GLOBAL_BATCH, NUM_CLASSES)).astype(np.float32),
             **{f"w/{k}": v for k, v in _seeded_flat(name).items()})
    return {"video": video, "label": label, "keep": keep.numpy(), "masked": masked.numpy()}


CASES = [
    # world 2, (1, 2)
    {"tag": "blocks_12", "kind": "blocks", "world": 2, "model": 2},
    {"tag": "blocks_12_control", "kind": "blocks", "world": 2, "model": 2, "control": True},
    {"tag": "blocks_12_remat", "kind": "blocks", "world": 2, "model": 2, "remat": True},
    {"tag": "fold", "kind": "fold", "world": 2, "model": 2, "name": "videomae_t"},
    {"tag": "mvit", "kind": "mvit", "world": 2, "model": 2},
    {"tag": "guard", "kind": "step", "world": 2, "model": 2, "name": "videomae_t_pretrain",
     "nan": True},
    {"tag": "trainer", "kind": "trainer", "world": 2, "model": 2, "argv": PIPE_ARGV},
    {"tag": "trainer_control", "kind": "trainer", "world": 2, "model": 2, "argv": PIPE_ARGV,
     "control": True},
    # world 4, (2, 2) and the library mesh (1, 1, 2, 2)
    {"tag": "blocks_22", "kind": "blocks", "world": 4, "model": 2},
    {"tag": "step_pretrain", "kind": "step", "world": 4, "model": 2,
     "name": "videomae_t_pretrain"},
    {"tag": "step_supervised", "kind": "step", "world": 4, "model": 2, "name": "videomae_t"},
    {"tag": "library", "kind": "library", "world": 4, "library": [1, 1, 2, 2],
     "name": "videomae_t"},
]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The world-2 and world-4 groups over one spec directory, then the
    (1, 1) restore of the world-2 Trainer's checkpoint."""
    d = tmp_path_factory.mktemp("pipeline")
    data = {n: _spec(d, n, 11) for n in ("videomae_t", "videomae_t_pretrain")}
    rng = np.random.default_rng(5)
    np.savez(d / "blocks.npz", x=rng.standard_normal((4, 32, 32)).astype(np.float32),
             ct=rng.standard_normal((4, 32, 32)).astype(np.float32))
    np.savez(d / "mvit_u.npz", x=rng.standard_normal((4, 4, 16, 16, 3)).astype(np.float32),
             ct=rng.standard_normal((4, 4)).astype(np.float32))
    with open(d / "pipeline.json", "w") as f:
        json.dump({"optim": OPT, "cases": CASES}, f)
    two = run_group("pipeline", d, world=2, timeout_s=240)
    four = run_group("pipeline", d, world=4, timeout_s=240)
    with open(d / "ckpt.txt", "w") as f:
        f.write(two[0]["trainer"]["ckpt"])
    (one_one,) = run_group("pipeline_restore", d, world=1, timeout_s=120)
    return d, data, two, four, one_one


def _within(got: dict, want: dict, rel: float) -> list:
    """The leaves of `want` whose max abs difference from `got` exceeds
    rel * (1 + max|want|)."""
    fails = []
    for k, w in want.items():
        diff = float(np.abs(got[k] - w).max())
        if diff > rel * (1 + float(np.abs(w).max())):
            fails.append((k, diff))
    return fails


def _stage_groups_agree(ranks, tag):
    """Every stage group's ranks made the same collectives over it."""
    by_group = {}
    for r, out in enumerate(ranks):
        for (name, members), n in out[tag]["counts"].items():
            if r in members:
                by_group.setdefault((name, members), {})[r] = n
    assert by_group, tag
    for (name, members), per_rank in by_group.items():
        assert set(per_rank) == set(members) and len(set(per_rank.values())) == 1, (
            tag, name, members, per_rank)


# --- (b), (i): pipeline_blocks against the blocks in sequence ------------------


def _sequential(d, data):
    """Output and input gradient of the blocks in sequence on the whole
    batch, and their gradients as the mean over the `data` shards of each
    shard's (the step's reduction)."""
    spec = np.load(d / "blocks.npz")
    b = spec["x"].shape[0] // data
    ys, dxs, shards = [], [], []
    for di in range(data):
        enc = _port_model("videomae_t").encoder
        x = torch.from_numpy(spec["x"][di * b:(di + 1) * b]).requires_grad_()
        y = x
        for block in enc.blocks():
            y = block(y)
        (y * torch.from_numpy(spec["ct"][di * b:(di + 1) * b])).sum().backward()
        ys.append(y.detach().numpy())
        dxs.append(x.grad.numpy())
        shards.append({n: p.grad.numpy().copy() for n, p in enc.named_parameters()
                       if n.startswith("block")})
    grads = {k: np.mean([s[k] for s in shards], axis=0) for k in shards[0]}
    return np.concatenate(ys), np.concatenate(dxs), grads


def _blocks_failures(ranks, tag, data, model, d) -> list:
    y, dx, grads = _sequential(d, data)
    b = y.shape[0] // data
    fails = []
    for r, out in enumerate(ranks):
        got = out[tag]
        rows = slice(r // model * b, (r // model + 1) * b)
        if float(np.abs(got["y"] - y[rows]).max()) > 1e-5:
            fails.append((r, "y"))
        fails += [(r, k) for k in _within({"dx": got["dx"]}, {"dx": dx[rows]}, 1e-5)]
        fails += [(r, k) for k in _within(got["grads"], grads, 1e-5)]
    return fails


@pytest.mark.parametrize("mesh", ["12", "22", "12_remat"])
def test_pipeline_blocks_match_sequential(groups, mesh):
    """(b); `12_remat`: each block under its own remat inside the stage."""
    d, _, two, four, _ = groups
    ranks, data = (four, 2) if mesh == "22" else (two, 1)
    tag = f"blocks_{mesh}"
    assert _blocks_failures(ranks, tag, data, 2, d) == []
    _stage_groups_agree(ranks, tag)
    # each stage hands M = 2 microbatches on, one way and back
    t0, t1 = ranks[0][tag]["transfers"], ranks[1][tag]["transfers"]
    assert (t0["sends"], t0["recvs"], t1["sends"], t1["recvs"]) == (2, 2, 2, 2)
    assert t0["broadcasts"] == t1["broadcasts"] == 2  # the output, the input's gradient


def test_pipeline_batch_check_matches_jax():
    """The batch check of `pipeline_blocks` needs no rank: it runs before
    any transfer, and the one-rank grid is (1, 1) (whose stage count 1
    cannot differ from the plan's when the plan is made on the grid)."""
    plan = tpl.make_plan((1, 1), 1, microbatches=4)
    blocks = [_Leaf("w", (4, 4)) for _ in range(2)]
    jplan = jpl.make_plan(_jmesh((1, 1)), 1, microbatches=4)
    want = _msg(lambda: jax.eval_shape(lambda: jpl.pipeline_blocks(
        lambda p, h: h, [{"w": jnp.zeros((4, 4))}] * 2, jnp.zeros((6, 3, 4)), jplan)))
    assert _msg(tpl.pipeline_blocks, blocks, torch.zeros(6, 3, 4), plan) == want


def test_control_without_the_stage_sum_fails_blocks(groups):
    d, _, two, _, _ = groups
    fails = _blocks_failures(two, "blocks_12_control", 1, 2, d)
    assert fails and all(k[1][0].startswith("block") for k in fails)


# --- (c): one step at (2, 2) against the JAX pipelined step --------------------


_JAX_STEPS = {}


def _jax_step(name, data, monkeypatch):
    if name in _JAX_STEPS:
        return _JAX_STEPS[name]
    monkeypatch.setattr(jvideomae, "tube_mask_indices",
                        lambda *a, **k: (jnp.asarray(data["keep"]),
                                         jnp.asarray(data["masked"])))
    mesh = _jmesh((2, 2))
    plan = jpl.make_plan(mesh, 2, microbatches=2)
    cfg = JModelConfig(name=name, num_classes=NUM_CLASSES, dropout_rate=0.0)
    jm = jmodels.create_model(cfg, "fp32", mesh=mesh, pipeline=plan)
    plain = jmodels.create_model(cfg, "fp32")
    params = jax.tree.map(jnp.asarray, unflatten_tree(_seeded_flat(name))["params"])
    video, label = jnp.asarray(data["video"]), jnp.asarray(data["label"])
    pretrain = name.endswith("_pretrain")

    def loss_of(p):
        if pretrain:
            return plain.apply({"params": p}, video, rngs={"mask": jax.random.key(0)})["loss"]
        return jsteps._loss_and_metrics(plain.apply({"params": p}, video), label,
                                        jnp.ones(label.shape[0]), 0.0)[0]

    grads = jax.jit(jax.grad(loss_of))(params)
    jcfg = JOptimConfig(**OPT)
    tx = joptim.build_optimizer(jcfg, 4)
    make = jsteps.make_pretrain_step if pretrain else jsteps.make_train_step
    step = make(jm, tx, mesh, lr_schedule=joptim.build_lr_schedule(jcfg, 4), pipeline=plan)
    state = shard_state(mesh, JState.create(params, {}, tx), tp=False)
    batch = {"video": data["video"]} if pretrain else {"video": data["video"],
                                                       "label": data["label"]}
    state, metrics = step(state, shard_batch(mesh, batch), jax.random.key(0))
    _JAX_STEPS[name] = ({k: float(v) for k, v in metrics.items()},
                        state_dict_from_jax({"params": jax.device_get(grads)}),
                        state_dict_from_jax({"params": jax.device_get(state.params)}))
    return _JAX_STEPS[name]


@pytest.mark.parametrize("name", ["videomae_t_pretrain", "videomae_t"])
def test_step_matches_the_jax_pipelined_step(groups, name, monkeypatch):
    _, data, _, four, _ = groups
    tag = "step_pretrain" if name.endswith("_pretrain") else "step_supervised"
    metrics, want_g, want_s = _jax_step(name, data[name], monkeypatch)
    got = four[0][tag]
    assert abs(got["loss"] - metrics["loss"]) <= 1e-5
    assert _within(got["grads"], want_g, 1e-2) == []
    assert [k for k, w in want_s.items() if float(np.abs(got["state"][k] - w).max()) > 2e-5] == []
    np.testing.assert_allclose(got["grad_norm"], metrics["grad_norm"], rtol=1e-4)
    for out in four[1:]:  # every rank the same step, bit for bit
        assert out[tag]["loss"] == got["loss"]
        for k, v in out[tag]["state"].items():
            np.testing.assert_array_equal(v, got["state"][k], err_msg=k)
    _stage_groups_agree(four, tag)


# --- (d), (e), (f), (g) ---------------------------------------------------------


def test_fold_matches_plain_accumulation(groups):
    _, _, two, _, _ = groups
    for out in two:
        got = out["fold"]
        assert got["pipelined"]["loss"] == got["plain"]["loss"]
        for k, v in got["plain"]["state"].items():
            assert float(np.abs(got["pipelined"]["state"][k] - v).max()) < 1e-6, k


def test_uniform_mvit_pipelined_matches_plain(groups):
    _, _, two, _, _ = groups
    for out in two:
        got = out["mvit"]
        assert float(np.abs(got["pipelined"]["y"] - got["plain"]["y"]).max()) < 1e-5
        assert _within({"dx": got["pipelined"]["dx"]}, {"dx": got["plain"]["dx"]}, 1e-5) == []
        assert _within(got["pipelined"]["grads"], got["plain"]["grads"], 1e-5) == []


@pytest.mark.parametrize("kw,port_kw", [
    (dict(stage_starts=(1, 3)), dict(stage_starts=(1, 3))),
    (dict(stage_starts=(), drop_path_rate=0.2), dict(stage_starts=(), drop_path_rate=0.2)),
    (dict(stage_starts=(), drop_path_rate=0.0, attention_backend="ring"),
     dict(stage_starts=(), drop_path_rate=0.0, attention_backend="ring")),
    (dict(stage_starts=(), drop_path_rate=0.0, depth=3), dict(stage_starts=(),
                                                             drop_path_rate=0.0, depth=3)),
])
def test_mvit_cut_check_refuses_in_the_jax_text(kw, port_kw):
    jplan = jpl.make_plan(_jmesh((2, 2)), 2, microbatches=2)
    base = dict(embed_dim=16, num_heads=2, dropout_rate=0.0)
    jm = JMViT(num_classes=4, pipeline=jplan, **{"depth": 4, **base, **kw})
    want = _msg(jm.init, jax.random.key(0), jnp.zeros((1, 4, 16, 16, 3)))
    port = MViT(4, input_grid=(4, 16, 16), **{"depth": 4, **base, **port_kw})
    assert _msg(port.set_pipeline, tpl.make_plan((2, 2), 2, microbatches=2)) == want


def test_conv_family_refuses_in_the_jax_text():
    jplan = jpl.make_plan(_jmesh((2, 2)), 2)
    want = _msg(jmodels.create_model, JModelConfig(name="slowfast_t", num_classes=4), "fp32",
                pipeline=jplan)
    assert _msg(tmodels.create_model, ModelConfig(name="slowfast_t", num_classes=4), "fp32",
                pipeline=tpl.make_plan((2, 2), 2)) == want
    # a P = 1 plan is no pipeline: every family takes it
    tmodels.create_model(ModelConfig(name="slowfast_t", num_classes=4), "fp32",
                         pipeline=tpl.make_plan((2, 1), 1))


def test_masked_trunk_refuses_in_the_jax_text():
    """A band mask does not pipeline: the JAX error, raised where the
    stack would be cut (the JAX package's at apply, after init)."""
    cfg = dict(name="videomae_t", num_classes=4, attn_mask="causal")
    x = np.zeros((2, FRAMES, CROP, CROP, 3), np.float32)
    jplan = jpl.make_plan(_jmesh((1, 2)), 2, microbatches=2)
    jm = jmodels.create_model(JModelConfig(**cfg), "fp32", pipeline=jplan)
    v = jmodels.create_model(JModelConfig(**cfg), "fp32").init(jax.random.key(0), x)
    want = _msg(jm.apply, v, x)
    model = tmodels.create_model(ModelConfig(**cfg), "fp32",
                                 pipeline=tpl.make_plan((1, 2), 2, microbatches=2))
    assert _msg(model, torch.from_numpy(x)) == want


def test_pipeline_with_fsdp_is_refused():
    argv = ["--cpu", "--synthetic", "--model.name", "videomae_t", "--num_frames", "4",
            "--data.crop_size", "32", "--batch_size", "2",
            "--parallel.pipeline_stages", "2", "--mesh.fsdp", "2"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(parse_cli(argv))


def test_cp_over_context_composes_with_stages_over_tensor(groups):
    _, _, _, four, _ = groups
    for out in four:
        got = out["library"]
        assert float(np.abs(got["ring_pipelined"]["y"] - got["dense"]["y"]).max()) < 1e-5
        assert _within(got["ring_pipelined"]["grads"], got["dense"]["grads"], 1e-5) == []


def test_guard_skip_keeps_every_leaf_on_every_stage(groups):
    _, _, two, _, _ = groups
    for out in two:
        got = out["guard"]
        assert got["skipped"] == 1.0
        for k, v in got["before"].items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        assert all(not np.any(v) for v in got["opt"].values())


# --- (h), (i): the Trainer, its checkpoint, the control -----------------------


@pytest.fixture(scope="module")
def one_process(groups):
    """The unpipelined fit of the same argv in this process (no group), and
    the state restored from the pipelined run's checkpoint."""
    d = groups[0]
    result, seen, state = _fit(_ma_argv(str(d), "one", TRAINER_ARGV))
    t = Trainer(parse_cli(_ma_argv(str(d), "restore1", TRAINER_ARGV)))
    ckpt = groups[2][0]["trainer"]["ckpt"]
    Checkpointer(os.path.dirname(ckpt)).restore(t.state, step=int(os.path.basename(ckpt)))
    restored = {k: v.numpy().copy() for k, v in t.state.state_dict()["model"].items()}
    t.close()
    return seen, state, restored


def _trainer_failures(two, tag, one) -> list:
    seen, state, _ = one
    got = two[0][tag]
    fails = [("loss", a[1], b[1]) for a, b in zip(got["seen"], seen)
             if abs(a[1] - b[1]) > 1e-5]
    fails += [(k,) for k, v in state.items()
              if float(np.abs(got["full"][k] - v).max()) > 2e-5]
    return fails


def test_trainer_pipelined_checkpoint_restores_bitwise(groups, one_process):
    _, _, two, _, one_one = groups
    r0, r1 = two[0]["trainer"], two[1]["trainer"]
    assert r0["mode"] == "pipelined (2 stages, 4 microbatches)"
    assert len(r0["states"]) == len(one_process[0]) == 2
    for a, b in zip(r0["states"], r1["states"]):  # the stage ranks, every step
        for k, v in a.items():
            np.testing.assert_array_equal(v, b[k], err_msg=k)
    assert [s[1] for s in r0["seen"]] == [s[1] for s in r1["seen"]]
    assert _trainer_failures(two, "trainer", one_process) == []
    for restored in (one_process[2], one_one):
        for k, v in r0["full"].items():
            np.testing.assert_array_equal(restored[k], v, err_msg=k)
    res = r0["result"]
    assert (res["pipeline_stages"], res["pipeline_microbatches"]) == (2, 4)
    assert res["pipeline_bubble_frac_analytic"] == 0.2
    assert res["pipeline_cps_per_chip"] == pytest.approx(res["clips_per_sec"] / 2)


def test_control_without_the_stage_sum_fails_the_trainer(groups, one_process):
    _, _, two, _, _ = groups
    assert _trainer_failures(two, "trainer_control", one_process)
