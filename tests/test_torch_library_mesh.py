"""The library mesh in the port (FSDP parameter and optimizer-state sharding
over data x fsdp, tensor x context composed on their own axes) against
the JAX package, on the CPU in float32.

Ranks run as gloo processes spawned by `tests/_torch_dp_worker.py`
(scenario `library`); the JAX side runs on the conftest's CPU devices on
the same `make_mesh` layout, its params and BN statistics placed by
`shard_params`, its step's state by `shard_state`. Weights are the seeded
twins (`slowfast_t` of `tests/test_torch_train.py`, `mvit_t` and
`videomae_t` of `tests/test_torch_mvit_videomae.py`). Held:

- (i) the port's fsdp rule (`sharding.param_dims`, `fsdp_plan`), with and
  without tensor 2, against JAX `param_sharding` on every params and
  batch_stats leaf of slowfast_t, mvit_t, videomae_t and the full-size
  slowfast_r50, mvit_b and videomae_b trees (shapes only), at fsdp 2 and 4;
  each flax dim mapped to its torch dim (on the twins: the same elements
  land in each chunk); params a rank at fsdp 2 equal the JAX rule's
  (SlowFast-R50, 700 classes: 18,083,972);
- (ii) `resolve_mesh_shape`, and the "pick one layout" error, against the
  JAX package's on a grid of shapes and bad configs;
- (iii) shard -> gather bitwise at fsdp 2 and 4, composed with tensor 2;
- (iv) one SGD step of slowfast_t (accumulation 2, a global batch of 8) at
  (1,2,1,1) and at (2,2,1,1) against the JAX step on the same mesh: loss
  atol 1e-5, each gathered gradient leaf within 1e-2 * (1 + max|g|) of
  `jax.grad`'s, params and BN averages atol 2e-5 (the bounds of
  `tests/test_torch_dp_train.py`); replicated leaves bitwise across the
  ranks; parameters and momentum a rank exactly the JAX rule's, and no
  gathered leaf left set after the step; the control with the sum of the
  gather's reduce-scatter patched out fails those bounds. The step runs
  with `min_size` 0 (`tests/test_mesh_composition.py`'s), so the tiny
  twins shard every divisible leaf, the BN scales among them;
- (v) videomae_t at (1,2,2,1) (fsdp x tensor) and at (1,1,2,2) with ring
  and with ulysses (tensor x context), against the JAX step on the same
  mesh, as (iv);
- (v) also videomae_t at (1,2,2,1) under `--model.remat` (the recompute
  gathers again), and `run.main`'s Trainer at (1,1,2,2): its first batch
  byte-equal on the four ranks and to one process's;
- (vi) `Trainer.fit` of slowfast_t at (1,2,1,1) (SGD, EMA, the guard, a
  checkpoint every step; the default min_size shards its 4 largest
  leaves): the last checkpoint restored in one process bitwise (params,
  momentum, EMA) and the guard's last LKG bitwise it, and that process's
  export equal to the (1,2,1,1) run's; a (1,1) checkpoint of
  step 3 resumed at (1,2,1,1) (the same global batch of 4: `--batch_size`
  is a shard's): the restored state bitwise the file, the continued losses
  bitwise those of plain data parallelism at world 2 resuming the same
  file, and the unbroken (1,1) run's at rtol 1e-6 for the first step and
  1e-5 for all 5 (two batch shards sum in another f32 order than one);
- (vii) what stays refused: pipeline stages against a tensor axis of 1
  (the JAX package's "must equal the mesh's"), the dataplane, the process
  transport.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_mvit_videomae as tmv
import test_torch_train as ttrain
from _torch_dp_worker import _GRAD_NORMS, _fit, _ma_argv, run_group
from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.config import MeshConfig as JMeshConfig
from pytorchvideo_accelerate_tpu.config import ModelConfig as JModelConfig
from pytorchvideo_accelerate_tpu.config import OptimConfig as JOptimConfig
from pytorchvideo_accelerate_tpu.parallel import mesh as jmesh
from pytorchvideo_accelerate_tpu.parallel import sharding as jsharding
from pytorchvideo_accelerate_tpu.trainer import optim as joptim
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState as JState
from pytorchvideo_accelerate_tpu_torch import models as tmodels
from pytorchvideo_accelerate_tpu_torch.config import (
    DataConfig,
    MeshConfig,
    ModelConfig,
    parse_cli,
)
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    _kernel_layout,
    flatten_tree,
    state_dict_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.parallel import mesh as tmesh
from pytorchvideo_accelerate_tpu_torch.parallel import sharding as tsharding
from pytorchvideo_accelerate_tpu_torch.parallel import tensor_parallel as ttp
from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

NUM_CLASSES = 5
OPT = dict(lr=0.05, momentum=0.9, weight_decay=1e-3, schedule="cosine",
           warmup_steps=1)
# name: (frames, crop, num_classes); the twins at their tests' geometry
TREES = {"slowfast_t": (4, 32, NUM_CLASSES), "mvit_t": (4, 32, NUM_CLASSES),
         "videomae_t": (4, 32, NUM_CLASSES), "slowfast_r50": (32, 256, 700),
         "mvit_b": (16, 224, 700), "videomae_b": (16, 224, 700)}
# params a rank at fsdp 2 by the JAX rule (700-class heads)
PER_RANK_F2 = {"slowfast_r50": 18_083_972, "mvit_b": 19_951_996,
               "videomae_b": 43_448_764}


# --- (i) the rule, (ii) the shape, (iii) shard and gather ----------------------


_TREE_CACHE = {}


def _jax_tree(name):
    """{"params": ..., "batch_stats": ...} of the JAX model as zero-stride
    numpy leaves (eval_shape: no compute, no memory)."""
    if name not in _TREE_CACHE:
        frames, crop, nc = TREES[name]
        jm = jmodels.create_model(JModelConfig(name=name, num_classes=nc), "fp32")
        key = jax.random.PRNGKey(0)
        if name.startswith("slowfast"):
            spec = (jax.ShapeDtypeStruct((1, frames // 4, crop, crop, 3), jnp.float32),
                    jax.ShapeDtypeStruct((1, frames, crop, crop, 3), jnp.float32))
            tree = jax.eval_shape(lambda x: jm.init(key, x, train=False), spec)
        else:
            spec = jax.ShapeDtypeStruct((1, frames, crop, crop, 3), jnp.float32)
            tree = jax.eval_shape(lambda x: jm.init({"params": key, "mask": key}, x), spec)
        _TREE_CACHE[name] = jax.tree.map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), dict(tree))
    return _TREE_CACHE[name]


def _port_model(name, device="cpu"):
    frames, crop, nc = TREES[name]
    with torch.device(device):
        return tmodels.create_model(ModelConfig(name=name, num_classes=nc), "fp32",
                                    data_cfg=DataConfig(num_frames=frames, crop_size=crop))


@pytest.mark.parametrize("name", sorted(TREES))
def test_fsdp_rule_matches_jax_param_sharding_on_every_leaf(name):
    tree = _jax_tree(name)
    tp = ttp.family_uses_tp(name)
    tiny = not name.endswith(("_r50", "_b"))
    model = _port_model(name, "cpu" if tiny else "meta")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    for fsdp in (2, 4):
        for tensor in (1, 2):
            mesh = jmesh.make_mesh(JMeshConfig(data=1, fsdp=fsdp, tensor=tensor),
                                   devices=jax.devices()[:fsdp * tensor])
            want = {}
            for col in ("params", "batch_stats"):
                shard = jsharding.param_sharding(mesh, tree.get(col, {}), tp=tp)
                for k, s in flatten_tree({col: shard}).items():
                    want[k] = s.spec
            t_size = tensor if tp else 1
            plan = tsharding.fsdp_plan(
                {k: v for k, v in shapes.items() if k in params}, fsdp, t_size)
            seen = 0
            for key, shape in shapes.items():
                names, fshape = tsharding.flax_names(key, shape)
                flat = tsharding.flax_key(key, len(shape))
                td, fd = tsharding.param_dims(names, fshape, t_size, fsdp)
                spec = [None] * len(fshape)
                if td is not None:
                    spec[td] = "tensor"
                if fd is not None:
                    spec[fd] = "fsdp"
                got = tuple(want[flat]) + (None,) * (len(fshape) - len(want[flat]))
                assert tuple(spec) == got, (key, fsdp, tensor, spec, got)
                if key in params:
                    assert plan.get(key) == (None if fd is None else tsharding._torch_dim(
                        fd, len(shape), names[-1] == "kernel")), key
                    if fd is not None:
                        assert shape[plan[key]] == fshape[fd], key
                seen += 1
            assert seen == len(want), (seen, len(want))
            if tensor == 1 and tiny and plan:
                _hold_chunks_cross_layouts(model, plan, fsdp)
            if fsdp == 2 and tensor == 1 and name in PER_RANK_F2:
                local = sum(v.numel() // fsdp if k in plan else v.numel()
                            for k, v in params.items())
                assert local == PER_RANK_F2[name], (name, local)


def _hold_chunks_cross_layouts(model, plan, fsdp):
    """Each fsdp chunk of a torch leaf holds the elements of the flax
    leaf's chunk of the mapped dim (values = element indices)."""
    for key, dim in plan.items():
        t = torch.arange(model.state_dict()[key].numel(), dtype=torch.float64)
        t = t.reshape(model.state_dict()[key].shape)
        names, fshape = tsharding.flax_names(key, tuple(t.shape))
        kernel = names[-1] == "kernel"
        fd = [d for d in range(len(fshape))
              if tsharding._torch_dim(d, t.dim(), kernel) == dim][0]
        f = _kernel_layout(t.numpy()) if kernel else t.numpy()
        for i in range(fsdp):
            tc = tsharding.shard_tensor(t, i, fsdp, dim, 1).numpy()
            fc = np.split(f, fsdp, axis=fd)[i]
            assert sorted(tc.ravel()) == sorted(fc.ravel()), (key, i)


_SHAPE_CASES = [
    dict(), dict(fsdp=2), dict(fsdp=4), dict(tensor=2, context=2), dict(data=2, fsdp=2),
    dict(data=2, fsdp=2, tensor=2), dict(data=3, fsdp=2), dict(fsdp=3),
    dict(fsdp=0), dict(tensor=-1), dict(data=0), dict(data=-2), dict(context=5),
    dict(data=1, fsdp=2), dict(fsdp=2, tensor=2, context=2), dict(data=8)]


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_resolve_mesh_shape_matches_jax(n):
    for kw in _SHAPE_CASES:
        try:
            want = jmesh.resolve_mesh_shape(JMeshConfig(**kw), n)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tmesh.resolve_mesh_shape(MeshConfig(**kw), n)
            assert str(got.value) == str(e), kw
            continue
        assert tmesh.resolve_mesh_shape(MeshConfig(**kw), n) == want, kw
        assert tmesh.data_shard_count(want) == want[0] * want[1]


@pytest.mark.parametrize("kw", [dict(model=2, fsdp=2), dict(model=2, tensor=2),
                                dict(model=4, context=2, data=1)])
def test_model_with_a_legacy_axis_raises_the_jax_error(kw):
    with pytest.raises(ValueError) as want:
        jmesh.make_train_mesh(JMeshConfig(**kw), devices=jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        tmesh.resolve_layout(MeshConfig(**kw), 8)
    assert str(got.value) == str(want.value)
    assert "pick one layout" in str(got.value)


def test_layout_axes_and_mesh_line():
    lib = tmesh.resolve_layout(MeshConfig(fsdp=2, tensor=2), 8)
    two = tmesh.resolve_layout(MeshConfig(model=2), 8)
    assert lib == (2, 2, 2, 1) and two == (4, 2)
    assert tmesh.batch_axes(lib) == ("data", "fsdp") and tmesh.batch_axes(two) == ("data",)
    assert (tmesh.model_axis(lib), tmesh.cp_axis(lib)) == ("tensor", "context")
    assert (tmesh.model_axis(two), tmesh.cp_axis(two)) == ("model", "model")
    assert tmesh.data_shard_count(lib) == 4 and tmesh.data_shard_count(two) == 4
    assert tmesh.mesh_line(lib, "cpu", "tensor-parallel") == (
        "mesh: {'data': 2, 'fsdp': 2, 'tensor': 2, 'context': 1} over 8 cpu "
        "devices, 8 process(es); model axis (2): tensor-parallel")
    assert tmesh.mesh_line((1, 2, 1, 1), "cpu", "replicated") == (
        "mesh: {'data': 1, 'fsdp': 2, 'tensor': 1, 'context': 1} over 2 cpu "
        "devices, 2 process(es)")


def test_library_ranks_are_row_major():
    from pytorchvideo_accelerate_tpu_torch.parallel import distributed as pdist

    shape = (2, 2, 2, 1)
    groups = pdist.library_ranks(shape)
    assert groups["batch"] == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert groups["fsdp"] == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert groups["data"] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert groups["tensor"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert groups["context"] == [[r] for r in range(8)]
    assert pdist.library_coords(6, shape) == (1, 1, 0, 0)
    # the JAX device grid of the same shape, on the conftest's devices
    mesh = jmesh.make_mesh(JMeshConfig(data=2, fsdp=2, tensor=2), devices=jax.devices()[:8])
    ids = np.vectorize(lambda dev: dev.id)(mesh.devices)
    for r in range(8):
        assert ids[pdist.library_coords(r, shape)] == r


@pytest.mark.parametrize("fsdp", [2, 4])
@pytest.mark.parametrize("which,tensor", [("slowfast_t", 1), ("videomae_t", 2),
                                          ("mvit_staged", 2)])
def test_shard_then_gather_is_bitwise(which, tensor, fsdp):
    def build():
        if which == "mvit_staged":
            model = tmv.MViT(NUM_CLASSES, input_grid=(4, 32, 32), **tmv.STAGED)
            tmodels.init_like_jax(model, torch.Generator().manual_seed(0))
            return model
        return _port_model(which)

    name = "mvit_b" if which == "mvit_staged" else which
    full = build().state_dict()
    shards = {}
    for t in range(tensor):
        for f in range(fsdp):
            model = build()
            axis = ttp.layout(name, "pallas", tensor, t, library=True, fsdp_count=fsdp,
                              fsdp_index=f, fsdp_min_size=0)
            ttp.apply_model_axis(model, axis)
            assert axis.fsdp_plan and (axis.plan or tensor == 1)
            sd = model.state_dict()
            want = tsharding.local_state_dict(full, axis)
            assert sorted(sd) == sorted(want)
            for k in sd:
                assert torch.equal(sd[k], want[k]), k
            shards[t, f] = (sd, axis)
    _, axis = shards[0, 0]
    for k, v in full.items():
        per_t = []
        for t in range(tensor):
            parts = [shards[t, f][0][k] for f in range(fsdp)]
            per_t.append(torch.cat(parts, axis.fsdp_plan[k]) if k in axis.fsdp_plan
                         else parts[0])
        got = (tsharding.join_shards(per_t, *axis.plan[k]) if k in axis.plan
               else per_t[0])
        assert torch.equal(got, v), k
    if tensor > 1:  # a leaf split over both axes, on different dims
        both = [k for k in axis.plan if k in axis.fsdp_plan]
        assert both and all(axis.plan[k][0] != axis.fsdp_plan[k] for k in both)


# --- (iv), (v): one step against the JAX step on the same mesh -----------------


def _write_spec(d, name, batch, accum, seed):
    """The global batch and the seeded twin's flax leaves of one case."""
    if name == "slowfast_t":
        clips = ttrain._clips(name, batch, seed, lead=(accum,) if accum > 1 else ())
        label = ttrain._labels(batch, seed, lead=(accum,) if accum > 1 else ())
        flat = ttrain._seeded_flat(name)
    else:
        rng = np.random.default_rng(seed)
        clips = {"video": rng.standard_normal((batch, 4, 32, 32, 3)).astype(np.float32)}
        label = rng.integers(0, NUM_CLASSES, batch).astype(np.int32)
        flat = tmv._seeded_flat(name)
    np.savez(d / f"{name}.npz", num_classes=NUM_CLASSES, accum=accum, label=label,
             **clips, **{f"w/{k}": v for k, v in flat.items()})
    return clips, label, flat


CASES_2 = [  # world 2
    {"tag": "slowfast_f2", "name": "slowfast_t", "shape": [1, 2, 1, 1],
     "attention": "pallas"},
    {"tag": "slowfast_f2_control", "name": "slowfast_t", "shape": [1, 2, 1, 1],
     "attention": "pallas", "control": True},
]
CASES_4 = [  # world 4
    {"tag": "slowfast_d2f2", "name": "slowfast_t", "shape": [2, 2, 1, 1],
     "attention": "pallas"},
    {"tag": "videomae_f2t2", "name": "videomae_t", "shape": [1, 2, 2, 1],
     "attention": "pallas"},
    {"tag": "videomae_t2c2_ring", "name": "videomae_t", "shape": [1, 1, 2, 2],
     "attention": "ring"},
    {"tag": "videomae_t2c2_ulysses", "name": "videomae_t", "shape": [1, 1, 2, 2],
     "attention": "ulysses"},
    # per-block remat: the recompute gathers the block's leaves again
    {"tag": "videomae_f2t2_remat", "name": "videomae_t", "shape": [1, 2, 2, 1],
     "attention": "pallas", "remat": True},
]
# run.main's Trainer at (1, 1, 2, 2): every rank is one batch shard's
BATCHES = ["--model.name", "videomae_t", "--batch_size", "2", "--mesh.tensor", "2",
           "--mesh.context", "2", "--model.attention", "ring"]
# the fit of (vi): SGD + EMA, a checkpoint every step; `--batch_size` is a
# batch shard's, so (1, 1) runs 4 and (1, 2, 1, 1) 2: one global batch of 4
FIT = ["--model.name", "slowfast_t", "--model.dropout_rate", "0", "--optim.lr", "0.001",
       "--optim.ema_decay", "0.9", "--checkpointing_steps", "1", "--guard.enabled",
       "--guard.lkg_every_steps", "2",
       "--data.synthetic_num_videos", "16", "--num_epochs", "2", "--batch_size", "2"]
RESUME_AT = 3


def _write_cases(d, cases, fit=False, batches=None):
    data = {}
    for c in cases:
        c["min_size"] = 0
        if c["name"] not in data:
            accum, batch = (2, 8) if c["name"] == "slowfast_t" else (1, 4)
            data[c["name"]] = _write_spec(d, c["name"], batch, accum, 11) + (accum,)
        c["spec"] = f"{c['name']}.npz"
    body = {"optim": OPT, "cases": cases}
    if fit:
        body["fit"] = FIT
    if batches:
        body["batches"] = batches
    with open(d / "library.json", "w") as f:
        json.dump(body, f)
    return data


_JAX_REFS, _JAX_GRADS = {}, {}


def _jax_reference(name, attention, shape, clips, label, flat, accum):
    key = (name, attention, tuple(shape))
    if key not in _JAX_REFS:
        _JAX_REFS[key] = _jax_reference_uncached(name, attention, shape, clips,
                                                 label, flat, accum)
    return _JAX_REFS[key]


def _jax_model(name, attention="dense", mesh=None):
    if name == "slowfast_t":
        return ttrain._jax_model(name, "xla")
    return jmodels.create_model(JModelConfig(
        name=name, num_classes=NUM_CLASSES, dropout_rate=0.0,
        attention="dense" if attention == "pallas" else attention), "fp32", mesh=mesh)


def _jax_grads(name, clips, label, flat, accum):
    """`jax.grad` of the global batch's loss (the mean over micro-steps),
    one per model: the gradient does not depend on the layout."""
    if name not in _JAX_GRADS:
        jm = _jax_model(name)
        tree = unflatten_tree(flat)
        params = jax.tree.map(jnp.asarray, tree["params"])

        def loss_of(p, x, y):
            if "batch_stats" in tree:
                logits, _ = jm.apply({"params": p, "batch_stats": tree["batch_stats"]}, x,
                                     train=True, mutable=["batch_stats"])
            else:
                logits = jm.apply({"params": p}, x)
            return jsteps._loss_and_metrics(logits, y, jnp.ones(y.shape[0]), 0.0)[0]

        grad = jax.jit(jax.grad(loss_of))
        micro = [(lambda a, i=i: a[i]) for i in range(accum)] if accum > 1 else [lambda a: a]
        total = None
        for take in micro:
            x = ((take(clips["slow"]), take(clips["fast"])) if "slow" in clips
                 else take(clips["video"]))
            g = grad(params, x, jnp.asarray(take(label)))
            total = g if total is None else jax.tree.map(jnp.add, total, g)
        grads = jax.tree.map(lambda a: a / len(micro), total)
        _JAX_GRADS[name] = state_dict_from_jax({"params": jax.device_get(grads)})
    return _JAX_GRADS[name]


def _jax_reference_uncached(name, attention, shape, clips, label, flat, accum):
    """The JAX step's metrics and new state on the (data, fsdp, tensor,
    context) mesh (min_size 0, as the ranks), and `jax.grad` of the global
    batch."""
    d, f, t, c = shape
    mesh = jmesh.make_train_mesh(JMeshConfig(data=d, fsdp=f, tensor=t, context=c),
                                 devices=jax.devices()[:d * f * t * c])
    assert tuple(mesh.axis_names) == ("data", "fsdp", "tensor", "context")
    tp = ttp.family_uses_tp(name)
    jm = _jax_model(name, attention, mesh)
    tree = unflatten_tree(flat)
    params = jax.tree.map(jnp.asarray, tree["params"])
    stats = jax.tree.map(jnp.asarray, tree.get("batch_stats", {}))
    want_g = _jax_grads(name, clips, label, flat, accum)
    jcfg = JOptimConfig(**OPT)
    tx = joptim.build_optimizer(jcfg, 4)
    jstate = JState.create(jsharding.shard_params(mesh, params, min_size=0, tp=tp),
                           jsharding.shard_params(mesh, stats, min_size=0, tp=tp), tx)
    jstate = jsharding.shard_state(mesh, jstate, min_size=0, tp=tp)
    jstep = jsteps.make_train_step(jm, tx, mesh, accum_steps=accum,
                                   lr_schedule=joptim.build_lr_schedule(jcfg, 4))
    batch = {**clips, "label": label}
    jstate, metrics = jstep(jstate, jsharding.shard_batch(mesh, batch, micro_dim=accum > 1),
                            jax.random.key(0))
    want_s = {"params": jax.device_get(jstate.params)}
    if stats:
        want_s["batch_stats"] = jax.device_get(jstate.batch_stats)
    return ({k: float(v) for k, v in metrics.items()}, want_g,
            state_dict_from_jax(want_s), _jax_per_rank(mesh, jstate))


def _jax_per_rank(mesh, jstate):
    """Elements a device holds of the params and of the SGD trace."""
    def count(tree):
        return sum(int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
                   for leaf in jax.tree.leaves(tree) if leaf.ndim)

    return count(jstate.params), count(jstate.opt_state)


def _bound_failures(out, metrics, want_g, want_s) -> list:
    fails = []
    if abs(out["loss"] - metrics["loss"]) > 1e-5:
        fails.append(("loss", out["loss"], metrics["loss"]))
    for k, w in want_g.items():
        dd = float(np.abs(out["grads"][k] - w).max())
        if dd > 1e-2 * (1 + float(np.abs(w).max())):
            fails.append((k, dd))
    for k, w in want_s.items():
        dd = float(np.abs(out["state"][k] - w).max())
        if dd > 2e-5:
            fails.append((k, dd))
    return fails


def _hold(ranks, tag, case, data):
    clips, label, flat, accum = data[case["name"]]
    metrics, want_g, want_s, (jparams, jopt) = _jax_reference(
        case["name"], case["attention"], case["shape"], clips, label, flat, accum)
    for r, out in enumerate(ranks):
        got = out[tag]
        # every rank gathers the same step
        assert got["loss"] == ranks[0][tag]["loss"], (tag, r)
        for k, v in got["state"].items():
            np.testing.assert_array_equal(v, ranks[0][tag]["state"][k], err_msg=k)
        # the shards are shards: counts a rank as the JAX rule places them,
        # and no gathered leaf left set after the step
        assert got["n_params"] == jparams, (tag, r, got["n_params"], jparams)
        assert got["opt_numel"] == jopt, (tag, r, got["opt_numel"], jopt)
        assert got["leftover"] == [], got["leftover"]
    # replicated leaves bitwise across every rank
    for out in ranks[1:]:
        for k, v in out[tag]["replicated"].items():
            np.testing.assert_array_equal(v, ranks[0][tag]["replicated"][k], err_msg=k)
    assert _bound_failures(ranks[0][tag], metrics, want_g, want_s) == [], tag
    np.testing.assert_allclose(ranks[0][tag]["grad_norm"], metrics["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(ranks[0][tag]["accuracy"], metrics["accuracy"], atol=1e-7)
    return metrics, want_g, want_s


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("library2")
    data = _write_cases(d, [dict(c) for c in CASES_2], fit=True)
    # (vi)'s unbroken (1, 1) run: its checkpoint of step RESUME_AT is what
    # the ranks resume from
    _GRAD_NORMS.clear()
    one = _fit(_ma_argv(d, "one", FIT + ["--batch_size", "4"]))
    for name in ("resume", "resume_dp"):
        os.makedirs(d / name / "checkpoints")
        shutil.copytree(d / "one" / "checkpoints" / str(RESUME_AT),
                        d / name / "checkpoints" / str(RESUME_AT))
    return d, data, one, run_group("library", d, world=2, timeout_s=300)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("library4")
    data = _write_cases(d, [dict(c) for c in CASES_4], batches=BATCHES)
    return data, run_group("library", d, world=4, timeout_s=300)


def test_fsdp_step_at_1x2_matches_the_jax_mesh_and_the_control_fails(world2):
    _, data, _, ranks = world2
    case = CASES_2[0]
    metrics, want_g, want_s = _hold(ranks, "slowfast_f2", case, data)
    got = ranks[0]["slowfast_f2"]
    # min_size 0: every leaf with a dim that 2 divides, the BN scales too
    assert any(k.endswith("norm.weight") for k in got["fsdp_plan"])
    assert got["mode"] == "replicated" and not got["plan"]
    # one gather a sharded leaf a forward: 2 micro-steps
    assert got["gathers"] == 2 * len(got["fsdp_plan"])
    control = _bound_failures(ranks[0]["slowfast_f2_control"], metrics, want_g, want_s)
    assert any(k in got["fsdp_plan"] for k, *_ in control), control


@pytest.mark.parametrize("tag", [c["tag"] for c in CASES_4])
def test_library_mesh_step_matches_the_jax_mesh(world4, tag):
    data, ranks = world4
    case = next(c for c in CASES_4 if c["tag"] == tag)
    _hold(ranks, tag, case, data)
    got = ranks[0][tag]
    d, f, t, c = case["shape"]
    assert [r[tag]["coords"] for r in ranks] == [
        (i // (f * t * c), i // (t * c) % f, i // c % t, i % c) for i in range(4)]
    if case["name"] == "videomae_t":
        assert got["mode"] == "tensor-parallel" and got["plan"]
    assert bool(got["fsdp_plan"]) == (f > 1)
    if f > 1 and t > 1:  # leaves split over both axes
        assert set(got["plan"]) & set(got["fsdp_plan"])


def test_tensor_and_context_ranks_train_on_one_batch(world4, tmp_path):
    """run.main's Trainer at (1, 1, 2, 2): the mesh line's layout, and the
    first batch byte-equal on the 4 ranks (one batch shard) and to the
    loader of one process."""
    _, ranks = world4
    got = [r["batches"] for r in ranks]
    assert all(g["shape"] == (1, 1, 2, 2) and g["mode"] == "tensor-parallel" for g in got)
    one = Trainer(parse_cli(_ma_argv(tmp_path, "one", BATCHES[:4])))
    want = {k: v.numpy() for k, v in next(iter(one.train_prefetch.epoch(0))).items()}
    one.close()
    for g in got:
        assert sorted(g["batch"]) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(g["batch"][k], want[k], err_msg=k)


# --- (vi) the Trainer: checkpoints, export, resume across layouts ------------


def test_trainer_fit_checkpoints_and_export_cross_layouts(world2):
    d, _, _, ranks = world2
    fit = ranks[0]["fit"]
    # the default min_size: slowfast_t's 4 largest leaves; a rank holds
    # its chunks, the EMA too
    assert sorted(fit["fsdp_plan"]) == sorted(
        k for k in fit["full"]["model"] if k.endswith("conv.weight")
        and fit["full"]["model"][k].numel() >= 2 ** 16)
    full_n = sum(v.numel() for k, v in fit["full"]["model"].items()
                 if not k.endswith(("running_mean", "running_var")))
    cut = sum(fit["full"]["model"][k].numel() // 2 for k in fit["fsdp_plan"])
    assert fit["n_params"] == fit["ema_numel"] == full_n - cut
    ckpt = d / "lib" / "checkpoints"
    last = Checkpointer(str(ckpt)).latest_step()
    assert last == len(fit["seen"]) == 8
    saved = torch.load(ckpt / str(last) / "state.pt", weights_only=True)
    from test_torch_model_axis import _assert_tree_equal

    for r in ranks:
        _assert_tree_equal(saved, r["fit"]["full"])
    # the guard's ring holds gathered states too: its newest is the
    # checkpoint of the same step, bit for bit
    s = max(fit["lkg"])
    _assert_tree_equal(fit["lkg"][s], torch.load(ckpt / str(s) / "state.pt",
                                                 weights_only=True))
    # restored in one process: bitwise the gathered state; exported alike
    t = Trainer(parse_cli(_ma_argv(d, "lib", FIT + ["--resume_from_checkpoint", "auto"])))
    t._maybe_resume()
    _assert_tree_equal(t.state.state_dict(), saved)
    assert saved["optimizer"]["state"] and saved["ema"]
    t.export_inference(str(d / "one_art"))
    t.close()
    with np.load(d / "lib_art" / "weights.npz") as a, \
            np.load(d / "one_art" / "weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_a_one_process_checkpoint_resumes_at_1x2(world2):
    d, _, one, ranks = world2
    _, seen_one, _ = one
    from test_torch_model_axis import _assert_tree_equal

    saved = torch.load(d / "one" / "checkpoints" / str(RESUME_AT) / "state.pt",
                       weights_only=True)
    want = [loss for _, loss, _ in seen_one[RESUME_AT:]]
    for r in ranks:
        # the (1, 1) file cut to the ranks' shards and gathered back: bitwise
        _assert_tree_equal(r["resumed"]["restored"], saved)
        resumed = r["resumed"]["seen"]
        assert [s for s, _, _ in resumed] == [s for s, _, _ in seen_one[RESUME_AT:]]
        # fsdp at (1, 2, 1, 1) is plain data parallelism at world 2 bit for
        # bit: the same gathered weights, and a reduce-scatter sum / 2 for
        # the all-reduce mean
        assert resumed == r["resumed_dp"]
        got = [loss for _, loss, _ in resumed]
        # against one process: the first step at 1e-6; then the f32
        # reduction order of two batch shards against one (the BN moments'
        # E[x^2] - E[x]^2, the gradient's sum) drifts the trajectory, as
        # plain data parallelism's, by up to ~7e-6 over 5 steps at this lr
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert ranks[0]["resumed"]["seen"] == ranks[1]["resumed"]["seen"]


# --- (vii) what stays refused -------------------------------------------------


_REFUSE = ["--cpu", "--synthetic", "--model.name", "slowfast_t", "--num_frames", "4",
           "--data.crop_size", "32", "--data.min_short_side_scale", "32",
           "--data.max_short_side_scale", "40", "--batch_size", "2",
           "--data.synthetic_num_videos", "4", "--num_workers", "1"]


@pytest.mark.parametrize("extra,err,match", [
    (["--parallel.pipeline_stages", "2"], ValueError, "must equal the mesh's"),
    (["--data.dataplane_workers", "2"], NotImplementedError, "dataplane"),
    (["--data.transport", "process"], NotImplementedError, "process"),
    (["--mesh.fsdp", "2"], ValueError, "does not divide device count 1"),
    (["--mesh.fsdp", "2", "--mesh.model", "2"], ValueError, "pick one layout"),
])
def test_what_stays_refused(extra, err, match):
    with pytest.raises(err, match=match):
        Trainer(parse_cli(_REFUSE + extra))
