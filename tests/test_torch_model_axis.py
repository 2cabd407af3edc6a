"""The train mesh's model axis in the port (tensor parallelism for MViT and
VideoMAE, ring and Ulysses context parallelism, replication of the conv
families) against the JAX package, on the CPU in float32.

Ranks run as gloo processes spawned by `tests/_torch_dp_worker.py`; the
JAX side runs on the conftest's CPU devices on the same (data, model)
train mesh (`make_train_mesh`), its params placed by `shard_params` (tensor
parallel unless the attention is ring or ulysses, which spend the axis on
tokens). Weights are the seeded twins of `tests/test_torch_mvit_videomae.py`
(mvit_t, videomae_t; 4 frames at 32x32). Held:

- (i) the port's `tp_dim` / `family_uses_tp` against the JAX package's on
  every leaf of mvit_t, videomae_t, videomae_t_pretrain and the full-size
  mvit_b / videomae_b trees (shapes only), each port key mapped to its
  flax path and kernel layout;
- (ii) shard -> gather bitwise at tp 2 and 4, a 1-head stage (MViT) and a
  decoder whose attention stays replicated (VideoMAE pretraining) among
  them;
- (iii) the forward of mvit_t and videomae_t at (1, 2) against the JAX
  forward on a (1, 2) mesh, rtol / atol 2e-5 (`tests/test_tensor_parallel.py`);
- (iv) one SGD step of mvit_t at (1, 2) and of videomae_t at (2, 2) against
  the JAX step on the same mesh: loss atol 1e-5, each gathered gradient leaf
  within 1e-2 * (1 + max|g|) of `jax.grad`'s, params atol 2e-5 (the bounds of
  `tests/test_torch_dp_train.py`); the replicated leaves bitwise equal across
  the ranks; the control with `RowDense`'s all-reduce patched out fails them;
- (v) `ring` and `ulysses` at cp 2 and 3 against the JAX wrappers (under
  `shard_map`) and against dense: output atol 1e-5, input gradients 1e-4
  (`tests/test_ring_attention.py`), ragged Nq != Nk and Ulysses's fall-back
  to ring at H % cp != 0 among the cases;
- (vi) one step of mvit_t with ring and of videomae_t with ulysses at (1, 2)
  against the JAX step, as (iv);
- (vii) slowfast_t at (1, 2), replicated, equal to world 1, its batches
  byte-equal across the model group;
- (viii) the (1, 2) <-> (1, 1) checkpoint round trip bitwise (params, adamw
  moments, EMA), the exported artifact of a (1, 2) run equal to world 1's
  export of the same state, and the clip's global norm at (1, 2) equal to
  world 1's (rtol 1e-5);
- (ix) what stays refused: pipeline stages against a model axis of 1 (the
  JAX package's "must equal the mesh's"), `--mesh.model` beside a
  legacy fsdp / tensor axis (the JAX package's "pick one layout"), ring
  or ulysses with a mask, and a model axis that does not divide the world.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dp_worker import _GRAD_NORMS, _fit, _ma_argv, run_group
from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.config import MeshConfig as JMeshConfig
from pytorchvideo_accelerate_tpu.config import ModelConfig as JModelConfig
from pytorchvideo_accelerate_tpu.config import OptimConfig as JOptimConfig
from pytorchvideo_accelerate_tpu.ops import attention as jattn
from pytorchvideo_accelerate_tpu.parallel import sharding as jsharding
from pytorchvideo_accelerate_tpu.parallel.mesh import make_mesh, make_train_mesh
from pytorchvideo_accelerate_tpu.parallel.ring_attention import make_ring_attention
from pytorchvideo_accelerate_tpu.parallel.ulysses import make_ulysses_attention
from pytorchvideo_accelerate_tpu.trainer import optim as joptim
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState as JState
from pytorchvideo_accelerate_tpu_torch import models as tmodels
from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig, parse_cli
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    state_dict_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.models.mvit import MViT
from pytorchvideo_accelerate_tpu_torch.ops import attention as tattn
from pytorchvideo_accelerate_tpu_torch.parallel import sharding as tsharding
from pytorchvideo_accelerate_tpu_torch.parallel import tensor_parallel as ttp
from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer
from test_torch_mvit_videomae import CROP, FRAMES, NUM_CLASSES, STAGED, _seeded_flat

OPT = dict(lr=0.05, momentum=0.9, weight_decay=1e-3, schedule="cosine",
           warmup_steps=1)
TRANSFORMERS = ("mvit_t", "videomae_t", "videomae_t_pretrain")


# --- (i) the rules, (ii) shard and gather ------------------------------------


def _jax_shapes(name, frames=FRAMES, crop=CROP):
    """{flax key: shape} of the JAX model's params (eval_shape, no compute)."""
    if (frames, crop) == (FRAMES, CROP):
        return {k: v.shape for k, v in _seeded_flat(name).items()}
    jm = jmodels.create_model(JModelConfig(name=name, num_classes=NUM_CLASSES), "fp32")
    spec = jax.ShapeDtypeStruct((1, frames, crop, crop, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda x: jm.init({"params": key, "mask": key}, x), spec)
    return {k: v.shape for k, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("name,frames,crop", [
    *[(n, FRAMES, CROP) for n in TRANSFORMERS],
    ("mvit_b", 16, 224), ("videomae_b", 16, 224)])
def test_tp_rules_match_jax_on_every_leaf(name, frames, crop):
    jshapes = _jax_shapes(name, frames, crop)
    model = tmodels.create_model(ModelConfig(name=name, num_classes=NUM_CLASSES),
                                 "fp32", data_cfg=DataConfig(num_frames=frames,
                                                             crop_size=crop))
    seen = 0
    for key, v in model.state_dict().items():
        names, fshape = tsharding.flax_names(key, tuple(v.shape))
        flat = "params/" + "/".join(names)
        assert jshapes[flat] == fshape, key
        for n in (1, 2, 3, 4):
            assert (tsharding.tp_dim(names, fshape, n)
                    == jsharding.tp_dim(names, jshapes[flat], n)), (key, n)
        seen += 1
    assert seen == len(jshapes)


def test_family_uses_tp_matches_jax():
    for name in tmodels.available_models():
        assert tsharding.family_uses_tp(name) == jsharding.family_uses_tp(name)


def _staged():
    model = MViT(NUM_CLASSES, input_grid=(FRAMES, CROP, CROP), **STAGED)
    tmodels.init_like_jax(model, torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("which", ["mvit_staged", "videomae_t_pretrain"])
def test_shard_then_gather_is_bitwise(which, count):
    def build():
        if which == "mvit_staged":
            return _staged()
        return tmodels.create_model(ModelConfig(name=which, num_classes=NUM_CLASSES), "fp32")

    full = build().state_dict()
    shards, plans = [], []
    for index in range(count):
        model = build()
        axis = ttp.apply_model_axis(model, ttp.ModelAxis(count, index, tp=True)).model_axis
        plans.append(axis.plan)
        sd = model.state_dict()
        want = tsharding.shard_state_dict(full, index, count, axis.plan)
        assert sorted(sd) == sorted(want)
        for k in sd:
            assert torch.equal(sd[k], want[k]), k
        shards.append(sd)
    plan = plans[0]
    assert all(p == plan for p in plans) and plan
    for k, v in full.items():
        got = (tsharding.join_shards([s[k] for s in shards], *plan[k])
               if k in plan else shards[0][k])
        assert torch.equal(got, v), k
    if which == "mvit_staged":
        # block0 has 1 head: its attention stays whole, its MLP splits;
        # block3 (4 heads) splits at 2 and 4
        assert "block0.attn.qkv.weight" not in plan
        assert plan["block0.mlp_fc1.weight"] == (0, 1)
        assert plan["block0.mlp_fc2.weight"] == (1, 1)
        assert plan["block3.attn.qkv.weight"] == (0, 3)
        assert plan["block3.attn.proj.weight"] == (1, 1)
        assert ("block1.attn.qkv.weight" in plan) == (count == 2)
    else:
        # the decoder's proj is no block projection for the JAX rules:
        # its attention stays whole; the encoder's 2 heads split at 2 only
        assert not any(k.startswith("dec_block") and ".qkv" in k for k in plan)
        assert "dec_block0.mlp_fc1.weight" in plan
        assert ("encoder.block0.qkv.weight" in plan) == (count == 2)


def test_cp_backends_build_and_run_on_one_rank():
    """ring and ulysses build (they were refused before the model axis) and,
    without a model axis, equal dense attention on one rank."""
    tmodels.create_model(ModelConfig(name="mvit_b", num_classes=3, attention="ring"))
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 9, 2, 8), np.float32))
               for _ in range(3))
    want = tattn.dense_attention(q, k, v)
    for backend in ("ring", "ulysses"):
        np.testing.assert_allclose(
            tattn.dot_product_attention(q, k, v, backend=backend).numpy(),
            want.numpy(), atol=1e-5)


# --- (iii), (iv), (vi): forwards and steps against the JAX mesh -------------


def _spec(d, tag, name, batch, seed):
    rng = np.random.default_rng(seed)
    video = rng.standard_normal((batch, FRAMES, CROP, CROP, 3)).astype(np.float32)
    label = rng.integers(0, NUM_CLASSES, batch).astype(np.int32)
    np.savez(d / f"{tag}.npz", num_classes=NUM_CLASSES, video=video, label=label,
             **{f"w/{k}": v for k, v in _seeded_flat(name).items()})
    return video, label


def _write_cases(d, model, cases, batch):
    data = {}
    for c in cases:
        if c["name"] not in data:
            data[c["name"]] = _spec(d, c["name"], c["name"], batch, 11)
        c["spec"] = f"{c['name']}.npz"
    with open(d / "model_axis.json", "w") as f:
        json.dump({"model": model, "optim": OPT, "cases": cases}, f)
    return data


_JAX_REFS = {}


def _jax_reference(name, attention, video, label, data, model):
    """JAX forward logits, one SGD step's metrics and new params on the
    (data, model) train mesh, and the gradient by `jax.grad` (each case's
    once: the clips of a (name, data) spec are fixed)."""
    key = (name, attention, data, model)
    if key not in _JAX_REFS:
        _JAX_REFS[key] = _jax_reference_uncached(name, attention, video, label,
                                                 data, model)
    return _JAX_REFS[key]


def _jax_reference_uncached(name, attention, video, label, data, model):
    mesh = make_train_mesh(JMeshConfig(data=data, model=model),
                           devices=jax.devices()[:data * model])
    cp = attention in ("ring", "ulysses")
    jm = jmodels.create_model(JModelConfig(
        name=name, num_classes=NUM_CLASSES, dropout_rate=0.0,
        attention="dense" if attention == "pallas" else attention), "fp32", mesh=mesh)
    tree = unflatten_tree(_seeded_flat(name))
    params = jax.tree.map(jnp.asarray, tree["params"])
    fwd = jax.jit(lambda p, x: jm.apply({"params": p}, x))
    with mesh:
        logits = np.asarray(fwd(jsharding.shard_params(mesh, params, tp=not cp),
                                jnp.asarray(video)))

    def loss_of(p):
        out = jm.apply({"params": p}, jnp.asarray(video))
        return jsteps._loss_and_metrics(out, jnp.asarray(label),
                                        jnp.ones(label.shape[0]), 0.0)[0]

    with mesh:
        grads = jax.jit(jax.grad(loss_of))(params)
    jcfg = JOptimConfig(**OPT)
    tx = joptim.build_optimizer(jcfg, 4)
    jstate = JState.create(jsharding.shard_params(mesh, params, tp=not cp), {}, tx)
    jstep = jsteps.make_train_step(jm, tx, mesh,
                                   lr_schedule=joptim.build_lr_schedule(jcfg, 4))
    batch = jsharding.shard_batch(mesh, {"video": video, "label": label})
    jstate, metrics = jstep(jstate, batch, jax.random.key(0))
    return (logits, {k: float(v) for k, v in metrics.items()},
            state_dict_from_jax({"params": jax.device_get(grads)}),
            state_dict_from_jax({"params": jax.device_get(jstate.params)}))


def _bound_failures(out, metrics, want_g, want_s) -> list:
    fails = []
    if abs(out["loss"] - metrics["loss"]) > 1e-5:
        fails.append(("loss", out["loss"], metrics["loss"]))
    for k, w in want_g.items():
        d = float(np.abs(out["grads"][k] - w).max())
        if d > 1e-2 * (1 + float(np.abs(w).max())):
            fails.append((k, d))
    for k, w in want_s.items():
        d = float(np.abs(out["state"][k] - w).max())
        if d > 2e-5:
            fails.append((k, d))
    return fails


def _hold_case(ranks, tag, data, model, video, label, attention, name):
    logits, metrics, want_g, want_s = _jax_reference(name, attention, video, label,
                                                     data, model)
    b = video.shape[0] // data
    for r, out in enumerate(ranks):
        got = out[tag]
        d_i = r // model
        # (iii) the forward of this rank's data slice
        np.testing.assert_allclose(got["logits"], logits[d_i * b:(d_i + 1) * b],
                                   rtol=2e-5, atol=2e-5, err_msg=tag)
        # every rank of the group gathers the same step
        assert got["loss"] == ranks[0][tag]["loss"]
        for k, v in got["state"].items():
            np.testing.assert_array_equal(v, ranks[0][tag]["state"][k], err_msg=k)
    for g in range(0, len(ranks), model):  # each model group's replicated leaves
        for r in range(g, g + model):
            for k, v in ranks[r][tag]["replicated"].items():
                np.testing.assert_array_equal(v, ranks[g][tag]["replicated"][k], err_msg=k)
    assert _bound_failures(ranks[0][tag], metrics, want_g, want_s) == [], tag
    np.testing.assert_allclose(ranks[0][tag]["grad_norm"], metrics["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(ranks[0][tag]["accuracy"], metrics["accuracy"], atol=1e-7)
    return metrics, want_g, want_s


CASES_12 = [
    {"tag": "mvit_tp", "name": "mvit_t", "attention": "pallas"},
    {"tag": "mvit_tp_control", "name": "mvit_t", "attention": "pallas", "control": True},
    {"tag": "videomae_tp", "name": "videomae_t", "attention": "pallas"},
    {"tag": "mvit_ring", "name": "mvit_t", "attention": "ring"},
    {"tag": "videomae_ulysses", "name": "videomae_t", "attention": "ulysses"},
]
CASES_22 = [
    {"tag": "videomae_tp", "name": "videomae_t", "attention": "pallas"},
    {"tag": "videomae_tp_control", "name": "videomae_t", "attention": "pallas",
     "control": True},
]


@pytest.fixture(scope="module")
def mesh12(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh12")
    data = _write_cases(d, 2, [dict(c) for c in CASES_12], batch=2)
    return data, run_group("model_axis", d, world=2, timeout_s=240)


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh22")
    data = _write_cases(d, 2, [dict(c) for c in CASES_22], batch=4)
    return data, run_group("model_axis", d, world=4, timeout_s=240)


@pytest.mark.parametrize("tag", ["mvit_tp", "videomae_tp"])
def test_tensor_parallel_at_1x2_matches_the_jax_mesh(mesh12, tag):
    data, ranks = mesh12
    case = next(c for c in CASES_12 if c["tag"] == tag)
    video, label = data[case["name"]]
    assert ranks[0][tag]["mode"] == "tensor-parallel" and ranks[0][tag]["plan"]
    full = sum(v.size for v in ranks[0][tag]["state"].values())
    assert ranks[0][tag]["n_params"] < full
    _hold_case(ranks, tag, 1, 2, video, label, "pallas", case["name"])


def test_tensor_parallel_at_2x2_matches_the_jax_mesh(mesh22):
    data, ranks = mesh22
    video, label = data["videomae_t"]
    metrics, want_g, want_s = _hold_case(ranks, "videomae_tp", 2, 2, video, label,
                                         "pallas", "videomae_t")
    control = _bound_failures(ranks[0]["videomae_tp_control"], metrics, want_g, want_s)
    assert control and control[0][0] == "loss", control


def test_control_without_the_row_all_reduce_fails(mesh12):
    data, ranks = mesh12
    video, label = data["mvit_t"]
    _, metrics, want_g, want_s = _jax_reference("mvit_t", "pallas", video, label, 1, 2)
    control = _bound_failures(ranks[0]["mvit_tp_control"], metrics, want_g, want_s)
    assert control and control[0][0] == "loss", control


@pytest.mark.parametrize("tag", ["mvit_ring", "videomae_ulysses"])
def test_context_parallel_step_matches_the_jax_mesh(mesh12, tag):
    data, ranks = mesh12
    case = next(c for c in CASES_12 if c["tag"] == tag)
    video, label = data[case["name"]]
    assert ranks[0][tag]["mode"] == "context-parallel" and not ranks[0][tag]["plan"]
    _hold_case(ranks, tag, 1, 2, video, label, case["attention"], case["name"])


# --- (v) ring and ulysses against the JAX wrappers --------------------------

CP_CASES = {  # tag: (B, Nq, Nk, H, D)
    "even": (2, 12, 12, 4, 8),
    "ragged": (2, 11, 7, 4, 8),  # MViT's pooled K/V: Nk != Nq, neither divides
    "h6": (1, 10, 10, 6, 16),
}


@pytest.fixture(scope="module", params=[2, 3], ids=["cp2", "cp3"])
def cp_runs(request, tmp_path_factory):
    cp = request.param
    d = tmp_path_factory.mktemp(f"cp{cp}")
    rng = np.random.default_rng(5)
    arrays = {}
    for tag, (b, nq, nk, h, dd) in CP_CASES.items():
        for x, n in (("q", nq), ("k", nk), ("v", nk), ("ct", nq)):
            arrays[f"{tag}/{x}"] = rng.standard_normal((b, n, h, dd)).astype(np.float32)
    np.savez(d / "cp.npz", **arrays)
    return cp, arrays, run_group("cp_attention", d, world=cp, timeout_s=120)


def _jax_cp(fn_maker, cp, q, k, v, ct):
    mesh = make_mesh(JMeshConfig(data=1, context=cp), devices=jax.devices()[:cp])
    fn = fn_maker(mesh) if fn_maker is not None else jattn.dense_attention
    with mesh:
        out, vjp = jax.vjp(jax.jit(fn), *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(ct))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("tag", sorted(CP_CASES))
def test_ring_and_ulysses_match_jax_and_dense(cp_runs, tag):
    cp, arrays, ranks = cp_runs
    q, k, v, ct = (arrays[f"{tag}/{x}"] for x in ("q", "k", "v", "ct"))
    dense_out, dense_g = _jax_cp(None, cp, q, k, v, ct)
    h = q.shape[2]
    for name, maker in (("ring", make_ring_attention), ("ulysses", make_ulysses_attention)):
        want_out, want_g = _jax_cp(maker, cp, q, k, v, ct)
        for r, out in enumerate(ranks):
            got = out[f"{tag}/{name}"]
            for ref_out, ref_g in ((want_out, want_g), (dense_out, dense_g)):
                np.testing.assert_allclose(got["out"], ref_out, atol=1e-5,
                                           err_msg=f"{tag}/{name} rank {r}")
                for gname, g, w in zip(("dq", "dk", "dv"),
                                       (got["dq"], got["dk"], got["dv"]), ref_g):
                    np.testing.assert_allclose(g, w, atol=1e-4,
                                               err_msg=f"{tag}/{name} {gname}")
            # ring runs cp blocks a rank; ulysses none, unless it falls back
            falls_back = name == "ring" or h % cp != 0
            assert got["blocks"] == (cp if falls_back else 0), (tag, name)


# --- (vii) the conv families replicate ----------------------------------------


def test_conv_family_replicates_at_1x2_equal_to_world_1(tmp_path):
    r0, r1 = run_group("replicated", tmp_path, timeout_s=240)
    (one,) = run_group("replicated", tmp_path, world=1, timeout_s=240)
    assert r0["mode"] == "replicated"
    assert len(r0["batches"]) == len(r1["batches"]) == len(one["batches"]) > 0
    for a, b, c in zip(r0["batches"], r1["batches"], one["batches"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    assert r0["seen"] == r1["seen"] == one["seen"]
    for k in one["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k], err_msg=k)
        np.testing.assert_array_equal(r0["state"][k], one["state"][k], err_msg=k)


# --- (viii) checkpoints across layouts, the export, the clip's norm ---------


CKPT_EXTRA = ["--model.name", "mvit_t", "--batch_size", "2", "--model.dropout_rate", "0",
              "--optim.optimizer", "adamw", "--optim.lr", "0.01",
              "--optim.ema_decay", "0.9", "--optim.grad_clip_norm", "0.5",
              "--checkpointing_steps", "1"]


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}/{i}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_checkpoints_cross_layouts_bitwise(tmp_path):
    # (1, 1) first: the checkpoint the (1, 2) ranks restore
    _GRAD_NORMS.clear()
    _fit(_ma_argv(tmp_path, "one", CKPT_EXTRA))
    norms_one = list(_GRAD_NORMS)
    r0, r1 = run_group("ckpt", tmp_path, timeout_s=240)
    # the (1, 2) fit: its clip's norms, its checkpoint and export
    np.testing.assert_allclose(r0["fit"]["grad_norms"], norms_one, rtol=1e-5)
    ckpt_two = os.path.join(tmp_path, "two", "checkpoints")
    last = Checkpointer(ckpt_two).latest_step()
    assert last == len(norms_one) == 4
    saved = torch.load(os.path.join(ckpt_two, str(last), "state.pt"), weights_only=True)
    _assert_tree_equal(saved, r0["fit"]["full"])
    _assert_tree_equal(saved, r1["fit"]["full"])
    # ... resumed in one process: bitwise the gathered state; exported alike
    t = Trainer(parse_cli(_ma_argv(tmp_path, "two", CKPT_EXTRA + [
        "--resume_from_checkpoint", "auto"])))
    t._maybe_resume()
    _assert_tree_equal(t.state.state_dict(), saved)
    t.export_inference(os.path.join(tmp_path, "one_art"))
    t.close()
    with np.load(os.path.join(tmp_path, "two_art", "weights.npz")) as a, \
            np.load(os.path.join(tmp_path, "one_art", "weights.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the (1, 1) checkpoint restored at (1, 2): each rank's shards its
    # slices of the file, and the gathered state the file
    one = torch.load(os.path.join(tmp_path, "one", "checkpoints", str(last), "state.pt"),
                     weights_only=True)
    for r in (r0, r1):
        rest = r["restored"]
        _assert_tree_equal(rest["full"], one)
        want = tsharding.shard_state_dict(one["model"], rest["index"], 2, rest["plan"])
        _assert_tree_equal(rest["shards"], want)
        want_ema = tsharding.shard_state_dict(one["ema"], rest["index"], 2, rest["plan"])
        _assert_tree_equal(rest["ema_local"], want_ema)


# --- (ix) what stays refused --------------------------------------------------


_REFUSE = ["--cpu", "--synthetic", "--model.name", "videomae_t", "--num_frames", "4",
           "--data.crop_size", "32", "--data.min_short_side_scale", "32",
           "--data.max_short_side_scale", "40", "--batch_size", "2",
           "--data.synthetic_num_videos", "4", "--num_workers", "1"]


@pytest.mark.parametrize("extra,err,match", [
    (["--parallel.pipeline_stages", "2"], ValueError, "must equal the mesh's"),
    (["--mesh.tensor", "2", "--mesh.model", "2"], ValueError, "pick one layout"),
    (["--mesh.fsdp", "2", "--mesh.model", "2"], ValueError, "pick one layout"),
    (["--mesh.model", "2"], ValueError, "does not divide device count 1"),
    (["--mesh.model", "3", "--mesh.data", "1"], ValueError, "needs 3 devices"),
])
def test_what_stays_refused(extra, err, match):
    with pytest.raises(err, match=match):
        Trainer(parse_cli(_REFUSE + extra))


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_context_parallel_refuses_a_masked_trunk(backend):
    model = tmodels.create_model(ModelConfig(
        name="videomae_t", num_classes=3, attention=backend, attn_mask="causal"), "fp32")
    with pytest.raises(NotImplementedError, match="no masked lowering"):
        model(torch.zeros(1, FRAMES, CROP, CROP, 3))
