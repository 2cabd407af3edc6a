"""The port's MViT and VideoMAE against the JAX package's, on the CPU in
float32.

Tiny twins of both families (B=2, 4 frames at 32x32): `mvit_t` (uniform
schedule), a directly built MViT with stage starts (1, 3) and an initial
kv stride (1, 4, 4), so q pooling, `skip_proj`, the max-pooled skip and
stride-1 K/V pools all run; `videomae_t` and `videomae_t_pretrain`.
Weights are drawn once with numpy in the flax layout (kernels std
1/sqrt(fan_in), LayerNorm scales in [0.5, 1.5], biases, `pos_embed` and
`mask_token` std 0.1) and carried into the port by `state_dict_from_jax`.
Dropout and drop path are 0 on both sides. The JAX side runs its Pallas
flash kernels in interpret mode under `attention pallas`; the port runs
`FlashAttention` with the plain versions inside (CPU tensors).

The VideoMAE tube mask cannot be drawn alike in both frameworks: the JAX
model's `tube_mask_indices` is replaced in the test (monkeypatch) by one
returning seeded numpy indices, and the port gets the same indices
injected.

Tolerances: eval logits, the pretraining loss and `pred` atol 1e-4 (f32
stacks that sum in other orders); one training forward + backward: the
loss atol 1e-5 and every gradient within 1e-4 * (1 + max|g|) of its leaf.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu import config as jcfg
from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.models import videomae as jvideomae
from pytorchvideo_accelerate_tpu.models.mvit import MViT as JMViT
from pytorchvideo_accelerate_tpu.serving import engine as jengine
from pytorchvideo_accelerate_tpu.trainer import checkpoint as jckpt
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu_torch import config as tcfg
from pytorchvideo_accelerate_tpu_torch import models as tmodels
from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig, OptimConfig
from pytorchvideo_accelerate_tpu_torch.models import videomae as tvideomae
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    jax_train_state_from_port,
    jax_tree_from_state_dict,
    load_train_state,
    state_dict_from_jax,
    train_state_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.models.mvit import MViT
from pytorchvideo_accelerate_tpu_torch.serving import engine as tengine
from pytorchvideo_accelerate_tpu_torch.trainer import checkpoint as tckpt
from pytorchvideo_accelerate_tpu_torch.trainer import optim as toptim
from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps
from pytorchvideo_accelerate_tpu_torch.trainer.train_state import TrainState

NUM_CLASSES = 5
BATCH, FRAMES, CROP = 2, 4, 32
DATA = DataConfig(num_frames=FRAMES, crop_size=CROP)
# the directly built MViT twin with stage starts (mvit_t has none)
STAGED = dict(depth=4, embed_dim=16, num_heads=1, stage_starts=(1, 3),
              initial_kv_stride=(1, 4, 4), drop_path_rate=0.0, dropout_rate=0.0)
MODELS = ("mvit_t", "mvit_staged", "videomae_t", "videomae_t_pretrain")


def _clips(seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, FRAMES, CROP, CROP, 3), np.float32)


def _labels(seed=0, batch=BATCH):
    return np.random.default_rng(seed + 100).integers(
        0, NUM_CLASSES, batch).astype(np.int32)


def _jax_model(name, attention="dense", attn_mask="none"):
    if name == "mvit_staged":
        return JMViT(num_classes=NUM_CLASSES, attention_backend=attention, **STAGED)
    return jmodels.create_model(jcfg.ModelConfig(
        name=name, num_classes=NUM_CLASSES, dropout_rate=0.0,
        attention=attention, attn_mask=attn_mask), "fp32")


def _port_model(name, attention="dense", attn_mask="none"):
    if name == "mvit_staged":
        model = MViT(NUM_CLASSES, input_grid=(FRAMES, CROP, CROP),
                     attention_backend=attention, **STAGED)
    else:
        model = tmodels.create_model(ModelConfig(
            name=name, num_classes=NUM_CLASSES, dropout_rate=0.0,
            attention=attention, attn_mask=attn_mask), "fp32", data_cfg=DATA)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_jax(_seeded_flat(name)).items()},
                          strict=True)
    return model


@functools.lru_cache(maxsize=None)
def _seeded_flat(name):
    spec = jax.ShapeDtypeStruct((1, FRAMES, CROP, CROP, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda x: _jax_model(name).init(
        {"params": key, "mask": key}, x), spec)
    rng = np.random.default_rng(21)
    flat = {}
    for k, leaf in flatten_tree(tree).items():
        shape = leaf.shape
        if k.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif k.endswith("scale"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # biases, pos_embed, mask_token
            v = rng.standard_normal(shape) * 0.1
        flat[k] = v.astype(np.float32)
    return flat


def _mask_indices(seed=7, batch=BATCH):
    """A seeded tube mask for the (2, 4, 4) token grid of the tiny twin."""
    return tvideomae.tube_mask_indices(torch.Generator().manual_seed(seed),
                                       batch, 2, 4, 4, 0.9)


def _jax_pretrain_out(params, x, monkeypatch, keep, masked):
    monkeypatch.setattr(jvideomae, "tube_mask_indices",
                        lambda *a, **k: (jnp.asarray(keep.numpy()),
                                         jnp.asarray(masked.numpy())))
    return _jax_model("videomae_t_pretrain").apply(
        {"params": params}, jnp.asarray(x), rngs={"mask": jax.random.PRNGKey(3)})


@pytest.mark.parametrize("name", MODELS)
def test_converter_round_trips_the_whole_tree(name):
    """The repaired converter: every leaf of the flax tree, `pos_embed` and
    `mask_token` included, maps to one port key of the same shape (a strict
    load) and back, bitwise."""
    flat = _seeded_flat(name)
    model = _port_model(name)
    free = [k for k in flat if k.endswith(("pos_embed", "mask_token"))]
    assert len(free) == (0 if name == "videomae_t" else 1)
    for k in free:
        assert tuple(model.state_dict()[k.split("/", 1)[1]].shape) == flat[k].shape
    back = flatten_tree(jax_tree_from_state_dict(model.state_dict()))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("name", ["mvit_staged", "videomae_t_pretrain"])
def test_train_state_with_momentum_crosses_both_ways(name):
    flat = _seeded_flat(name)
    params = unflatten_tree(flat)["params"]
    rng = np.random.default_rng(5)
    momentum = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    model = _port_model(name)
    opt = toptim.build_optimizer(OptimConfig(), 4, model.named_parameters())
    state = TrainState.create(model, opt)
    load_train_state(state, train_state_from_jax(params, {}, 3, momentum))
    back = jax_train_state_from_port(state)
    assert back["step"] == 3 and not flatten_tree(back["batch_stats"])
    for tree, want in ((back["params"], params), (back["momentum"], momentum)):
        got, want = flatten_tree(tree), flatten_tree(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name,attention,attn_mask", [
    (name, attention, "none") for name in ("mvit_t", "mvit_staged", "videomae_t")
    for attention in ("dense", "pallas")] + [("videomae_t", "dense", "causal")])
def test_eval_logits_match_jax(name, attention, attn_mask):
    x = _clips()
    jm = _jax_model(name, attention, attn_mask)
    want = np.asarray(jax.jit(jm.apply)(unflatten_tree(_seeded_flat(name)),
                                        jnp.asarray(x)))
    model = _port_model(name, attention, attn_mask).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (BATCH, NUM_CLASSES)
    assert np.abs(want).max() > 0.1  # the weights make the comparison mean something
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("attention", ["dense", "pallas"])
def test_pretrain_loss_and_pred_match_jax(attention, monkeypatch):
    x = _clips(1)
    keep, masked = _mask_indices()
    want = _jax_pretrain_out(unflatten_tree(_seeded_flat("videomae_t_pretrain"))["params"],
                             x, monkeypatch, keep, masked)
    model = _port_model("videomae_t_pretrain", attention)
    with torch.no_grad():
        got = model(torch.from_numpy(x), keep, masked)
    assert got["pred"].shape == got["target"].shape == (BATCH, 2 * 14, 2 * 8 * 8 * 3)
    np.testing.assert_array_equal(got["masked_idx"].numpy(), masked.numpy())
    np.testing.assert_allclose(got["target"].numpy(), np.asarray(want["target"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), atol=1e-4)


def test_tube_mask_shares_one_spatial_mask_over_time():
    keep, masked = _mask_indices(seed=11, batch=3)
    assert keep.shape == (3, 2 * 2) and masked.shape == (3, 2 * 14)
    for row_keep, row_masked in zip(keep.numpy(), masked.numpy()):
        assert sorted(np.concatenate([row_keep, row_masked])) == list(range(32))
        np.testing.assert_array_equal(row_keep[2:] - 16, row_keep[:2])
    again = _mask_indices(seed=11, batch=3)
    assert torch.equal(keep, again[0]) and torch.equal(masked, again[1])


def test_patchify_and_sincos_match_jax():
    x = _clips(2)
    np.testing.assert_array_equal(
        tvideomae.patchify(torch.from_numpy(x), (2, 8, 8)).numpy(),
        np.asarray(jvideomae.patchify(jnp.asarray(x), (2, 8, 8))))
    np.testing.assert_array_equal(tvideomae.sincos_pos_embed(32, 16),
                                  np.asarray(jvideomae.sincos_pos_embed(32, 16)))


def _close_per_leaf(got: dict, want: dict, rel: float):
    """Each leaf within rel * (1 + max|want|)."""
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        tol = rel * (1.0 + np.abs(w).max())
        assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max(), tol)


@pytest.mark.parametrize("attention", ["dense", "pallas"])
@pytest.mark.parametrize("name", ["mvit_staged", "videomae_t_pretrain"])
def test_train_step_gradients_match_jax(name, attention, monkeypatch):
    """One training forward + backward (the loss and every gradient of an
    SGD step) against `jax.value_and_grad`: MViT under cross-entropy with
    label smoothing, VideoMAE pretraining under its reconstruction loss with
    the injected mask."""
    x, labels = _clips(3), _labels(3)
    params = unflatten_tree(_seeded_flat(name))["params"]
    jm = _jax_model(name, attention)
    keep, masked = _mask_indices(seed=9)
    if name == "videomae_t_pretrain":
        monkeypatch.setattr(jvideomae, "tube_mask_indices",
                            lambda *a, **k: (jnp.asarray(keep.numpy()),
                                             jnp.asarray(masked.numpy())))

        def jloss(p):
            return jm.apply({"params": p}, jnp.asarray(x), train=True,
                            rngs={"mask": jax.random.PRNGKey(1)})["loss"]
    else:
        def jloss(p):
            logits = jm.apply({"params": p}, jnp.asarray(x), train=True)
            return jsteps._loss_and_metrics(logits, jnp.asarray(labels),
                                            jnp.ones(BATCH, jnp.float32), 0.1)[0]
    wl, wg = jax.jit(jax.value_and_grad(jloss))(params)
    model = _port_model(name, attention).train()
    if name == "videomae_t_pretrain":
        loss = model(torch.from_numpy(x), keep, masked)["loss"]
    else:
        loss = tsteps._loss_and_metrics(model(torch.from_numpy(x)),
                                        torch.from_numpy(labels),
                                        torch.ones(BATCH), 0.1)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(wl), atol=1e-5)
    _close_per_leaf({n: p.grad.numpy() for n, p in model.named_parameters()},
                    state_dict_from_jax({"params": jax.device_get(wg)}), 1e-4)


def test_pretrain_steps_train_and_score_deterministically():
    """`make_pretrain_step` takes an SGD step on the reconstruction loss
    (no labels, masks from (seed, step)); `make_pretrain_eval_step` scores
    the masked per-clip loss under the deterministic mask, the same on
    every call, and padded rows do not count."""
    model = _port_model("videomae_t_pretrain")
    opt = toptim.build_optimizer(OptimConfig(lr=0.05), 10, model.named_parameters())
    state = TrainState.create(model, opt)
    step = tsteps.make_pretrain_step(model, opt, accum_steps=2, seed=4)
    batch = {"video": torch.from_numpy(np.stack([_clips(5), _clips(6)]))}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = step(state, batch)
    assert state.step == 1 and set(m) == {"loss", "grad_norm", "lr"}
    assert torch.isfinite(m["loss"]) and m["grad_norm"] > 0
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())
    eval_step = tsteps.make_pretrain_eval_step(model)
    x = torch.from_numpy(_clips(7))
    a = eval_step(state, {"video": x})
    b = eval_step(state, {"video": x, "mask": torch.tensor([1.0, 0.0])})
    assert a["count"].item() == 2 and b["count"].item() == 1
    assert a["correct"].item() == a["correct5"].item() == 0
    with torch.no_grad():
        keep, masked = tvideomae.tube_mask_indices(
            torch.Generator().manual_seed(0), 2, 2, 4, 4, 0.9)
        out = model.eval()(x, keep, masked)
        per = ((out["pred"] - out["target"]) ** 2).mean(dim=(1, 2))
    np.testing.assert_allclose(a["loss_sum"].item(), per.sum().item(), rtol=1e-6)
    np.testing.assert_allclose(b["loss_sum"].item(), per[0].item(), rtol=1e-6)


@pytest.fixture(scope="module")
def mvit_artifact(tmp_path_factory):
    """A JAX-written `mvit_t` artifact (LayerNorm-only tree, no batch_stats)
    and the JAX engine's logits on its first bucket."""
    argv = ["--model.name", "mvit_t", "--model.num_classes", str(NUM_CLASSES),
            "--num_frames", str(FRAMES), "--data.crop_size", str(CROP),
            "--mixed_precision", "fp32", "--serve.max_batch_size", "2"]
    cfg = jcfg.parse_cli(argv)
    state = types.SimpleNamespace(
        params=unflatten_tree(_seeded_flat("mvit_t"))["params"], batch_stats={},
        ema_params=None, step=2)
    art = str(tmp_path_factory.mktemp("mvit_art"))
    meta = {"num_classes": NUM_CLASSES, "model": "mvit_t"}
    jckpt.export_inference(art, state, config=cfg, meta=meta)
    eng = jengine.InferenceEngine.from_artifact(art)
    clips = {"video": _clips(8, batch=eng.buckets[0])}
    return art, argv, meta, clips, eng.predict(clips)


def test_mvit_artifact_crosses_both_ways(mvit_artifact, tmp_path):
    art, argv, meta, clips, want = mvit_artifact
    eng = tengine.InferenceEngine.from_artifact(art, device="cpu",
                                                max_batch_size=len(want))
    got = eng.predict(clips)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    out = tckpt.export_inference(str(tmp_path / "port_art"), eng.model,
                                 tcfg.parse_cli(argv), meta=meta)
    np.testing.assert_allclose(
        jengine.InferenceEngine.from_artifact(out).predict(clips), want,
        atol=1e-4, rtol=0)


def test_init_draws_like_jax():
    """LayerNorm ones/zeros, pos_embed a +-2-cut normal times 0.02,
    mask_token normal(0.02), VideoMAE's head normal(0.01) with a zero bias,
    MViT's head and every Dense lecun-normal with zero biases."""
    mvit = tmodels.create_model(ModelConfig(name="mvit_b", num_classes=400),
                                "fp32", seed=2,
                                data_cfg=DataConfig(num_frames=16, crop_size=224))
    pos = mvit.pos_embed.detach()
    assert pos.shape == (1, 8, 56, 56, 96)
    assert pos.abs().max().item() <= 0.04
    # a standard normal cut at +-2 has std 0.8796
    np.testing.assert_allclose(pos.std().item(), 0.02 * 0.87962566, rtol=0.02)
    assert (mvit.block0.norm1.weight.detach() == 1).all()
    assert not mvit.block3.attn.pool_q.norm.bias.detach().any()
    for w, fan_in in ((mvit.head.weight, 768), (mvit.block5.attn.qkv.weight, 384),
                      (mvit.block0.attn.pool_k.pool.weight, 27)):
        np.testing.assert_allclose(w.detach().std().item(), np.sqrt(1.0 / fan_in),
                                   rtol=0.1)
    assert not mvit.head.bias.detach().any()
    pre = tmodels.create_model(ModelConfig(name="videomae_t_pretrain"), "fp32", seed=2)
    assert pre.mask_token.shape == (1, 1, 16)
    cls = tmodels.create_model(ModelConfig(name="videomae_b", num_classes=400),
                               "fp32", seed=2)
    np.testing.assert_allclose(cls.head.weight.detach().std().item(), 0.01, rtol=0.05)
    assert not cls.head.bias.detach().any()
    assert not cls.encoder.block0.qkv.bias.detach().any()
