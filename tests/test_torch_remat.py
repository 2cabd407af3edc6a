"""Per-block remat (`--model.remat`, `models/common.py remat_call`) of the
port's transformers, on the CPU in float32.

Port against port, remat against none, on the same weights and batch: the
loss and every gradient within 1e-6, with drop path at 0.5 in every MViT
block (`mvit_t` and the staged twin of tests/test_torch_mvit_videomae.py,
whose stride-1 K/V pools run `Depthwise3dS1`) and the flash and depthwise
`autograd.Function`s inside the checkpointed blocks (`attention pallas`,
`depthwise_impl pallas`; on CPU tensors they run their plain versions). A
checkpoint that let the recompute redraw the drop-path masks misses this
by orders of magnitude, which the control test shows. VideoMAE's blocks
draw no masks; its classifier runs with head dropout 0.5 and its
pretraining twin under one injected tube mask.

Port against JAX, remat on both sides with drop path off: the loss within
1e-5 and every gradient within 1e-4 * (1 + max|g|) of its leaf, the
tolerances of tests/test_torch_mvit_videomae.py (mirroring
tests/test_models_x3d_mvit.py's remat parity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import test_torch_mvit_videomae as tw
from pytorchvideo_accelerate_tpu import config as jcfg
from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.models import videomae as jvideomae
from pytorchvideo_accelerate_tpu.models.mvit import MViT as JMViT
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu_torch import models as tmodels
from pytorchvideo_accelerate_tpu_torch.config import ModelConfig
from pytorchvideo_accelerate_tpu_torch.models import common
from pytorchvideo_accelerate_tpu_torch.models import mvit as tmvit
from pytorchvideo_accelerate_tpu_torch.models.common import DropPath, SeededDropout
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    state_dict_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.models.mvit import MViT
from pytorchvideo_accelerate_tpu_torch.trainer import steps as tsteps

NAMES = ("mvit_t", "mvit_staged", "videomae_t", "videomae_t_pretrain")


def _model(name, remat, attention="pallas", impl="pallas", drop=0.5):
    """The port's twin `name` with the seeded weights of the parity tests,
    its drop paths (MViT) or head dropout (VideoMAE classifier) at
    `drop`."""
    if name == "mvit_staged":
        kw = dict(tw.STAGED, drop_path_rate=drop)
        model = MViT(tw.NUM_CLASSES, input_grid=(tw.FRAMES, tw.CROP, tw.CROP),
                     attention_backend=attention, depthwise_impl=impl,
                     remat=remat, **kw)
    else:
        model = tmodels.create_model(ModelConfig(
            name=name, num_classes=tw.NUM_CLASSES, attention=attention,
            depthwise_impl=impl, remat=remat,
            dropout_rate=drop if name == "videomae_t" else 0.0),
            "fp32", data_cfg=tw.DATA)
        for m in model.modules():
            if isinstance(m, DropPath):
                m.rate = drop
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_jax(tw._seeded_flat(name)).items()})
    return model.train()


def _loss_and_grads(model, name, seed=3):
    """One training forward + backward; every SeededDropout reseeded as
    the train step does."""
    for i, d in enumerate(m for m in model.modules() if isinstance(m, SeededDropout)):
        d.reseed(1000 + i)
    x = torch.from_numpy(tw._clips(seed))
    if name == "videomae_t_pretrain":
        keep, masked = tw._mask_indices(seed=9)
        loss = model(x, keep, masked)["loss"]
    else:
        loss = tsteps._loss_and_metrics(
            model(x), torch.from_numpy(tw._labels(seed)), torch.ones(tw.BATCH),
            0.1)[0]
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _max_rel(a: dict, b: dict) -> float:
    return max(((a[k] - b[k]).abs().max() / (1.0 + b[k].abs().max())).item()
               for k in b)


@pytest.mark.parametrize("name", NAMES)
def test_remat_equals_no_remat_with_drop_path_on(name):
    l0, g0 = _loss_and_grads(_model(name, remat=False), name)
    l1, g1 = _loss_and_grads(_model(name, remat=True), name)
    assert abs(l1 - l0) <= 1e-6
    assert sorted(g1) == sorted(g0)
    assert _max_rel(g1, g0) <= 1e-6


def test_a_recompute_that_redraws_the_masks_is_caught(monkeypatch):
    """The control: a plain non-reentrant checkpoint (no rewind of the
    drop-path generators) draws new masks in the recompute, and the
    gradient misses by orders of magnitude more than 1e-6."""
    _, want = _loss_and_grads(_model("mvit_staged", remat=False), "mvit_staged")
    monkeypatch.setattr(tmvit, "remat_call", lambda block, fn, x, *a: checkpoint(
        fn, x, *a, use_reentrant=False))
    _, got = _loss_and_grads(_model("mvit_staged", remat=True), "mvit_staged")
    assert _max_rel(got, want) > 1e-3


def test_remat_runs_each_block_forward_twice(monkeypatch):
    """Under remat the backward runs every block's forward again: the flash
    Function's forward is entered twice per block, once without."""
    from pytorchvideo_accelerate_tpu_torch.ops import flash_attention

    calls = []
    real = flash_attention.FlashAttention.forward

    def counting(ctx, *a, **k):
        calls.append(1)
        return real(ctx, *a, **k)

    monkeypatch.setattr(flash_attention.FlashAttention, "forward",
                        staticmethod(counting))
    depth = 2  # mvit_t
    for remat, want in ((False, depth), (True, 2 * depth)):
        calls.clear()
        _loss_and_grads(_model("mvit_t", remat=remat), "mvit_t")
        assert len(calls) == want


def test_remat_refuses_a_block_with_batchnorm():
    block = tmvit.MViTBlock(8, 8, 2)
    block.add_module("bn", common.BNAffine(8))
    with pytest.raises(ValueError, match="running averages twice"):
        common.check_remat_block(block)


def test_remat_without_grad_is_a_plain_forward():
    model = _model("mvit_t", remat=True).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(tw._clips(4)))
    plain = _model("mvit_t", remat=False).eval()
    with torch.no_grad():
        want = plain(torch.from_numpy(tw._clips(4)))
    assert torch.equal(got, want)


def _jax_remat_model(name):
    if name == "mvit_staged":
        return JMViT(num_classes=tw.NUM_CLASSES, remat=True, **tw.STAGED)
    return jmodels.create_model(jcfg.ModelConfig(
        name=name, num_classes=tw.NUM_CLASSES, dropout_rate=0.0, remat=True),
        "fp32")


@pytest.mark.parametrize("name", ["mvit_t", "videomae_t", "videomae_t_pretrain"])
def test_remat_matches_jax_remat(name, monkeypatch):
    x, labels = tw._clips(3), tw._labels(3)
    params = unflatten_tree(tw._seeded_flat(name))["params"]
    jm = _jax_remat_model(name)
    keep, masked = tw._mask_indices(seed=9)
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
                                            jnp.ones(tw.BATCH, jnp.float32),
                                            0.1)[0]
    wl, wg = jax.jit(jax.value_and_grad(jloss))(params)
    loss, grads = _loss_and_grads(
        _model(name, remat=True, attention="dense", impl="conv", drop=0.0), name)
    np.testing.assert_allclose(loss, float(wl), atol=1e-5)
    tw._close_per_leaf({k: v.numpy() for k, v in grads.items()},
                       state_dict_from_jax({"params": jax.device_get(wg)}), 1e-4)
