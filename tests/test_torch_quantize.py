"""The port's int8 serving (serving/quantize.py) against the JAX package's,
on the CPU in float32.

- Per family (each tiny twin's weights, seeded with numpy): the JAX
  `quantize_tree` on the flax params and the port's `quantize_tree` on the
  converted state_dict select the same weights and are byte-equal, int8 and
  scale, once the int8 array is carried into the flax layout.
- Quantizing twice changes nothing; norms, biases, statistics, `pos_embed`
  stay full precision; a zero channel is safe.
- A JAX-baked int8 artifact serves through the port's engine and a
  port-baked one through the JAX engine with the same logits (atol 1e-5).
- On the JAX gate's fixture (tiny3d trained 2 steps, here by `run.main`)
  the port's int8 logits pass the JAX gate against its fp logits (top-1
  agreement >= 0.75, atol 5e-2); on-the-fly and baked int8 are bitwise
  equal; padded rows and multi-view requests answer as in fp, through the
  default scheduler.
"""

import functools
import json
import os
import types

import numpy as np
import pytest
import torch

import jax

import test_torch_mvit_videomae as tmv
import test_torch_r2plus1d as tr2
import test_torch_x3d_csn as txc
from pytorchvideo_accelerate_tpu import config as jcfg
from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.serving import engine as jengine
from pytorchvideo_accelerate_tpu.serving import quantize as jquant
from pytorchvideo_accelerate_tpu.trainer import checkpoint as jckpt
from pytorchvideo_accelerate_tpu_torch import config as tcfg
from pytorchvideo_accelerate_tpu_torch.fleet.scheduler import Scheduler
from pytorchvideo_accelerate_tpu_torch.models import create_model
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    jax_tree_from_state_dict,
    state_dict_from_jax,
    unflatten_tree,
)
from pytorchvideo_accelerate_tpu_torch.serving import engine as tengine
from pytorchvideo_accelerate_tpu_torch.serving import quantize as tquant
from pytorchvideo_accelerate_tpu_torch.serving.stats import ServingStats
from pytorchvideo_accelerate_tpu_torch.trainer import checkpoint as tckpt

ATOL = 1e-5
NUM_CLASSES = 5
FRAMES, CROP = 4, 32


def _seed_flat(tree, seed):
    """numpy-seeded values for an abstract flax tree (He-scaled kernels,
    statistics away from identity)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, leaf in flatten_tree(tree).items():
        shape = leaf.shape
        if key.endswith("kernel") and len(shape) == 5:
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:4]))
        elif key.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif key.endswith(("scale", "var")):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.standard_normal(shape) * 0.1
        flat[key] = v.astype(np.float32)
    return flat


def _argv(name):
    return ["--model.name", name, "--model.num_classes", str(NUM_CLASSES),
            "--num_frames", str(FRAMES), "--data.crop_size", str(CROP),
            "--mixed_precision", "fp32", "--model.fused_kernels", "xla",
            "--serve.max_batch_size", "8"]


@functools.lru_cache(maxsize=None)
def _registry_flat(name):
    cfg = jcfg.parse_cli(_argv(name))
    model = jmodels.create_model(cfg.model, cfg.mixed_precision)
    spec = {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in
            jmodels.model_input_spec(cfg.model, cfg.data).items()}
    inputs = (spec["slow"], spec["fast"]) if "slow" in spec else spec["video"]
    tree = jax.eval_shape(lambda x: model.init(
        jax.random.PRNGKey(0), x, train=False), inputs)
    return _seed_flat(tree, seed=5)


FAMILIES = {
    "tiny3d": lambda: _registry_flat("tiny3d"),
    "slowfast_t": lambda: _registry_flat("slowfast_t"),
    "x3d": lambda: txc._seeded_flat("x3d"),
    "csn": lambda: txc._seeded_flat("csn"),
    "r2plus1d": lambda: tr2._seeded_flat(),
    "mvit_staged": lambda: tmv._seeded_flat("mvit_staged"),
    "videomae_t": lambda: tmv._seeded_flat("videomae_t"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantize_tree_is_byte_equal_to_jax(family):
    flat = FAMILIES[family]()
    jq, jn = jquant.quantize_tree(unflatten_tree(flat)["params"])
    tq, tn = tquant.quantize_tree(state_dict_from_jax(flat))
    assert tn == jn == tquant.quantized_leaf_count(tq) > 0
    want = flatten_tree({"params": jq})
    got = {k: v for k, v in flatten_tree(jax_tree_from_state_dict(tq)).items()
           if k.startswith("params/")}
    assert sorted(got) == sorted(want)  # the same selection
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == np.asarray(w).tobytes(), key


def test_selection_and_idempotence():
    flat = tmv._seeded_flat("mvit_staged")
    sd = state_dict_from_jax(flat)
    q, n = tquant.quantize_tree(sd)
    for name, v in q.items():
        leaf = name.rpartition(".")[2]
        big = np.ndim(sd[name]) >= 2 and np.size(sd[name]) >= tquant.MIN_QUANT_SIZE
        assert tquant.is_quant_leaf(v) == (leaf == "weight" and big), name
    assert not tquant.is_quant_leaf(q["pos_embed"])  # a free parameter
    q2, n2 = tquant.quantize_tree(q)
    assert n > 0 and n2 == 0
    for name, v in q.items():
        if tquant.is_quant_leaf(v):
            assert q2[name] is v
    # a zero channel must not divide by zero
    z = np.zeros((64, 4, 4, 4), np.float32)
    z[1:] = 1.0
    qz = tquant.quantize_array(z)
    assert np.all(qz["q8"][0] == 0) and qz["q8_scale"][0] == 1.0
    assert np.all(qz["q8"][1:] == 127)


def test_dequantize_error_is_half_a_step():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((24, 16, 3, 3, 3)).astype(np.float32)
    q = tquant.quantize_array(w)
    assert q["q8"].dtype == np.int8 and q["q8_scale"].shape == (24,)
    deq = tquant.dequantize_tree({"w.weight": q}, torch.float32)["w.weight"]
    bound = q["q8_scale"].reshape(-1, 1, 1, 1, 1) * 0.5 + 1e-7
    assert np.all(np.abs(deq.numpy() - w) < bound)
    assert np.all(np.abs(q["q8"]).max(axis=(1, 2, 3, 4)) == 127)


# --- artifacts and engines --------------------------------------------------


def _clips(n, seed=0, views=0):
    rng = np.random.default_rng(seed)
    shape = (n,) + ((views,) if views else ()) + (FRAMES, CROP, CROP, 3)
    return {"video": rng.standard_normal(shape).astype(np.float32)}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """JAX-baked fp and int8 tiny3d artifacts, and port-baked int8 and fp
    ones of the same weights."""
    root = tmp_path_factory.mktemp("quant")
    jax_cfg = jcfg.parse_cli(_argv("tiny3d"))
    variables = unflatten_tree(_registry_flat("tiny3d"))
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  ema_params=None, step=2)
    meta = {"num_classes": NUM_CLASSES, "model": "tiny3d"}
    out = {}
    for q in ("off", "int8"):
        out[f"jax_{q}"] = jckpt.export_inference(
            str(root / f"jax_{q}"), state, config=jax_cfg, meta=meta,
            quantization=q)
    port_cfg = tcfg.parse_cli(_argv("tiny3d"))
    model = create_model(port_cfg.model, "fp32")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_jax(_registry_flat("tiny3d")).items()})
    for q in ("off", "int8"):
        out[f"port_{q}"] = tckpt.export_inference(
            str(root / f"port_{q}"), model, port_cfg, meta=meta, step=2,
            quantization=q)
    return out


def _port_engine(art, **kw):
    return tengine.InferenceEngine.from_artifact(art, device="cpu", **kw)


@pytest.mark.parametrize("baked_by", ["jax", "port"])
def test_int8_artifacts_cross_both_ways(artifacts, baked_by):
    art = artifacts[f"{baked_by}_int8"]
    with open(os.path.join(art, "meta.json")) as f:
        assert json.load(f)["quantization"] == "int8"
    jeng = jengine.InferenceEngine.from_artifact(art)
    teng = _port_engine(art)
    assert jeng.quantization == teng.quantization == "int8"
    clips = _clips(8, seed=1)
    want = jeng.predict(clips)
    got = teng.predict(clips)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_port_and_jax_bake_the_same_bytes(artifacts):
    def weights(art):
        with np.load(os.path.join(art, "weights.npz")) as d:
            return {k: d[k] for k in d.files}

    want, got = weights(artifacts["jax_int8"]), weights(artifacts["port_int8"])
    assert sorted(got) == sorted(want)
    assert any(k.endswith("/q8") for k in want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX gate's fixture in the port: tiny3d trained 2 steps from its
    init by `run.main`, exported fp and baked int8
    (`--serve.quantization int8`)."""
    from pytorchvideo_accelerate_tpu_torch import run as trun

    root = tmp_path_factory.mktemp("trained")
    argv = ["--cpu", "--synthetic", "--model.name", "tiny3d",
            "--model.num_classes", "4", "--num_frames", str(FRAMES),
            "--data.crop_size", str(CROP), "--data.min_short_side_scale",
            str(CROP), "--data.max_short_side_scale", "40",
            "--batch_size", "2", "--num_epochs", "1",
            "--data.synthetic_num_videos", "4", "--mixed_precision", "fp32",
            "--model.dropout_rate", "0", "--checkpointing_steps", "1",
            "--output_dir", str(root / "run")]
    assert trun.main(argv)["steps"] == 2
    out = {}
    for q in ("off", "int8"):
        out[q] = str(root / q)
        trun.main(argv + ["--resume_from_checkpoint", "auto",
                          "--serve.quantization", q, "--export_inference", out[q]])
    return out


def test_int8_passes_the_jax_gate_and_baked_equals_on_the_fly(trained):
    fp = _port_engine(trained["off"])
    fly = _port_engine(trained["off"], quantization="int8")
    baked = _port_engine(trained["int8"])
    assert fp.quantization == "off" and fly.quantization == baked.quantization == "int8"
    q_fly = fly.model.state_dict()
    q_baked = baked.model.state_dict()
    assert sorted(q_fly) == sorted(q_baked)
    n_int8 = 0
    for k, v in q_fly.items():
        assert v.dtype == q_baked[k].dtype and torch.equal(v, q_baked[k]), k
        n_int8 += v.dtype == torch.int8
    assert n_int8 == tquant.quantized_leaf_count(
        tckpt.load_inference(trained["int8"])[0]) > 0
    clips = _clips(8, seed=7)
    lf, lq = fp.predict(clips), fly.predict(clips)
    np.testing.assert_array_equal(lq, baked.predict(clips))
    # the JAX package's gate (tests/test_zquant.py): top-1 agreement and
    # the weight-rounding envelope
    assert float((lf.argmax(-1) == lq.argmax(-1)).mean()) >= 0.75
    np.testing.assert_allclose(lq, lf, atol=5e-2, rtol=0)
    assert np.abs(lq - lf).max() > 0  # the weights really are int8


def test_baked_int8_never_serves_as_fp(artifacts):
    eng = _port_engine(artifacts["port_int8"], quantization="off")
    assert eng.quantization == "int8"
    with pytest.raises(ValueError, match="quantization"):
        _port_engine(artifacts["port_off"], quantization="int4")


def test_int8_padded_rows_and_views_through_the_scheduler(trained):
    fp = _port_engine(trained["off"], max_batch_size=4)
    q = _port_engine(trained["int8"], max_batch_size=4)
    views = [_clips(1, seed=10 + i, views=2)["video"][0] for i in range(3)]
    outs = {}
    for name, eng in (("fp", fp), ("q", q)):
        sched = Scheduler(eng, stats=ServingStats(),
                          realtime_deadline_ms=120_000.0)
        try:
            futs = [sched.submit({"video": v}, priority="batch") for v in views]
            outs[name] = [f.result(timeout=120) for f in futs]
        finally:
            sched.close()
        # three requests ride one padded bucket-4 launch: each answer is its
        # own row of a direct forward of the stacked, padded batch
        stacked = np.concatenate([np.stack(views), np.zeros_like(views[:1])])
        direct = eng.predict({"video": stacked})
        for i, got in enumerate(outs[name]):
            np.testing.assert_allclose(got, direct[i], atol=ATOL, rtol=0)
    for lf, lq in zip(outs["fp"], outs["q"]):
        assert lf.shape == lq.shape == (fp.num_classes,)
        np.testing.assert_allclose(lq, lf, atol=5e-2, rtol=0)
