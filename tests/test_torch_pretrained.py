"""The port's pretrained-weights path against the JAX package's, on the CPU.

Hub checkpoints are synthetic: every key and shape of a real one
(tests/hub_manifests.py, written independently of either converter) or of
a tiny twin (the JAX package's `torch_key_for` inverses; transformers'
VideoMAE classes), values drawn from a numpy seed. Held:

- conversion: the port's `convert_state_dict` gives the JAX package's flax
  tree bitwise (paths, arrays, dtypes) and the same `skipped` list; the
  tree covers the port model of the same name key for key, shape for shape;
- loading: each package's `load_pretrained` of one hub-layout file gives
  the same report and the same state bitwise; eval forwards within 1e-4
  of the logits' scale (f32, another summation order);
- the MViT position table resized 8 <-> 16 within 1e-6 of
  `jax.image.resize` (f32 rounding of the interpolation weights);
- artifacts: `.npz` files cross both ways unchanged; the port's safetensors
  reader equals `safetensors.numpy.load_file`; the two CLIs write the same;
- the Trainer: the JAX Trainer's state after load, the EMA starting from
  the loaded weights, `--freeze_backbone` steps at test_torch_train.py's
  tolerance (loss rtol 1e-4); the MAE pretrain -> fine-tune handoff; two
  ranks over gloo holding the same loaded weights.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu import models as jmodels
from pytorchvideo_accelerate_tpu.config import MeshConfig as JMeshConfig
from pytorchvideo_accelerate_tpu.config import ModelConfig as JModelConfig
from pytorchvideo_accelerate_tpu.config import parse_cli as jparse_cli
from pytorchvideo_accelerate_tpu.models import convert as jconvert
from pytorchvideo_accelerate_tpu.models.x3d import X3D as JX3D
from pytorchvideo_accelerate_tpu.parallel.mesh import make_mesh
from pytorchvideo_accelerate_tpu.parallel.sharding import shard_batch
from pytorchvideo_accelerate_tpu.trainer import optim as joptim
from pytorchvideo_accelerate_tpu.trainer import steps as jsteps
from pytorchvideo_accelerate_tpu.trainer.train_state import TrainState as JState
from pytorchvideo_accelerate_tpu_torch import models as tmodels
from pytorchvideo_accelerate_tpu_torch import run as trun
from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig, parse_cli
from pytorchvideo_accelerate_tpu_torch.models import convert as tconvert
from pytorchvideo_accelerate_tpu_torch.models.convert import (
    flatten_tree,
    jax_tree_from_state_dict,
    state_dict_from_jax,
)
from pytorchvideo_accelerate_tpu_torch.models.x3d import X3D
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from hub_manifests import MANIFESTS  # noqa: E402

HUB_CLASSES, NUM_CLASSES = 7, 5
FRAMES, CROP = 4, 32


def _same_tree(got: dict, want: dict) -> None:
    """Two nested numpy trees equal bitwise: paths, dtypes, shapes, values."""
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w), (sorted(set(g) ^ set(w)))[:8]
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _same_report(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"loaded", "kept", "mismatched", "interpolated"}
    for k in want:
        assert sorted(got[k]) == sorted(want[k]), k


# --- every hub manifest at full size -----------------------------------------


def _manifest_sd(name: str, seed: int = 0) -> dict:
    """A state_dict with exactly the hub checkpoint's keys and shapes."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in MANIFESTS[name]().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = np.array(0, np.int64)
        elif key.endswith("running_var"):
            sd[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            sd[key] = rng.standard_normal(shape, np.float32)
    return sd


# the port model a manifest loads into, and the clip geometry that sizes
# MViT's position table (the checkpoint's own)
GEOMETRY = {"mvit_b": (16, 224), "mvit_b_32x3": (32, 224)}


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_manifest_converts_like_jax(name):
    sd = _manifest_sd(name)
    family = jconvert.detect_model(sd)
    assert tconvert.detect_model(sd) == family
    want = jconvert.convert_state_dict(sd, name)
    got = tconvert.convert_state_dict(sd, name)
    assert got["skipped"] == want["skipped"] == []
    for coll in ("params", "batch_stats"):
        _same_tree(got[coll], want[coll])
    # the tree is the port model's state, key for key and shape for shape
    # (the model built on the meta device: shapes, no weights)
    frames, crop = GEOMETRY.get(name, (8, 224))
    with torch.device("meta"):
        model = tmodels.create_model(
            ModelConfig(name=name, num_classes=400), "fp32",
            data_cfg=DataConfig(num_frames=frames, crop_size=crop))
    converted = state_dict_from_jax({c: got[c] for c in ("params", "batch_stats")})
    state = model.state_dict()
    assert sorted(converted) == sorted(state)
    for k, v in state.items():
        assert converted[k].shape == tuple(v.shape), k


# --- transformers VideoMAE checkpoints ------------------------------------------


def _hf_config(**over):
    from transformers import VideoMAEConfig

    kw = dict(image_size=CROP, patch_size=8, num_channels=3, num_frames=FRAMES,
              tubelet_size=2, hidden_size=32, num_hidden_layers=4,
              num_attention_heads=2, intermediate_size=128,
              decoder_hidden_size=16, decoder_num_hidden_layers=2,
              decoder_num_attention_heads=2, decoder_intermediate_size=64,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
              num_labels=HUB_CLASSES)
    kw.update(over)
    return VideoMAEConfig(**kw)


def _seeded_like(sd: dict, seed: int) -> dict:
    """`sd`'s keys and shapes with numpy-seeded values: matrices and conv
    kernels at 1/sqrt(fan-in), norm scales in [0.5, 1.5], the rest 0.1
    normal (HF's own init is too small for the logits to mean much)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        if len(shape) >= 2:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif "norm" in k and k.endswith("weight"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.standard_normal(shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("kind,over", [
    ("VideoMAEModel", dict(use_mean_pooling=False)),
    ("VideoMAEForVideoClassification", {}),
    ("VideoMAEForVideoClassification", dict(use_mean_pooling=False)),
    ("VideoMAEForPreTraining", {})])
def test_videomae_checkpoints_convert_like_jax(kind, over):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = getattr(transformers, kind)(_hf_config(**over))
    sd = _seeded_like(hf.state_dict(), 1)
    assert tconvert.detect_model(sd) == jconvert.detect_model(sd) == "videomae_b"
    want = jconvert.convert_state_dict(sd, "videomae_b")
    got = tconvert.convert_state_dict(sd, "videomae_b")
    assert got["skipped"] == want["skipped"]
    for coll in ("params", "batch_stats"):
        _same_tree(got[coll], want[coll])
    # the fused qkv bias: [q_bias, 0, v_bias]
    qkv_b = flatten_tree(got["params"])["encoder/block0/qkv/bias"]
    np.testing.assert_array_equal(qkv_b[32:64], np.zeros(32, np.float32))


# --- the tiny twins through each package's load_pretrained ------------------------

# (registry name of the twin or "x3d_twin", family passed to load_pretrained)
FAMILY = {"tiny3d": "tiny3d", "slowfast_t": "slowfast_t", "x3d_twin": "x3d_s",
          "mvit_t": "mvit_t", "videomae_t": "videomae_t"}
X3D_TWIN = dict(depths=(3, 2), stem_features=8, stage_features=(8, 16),
                head_features=32)


def _clips(name, batch, seed):
    rng = np.random.default_rng(seed)
    if name.startswith("slowfast"):
        return {"slow": rng.standard_normal((batch, 1, CROP, CROP, 3), np.float32),
                "fast": rng.standard_normal((batch, FRAMES, CROP, CROP, 3), np.float32)}
    return {"video": rng.standard_normal((batch, FRAMES, CROP, CROP, 3), np.float32)}


def _inputs(clips, as_torch: bool):
    c = {k: torch.from_numpy(v) for k, v in clips.items()} if as_torch else clips
    return (c["slow"], c["fast"]) if "slow" in c else c["video"]


def _jax_twin(name, num_classes=HUB_CLASSES):
    if name == "x3d_twin":
        return JX3D(num_classes=num_classes, dropout_rate=0.0, **X3D_TWIN)
    return jmodels.create_model(JModelConfig(
        name=name, num_classes=num_classes, dropout_rate=0.0), "fp32")


def _port_twin(name, num_classes=HUB_CLASSES, frames=FRAMES):
    if name == "x3d_twin":
        return X3D(num_classes, dropout_rate=0.0, **X3D_TWIN)
    return tmodels.create_model(
        ModelConfig(name=name, num_classes=num_classes, dropout_rate=0.0), "fp32",
        data_cfg=DataConfig(num_frames=frames, crop_size=CROP))


def _cnn(name):
    return name in ("tiny3d", "slowfast_t", "x3d_twin")


@functools.lru_cache(maxsize=None)
def _jax_variables(name):
    """The JAX twin's variable tree at the test geometry, as numpy zeros (a
    merge target: every leaf the tests compare comes from a checkpoint)."""
    key = jax.random.PRNGKey(0)
    x = _inputs(_clips(name, 1, 0), as_torch=False)
    kw = {"train": False} if _cnn(name) else {}
    shapes = jax.eval_shape(lambda k, x: _jax_twin(name).init(
        {"params": k, "dropout": k, "mask": k}, x, **kw), key, x)
    return jax.tree.map(lambda v: np.zeros(v.shape, v.dtype), shapes)


def _seeded_flax(key: str, shape, rng) -> np.ndarray:
    if key.endswith("kernel") and len(shape) == 5:
        v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:4]))
    elif key.endswith("kernel"):
        v = rng.standard_normal(shape) / np.sqrt(shape[0])
    elif key.endswith("scale") or key.endswith("var"):
        v = rng.uniform(0.5, 1.5, shape)
    else:  # biases, means
        v = rng.standard_normal(shape) * 0.1
    return v.astype(np.float32)


def _cnn_hub_sd(name, seed=3):
    """The twin's checkpoint in the hub layout, through the JAX package's
    `torch_key_for` inverse, BN `num_batches_tracked` included."""
    rng = np.random.default_rng(seed)
    sd = {}
    for coll in ("params", "batch_stats"):
        for key, leaf in flatten_tree(_jax_variables(name)[coll]).items():
            path = tuple(key.split("/"))
            tkey = jconvert.torch_key_for(coll, path, FAMILY[name])
            assert tkey is not None, key
            sd[tkey] = jconvert.export_tensor(path, _seeded_flax(key, leaf.shape, rng))
            if tkey.endswith("running_mean"):
                sd[tkey.replace("running_mean", "num_batches_tracked")] = np.array(3)
    return sd


# MViT's flax leaf names -> pytorchvideo's
_MVIT_TORCH = {"norm1": "norm1", "norm2": "norm2", "attn/qkv": "attn.qkv",
               "attn/proj": "attn.proj", "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2",
               "skip_proj": "proj"}


def _mvit_hub_sd(seed=3):
    """mvit_t in pytorchvideo's layout: separable position tables and a CLS
    table, per-head (head_dim, 1, 3, 3, 3) pool kernels and LayerNorms."""
    rng = np.random.default_rng(seed)
    params = flatten_tree(_jax_variables("mvit_t")["params"])
    _, t, h, w, c = params["pos_embed"].shape
    sd = {"cls_positional_encoding.pos_embed_spatial": rng.standard_normal((1, h * w, c)),
          "cls_positional_encoding.pos_embed_temporal": rng.standard_normal((1, t, c)),
          "cls_positional_encoding.pos_embed_class": rng.standard_normal((1, 1, c))}
    for key, leaf in params.items():
        if key == "pos_embed":
            continue
        *path, leaf_name = key.split("/")
        value = jconvert.export_tensor(tuple(key.split("/")),
                                       _seeded_flax(key, leaf.shape, rng))
        tleaf = "weight" if leaf_name in ("kernel", "scale") else "bias"
        stem = "/".join(path)
        if stem in ("patch_embed", "norm"):
            tkey = {"patch_embed": "patch_embed.patch_model", "norm": "norm"}[stem]
        elif stem == "head":
            tkey = "head.proj"
        else:
            block, rest = path[0], "/".join(path[1:])
            i = int(block.replace("block", ""))
            if rest.endswith("/pool"):  # tiled over heads: one head's kernel
                hd = params[f"{block}/{rest[:-len('pool')]}norm/scale"].shape[0]
                value = value[:hd]
                tkey = f"blocks.{i}.attn.{rest.split('/')[1]}"
            elif rest.endswith("/norm"):
                tkey = f"blocks.{i}.attn.norm_{rest.split('/')[1][-1]}"
            else:
                tkey = f"blocks.{i}.{_MVIT_TORCH[rest]}"
        sd[f"{tkey}.{tleaf}"] = value
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _hub_file(name, tmp_path) -> str:
    """The twin's hub-layout checkpoint on disk: CNNs as `.pth` (SlowFast
    under a `model_state` wrapper), MViT as `.pt`, VideoMAE (a transformers
    classifier) as `.safetensors`."""
    if name == "videomae_t":
        from safetensors.torch import save_file
        transformers = pytest.importorskip("transformers")
        torch.manual_seed(0)
        hf = transformers.VideoMAEForVideoClassification(_hf_config())
        path = str(tmp_path / "videomae.safetensors")
        save_file({k: torch.from_numpy(v) for k, v in
                   _seeded_like(hf.state_dict(), 4).items()}, path)
        return path
    sd = _mvit_hub_sd() if name == "mvit_t" else _cnn_hub_sd(name)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    if name == "slowfast_t":
        sd = {"model_state": sd}
    path = str(tmp_path / (f"{name}.pt" if name == "mvit_t" else f"{name}.pth"))
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_hub_checkpoint_loads_and_forwards_like_jax(name, tmp_path):
    path = _hub_file(name, tmp_path)
    jmerged, jreport = jconvert.load_pretrained(path, _jax_variables(name),
                                                model=FAMILY[name])
    model = _port_twin(name)
    report = tconvert.load_pretrained(path, model, FAMILY[name])
    _same_report(report, jreport)
    assert report["kept"] == report["mismatched"] == report["interpolated"] == []
    want = state_dict_from_jax(jax.device_get(jmerged))
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    clips = _clips(name, 2, 5)
    kw = {"train": False} if _cnn(name) else {}
    jlogits = np.asarray(jax.jit(lambda v, x: _jax_twin(name).apply(v, x, **kw))(
        jmerged, _inputs(clips, as_torch=False)))
    with torch.no_grad():
        logits = model.eval()(_inputs(clips, as_torch=True)).numpy()
    scale = max(1.0, float(np.abs(jlogits).max()))
    assert np.abs(jlogits).max() > 0.1
    np.testing.assert_allclose(logits, jlogits, atol=1e-4 * scale, rtol=0)


def test_swapped_head_is_mismatched_and_kept_fresh(tmp_path):
    """A head of another class count keeps its fresh init in both packages
    (the reference's head swap); every other leaf loads."""
    path = _hub_file("slowfast_t", tmp_path)
    model = _port_twin("slowfast_t", num_classes=NUM_CLASSES)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    report = tconvert.load_pretrained(path, model)  # family detected
    jvars = jax.tree.map(np.copy, _jax_variables("slowfast_t"))
    head = jvars["params"]["head"]["proj"]
    head["kernel"], head["bias"] = head["kernel"][:, :NUM_CLASSES], head["bias"][:NUM_CLASSES]
    _, jreport = jconvert.load_pretrained(path, jvars)
    _same_report(report, jreport)
    assert sorted(report["mismatched"]) == ["params/head/proj/bias",
                                            "params/head/proj/kernel"]
    for k in ("head.proj.weight", "head.proj.bias"):
        assert torch.equal(model.state_dict()[k], fresh[k])


# --- the position table ---------------------------------------------------------


@pytest.mark.parametrize("src_frames,dst_frames", [(16, 32), (32, 16)])
def test_pos_embed_resize_matches_jax_image_resize(src_frames, dst_frames, tmp_path):
    """MViT fine-tuned at another clip length: the (1, T, H, W, C) table is
    resized 8 -> 16 (and 16 -> 8) exactly as the JAX package resizes it."""
    src = _port_twin("mvit_t", frames=src_frames)
    npz = str(tmp_path / "mvit.npz")
    tconvert.save_converted(jax_tree_from_state_dict(src.state_dict()), npz)
    table = src.pos_embed.detach().numpy()
    model = _port_twin("mvit_t", frames=dst_frames)
    report = tconvert.load_pretrained(npz, model)
    assert report["interpolated"] == [
        f"params/pos_embed {table.shape[1:4]}->{tuple(model.pos_embed.shape[1:4])}"]
    assert report["kept"] == report["mismatched"] == []
    want = np.asarray(jax.image.resize(jnp.asarray(table), model.pos_embed.shape,
                                       "trilinear", antialias=False))
    np.testing.assert_allclose(model.pos_embed.detach().numpy(), want, atol=1e-6, rtol=0)
    # and the JAX package's own merge reports the same
    jm = jmodels.create_model(JModelConfig(name="mvit_t", num_classes=HUB_CLASSES), "fp32")
    jvars = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros(
        (1, dst_frames, CROP, CROP, 3), jnp.float32)))
    jmerged, jreport = jconvert.load_pretrained(npz, jvars)
    _same_report(report, jreport)
    np.testing.assert_allclose(model.pos_embed.detach().numpy(),
                               np.asarray(jmerged["params"]["pos_embed"]),
                               atol=1e-6, rtol=0)


# --- artifacts and files ----------------------------------------------------------


def test_npz_artifacts_cross_both_ways(tmp_path):
    sd = _cnn_hub_sd("slowfast_t")
    tree = jconvert.convert_state_dict(sd, "slowfast_t")
    jconvert.save_converted(tree, str(tmp_path / "jax.npz"))
    tconvert.save_converted(tconvert.convert_state_dict(sd, "slowfast_t"),
                            str(tmp_path / "port.npz"))
    for name in ("jax.npz", "port.npz"):
        path = str(tmp_path / name)
        _same_tree(tconvert.load_converted(path), jconvert.load_converted(path))
        _same_tree(tconvert.load_converted(path),
                   {c: tree[c] for c in ("params", "batch_stats")})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_matches_the_library(dtype, tmp_path):
    pytest.importorskip("safetensors")
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    sd = {"w": torch.randn(4, 3, 2, generator=g).to(dtype),
          "b": torch.randn(5, generator=g).to(dtype),
          "s": torch.randn((), generator=g).to(dtype),
          "n": torch.arange(6, dtype=torch.int64).reshape(2, 3),
          "m": torch.tensor([True, False])}
    path = str(tmp_path / "w.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got = tconvert.read_safetensors(path)
    # the JAX package's reader widens bf16 to float32, as the port's does
    want = (jconvert.load_torch_state_dict(path) if dtype == torch.bfloat16
            else load_file(path))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["w"], sd["w"].float().numpy())
    assert tconvert.load_torch_state_dict(path).keys() == got.keys()


def test_safetensors_reader_refuses_a_truncated_file(tmp_path):
    from safetensors.torch import save_file

    path = str(tmp_path / "w.safetensors")
    save_file({"w": torch.zeros(64)}, path)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:-8])
    with pytest.raises(ValueError, match="offsets"):
        tconvert.read_safetensors(path)


def test_cli_writes_what_the_jax_cli_writes(tmp_path, capsys):
    path = _hub_file("slowfast_t", tmp_path)
    jconvert.main([path, str(tmp_path / "jax.npz"), "--model", "slowfast_r50"])
    tconvert.main([path, str(tmp_path / "port.npz"), "--model", "slowfast_r50"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace("jax.npz", "X") == lines[1].replace("port.npz", "X")
    with np.load(str(tmp_path / "jax.npz")) as a, np.load(str(tmp_path / "port.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_cli_maps_nothing_and_leaves_dst_alone(tmp_path):
    src = str(tmp_path / "other.pth")
    torch.save({"encoder.weight": torch.zeros(3, 3)}, src)
    dst = tmp_path / "good.npz"
    dst.write_bytes(b"a good artifact")
    with pytest.raises(SystemExit) as e:
        tconvert.main([src, str(dst), "--model", "slow_r50"])
    assert e.value.code not in (0, None)
    assert dst.read_bytes() == b"a good artifact"


# --- the Trainer --------------------------------------------------------------


def _run_argv(name, out, extra=()):
    return ["--cpu", "--synthetic", "--model.name", name, "--num_frames", str(FRAMES),
            "--data.crop_size", str(CROP), "--data.min_short_side_scale", "32",
            "--data.max_short_side_scale", "40", "--batch_size", "2",
            "--data.synthetic_num_videos", "8", "--num_workers", "1",
            "--mixed_precision", "fp32", "--model.num_classes", str(NUM_CLASSES),
            "--model.dropout_rate", "0", "--output_dir", out, *extra]


def _jax_argv(argv):
    """The same run for the JAX Trainer: its `--batch_size` is per device
    (the test harness has 8), so 1 there is the port's global batch 8."""
    i = argv.index("--batch_size")
    return argv[:i] + ["--batch_size", "1"] + argv[i + 2:]


def _flax_state(model) -> dict:
    return flatten_tree(jax_tree_from_state_dict(model.state_dict()))


def _shape_only_jax_init(monkeypatch, name):
    """The JAX Trainer initialises its model eagerly, one XLA compile per op
    (~40 s for slowfast_t on a CPU); give it zeros of the init's shapes
    (`jax.eval_shape`) instead. Only the fresh leaves' values differ, and no
    check here reads them."""
    cls = type(jmodels.create_model(JModelConfig(name=name), "fp32"))
    eager = cls.init

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda r, *a: eager(self, r, *a, **kw), rngs, *args)
        return jax.tree.map(lambda v: jnp.zeros(v.shape, v.dtype), shapes)

    monkeypatch.setattr(cls, "init", init)


@pytest.mark.parametrize("name", ["slowfast_t", "mvit_t"])
def test_trainer_loads_like_the_jax_trainer_and_freezes(name, tmp_path, monkeypatch):
    """Both Trainers load the CLI's artifact of a hub checkpoint whose head
    has 7 classes into a 5-class run: the same leaves, bitwise, the EMA
    starting from them; then two `--freeze_backbone` steps against the JAX
    step from the same state."""
    from pytorchvideo_accelerate_tpu.trainer.loop import Trainer as JTrainer

    _shape_only_jax_init(monkeypatch, name)
    npz = str(tmp_path / "w.npz")
    tconvert.main([_hub_file(name, tmp_path), npz, "--model", FAMILY[name]])
    argv = _run_argv(name, str(tmp_path / "out"), [
        "--model.pretrained", "--model.pretrained_path", npz,
        "--freeze_backbone", "--optim.ema_decay", "0.9"])
    tr = Trainer(parse_cli(argv))
    jt = JTrainer(jparse_cli(_jax_argv(argv)))
    try:
        report = tr.pretrained_report
        head = ("params/head/kernel", "params/head/bias") if name == "mvit_t" else (
            "params/head/proj/kernel", "params/head/proj/bias")
        assert sorted(report["mismatched"]) == sorted(head)
        assert report["kept"] == report["interpolated"] == []
        saved = flatten_tree(tconvert.load_converted(npz))
        got = _flax_state(tr.model)
        want = flatten_tree(jax.device_get({"params": jt.state.params,
                                            "batch_stats": jt.state.batch_stats}))
        assert sorted(report["loaded"]) == sorted(set(got) - set(head))
        for k in report["loaded"]:
            np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
            np.testing.assert_array_equal(want[k], saved[k], err_msg=k)
        # the EMA starts from the loaded weights, on both sides
        for n, p in tr.model.named_parameters():
            assert torch.equal(tr.state.ema[n], p.detach()), n
        for a, b in zip(jax.tree.leaves(jax.device_get(jt.state.ema_params)),
                        jax.tree.leaves(jax.device_get(jt.state.params))):
            np.testing.assert_array_equal(a, b)

        # two frozen steps from the port's state after load, both sides
        s0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
        jcfg = jparse_cli(_jax_argv(argv)).optim
        jm = jmodels.create_model(JModelConfig(name=name, num_classes=NUM_CLASSES,
                                               dropout_rate=0.0), "fp32")
        tree = jax_tree_from_state_dict(s0)
        tx = joptim.build_optimizer(jcfg, tr.total_steps,
                                    backbone_filter=type(jm).backbone_param_filter,
                                    freeze_backbone=True)
        jstate = JState.create(jax.tree.map(jnp.asarray, tree["params"]),
                               jax.tree.map(jnp.asarray, tree["batch_stats"]), tx)
        mesh = make_mesh(JMeshConfig(data=1), devices=jax.devices()[:1])
        jstep = jsteps.make_train_step(
            jm, tx, mesh, label_smoothing=jcfg.label_smoothing,
            lr_schedule=joptim.build_lr_schedule(jcfg, tr.total_steps))
        rng = np.random.default_rng(8)
        for i in range(2):
            batch = {**_clips(name, 4, 20 + i),
                     "label": rng.integers(0, NUM_CLASSES, 4).astype(np.int32)}
            jstate, jm_i = jstep(jstate, shard_batch(mesh, batch), jax.random.key(i))
            tm_i = tr.train_step(tr.state, {k: torch.from_numpy(v) for k, v in batch.items()})
            np.testing.assert_allclose(float(tm_i["loss"]), float(jm_i["loss"]),
                                       rtol=1e-4, atol=1e-7)
        frozen = type(tr.model).backbone_param_filter
        for n, p in tr.model.named_parameters():
            moved = not torch.equal(p.detach(), s0[n])
            assert moved != frozen(tuple(n.split("."))), n
    finally:
        tr.close()
        jt.close()


def test_pretrained_path_without_pretrained_is_ignored(tmp_path, capsys):
    npz = str(tmp_path / "w.npz")
    tconvert.main([_hub_file("slowfast_t", tmp_path), npz])
    fresh = Trainer(parse_cli(_run_argv("slowfast_t", str(tmp_path / "a"))))
    tr = Trainer(parse_cli(_run_argv("slowfast_t", str(tmp_path / "b"), [
        "--model.pretrained_path", npz])))
    assert "--model.pretrained_path set without --model.pretrained" in capsys.readouterr().out
    assert tr.pretrained_report is None
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k
    fresh.close()
    tr.close()


def test_evaluate_warns_on_random_weights(tmp_path, caplog):
    argv = _run_argv("tiny3d", str(tmp_path / "e"), ["--data.limit_val_batches", "1"])
    with caplog.at_level("WARNING"):
        Trainer(parse_cli(argv)).evaluate()
    assert "scoring freshly-initialized random weights" in caplog.text


def test_mae_handoff_pretrain_export_finetune(tmp_path, capsys, monkeypatch):
    """videomae_t_pretrain -> its checkpoint -> the CLI's artifact ->
    videomae_t: the encoder loads bitwise, the classifier head stays fresh;
    the same artifact loads into the JAX Trainer."""
    from pytorchvideo_accelerate_tpu.trainer.loop import Trainer as JTrainer

    _shape_only_jax_init(monkeypatch, "videomae_t")

    res = trun.main(_run_argv("videomae_t_pretrain", str(tmp_path / "pre"), [
        "--num_epochs", "1", "--data.limit_train_batches", "2",
        "--checkpointing_steps", "2"]))
    ckpt_dir = str(tmp_path / "pre" / "checkpoints")
    npz = str(tmp_path / "mae.npz")
    tconvert.main([ckpt_dir, npz])
    assert f"exported params of step {res['steps']} from" in capsys.readouterr().out
    saved = flatten_tree(tconvert.load_converted(npz))
    ckpt = torch.load(os.path.join(ckpt_dir, str(res["steps"]), "state.pt"),
                      weights_only=True)
    _same_tree(tconvert.load_converted(npz), jax_tree_from_state_dict(ckpt["model"]))

    argv = _run_argv("videomae_t", str(tmp_path / "ft"), [
        "--model.pretrained", "--model.pretrained_path", npz,
        "--num_epochs", "1", "--data.limit_train_batches", "1"])
    tr = Trainer(parse_cli(argv))
    report = tr.pretrained_report
    now = _flax_state(tr.model)
    encoder = sorted(k for k in now if k.startswith("params/encoder/"))
    assert sorted(report["loaded"]) == encoder
    assert report["kept"] and not any(k.startswith("params/encoder/")
                                      for k in report["kept"])
    assert report["mismatched"] == report["interpolated"] == []
    for k in encoder:
        np.testing.assert_array_equal(now[k], saved[k], err_msg=k)
    assert np.isfinite(tr.fit()["train_loss"])

    jt = JTrainer(jparse_cli(_jax_argv(argv)))
    jflat = flatten_tree(jax.device_get({"params": jt.state.params}))
    jt.close()
    for k in encoder:
        np.testing.assert_array_equal(jflat[k], saved[k], err_msg=k)


def test_two_ranks_hold_the_loaded_weights(tmp_path):
    """World 2 over gloo, each rank seeded apart: both hold the file's
    tensors and rank 0's fresh head."""
    from _torch_dp_worker import run_group

    path = str(tmp_path / "hub.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                _cnn_hub_sd("tiny3d").items()}, path)
    r0, r1 = run_group("pretrained", tmp_path)
    model = _port_twin("tiny3d", num_classes=4)  # the synthetic default
    report = tconvert.load_pretrained(path, model)
    _same_report(r0["report"], report)
    assert sorted(report["mismatched"]) == ["params/head/proj/bias",
                                            "params/head/proj/kernel"]
    assert sorted(r0["state"]) == sorted(r1["state"]) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k], err_msg=k)
        if not k.startswith("head."):
            np.testing.assert_array_equal(r0["state"][k], v.numpy(), err_msg=k)
    seed1 = tmodels.create_model(ModelConfig(name="tiny3d", num_classes=4), "fp32",
                                 seed=1)
    assert not np.array_equal(r1["state"]["head.proj.weight"],
                              seed1.state_dict()["head.proj.weight"].numpy())
