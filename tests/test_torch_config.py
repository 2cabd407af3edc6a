"""The PyTorch port's config and import boundary.

- The same argv parses to the same `to_dict()` tree in the JAX package and in
  the port, and an artifact's `meta.json["config"]` loads the same way on
  both sides.
- No module of the port and nothing in `chip_smoke.py` imports jax, flax,
  optax, orbax, chex, ml_dtypes, cv2 or the JAX package (an AST walk, so
  nothing is executed); the card's machine has none of them.
"""

import ast
import pathlib

import pytest

from pytorchvideo_accelerate_tpu import config as jcfg
from pytorchvideo_accelerate_tpu_torch import config as tcfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "pytorchvideo_accelerate_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "ml_dtypes",
             "cv2", "pytorchvideo_accelerate_tpu")

ARGVS = [
    [],
    ["--model.name", "slowfast_r50", "--model.num_classes", "700",
     "--num_frames", "32", "--data.crop_size", "256", "--data.host_cast", "u8",
     "--mixed_precision", "bf16", "--model.fused_kernels", "auto"],
    ["--is_slowfast", "--lr", "0.05", "--batch_size", "4", "--cpu"],
    ["--serve.scheduler=micro", "--serve.max_batch_size", "16",
     "--serve.port", "0", "--serve.max_wait_ms", "2.5"],
    ["--data.mean", "0.4,0.5,0.6", "--obs.enabled", "false",
     "--model.fused_kernels", "xla", "--mixed_precision", "fp32"],
    ["--model_name", "tiny3d", "--pin_memory", "--seed", "7",
     "--eval_num_clips", "2"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[str(i) for i in range(len(ARGVS))])
def test_same_argv_same_config_tree(argv):
    assert tcfg.parse_cli(argv).to_dict() == jcfg.parse_cli(argv).to_dict()


@pytest.mark.parametrize("argv", ARGVS[1:4], ids=["sf", "alias", "serve"])
def test_artifact_config_loads_the_same_both_ways(argv):
    jtree = jcfg.parse_cli(argv).to_dict()
    ttree = tcfg.parse_cli(argv).to_dict()
    assert tcfg.config_from_dict(jtree).to_dict() == jtree
    assert jcfg.config_from_dict(ttree).to_dict() == ttree


@pytest.mark.parametrize("argv", [["--no_such_flag", "1"],
                                  ["--serve.typo", "1"],
                                  ["--serve.port", "not-a-port"]])
def test_bad_flags_fail_on_both_sides(argv):
    with pytest.raises(SystemExit):
        jcfg.parse_cli(argv)
    with pytest.raises(SystemExit):
        tcfg.parse_cli(argv)


# a module the card's machine lacks, imported by one port file only, and
# only optionally (inside `try: ... except ImportError`): decode uses cv2
# where it is; without it decode raises and names the frame-cache route
OPTIONAL = {"cv2": "pytorchvideo_accelerate_tpu_torch/data/decode.py"}


def _imports(path):
    """(module, optional) of every absolute import in `path`: optional when
    the import sits in the body of a `try` that catches ImportError."""
    tree = ast.parse(path.read_text(), filename=str(path))
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                isinstance(h.type, ast.Name) and h.type.id == "ImportError"
                for h in node.handlers):
            guarded.update(id(n) for stmt in node.body for n in ast.walk(stmt))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in guarded
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module, id(node) in guarded


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    rel = str(path.relative_to(ROOT))
    bad = [m for m, optional in _imports(path) if m.split(".")[0] in FORBIDDEN
           and not (optional and OPTIONAL.get(m.split(".")[0]) == rel)]
    assert not bad, f"{rel} imports {bad}"
