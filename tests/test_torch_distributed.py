"""The port's process group, host collectives and launcher
(`parallel/distributed.py`, `parallel/collectives.py`, `parallel/mesh.py`,
`launch.py`) on the CPU over gloo, against the JAX package's.

Groups of two ranks run as spawned processes (`tests/_torch_dp_worker.py`)
on a FileStore under the test's tmp_path, so parallel test workers never
race for a port; the scenario that joins through the launcher's `PVA_*`
env, and the launcher's own runs, take a free TCP port as the JAX
package's launcher tests do. Every group has a deadline: a hang fails in
seconds. At one process the host collectives return what the JAX
package's return there (a leading axis of 1, numpy leaves).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from _torch_dp_worker import run_group
from pytorchvideo_accelerate_tpu.config import MeshConfig as JMeshConfig
from pytorchvideo_accelerate_tpu.parallel import collectives as jcoll
from pytorchvideo_accelerate_tpu.parallel import mesh as jmesh
from pytorchvideo_accelerate_tpu_torch import launch as tlaunch
from pytorchvideo_accelerate_tpu_torch.config import MeshConfig
from pytorchvideo_accelerate_tpu_torch.parallel import collectives as tcoll
from pytorchvideo_accelerate_tpu_torch.parallel import distributed as tdist
from pytorchvideo_accelerate_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PVA_ENV = ("PVA_COORDINATOR_ADDRESS", "PVA_NUM_PROCESSES", "PVA_PROCESS_ID")


# --- the launcher -------------------------------------------------------------


def test_build_commands_default_module_and_script():
    cmds = tlaunch.build_commands(2, ["--cpu", "--synthetic"])
    assert cmds == [[sys.executable, "-m", "pytorchvideo_accelerate_tpu_torch.run",
                     "--cpu", "--synthetic"]] * 2
    assert tlaunch.build_commands(1, ["train.py", "--flag"]) == [
        [sys.executable, "train.py", "--flag"]]


def test_find_free_port_is_bindable():
    port = tlaunch.find_free_port()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


def _script(tmp_path, body: str) -> str:
    path = tmp_path / "prog.py"
    path.write_text("import os, sys, time\nrank = int(os.environ['PVA_PROCESS_ID'])\n"
                    + body)
    return str(path)


def test_a_failing_rank_ends_the_group_with_its_exit_code(tmp_path):
    """Rank 1 exits 3 while rank 0 would sleep a minute: the group ends at
    once with 3, the sleeper terminated."""
    prog = _script(tmp_path, "time.sleep(60) if rank == 0 else sys.exit(3)\n")
    t0 = __import__("time").monotonic()
    assert tlaunch.launch(2, [prog], timeout=50) == 3
    assert __import__("time").monotonic() - t0 < 30


def test_the_group_deadline_gives_124(tmp_path):
    prog = _script(tmp_path, "time.sleep(60)\n")
    assert tlaunch.launch(2, [prog], timeout=1.5) == 124


def test_max_restarts_recovers_a_flaky_rank(tmp_path):
    """Rank 1 fails on the first attempt only (a marker file remembers):
    no restart returns its code, one restart succeeds; every rank sees the
    PVA_* contract."""
    marker = tmp_path / "attempted"
    prog = _script(tmp_path, (
        f"assert os.environ['PVA_NUM_PROCESSES'] == '2'\n"
        f"assert os.environ['PVA_COORDINATOR_ADDRESS'].startswith('127.0.0.1:')\n"
        f"if rank == 1 and not os.path.exists({str(marker)!r}):\n"
        f"    open({str(marker)!r}, 'w').close()\n"
        f"    sys.exit(5)\n"))
    assert tlaunch.launch(2, [prog], timeout=60, max_restarts=0) == 5
    marker.unlink()
    assert tlaunch.launch(2, [prog], timeout=60, max_restarts=1) == 0
    with pytest.raises(ValueError, match="max_restarts"):
        tlaunch.launch(2, [prog], max_restarts=-1)
    with pytest.raises(ValueError, match="num_processes"):
        tlaunch.main(["--num_processes", "0", "--", prog])


def test_launch_trains_slowfast_t_data_parallel_on_the_cpu(tmp_path):
    """`python -m pytorchvideo_accelerate_tpu_torch.launch --num_processes 2
    -- --cpu ...` trains slowfast_t end to end: two ranks over gloo, the
    global batch 2 x 2, one checkpoint written by rank 0, eval summed over
    both ranks, and `--debug_desync` finding the replicas equal."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "pytorchvideo_accelerate_tpu_torch.launch",
           "--num_processes", "2", "--timeout", "150", "--",
           "--cpu", "--synthetic", "--model.name", "slowfast_t", "--num_frames", "4",
           "--data.crop_size", "32", "--data.min_short_side_scale", "32",
           "--data.max_short_side_scale", "40", "--batch_size", "2",
           "--data.synthetic_num_videos", "16", "--num_epochs", "1",
           "--data.num_workers", "1", "--mixed_precision", "fp32",
           "--checkpointing_steps", "epoch", "--debug_desync",
           "--output_dir", str(out)]
    env = {k: v for k, v in os.environ.items() if k not in PVA_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=200)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    assert "distributed: 2 processes over gloo" in log, log[-4000:]
    # the JAX trainer's mesh line; no model axis to name at model 1
    assert "mesh: {'data': 2, 'model': 1} over 2 cpu devices, 2 process(es)\n" in log
    assert "epoch 0: val_acc=" in log
    # rank 0 alone logs; the other rank's lines carry its prefix
    assert "[rank 1] epoch 0" not in log
    ckpts = sorted(os.listdir(out / "checkpoints"))
    assert ckpts == ["4"], ckpts  # 16 clips / (2 x 2) a step


# --- env resolution, init, host collectives -----------------------------------


def test_single_process_resolution_is_a_no_op(monkeypatch):
    for key in PVA_ENV:
        monkeypatch.delenv(key, raising=False)
    assert tdist.initialize_distributed() is False
    monkeypatch.setenv("PVA_NUM_PROCESSES", "1")
    monkeypatch.setenv("PVA_COORDINATOR_ADDRESS", "127.0.0.1:1")
    assert tdist.initialize_distributed(cpu=True) is False
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)
    assert tdist.is_main_process() and not tdist.is_distributed()
    tdist.sync_global_devices()
    tdist.check_desync(float("nan"))
    assert tdist.any_process(True) and not tdist.any_process(False)


@pytest.mark.parametrize("kw,env,match", [
    (dict(num_processes=2), {}, "needs a coordinator address"),
    ({}, {"PVA_NUM_PROCESSES": "3", "PVA_COORDINATOR_ADDRESS": "127.0.0.1:1"},
     r"process_id must be in \[0, 3\)"),
    (dict(coordinator_address="127.0.0.1:1", num_processes=2, process_id=2), {},
     r"process_id must be in \[0, 2\)")])
def test_incomplete_multi_process_settings_raise(kw, env, match, monkeypatch):
    for key in PVA_ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match=match):
        tdist.initialize_distributed(cpu=True, **kw)
    assert not tdist.is_distributed()


def test_env_contract_joins_once(tmp_path):
    """Two ranks given only the launcher's PVA_* env join one gloo group
    (CPU), each at its PVA_PROCESS_ID; a second call is a no-op, and a
    string broadcast carries rank 0's value."""
    env = {"PVA_COORDINATOR_ADDRESS": f"127.0.0.1:{tlaunch.find_free_port()}",
           "PVA_NUM_PROCESSES": "2"}
    outs = run_group("env", tmp_path, env=env, timeout_s=120)
    for r, out in enumerate(outs):
        assert out["joined"] and out["again"]
        assert (out["rank"], out["world"], out["backend"]) == (r, 2, "gloo")
        assert out["main"] == (r == 0)
        assert out["name"] == "from-0"


def _jax_host(fn, x):
    return jax.tree.map(np.asarray, fn(x))


def test_host_collectives_at_one_process_match_jax():
    x = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
         "b": [np.float32(1.5), np.ones(2, np.float64)]}
    for tfn, jfn in ((tcoll.host_allgather, jcoll.host_allgather),
                     (tcoll.host_reduce_sum, jcoll.host_reduce_sum)):
        got, want = tfn(x), _jax_host(jfn, x)
        got_l, _ = tcoll._flatten(got)
        want_l = jax.tree.leaves(want)
        assert len(got_l) == len(want_l)
        for g, w in zip(got_l, want_l):
            assert isinstance(g, np.ndarray) and g.shape == w.shape
            # the JAX package's arrays are canonicalised (no x64: float64
            # comes back float32); the port keeps the leaf's own dtype
            assert jax.dtypes.canonicalize_dtype(g.dtype) == w.dtype
            np.testing.assert_array_equal(g, w)
    y = {"n": np.int64(7), "v": np.arange(3.0), "s": "run-é", "raw": b"\x00\x01"}
    got, want = tcoll.host_broadcast(y), jcoll.host_broadcast(y)
    assert got["s"] == want["s"] == "run-é" and got["raw"] == want["raw"] == b"\x00\x01"
    for k in ("n", "v"):
        assert isinstance(got[k], np.ndarray) and isinstance(want[k], np.ndarray)
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_host_and_step_collectives_at_two_processes(tmp_path):
    """Gather, broadcast (numeric, str and bytes leaves), reduce-sum, the
    any-rank flag, the peer exchange (bf16 and int), the flat mean, the
    flat broadcast, the autograd all-reduce (its backward sums the ranks'
    gradients) and `check_desync` (a perturbed rank raises, all-NaN
    passes, as in the JAX package)."""
    r0, r1 = run_group("collectives", tmp_path)
    for out in (r0, r1):
        np.testing.assert_array_equal(out["allgather"]["x"], [[0, 1, 2], [10, 11, 12]])
        np.testing.assert_array_equal(out["allgather"]["f"][0], np.float32([0.5, 1.5]))
        b = out["broadcast"]
        np.testing.assert_array_equal(b["n"], np.full((2, 2), 1, np.int64))
        assert b["n"].dtype == np.int64 and b["scalar"] == 7
        assert isinstance(b["scalar"], np.ndarray) and b["scalar"].shape == ()
        assert b["s"] == "run-0-é" and b["b"] == bytes([0] * 3)
        np.testing.assert_array_equal(out["reduce_sum"]["count"], [3, 4])
        assert out["any_rank1"] is True and out["any_none"] is False
        assert [t.tolist() for t in out["mean"]] == [[0.5] * 3, [[1.0, 1.0]] * 2,
                                                      [0.5, 0.5]]
        assert [t.tolist() for t in out["broadcast_"]] == [[1.0, 1.0], [3]]
        assert out["sum_fwd"].tolist() == [3.0] * 3
        # d/dx_r of sum_r' (r' + 1) * (x_0 + x_1) = 1 + 2
        assert out["sum_grad"].tolist() == [3.0] * 3
        assert "desync on 'perturbed'" in out["desync"]
    np.testing.assert_array_equal(r0["exchange_bf16"], np.arange(6).reshape(2, 3) + 100)
    np.testing.assert_array_equal(r1["exchange_bf16"], np.arange(6).reshape(2, 3))
    assert r0["exchange_int"].tolist() == [1, 5] and r1["exchange_int"].tolist() == [0, 5]


# --- the mesh ----------------------------------------------------------------


@pytest.mark.parametrize("data,model,n", [(-1, 1, 1), (-1, 1, 4), (2, 1, 2),
                                          (2, 1, 4), (3, 1, 2), (-1, 3, 4),
                                          (0, 1, 2), (1, 0, 1)])
def test_train_mesh_shape_matches_jax(data, model, n):
    """The (data, model) resolution and its errors, word for word."""
    try:
        want = jmesh.resolve_train_mesh_shape(JMeshConfig(data=data, model=model), n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.resolve_train_mesh_shape(MeshConfig(data=data, model=model), n)
        assert str(got.value) == str(e)
        return
    got = tmesh.resolve_train_mesh_shape(MeshConfig(data=data, model=model), n)
    assert got == tuple(want)
