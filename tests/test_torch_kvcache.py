"""The port's K/V and stem rings against the JAX package's, on the CPU in
float32 (the JAX side's oracles: `full_recompute_history`, the masked replay
of a stream's whole history).

- Causal and windowed K/V rings (videomae_t finetuned with the matching
  `attn_mask`), port against JAX through one ring wraparound at atol 1e-4;
  the port's incremental logits against its own `full_recompute_history`
  over two wraparounds, with no new step key once warm.
- The banded full trunk (`trunk="full"` on a masked model) equals
  `predict`; eviction reclaims a K/V slot whose rows then serve the new
  session.
- `quantize_kv` byte-equal to the JAX package's on the same f32 input; the
  int8 ring equal to the JAX int8 ring and within
  `tests/test_zkvcache.py::test_int8_kv_ring_bounds`'s bounds of the f32
  ring, on that test's weights.
- `MViT.forward(from_stem=True)` against the JAX model's, and the stem ring
  (mvit_t) against the JAX engine's `full_recompute_history`.
- The hot-swap carry rebuilds the K/V rings under the green weights.

Engines are built once per module from one set of numpy-seeded variables
(`tests/test_torch_streaming.py`'s builders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_accelerate_tpu.serving import quantize as jquant
from pytorchvideo_accelerate_tpu_torch.obs.registry import Registry
from pytorchvideo_accelerate_tpu_torch.serving import quantize as tquant
from pytorchvideo_accelerate_tpu_torch.streaming import (
    SessionAdmissionError,
    StreamingEngine,
)
from test_torch_streaming import (
    ATOL,
    CROP,
    S,
    T,
    frames,
    jax_stream,
    port_stream,
    seeded_variables,
)

KV = {"causal": {"attn_mask": "causal"},
      "windowed": {"attn_mask": "windowed", "attn_window": 2}}


@pytest.fixture(scope="module")
def kv_pairs():
    """trunk -> (JAX K/V stream, port K/V stream), built on first use."""
    built = {}

    def get(trunk):
        if trunk not in built:
            model, variables = seeded_variables("videomae_t", **KV[trunk])
            built[trunk] = (
                jax_stream("videomae_t", model, variables, trunk=trunk,
                           sname=f"j-kv-{trunk}"),
                port_stream("videomae_t", variables, sname=f"t-kv-{trunk}",
                            trunk=trunk, model_kw=KV[trunk]))
        return built[trunk]

    return get


@pytest.mark.parametrize("trunk", ["causal", "windowed"])
def test_kv_port_matches_jax_through_a_wraparound(kv_pairs, trunk):
    js, ts = kv_pairs(trunk)
    assert ts.kind == js.kind == "tokens" and ts.trunk == trunk
    assert ts._ring_names == js._ring_names == ("raw", "tok", "kv", "hid")
    rng = np.random.default_rng(11)
    sids = (f"jw-{trunk}-a", f"jw-{trunk}-b")
    win = frames(rng, 2)
    items = [{"sid": s, "window": win[i], "stride": S} for i, s in enumerate(sids)]
    np.testing.assert_allclose(np.stack(ts.advance_batch(items)),
                               np.stack(js.advance_batch(items)), atol=ATOL, rtol=0)
    for _ in range(T // S):
        f = frames(rng, 2, S)
        items = [{"sid": s, "frames": f[i]} for i, s in enumerate(sids)]
        got, want = np.stack(ts.advance_batch(items)), np.stack(js.advance_batch(items))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(want).max() > 0.1
    for s in sids:
        assert ts.end_session(s) and js.end_session(s)


@pytest.mark.parametrize("trunk", ["causal", "windowed"])
def test_kv_incremental_matches_history_replay(kv_pairs, trunk):
    """Two wraparounds: every advance equals the port's masked replay of
    the whole history; a steady stream adds no step key."""
    _, ts = kv_pairs(trunk)
    rng = np.random.default_rng(12)
    sids = (f"h-{trunk}-a", f"h-{trunk}-b")
    hist = frames(rng, 2)
    out = ts.advance_batch([{"sid": s, "window": hist[i], "stride": S}
                            for i, s in enumerate(sids)])
    np.testing.assert_allclose(np.stack(out), ts.full_recompute(hist), atol=ATOL, rtol=0)
    keys = None
    for step in range(2 * T // S):
        f = frames(rng, 2, S)
        out = ts.advance_batch([{"sid": s, "frames": f[i]} for i, s in enumerate(sids)])
        hist = np.concatenate([hist, f], axis=1)
        np.testing.assert_allclose(np.stack(out), ts.full_recompute_history(hist, T),
                                   atol=ATOL, rtol=0)
        if step == 0:
            keys = ts.compiled_stream_keys()
    assert ts.compiled_stream_keys() == keys
    for s in sids:
        assert ts.end_session(s)


def test_kv_history_replay_matches_jax(kv_pairs):
    js, ts = kv_pairs("windowed")
    hist = frames(np.random.default_rng(13), 2, 3 * T)
    np.testing.assert_allclose(ts.full_recompute_history(hist, T),
                               js.full_recompute_history(hist, T), atol=ATOL, rtol=0)


def test_banded_full_trunk_matches_predict(kv_pairs):
    """At establish the K/V trunk, the full token trunk of the same masked
    model and one-shot `predict` are one banded function: the full trunk
    keeps the band the model was finetuned with."""
    _, tk = kv_pairs("causal")
    tf = StreamingEngine(tk.engine, session_budget_mb=4.0, name="t-anchor-full",
                         trunk="full", registry=Registry())
    assert tf._ring_names == ("raw", "tok")
    win = frames(np.random.default_rng(16), 2)
    sids = ("an-a", "an-b")
    items = [{"sid": s, "window": win[i], "stride": S} for i, s in enumerate(sids)]
    ref = tk.full_recompute(win)
    np.testing.assert_allclose(np.stack(tk.advance_batch(items)), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.stack(tf.advance_batch(items)), ref, atol=1e-5, rtol=0)
    for s in sids:
        assert tk.end_session(s) and tf.end_session(s)


def test_eviction_reclaims_kv_slot(kv_pairs):
    """A stale holder's slot (raw, token, K/V and hidden rows) is reclaimed
    at establish, and its cached trunk state does not leak into the
    successor."""
    _, se = kv_pairs("causal")
    rng = np.random.default_rng(14)
    geom = se.geom_key(T, CROP, CROP, 3, se.input_dtype)
    se.advance_batch([{"sid": "kev-a", "window": frames(rng, 1)[0], "stride": S}])
    for _ in range(3):  # rotate a's ring so its K/V rows are "dirty"
        se.advance_batch([{"sid": "kev-a", "frames": frames(rng, 1, S)[0]}])
    with se.table._lock:
        saved = list(se.table._free[geom])
        se.table._free[geom] = []
    try:
        win_b = frames(rng, 1)[0]
        out = se.advance_batch([{"sid": "kev-b", "window": win_b, "stride": S}])
        assert isinstance(out[0], SessionAdmissionError)
        with se.table._lock:
            se.table._sessions["kev-a"].last_active -= 1e6
        out = se.advance_batch([{"sid": "kev-b", "window": win_b, "stride": S}])
        assert not isinstance(out[0], Exception) and se.table.get("kev-a") is None
        f = frames(rng, 1, S)[0]
        adv = se.advance_batch([{"sid": "kev-b", "frames": f}])[0]
        hist = np.concatenate([win_b, f])[None]
        np.testing.assert_allclose(adv, se.full_recompute_history(hist, T)[0],
                                   atol=ATOL, rtol=0)
    finally:
        with se.table._lock:
            se.table._free[geom].extend(saved)
        se.end_session("kev-b")


@pytest.mark.parametrize("shape,zero_row", [((2, 3, 5, 16), False),
                                            ((4, 7, 64), True)])
def test_quantize_kv_byte_equal_jax(shape, zero_row):
    x = np.random.default_rng(15).standard_normal(shape).astype(np.float32) * 3
    if zero_row:
        x[1, 2] = 0.0
    q, sc = tquant.quantize_kv(torch.from_numpy(x))
    jq, jsc = jquant.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert sc.numpy().tobytes() == np.asarray(jsc).tobytes()
    back = tquant.dequantize_kv(q, sc, torch.float32).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jquant.dequantize_kv(jq, jsc, jnp.float32)))


def test_int8_kv_ring_bounds():
    """`tests/test_zkvcache.py::test_int8_kv_ring_bounds` on the port, on
    that test's own weights (the JAX model's `init` at key 0) and engines
    (int8 weights dequantized to the default bf16): the K/V rings really are
    int8 with f32 per-row scales; the port's int8 logits equal the JAX int8
    engine's (atol 1e-4); they sit within 1e-2 of the f32 ring's (and not
    on them: the int8 path engaged) through a wraparound, and within 2e-3
    of the int8 engine's own replay."""
    from pytorchvideo_accelerate_tpu import config as jcfg
    from pytorchvideo_accelerate_tpu import models as jmodels
    from pytorchvideo_accelerate_tpu_torch.models.convert import (
        flatten_tree,
        unflatten_tree,
    )

    model = jmodels.create_model(jcfg.ModelConfig(
        name="videomae_t", num_classes=8, dropout_rate=0.0, attn_mask="causal"), "fp32")
    init = model.init(jax.random.key(0), np.zeros((1, T, CROP, CROP, 3), np.float32))
    variables = unflatten_tree({k: np.asarray(v) for k, v in flatten_tree(init).items()})
    kw = dict(trunk="causal", model_kw=KV["causal"])
    t32 = port_stream("videomae_t", variables, sname="t-q32", **kw)
    t8 = port_stream("videomae_t", variables, quant="int8", compute_dtype=None,
                     sname="t-q8", **kw)
    j8 = jax_stream("videomae_t", model, variables, quant="int8", trunk="causal",
                    sname="j-q8")
    assert t8._ring_names == ("raw", "tok", "kv", "kv_scale", "hid")
    rng = np.random.default_rng(17)
    win = frames(rng, 2)
    sids = ("q-a", "q-b")
    items = [{"sid": s, "window": win[i], "stride": S} for i, s in enumerate(sids)]
    e32, e8 = np.stack(t32.advance_batch(items)), np.stack(t8.advance_batch(items))
    np.testing.assert_allclose(e8, np.stack(j8.advance_batch(items)), atol=ATOL, rtol=0)
    d_est = float(np.max(np.abs(e32 - e8)))
    assert 1e-7 < d_est < 1e-2, d_est
    pool = next(iter(t8._pools.values()))
    assert pool["kv"].dtype == torch.int8 and pool["kv_scale"].dtype == torch.float32
    hist = win
    for _ in range(T // S + 1):
        f = frames(rng, 2, S)
        items = [{"sid": s, "frames": f[i]} for i, s in enumerate(sids)]
        a32, a8 = np.stack(t32.advance_batch(items)), np.stack(t8.advance_batch(items))
        np.testing.assert_allclose(a8, np.stack(j8.advance_batch(items)), atol=ATOL, rtol=0)
        hist = np.concatenate([hist, f], axis=1)
    assert float(np.max(np.abs(a32 - a8))) < 1e-2
    assert float(np.max(np.abs(a8 - t8.full_recompute_history(hist, T)))) < 2e-3


def test_kv_hotswap_rebuilds_under_green(kv_pairs):
    """The carry adopts the raw ring and rebuilds token, K/V and hidden
    rings under the green weights (fresh-establish semantics over the
    current window): with the carry on a ring boundary, green's next
    advance with no resend equals green's replay of the current window."""
    _, blue = kv_pairs("windowed")
    rng = np.random.default_rng(18)
    hist = frames(rng, 1)
    blue.advance_batch([{"sid": "ks", "window": hist[0], "stride": S}])
    for _ in range(T // S):
        f = frames(rng, 1, S)
        blue.advance_batch([{"sid": "ks", "frames": f[0]}])
        hist = np.concatenate([hist, f], axis=1)
    _, variables = seeded_variables("videomae_t", **KV["windowed"])
    green = port_stream("videomae_t", jax.tree.map(lambda x: x * 1.25, variables),
                        trunk="windowed", model_kw=KV["windowed"], sname="t-kv-green")
    green.prepare_carry_from(blue)
    assert green.carry_state_from(blue) == 1
    f = frames(rng, 1, S)
    out = green.advance_batch([{"sid": "ks", "frames": f[0]}])[0]
    cur = np.concatenate([hist[:, -T:], f], axis=1)
    np.testing.assert_allclose(out, green.full_recompute_history(cur, T)[0],
                               atol=ATOL, rtol=0)
    assert green.end_session("ks")


# --- the MViT stem seam --------------------------------------------------------

@pytest.fixture(scope="module")
def stem_pair():
    model, variables = seeded_variables("mvit_t")
    return (model, variables, jax_stream("mvit_t", model, variables, sname="j-stem"),
            port_stream("mvit_t", variables, sname="t-stem"))


def test_mvit_from_stem_matches_jax(stem_pair):
    """The trunk entered at the stem seam: the same pre-positional token grid
    through `forward(from_stem=True)` and the JAX `apply(from_stem=True)`,
    and the whole model when the grid is the patch embed's own output."""
    model, variables, _, ts = stem_pair
    pm = ts.engine.model
    rng = np.random.default_rng(19)
    grid = rng.standard_normal((2,) + tuple(pm.pos_embed.shape[1:])).astype(np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(grid), from_stem=True).numpy()
    want = model.apply(variables, jnp.asarray(grid), train=False, from_stem=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    x = frames(rng, 2)
    with torch.inference_mode():
        stem = ts._stem_embed(torch.from_numpy(x), ts._tok_meta["halo"])
        np.testing.assert_allclose(pm(stem, from_stem=True).numpy(),
                                   pm(torch.from_numpy(x)).numpy(), atol=1e-5, rtol=0)


def test_stem_ring_matches_jax_history(stem_pair):
    """The stem ring through a wraparound: each advance equals the port's
    history replay, and the last equals the JAX engine's replay."""
    _, _, js, ts = stem_pair
    assert ts.kind == js.kind == "stem" and ts._ring_names == ("raw", "stem")
    rng = np.random.default_rng(20)
    hist = frames(rng, 2)
    sids = ("mv-a", "mv-b")
    ts.advance_batch([{"sid": s, "window": hist[i], "stride": S}
                      for i, s in enumerate(sids)])
    for _ in range(T // S + 1):
        f = frames(rng, 2, S)
        out = np.stack(ts.advance_batch([{"sid": s, "frames": f[i]}
                                         for i, s in enumerate(sids)]))
        hist = np.concatenate([hist, f], axis=1)
        np.testing.assert_allclose(out, ts.full_recompute_history(hist, T),
                                   atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, js.full_recompute_history(hist, T), atol=ATOL, rtol=0)
    assert np.abs(out).max() > 0.1
    for s in sids:
        assert ts.end_session(s)


def test_stem_refuses_kv_trunks(stem_pair):
    _, _, _, ts = stem_pair
    with pytest.raises(ValueError, match="pooling attention"):
        StreamingEngine(ts.engine, trunk="causal", registry=Registry())
