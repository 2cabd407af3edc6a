"""Direction-aware comparison of two rounds of headline numbers (the port's
copy of `diff_rounds` from the JAX package's `analysis/perfdiff.py`).

`diff_rounds(old, new, threshold)` compares two flat dicts key by key over
the watched keys, with DIRECTION awareness (clips/s up is good, p99 down is
good): a regression is a watched key moving its bad way by more than
`threshold` (fractional). The fleet's canary (`fleet/control/canary.py`)
compares its canary side against the baseline with it, so a canary verdict
and a round-to-round gate argue from one definition of "regressed".

The JAX module's `pva-tpu-perfdiff` command reads that package's archived
TPU bench rounds; the port has no bench rounds yet, so it carries the
comparison only, and its command comes with the port's bench.

Stdlib only.
"""

from __future__ import annotations

from typing import Dict, Optional

# headline keys worth diffing, by direction. Keys absent from either
# round are skipped (lanes come and go across rounds).
HIGHER_BETTER = (
    "value",                    # flagship clips/s/chip
    "trainer_cps_chip",
    "trainer_vs_rawstep",
    "tflops_per_sec",
    "mfu",
    "mfu_analytic",
    "trainer_mfu",
    "multichip_mfu",
    "multichip_mfu_analytic",
    "serve_rps",
    "serve_fill_ratio",
    # per-kernel fused-vs-reference speedups (pva-tpu-kbench): the keys
    # that make a bench-trajectory move attributable to ONE kernel —
    # same-backend ratios, only comparable when kbench_platform matches
    # across the two rounds (the suspect-refusal rule keeps CPU-fallback
    # rounds from headlining device claims in the first place)
    "kbench_dw_x3d_res3_speedup",
    "kbench_pw_x3d_res3_speedup",
    "kbench_conv133_sf_res4_speedup",
    "kbench_conv311_sf_res4_speedup",
    # PIPELINE lane: pipelined clips/s/chip at the lane's P-stage point
    "pipeline_cps_per_chip",
    # STREAM lane: per-label cost ratio, full-recompute / incremental
    # (streaming/)
    "stream_incremental_speedup",
    # STREAM lane trunk reuse: per-label advance cost ratio, full-trunk
    # token ring / KV-ring incremental trunk — only headlined when the top-1 quality gate holds
    "stream_trunk_speedup",
    # incremental banded attention vs full-recompute attention at the
    # videomae_b stream shape (ops/attention.incremental_band_attention)
    "kbench_attn_causal_inc_speedup",
    "kbench_attn_windowed_inc_speedup",
    # FLEET_AUTO lane: model families served off ONE pool under the
    # shared budget (fleet/control/multimodel.py) — a drop means a
    # family fell off the fleet
    "fleet_models_served",
)
LOWER_BETTER = (
    "step_ms_blocked",
    "serve_p50_ms",
    "serve_p99_ms",
    "serve_p99_ms_under_load",
    "swap_blackout_ms",
    "fleet_shed_frac",
    "trainer_input_wait_frac",
    "obs_input_wait_frac",
    "trace_overhead_frac",
    # PIPELINE lane: realized fill/drain idle fraction (two-point fit)
    "pipeline_bubble_frac",
    # STREAM lane: label-latency tail under open-loop stream load, and
    # the exact per-advance H2D payload fraction (s/T)
    "stream_p99_ms",
    "stream_h2d_bytes_frac",
    # trunk-reuse quality gate: |top-1(full) - top-1(banded)| on the
    # fixed-seed synthetic eval — the gate that decides whether
    # stream_trunk_speedup may headline at all
    "stream_trunk_top1_delta",
    # FLEET_AUTO lane (fleet/control/): seconds from the traffic step to
    # the autoscaler's last scaling action, advances shed across the
    # scale-down drain, and rollbacks the seeded-regression canary took
    # (a rise past 1 means the ladder needed extra strikes — the canary
    # verdict got less decisive)
    "autoscale_converge_s",
    "fleet_scaledown_shed_frac",
    "canary_rollback",
    # pva-tpu-hbm: device high-water mark from the memory ledger (backend
    # peak_bytes_in_use where measured, peak attributed bytes elsewhere);
    # null -> number is the metric APPEARING on the first measured round
    "hbm_peak_bytes",
)


def _pct(old: float, new: float) -> Optional[float]:
    if old == 0:
        return None
    return (new - old) / abs(old)


def diff_rounds(old: dict, new: dict, threshold: float = 0.05) -> dict:
    """Key-by-key comparison; a REGRESSION is a watched key moving in its
    bad direction by more than `threshold` (fractional)."""
    keys: Dict[str, dict] = {}
    regressions = []
    improvements = []
    appeared = []
    for key in HIGHER_BETTER + LOWER_BETTER:
        ov, nv = old.get(key), new.get(key)
        if ov is None and isinstance(nv, (int, float)) \
                and not isinstance(nv, bool):
            # null -> number is a metric APPEARING (a lane started
            # measuring something it couldn't before — e.g. mfu_analytic
            # landing on a round after an r02-shaped round whose mfu was
            # null), never a regression-from-zero or a divide-by-zero:
            # "wasn't measured" and "measured zero" are different facts
            keys[key] = {"old": None, "new": float(nv), "pct": None}
            appeared.append(key)
            continue
        if not isinstance(ov, (int, float)) or not isinstance(nv, (int, float)):
            continue
        ov, nv = float(ov), float(nv)
        pct = _pct(ov, nv)
        rec = {"old": ov, "new": nv,
               "pct": None if pct is None else round(pct, 4)}
        keys[key] = rec
        if pct is None:
            # zero baseline: no finite pct, but the DIRECTION still
            # classifies — a shed_frac/input_wait_frac that APPEARS is a
            # regression the gate must not skip. `threshold` doubles as
            # the absolute movement floor (these keys are fractions/ms,
            # so sub-threshold appearances are noise, not a verdict).
            if abs(nv - ov) <= threshold:
                continue
            worse = (nv > ov) == (key in LOWER_BETTER)
            (regressions if worse else improvements).append(key)
            continue
        bad = -pct if key in HIGHER_BETTER else pct
        if bad > threshold:
            regressions.append(key)
        elif bad < -threshold:
            improvements.append(key)
    # per-model clips/s/chip deltas (error strings skipped)
    models: Dict[str, dict] = {}
    om, nm = old.get("models") or {}, new.get("models") or {}
    for name in sorted(set(om) & set(nm)):
        ov, nv = om[name], nm[name]
        if not isinstance(ov, (int, float)) or not isinstance(nv, (int, float)):
            continue
        pct = _pct(float(ov), float(nv))
        models[name] = {"old": ov, "new": nv,
                        "pct": None if pct is None else round(pct, 4)}
        if pct is not None and -pct > threshold:
            regressions.append(f"models.{name}")
        elif pct is not None and pct > threshold:
            improvements.append(f"models.{name}")
    return {
        "threshold": threshold,
        "old_metric": old.get("metric"),
        "new_metric": new.get("metric"),
        "keys": keys,
        "models": models,
        "regressions": sorted(regressions),
        "improvements": sorted(improvements),
        "appeared": sorted(appeared),
        "ok": not regressions,
    }
