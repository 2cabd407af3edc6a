"""TrainGuard: self-healing training, the port's copy of the JAX package's
`reliability/guard.py` (anomaly detection, last-known-good rollback,
replay bundles).

1. **Skip on the device** (`trainer/steps.py guard_skip`): with the guard
   armed, a step whose loss or gradient norm is not finite discards its own
   update with `torch.where` on every state leaf, without a host round
   trip, so one NaN batch never poisons the parameters, the BN running
   averages, the optimizer state or the EMA. The host sees the step one
   step late (the deferred-fetch discipline); the skip is why that is safe.
2. **EWMA spike detection** (`SpikeDetector`) over loss and grad_norm: an
   upward z-score excursion past `guard.spike_zscore` is an anomaly;
   downward cliffs never fire; a warmup budget keeps young statistics
   quiet.
3. **Last-known-good ring**: the port's `trainer/checkpoint.Checkpointer`
   under `<output_dir>/guard_lkg`, saved every `guard.lkg_every_steps`
   steps and only after a healthy window; `guard.lkg_keep` bounds it. The
   saves are asynchronous (the step thread only queues the host copy); a
   restore and `close()` fence them.
4. **Escalation**: an anomaly streak below `guard.rollback_after` is a
   skip; at it, a rollback to the LKG with the loader fast-forwarded past
   the anomalous batch; past `guard.max_rollbacks` rollbacks, `GuardHalt`.
5. **Replay bundle**: the first anomalous step of every streak dumps
   `<output_dir>/replay/step_<N>/` (the batch as `.npy`, bf16 widened to
   f32, and a timestamp-free `meta.json`), byte for byte what the JAX
   package writes for the same batch.

In a data-parallel job every rank runs the guard on the same global
metrics (the step all-reduces them), so every rank reaches the same
verdicts; rank 0 writes the LKG ring and the replay bundles (its share of
the batch), and a rollback restores the same file on every rank after a
barrier (`Checkpointer`).

Every ladder event is counted in the metric registry
(`pva_guard_events_total{action=}`, and `pva_guard_lkg_step`), and skips
and rollbacks leave a warning in the flight recorder, as in the JAX
package; `perf_keys()` reports the counts. Disarmed (`guard.enabled=false`,
the default) nothing here is built and the step carries no skip.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pytorchvideo_accelerate_tpu_torch.config import ReliabilityConfig
from pytorchvideo_accelerate_tpu_torch.obs import get_recorder, get_registry
from pytorchvideo_accelerate_tpu_torch.parallel.distributed import is_main_process
from pytorchvideo_accelerate_tpu_torch.trainer.checkpoint import Checkpointer

logger = logging.getLogger(__name__)

REPLAY_DIRNAME = "replay"


class GuardHalt(RuntimeError):
    """The top of the escalation ladder: rollbacks exhausted, or none
    possible. The message names the replay bundle."""


class SpikeDetector:
    """EWMA mean/variance z-score detector over one scalar stream.

    `update(value)` returns None (healthy), "nonfinite" or "spike". Upward
    excursions only; `warmup` observations pass while feeding the EWMA; an
    anomalous or nonfinite value is not absorbed into it."""

    def __init__(self, alpha: float = 0.05, zscore: float = 6.0,
                 warmup: int = 20):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.zscore = float(zscore)
        self.warmup = int(warmup)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, value: float) -> Optional[str]:
        v = float(value)
        if not math.isfinite(v):
            return "nonfinite"
        if self.n >= self.warmup:
            std = math.sqrt(self.var) if self.var > 0 else 0.0
            if std > 0 and (v - self.mean) / std > self.zscore:
                return "spike"
        d = v - self.mean
        self.mean += self.alpha * d
        # exponentially weighted variance (West): blends the squared
        # innovation
        self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1
        return None


# --- replay bundles ---------------------------------------------------------

_NPY_KEPT = tuple(np.dtype(t) for t in (np.float32, np.float64, np.int32,
                                        np.int64, np.uint8, np.bool_))


def _source_dtype(value) -> str:
    """The leaf's dtype by numpy's name (torch.bfloat16 -> "bfloat16")."""
    if torch.is_tensor(value):
        return str(value.dtype).replace("torch.", "")
    return str(np.asarray(value).dtype)


def _np_host(value) -> np.ndarray:
    """A host numpy copy of a leaf (a tensor on any device, or an array).
    Floats narrower than f32 widen to f32 (numpy's format has no bf16 and
    the widening is exact), as does any dtype outside f32/f64/i32/i64/u8/
    bool."""
    if torch.is_tensor(value):
        t = value.detach().cpu()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        arr = t.numpy()
    else:
        arr = np.asarray(value)
    if arr.dtype.kind == "f" and arr.dtype.itemsize < 4:
        arr = arr.astype(np.float32)
    elif arr.dtype not in _NPY_KEPT:
        arr = arr.astype(np.float32)
    return arr


def dump_replay_bundle(path: str, batch: Dict[str, Any],
                       meta: Dict[str, Any]) -> str:
    """Write a replay bundle directory: one `<key>.npy` per batch leaf and
    a sorted-keys `meta.json`, staged in a tmp directory and renamed into
    place (a kill mid-dump leaves no half bundle). Timestamp-free: the same
    anomaly dumps byte-identical bundles."""
    host = {str(k): _np_host(v) for k, v in batch.items()}
    meta = dict(meta)
    meta["arrays"] = {
        k: {"shape": list(v.shape), "dtype": str(v.dtype),
            "source_dtype": _source_dtype(batch[k])}
        for k, v in host.items()}
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    try:
        for k, v in host.items():
            np.save(os.path.join(tmp, f"{k}.npy"), v)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True, default=str)
        if os.path.isdir(path):  # a re-dump of the same step replaces it
            shutil.rmtree(path)
        os.rename(tmp, path)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def load_replay_bundle(path: str):
    """Read a bundle back -> `(meta, {key: np.ndarray})`."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    arrays = {k: np.load(os.path.join(path, f"{k}.npy"))
              for k in meta.get("arrays", {})}
    return meta, arrays


# --- the guard --------------------------------------------------------------

@dataclass
class GuardAction:
    """A verdict the step loop acts on (skips stay inside the guard, a halt
    raises): a rollback to `lkg_step`, the loader resumed at
    `resume_position` (just past the anomalous batch)."""

    kind: str  # "rollback"
    lkg_step: int
    resume_position: Dict[str, int]
    bundle_path: str = ""
    reason: str = ""


@dataclass
class _Stash:
    step: int
    metrics: Dict[str, Any]  # device scalars, read one step later
    batch: Any               # the device batch (one batch of memory)
    position: Dict[str, int]  # the LoaderState after consuming it


class TrainGuard:
    """The trainer-side state machine, one per Trainer when
    `guard.enabled`. `step()` runs after each dispatch and observes the
    step before it; `flush()` observes the last one at the epoch's end."""

    def __init__(self, cfg, output_dir: str,
                 config_dict: Optional[dict] = None, seed: int = 0,
                 reliability: Optional[ReliabilityConfig] = None):
        policy = getattr(cfg, "policy", "both")
        if policy not in ("nonfinite", "spike", "both"):
            raise ValueError(
                f"guard.policy must be nonfinite|spike|both, got {policy!r}")
        self.cfg = cfg
        self.policy = policy
        self.output_dir = output_dir
        self.config_dict = config_dict or {}
        self.seed = int(seed)
        self.reliability = reliability  # the LKG saves' retry policy
        self.detectors: Dict[str, SpikeDetector] = {
            name: SpikeDetector(alpha=cfg.ewma_alpha, zscore=cfg.spike_zscore,
                                warmup=cfg.warmup_steps)
            for name in ("loss", "grad_norm")}
        self._pending: Optional[_Stash] = None
        self._streak = 0
        self._streak_bundle = ""
        self._last_anomaly_step: Optional[int] = None
        self.skips = 0
        self.rollbacks = 0
        self.lkg_step: Optional[int] = None
        self.last_verdict: Optional[dict] = None
        self.last_rollback: Optional[dict] = None
        self.events: List[dict] = []  # the last 64 ladder events
        self.quarantine = None  # the trainer attaches its Quarantine
        self._ckpt: Optional[Checkpointer] = None  # made at the first save

    # --- LKG ring ---------------------------------------------------------

    @property
    def lkg_dir(self) -> str:
        return os.path.join(self.output_dir, "guard_lkg")

    def _checkpointer(self) -> Checkpointer:
        if self._ckpt is None:
            self._ckpt = Checkpointer(self.lkg_dir,
                                      max_to_keep=max(self.cfg.lkg_keep, 1),
                                      reliability=self.reliability,
                                      use_async=True)
        return self._ckpt

    def ring_steps(self) -> List[int]:
        return Checkpointer(self.lkg_dir).all_steps()

    def _maybe_save_lkg(self, gstep: int, live_state, loader_state) -> None:
        """Advance the ring iff due and the window is healthy (no anomaly
        observed within the last cadence window). The state saved is the
        live one; its newest step is observed one fetch later, and the skip
        keeps anything nonfinite out of it regardless."""
        every = max(int(self.cfg.lkg_every_steps), 1)
        due = self.lkg_step is None or gstep - self.lkg_step >= every
        healthy = (self._streak == 0
                   and (self._last_anomaly_step is None
                        or gstep - self._last_anomaly_step >= every))
        if not (due and healthy and gstep > 0):
            return
        ckpt = self._checkpointer()
        if gstep in ckpt.all_steps():
            # a trajectory after a rollback can revisit a step index the
            # ring holds: replace it so the ring tracks this trajectory
            ckpt.delete(gstep)
        ckpt.save(gstep, live_state,
                  {"kind": "lkg", "data_state": loader_state.to_dict()})
        self.lkg_step = gstep
        self._event("lkg_save", step=gstep)
        self._publish("lkg_save")
        get_registry().gauge(
            "pva_guard_lkg_step",
            "last-known-good checkpoint step the guard would roll back "
            "to").set(gstep)

    # --- per-step hook -----------------------------------------------------

    def step(self, gstep: int, metrics: Dict[str, Any], batch,
             loader_state, live_state) -> Optional[GuardAction]:
        """Called right after dispatching step `gstep` (`metrics` are its
        device scalars). Observes the previous step's stash, whose step has
        retired behind the one just dispatched, then stashes this one.
        Returns a `GuardAction` on rollback; raises `GuardHalt` at the
        ladder's top."""
        prev, self._pending = self._pending, _Stash(
            gstep, metrics, batch, loader_state.to_dict())
        if prev is None:
            return None
        return self._observe(prev, gstep, live_state, loader_state)

    def flush(self, live_state, loader_state) -> Optional[GuardAction]:
        """Epoch end: observe the last pending step."""
        prev, self._pending = self._pending, None
        if prev is None:
            return None
        return self._observe(prev, prev.step, live_state, loader_state)

    def _verdict(self, loss: float, grad_norm: float) -> Optional[dict]:
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            # a spike-only policy does not escalate on these, and never
            # feeds them to the EWMAs
            return None if self.policy == "spike" else {"kind": "nonfinite"}
        if self.policy == "nonfinite":
            for name, v in (("loss", loss), ("grad_norm", grad_norm)):
                self.detectors[name].update(v)  # keep the baselines warm
            return None
        for name, v in (("loss", loss), ("grad_norm", grad_norm)):
            if self.detectors[name].update(v) == "spike":
                return {"kind": "spike", "metric": name}
        return None

    def _observe(self, stash: _Stash, live_gstep: int, live_state,
                 live_loader_state) -> Optional[GuardAction]:
        loss = float(stash.metrics["loss"])
        grad_norm = float(stash.metrics["grad_norm"])
        verdict = self._verdict(loss, grad_norm)
        if verdict is None:
            self._streak = 0
            self._streak_bundle = ""
            self._maybe_save_lkg(live_gstep, live_state, live_loader_state)
            return None

        self._streak += 1
        self._last_anomaly_step = stash.step
        verdict.update(step=stash.step, loss=loss, grad_norm=grad_norm,
                       streak=self._streak, position=dict(stash.position))
        self.last_verdict = verdict
        if self._streak == 1:
            verdict["bundle"] = self._dump_bundle(stash, verdict)
            self._streak_bundle = verdict["bundle"]

        if self._streak < max(int(self.cfg.rollback_after), 1):
            self.skips += 1
            self._event("skip", **{k: v for k, v in verdict.items()
                                   if k != "position"})
            self._publish("skip")
            self._warn("guard: anomalous step skipped", verdict)
            logger.warning("guard: anomalous step skipped: %s", verdict)
            return None

        if self.rollbacks >= int(self.cfg.max_rollbacks):
            self._halt(verdict,
                       f"{self.rollbacks} rollback(s) already spent "
                       f"(guard.max_rollbacks={self.cfg.max_rollbacks}): "
                       "a rollback loop means the data or the optimizer, "
                       "not luck")
        if self.lkg_step is None:
            self._halt(verdict,
                       "no last-known-good checkpoint exists yet "
                       "(anomaly inside the first guard.lkg_every_steps "
                       "window)")
        self.rollbacks += 1
        self._streak = 0
        self._pending = None  # the step just dispatched is abandoned too
        action = GuardAction(
            kind="rollback", lkg_step=int(self.lkg_step),
            resume_position=dict(stash.position),
            bundle_path=self._streak_bundle,
            reason=f"{verdict['kind']} at step {stash.step} "
                   f"(loss={loss:g}, grad_norm={grad_norm:g})")
        self.last_rollback = {
            "lkg_step": action.lkg_step, "anomaly_step": stash.step,
            "resume_position": action.resume_position,
            "bundle": action.bundle_path, "reason": action.reason}
        self._event("rollback", **self.last_rollback)
        self._publish("rollback")
        self._warn("guard: rolling back to last-known-good", self.last_rollback)
        logger.warning("guard: rolling back to last-known-good: %s",
                       self.last_rollback)
        return action

    def _halt(self, verdict: dict, why: str) -> None:
        self._event("halt", step=verdict.get("step"), why=why)
        self._publish("halt")
        raise GuardHalt(
            f"TrainGuard halt: {verdict['kind']} anomaly at step "
            f"{verdict.get('step')}: {why}. Replay bundle: "
            f"{self._streak_bundle or verdict.get('bundle') or 'none'}")

    # --- recovery ----------------------------------------------------------

    def restore(self, live_state, action: GuardAction):
        """Load the LKG checkpoint `action.lkg_step` into `live_state` in
        place, fenced behind the ring's asynchronous saves; returns
        `(live_state, step)`. The caller moves the loader to
        `action.resume_position`."""
        ckpt = self._checkpointer()
        ckpt.wait()
        _extra, step = ckpt.restore(live_state, step=action.lkg_step)
        return live_state, step

    # --- evidence ----------------------------------------------------------

    def _dump_bundle(self, stash: _Stash, verdict: dict) -> str:
        if not is_main_process():
            return ""  # one bundle a job: rank 0's share of the batch
        path = os.path.join(self.output_dir, REPLAY_DIRNAME,
                            f"step_{stash.step}")
        meta = {
            "step": stash.step,
            "seed": self.seed,
            "position": dict(stash.position),
            "verdict": {k: v for k, v in verdict.items()
                        if k not in ("position", "bundle")},
            "config": self.config_dict,
            "note": "dropout and mix draws are seeded from (seed, step); "
                    "batch leaves below (bf16 widened to f32; see "
                    "arrays.*.source_dtype)",
        }
        try:
            return dump_replay_bundle(path, stash.batch, meta)
        except (OSError, ValueError, TypeError) as e:
            # evidence must not kill the recovery
            logger.warning("guard: replay bundle dump failed (%s: %s)",
                           type(e).__name__, e)
            return ""

    def _event(self, action: str, **info) -> None:
        self.events.append({"action": action, **info})
        del self.events[:-64]

    def _publish(self, action: str) -> None:
        get_registry().counter(
            "pva_guard_events_total",
            "TrainGuard ladder events (skip/rollback/halt/lkg_save), "
            "by action", labelnames=("action",)).inc(action=action)

    def _warn(self, msg: str, info: dict) -> None:
        # a verdict's "kind" would collide with the record's own kind: it
        # goes in as "verdict_kind" (the JAX guard's warn raises on it and
        # swallows the TypeError, so its skips and rollbacks leave no
        # warning)
        get_recorder().warn(msg, **{
            (f"verdict_{k}" if k in ("kind", "name") else k): str(v)[:200]
            for k, v in info.items()})

    def perf_keys(self) -> Dict[str, int]:
        """fit()'s result keys: rollbacks taken and clips quarantined."""
        return {"guard_rollbacks": int(self.rollbacks),
                "quarantined_clips": (len(self.quarantine)
                                      if self.quarantine is not None else 0)}

    def close(self, barrier: bool = True) -> None:
        """Fence the LKG ring's asynchronous saves and stop its writer
        (`Checkpointer.close(barrier)`)."""
        ck, self._ckpt = self._ckpt, None
        if ck is not None:
            ck.close(barrier)


def poison_batch(batch: dict) -> dict:
    """NaN-poison the floating clip leaves of a batch (the deterministic
    stand-in for a numerically diverged input); uint8 clips, labels and
    masks pass through."""
    out = dict(batch)
    for k in ("video", "slow", "fast"):
        v = out.get(k)
        if v is not None and torch.is_tensor(v) and v.is_floating_point():
            out[k] = v * torch.tensor(float("nan"), dtype=v.dtype,
                                      device=v.device)
    return out
