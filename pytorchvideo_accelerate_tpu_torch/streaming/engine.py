"""StreamingEngine: device-resident rolling-window rings and incremental
advance steps (the port's counterpart of the JAX package's
`streaming/engine.py`).

One-shot clip classification re-ships and re-embeds the whole (T, H, W, C)
window for every label, so a live stream scored at stride s pays T/s times
the host-to-device traffic and the patch embed. Here a session's window
lives on the device in a slot of a preallocated ring pool; an advance
ships only the s new frames, writes them into the ring in place
(`index_put_` into the preallocated tensors: after warm-up a steady advance
allocates no ring memory) and scores the cached window. The device is the
wrapped `InferenceEngine`'s: the CUDA card unless that engine was built on
the CPU.

Ring kinds, chosen by the served model:

- `frames` (the conv families: tiny3d, X3D, CSN, R(2+1)D, ...): raw frames
  in the engine's input dtype; the whole trunk runs again over the cached
  window (3-D convs mix time globally).
- `tokens` (`VideoMAEClassifier`, `trunk="full"`): the cube embed is a
  conv with kernel = stride, so each tubelet's token depends on its own
  pixels only. The ring caches pre-positional patch tokens per temporal
  slot, an advance embeds just the new frames, and the trunk runs over the
  cached tokens with the positions added in window order. A raw-frame ring
  rides alongside as the weight-independent carry substrate of a hot swap.
- K/V rings (`VideoMAEClassifier`, `trunk="causal"|"windowed"`): under a
  banded temporal mask (0 <= q_slot - k_slot < W) each slot's per-layer K/V
  and final hidden mean depend on its trailing window only, so they are
  cached. An advance embeds the new tubelets, attends only their queries
  against the cached K/V (the band on absolute slot indices from a position
  counter passed as a tensor, so a wraparound never aliases a future
  slot), writes the new K/V and hidden rows back and reads the label from
  the hidden ring. Positional codes are stable per ring slot ((abs_slot mod
  T') * hw + spatial). The masked attention runs on the dense route
  (`ops/attention.py`): the flash kernel has no masked lowering, in the JAX
  package either. With `serve.quantization int8` the K/V rings are int8
  with per-token-row scales (`serving/quantize.py quantize_kv`).
- `stem` (`MViT`): the (3,7,7)/(2,4,4) patch stem's temporal receptive
  field is one frame of left halo, which the raw ring supplies. An advance
  writes the new frames, gathers the halo frame, runs the stem conv valid
  in time over [halo, new frames], caches the stem-token slots and enters
  the trunk through `MViT.forward(..., from_stem=True)`. A steady advance
  sees the real halo frame where one-shot `predict` pads the window edge
  with zeros, so its oracle is `full_recompute_history`. Causal and
  windowed trunks are refused: MViT's pooling attention mixes time through
  (3,.,.) conv kernels in every block.
- `dual` (`SlowFast`): the fast ring holds every frame, the slow ring every
  alpha-th; `stride % alpha == 0` keeps the slow window the phase-0
  subsample `window[::alpha]` of the fast one. Both are raw frames, adopted
  as they are across a hot swap.

Parity: the incremental logits equal `InferenceEngine.predict` over the
assembled window (`full_recompute`) for `frames`, `tokens` and `dual`, and
the masked replay of the whole stream history (`full_recompute_history`)
for the K/V and stem rings.

Steps are built once per (op, kind, geometry, stride, bucket) and cached
(at most `MAX_STREAM_KEYS`); session slots, write offsets and the K/V
position counter are tensors passed to a step, never part of its key. So a
steady stream adds no key (`compiled_stream_keys`), and
`torch.cuda.memory_allocated()` is byte-equal from one steady advance to
the next: the two facts the JAX package's recompile probe stands for.

Memory ledger (obs/memory.py): each ring pool's bytes register under
component `stream_rings:<name>`; the budget counts them
(`session_budget_mb`), measured where the ledger reads the card.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pytorchvideo_accelerate_tpu_torch.models.mvit import MViT
from pytorchvideo_accelerate_tpu_torch.models.slowfast import SlowFast
from pytorchvideo_accelerate_tpu_torch.models.videomae import (
    VideoMAEClassifier,
    _pos_table,
    run_vit_blocks,
)
from pytorchvideo_accelerate_tpu_torch.obs import memory as obs_memory
from pytorchvideo_accelerate_tpu_torch.obs import trace
from pytorchvideo_accelerate_tpu_torch.ops.attention import (
    banded_time_mask,
    dot_product_attention,
    temporal_band_mask,
)
from pytorchvideo_accelerate_tpu_torch.precision import f32_island
from pytorchvideo_accelerate_tpu_torch.serving.quantize import (
    dequantize_kv,
    quantize_kv,
)
from pytorchvideo_accelerate_tpu_torch.streaming.session import (
    SessionAdmissionError,
    SessionError,
    SessionTable,
    SessionUnknownError,
)
from pytorchvideo_accelerate_tpu_torch.trainer.steps import (
    device_normalize_batch,
    model_inputs,
    multiview_logits,
)

logger = logging.getLogger("pva_tpu_torch")

# the bound on cached stream steps: every (geometry, stride, bucket) is a
# step and a ring pool a client could make the server hold
MAX_STREAM_KEYS = 64

TRUNK_MODES = ("full", "causal", "windowed")


def _torch_dtype(name: str) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _write(ring: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor,
           offs: torch.Tensor, axis: int = 1) -> None:
    """Write per-session `rows` (B, ..., s on `axis`, ...) into `ring` (R,
    ..., T on `axis`, ...) in place at (slots[i], offs[i] + [0, s)): one
    `index_put_`, moving only the new rows' bytes. Offsets never wrap
    (the stride divides the window); duplicate slots are the padding rows'
    scratch slot, whose contents nothing reads."""
    vals = rows.movedim(axis, 1).to(ring.dtype)
    t_idx = offs[:, None] + torch.arange(vals.shape[1], device=ring.device)
    ring.movedim(axis, 1).index_put_((slots[:, None], t_idx), vals)


def _rolled(ring: torch.Tensor, slots: torch.Tensor,
            start: torch.Tensor) -> torch.Tensor:
    """Rows `slots` of `ring` (R, n, ...), each read from its own `start`
    around the ring: (B, n, ...) in logical (oldest-first) order."""
    n = ring.shape[1]
    idx = (start[:, None] + torch.arange(n, device=ring.device)) % n
    return ring[slots[:, None], idx]


class StreamingEngine:
    """Session-stateful wrapper around one `InferenceEngine`.

    Presents the engine surface the scheduler already speaks (`predict`,
    `buckets`, `warmup` delegate to the wrapped engine) plus the session
    surface (`advance_batch`, `end_session`, `carry_state_from`).
    `supports_sessions` is the flag the scheduler and the server check
    before they route session traffic."""

    supports_sessions = True

    def __init__(self, engine, *, session_budget_mb: float = 256.0,
                 session_ttl_s: float = 120.0, retry_after_s: float = 1.0,
                 registry=None, name: str = "stream",
                 trunk: str = "full", attn_window: int = 0):
        self.engine = engine
        self.name = name
        self.session_budget_bytes = int(session_budget_mb * 1e6)
        self.table = SessionTable(ttl_s=session_ttl_s,
                                  retry_after_s=retry_after_s,
                                  registry=registry, name=name)
        self._lock = threading.Lock()
        # pool key -> {ring name: device tensor, "cap", "bytes", "measured_bytes"}
        self._pools: Dict[tuple, Dict[str, Any]] = {}
        self._committed = 0  # declared ring-pool bytes against the budget
        self._mem_component = f"stream_rings:{name}"
        self._fns: Dict[tuple, Any] = {}  # (op, kind, geom, stride, bucket)
        model = engine.model
        backend = "dense"
        if isinstance(model, VideoMAEClassifier):
            self.kind = "tokens"
            enc = model.encoder
            tt, p, _ = enc.patch_embed.proj.kernel_size
            self._tok_meta = {"tt": int(tt), "p": int(p), "dim": int(enc.dim),
                              "dtype": enc.patch_embed.dtype}
            backend = enc.block0.backend
        elif isinstance(model, MViT):
            self.kind = "stem"
            pe = model.patch_embed
            kt = int(pe.kernel_size[0])
            if kt % 2 == 0:
                raise SessionError(
                    "stem-ring streaming needs an odd temporal patch "
                    f"kernel (halo = kt//2 frames each side); got {kt}")
            self._tok_meta = {"ts": int(pe.stride[0]), "halo": kt // 2,
                              "kernel": tuple(int(k) for k in pe.kernel_size),
                              "stride_sp": tuple(int(s) for s in pe.stride),
                              "dim": int(pe.out_channels), "dtype": model.dtype}
        elif isinstance(model, SlowFast) \
                or engine.model_name.startswith("slowfast"):
            self.kind = "dual"
            self._tok_meta = {"alpha": int(getattr(model, "alpha", 4))}
        else:
            self.kind = "frames"
            self._tok_meta = None

        self.trunk = str(trunk)
        self.attn_window = int(attn_window)
        self._kv_meta: Optional[dict] = None
        if self.trunk not in TRUNK_MODES:
            raise SessionError(
                f"unknown stream trunk {trunk!r}; expected one of "
                f"{TRUNK_MODES} (serve.stream_trunk)")
        if self.trunk != "full":
            if self.kind != "tokens":
                reason = {
                    "stem": "MViT's pooling attention mixes time through "
                            "(3,·,·) conv kernels at every stage — there "
                            "is no causal KV seam",
                    "dual": "slowfast's lateral time-strided fusion convs "
                            "mix time globally",
                    "frames": "3-D conv trunks mix time globally",
                }[self.kind]
                raise SessionError(
                    f"stream trunk {self.trunk!r} needs a "
                    "VideoMAEClassifier token seam; "
                    f"{engine.model_name!r} does not have one ({reason}) "
                    "— serve stream_trunk=full "
                    "(docs/SERVING.md § trunk-reuse)")
            if backend != "dense":
                raise SessionError(
                    f"stream trunk {self.trunk!r} runs banded-mask "
                    "attention, which only the 'dense' backend lowers "
                    f"(model.attention={backend!r}) — "
                    "see ops/attention.dot_product_attention")
            if self.trunk == "windowed" and self.attn_window < 1:
                # the band width of the served model's own finetune knob
                # (--model.attn_mask windowed --model.attn_window W)
                self.attn_window = int(getattr(model.encoder, "attn_window", 0))
            if self.trunk == "windowed" and self.attn_window < 1:
                raise SessionError(
                    "stream trunk 'windowed' needs attn_window >= 1 "
                    "(temporal slots; pass attn_window= or serve a model "
                    "finetuned with --model.attn_window)")
            self._kv_meta = {"depth": int(model.encoder.depth),
                             "heads": int(model.encoder.block0.num_heads)}

        names = ["raw"]
        if self.kind == "tokens":
            names.append("tok")
            if self.trunk != "full":
                names.append("kv")
                if self.quantization == "int8":
                    names.append("kv_scale")
                names.append("hid")
        elif self.kind == "stem":
            names.append("stem")
        elif self.kind == "dual":
            names.append("slow")
        self._ring_names = tuple(names)

    # --- the wrapped engine's surface --------------------------------------

    @property
    def buckets(self):
        return self.engine.buckets

    @property
    def device(self):
        return self.engine.device

    @property
    def model(self):
        return self.engine.model

    @property
    def model_name(self):
        return self.engine.model_name

    @property
    def num_classes(self):
        return self.engine.num_classes

    @property
    def input_dtype(self):
        return self.engine.input_dtype

    @property
    def stats(self):
        return self.engine.stats

    @property
    def quantization(self):
        return getattr(self.engine, "quantization", "off")

    def bucket_for(self, n: int) -> int:
        return self.engine.bucket_for(n)

    def predict(self, batch):
        return self.engine.predict(batch)

    def warmup(self, sample_clip) -> None:
        self.engine.warmup(sample_clip)

    # --- geometry ---------------------------------------------------------

    @staticmethod
    def geom_key(window: int, h: int, w: int, c: int, dtype: str) -> tuple:
        return (int(window), int(h), int(w), int(c), str(dtype))

    def _band_width(self, geom: tuple) -> int:
        """The temporal band W in token slots: T' for causal, the model's
        attn_window for windowed."""
        return (geom[0] // self._tok_meta["tt"]) if self.trunk == "causal" \
            else self.attn_window

    def _stem_hw(self, geom: tuple) -> tuple:
        """The stem-token grid (h', w') of one geometry: the padded-conv
        arithmetic of the model's patch embed."""
        m = self._tok_meta
        _, kh, kw = m["kernel"]
        _, sh, sw = m["stride_sp"]
        _, h, w, _, _ = geom
        return (h + 2 * (kh // 2) - kh) // sh + 1, (w + 2 * (kw // 2) - kw) // sw + 1

    def ring_bytes(self, geom: tuple) -> int:
        """Device bytes of ONE session's ring(s): the unit of the session
        budget."""
        t, h, w, c, dtype = geom
        frame = h * w * c * np.dtype(dtype).itemsize
        total = t * frame
        m = self._tok_meta
        if self.kind == "tokens":
            itemsize = _itemsize(m["dtype"])
            tn = t // m["tt"]
            hw = (h // m["p"]) * (w // m["p"])
            total += tn * hw * m["dim"] * itemsize
            if self.trunk != "full":
                kv_elems = self._kv_meta["depth"] * 2 * tn * hw
                if self.quantization == "int8":
                    total += kv_elems * m["dim"] + kv_elems * 4  # q8 + scale
                else:
                    total += kv_elems * m["dim"] * itemsize
                total += tn * m["dim"] * itemsize  # hidden ring
        elif self.kind == "stem":
            hh, ww = self._stem_hw(geom)
            total += (t // m["ts"]) * hh * ww * m["dim"] * _itemsize(m["dtype"])
        elif self.kind == "dual":
            total += (t // m["alpha"]) * frame
        return total

    def advance_h2d_bytes(self, geom: tuple, stride: int) -> int:
        """Host-to-device payload bytes of one incremental advance."""
        _, h, w, c, dtype = geom
        return stride * h * w * c * np.dtype(dtype).itemsize

    def full_h2d_bytes(self, geom: tuple) -> int:
        """Host-to-device payload bytes of one full-window recompute."""
        t, h, w, c, dtype = geom
        return t * h * w * c * np.dtype(dtype).itemsize

    def _validate(self, geom: tuple, stride: int) -> None:
        t, h, w, c, _ = geom
        if stride <= 0 or t % stride != 0:
            raise SessionError(
                f"stride {stride} must divide the window length {t} "
                "(ring writes must never wrap mid-advance)")
        if self.kind == "tokens":
            m = self._tok_meta
            if stride % m["tt"] != 0:
                raise SessionError(
                    f"stride {stride} must be a multiple of the model's "
                    f"temporal tubelet {m['tt']} (token-ring granularity)")
            if t % m["tt"] or h % m["p"] or w % m["p"]:
                raise SessionError(
                    f"window geometry {(t, h, w)} does not tile the "
                    f"tubelet {(m['tt'], m['p'], m['p'])}")
            if self.trunk == "windowed" and self.attn_window > t // m["tt"]:
                raise SessionError(
                    f"attn_window {self.attn_window} exceeds the window's "
                    f"{t // m['tt']} token slots — a band wider than the "
                    "ring would attend evicted state")
        elif self.kind == "stem":
            m = self._tok_meta
            if stride % m["ts"] or t % m["ts"]:
                raise SessionError(
                    f"stride {stride} / window {t} must be multiples of "
                    f"the stem's temporal stride {m['ts']} (stem-ring "
                    "granularity)")
            kt = m["kernel"][0]
            if (m["halo"] + stride - kt) % m["ts"] \
                    or (m["halo"] + stride - kt) // m["ts"] + 1 \
                    != stride // m["ts"]:
                raise SessionError(
                    f"stride {stride} does not align the stem conv "
                    f"(kernel {kt}, stride {m['ts']}, halo {m['halo']})")
        elif self.kind == "dual":
            alpha = self._tok_meta["alpha"]
            if stride % alpha or t % alpha:
                raise SessionError(
                    f"stride {stride} / window {t} must be multiples of "
                    f"the slowfast alpha {alpha} — the slow ring advances "
                    "in lock-step at 1/alpha rate")

    # --- pools ------------------------------------------------------------

    def _pool(self, geom: tuple) -> Dict[str, Any]:
        """Get or allocate the ring pool of `geom`. The budget is global
        across pools: a new geometry's pool is sized from the budget's
        remaining bytes, and one that would hold no session is refused, so
        a client fanning out novel window shapes meets 503s, never an
        out-of-memory card."""
        with self._lock:
            pool = self._pools.get(geom)
            if pool is not None:
                return pool
            ring = max(self.ring_bytes(geom), 1)
            committed, src = self._budget_committed()
            cap = (self.session_budget_bytes - committed) // ring
            if cap < 1:
                raise SessionAdmissionError(
                    f"session budget exhausted ({self.name}: "
                    f"{committed / 1e6:.0f} MB committed ({src}) of "
                    f"{self.session_budget_bytes / 1e6:.0f} MB; a "
                    f"{ring / 1e6:.1f} MB/session pool for {geom} does "
                    "not fit); retry later",
                    retry_after_s=self.table.retry_after_s)
            # +1 scratch slot: padded launch rows write there, never into a
            # leased ring
            pool = {"cap": int(cap), "bytes": int(cap + 1) * ring}
            with torch.inference_mode():
                for nm in self._ring_names:
                    pool[nm] = self._alloc_ring(nm, geom, int(cap) + 1)
            self._register(pool)
            self._pools[geom] = pool
            self.table.register_pool(geom, int(cap))
            logger.info(
                "stream: pool %s = %d session slots (+1 scratch), "
                "%.1f MB/session (%s); %.0f/%.0f MB budget committed",
                geom, cap, ring / 1e6, "+".join(self._ring_names),
                self._committed / 1e6, self.session_budget_bytes / 1e6)
            return pool

    def _register(self, pool: Dict[str, Any]) -> None:
        """Caller holds `_lock`: count `pool` against the budget and the
        ledger (its tensors' actual bytes)."""
        pool["measured_bytes"] = sum(
            pool[nm].numel() * pool[nm].element_size()
            for nm in self._ring_names if nm in pool)
        self._committed += pool["bytes"]
        obs_memory.register(self._mem_component, pool["measured_bytes"])

    def _release(self, pool: Dict[str, Any]) -> None:
        """Caller holds `_lock`: the inverse of `_register`."""
        self._committed -= pool["bytes"]
        obs_memory.release(self._mem_component, pool["measured_bytes"])

    def _budget_committed(self) -> tuple:
        """(bytes, source) the admission diffs against the budget: the
        ledger's measured ring bytes where it reads the card, the declared
        `ring_bytes` sums otherwise."""
        led = obs_memory.get_ledger()
        if led is not None and led.source() == "measured":
            return led.component_bytes(self._mem_component), "measured"
        return self._committed, "declared"

    def _alloc_ring(self, name: str, geom: tuple, rows: int) -> torch.Tensor:
        t, h, w, c, dtype = geom
        m = self._tok_meta
        if name == "raw":
            shape, dt = (rows, t, h, w, c), _torch_dtype(dtype)
        elif name == "tok":
            shape = (rows, t // m["tt"], (h // m["p"]) * (w // m["p"]), m["dim"])
            dt = m["dtype"]
        elif name == "kv":
            tn, hw = t // m["tt"], (h // m["p"]) * (w // m["p"])
            shape = (rows, self._kv_meta["depth"], 2, tn, hw, m["dim"])
            dt = torch.int8 if self.quantization == "int8" else m["dtype"]
        elif name == "kv_scale":
            tn, hw = t // m["tt"], (h // m["p"]) * (w // m["p"])
            shape, dt = (rows, self._kv_meta["depth"], 2, tn, hw), torch.float32
        elif name == "hid":
            shape, dt = (rows, t // m["tt"], m["dim"]), m["dtype"]
        elif name == "stem":
            hh, ww = self._stem_hw(geom)
            shape, dt = (rows, t // m["ts"], hh, ww, m["dim"]), m["dtype"]
        elif name == "slow":
            shape, dt = (rows, t // m["alpha"], h, w, c), _torch_dtype(dtype)
        else:
            raise SessionError(f"unknown ring {name!r}")
        return torch.zeros(shape, dtype=dt, device=self.device)

    # --- forwards ---------------------------------------------------------

    def _normalize(self, frames: torch.Tensor) -> torch.Tensor:
        return device_normalize_batch({"video": frames},
                                      self.engine._device_normalize)["video"]

    def _forward_windows(self, windows: torch.Tensor) -> torch.Tensor:
        """The wrapped engine's forward over device windows (B, T, H, W, C):
        normalize -> model, the op sequence of `InferenceEngine.predict`."""
        batch = device_normalize_batch({"video": windows},
                                       self.engine._device_normalize)
        return f32_island(multiview_logits(self.engine.model, model_inputs(batch)))

    def _forward_dual(self, slow_w: torch.Tensor, fast_w: torch.Tensor) -> torch.Tensor:
        """`_forward_windows` for the SlowFast pathway pair."""
        batch = device_normalize_batch({"slow": slow_w, "fast": fast_w},
                                       self.engine._device_normalize)
        return f32_island(multiview_logits(self.engine.model, model_inputs(batch)))

    def _embed_tokens(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, t, H, W, C) frames -> (B, t/tt, hw, dim) pre-positional
        tokens through the classifier's own cube embed."""
        tokens, (t, h, w) = self.engine.model.encoder.patch_embed(
            self._normalize(frames))
        return tokens.reshape(tokens.shape[0], t, h * w, tokens.shape[-1])

    def _forward_tokens(self, tok_windows: torch.Tensor) -> torch.Tensor:
        """The trunk from cached tokens: + window-order positions -> the
        encoder's blocks (with the model's own band, if it was finetuned
        with one: `full` recomputes the trunk, it never drops the mask) ->
        mean -> fc_norm -> head, as `VideoMAEClassifier.forward`."""
        enc = self.engine.model.encoder
        b, t, hw, dim = tok_windows.shape
        tokens = tok_windows.reshape(b, t * hw, dim)
        tokens = tokens + _pos_table(t * hw, dim, tokens.device).to(tokens.dtype)
        tokens = run_vit_blocks(enc.blocks(), tokens,
                                enc.band_mask(t, hw, tokens.device), enc.pipeline)
        return self._head_logits(tokens.mean(dim=1))

    def _head_logits(self, feat: torch.Tensor) -> torch.Tensor:
        """The classifier's epilogue, fc_norm -> f32 head, shared by every
        token and K/V trunk."""
        model = self.engine.model
        return f32_island(model.head(f32_island(model.fc_norm(feat))))

    # --- the K/V trunk (causal / windowed) -------------------------------

    def _block_fwd(self, block, x, mask, kv_cache=None):
        """One ViT block from its submodules, exposing the per-layer K/V the
        rings cache; op for op `models/videomae.ViTBlock`. `kv_cache=(k, v)`
        (B, Nc, dim): x's queries attend [cache ++ x's own keys] under
        `mask` over that key order. Returns (x_out, k, v), k and v of x's
        own tokens only: what gets written back into the ring."""
        dim, heads = block.dim, block.num_heads
        hd = dim // heads
        q, k, v = block.qkv(block.norm1(x)).split(dim, dim=-1)
        kk, vv = k, v
        if kv_cache is not None:
            kk = torch.cat([kv_cache[0].to(k.dtype), k], dim=1)
            vv = torch.cat([kv_cache[1].to(v.dtype), v], dim=1)
        b, nq = q.shape[:2]
        nk = kk.shape[1]
        attn = dot_product_attention(
            q.reshape(b, nq, heads, hd), kk.reshape(b, nk, heads, hd),
            vv.reshape(b, nk, heads, hd), backend=block.backend,
            mask=mask).reshape(b, nq, dim)
        x = x + block.proj(attn)
        x = x + block.mlp_fc2(F.gelu(block.mlp_fc1(block.norm2(x))))
        return x, k, v

    def _stack_kv(self, ks, vs, b, slots, hw, dim) -> torch.Tensor:
        """Per-layer K and V lists -> (B, L, 2, slots, hw, dim)."""
        return torch.stack([torch.stack(ks, dim=1), torch.stack(vs, dim=1)],
                           dim=2).reshape(b, len(ks), 2, slots, hw, dim)

    def _trunk_kv_full(self, tokens, slot_idx, window: int, ring_slots: int):
        """The masked trunk over a whole window of tokens (B, tn, hw, dim) in
        logical (oldest-first) order -> (per-layer K/V (B, L, 2, tn, hw,
        dim), per-slot hidden means (B, tn, dim)). `slot_idx` (B, tn) is each
        slot's ring-stable position index (abs_slot mod T'); the positional
        codes are gathered by it, so cached K/V stay valid as the ring
        rotates (at establish `slot_idx == arange(T')`)."""
        enc = self.engine.model.encoder
        b, tn, hw, dim = tokens.shape
        dev = tokens.device
        pos = _pos_table(ring_slots * hw, dim, dev)
        pos_idx = slot_idx[..., None] * hw + torch.arange(hw, device=dev)
        x = tokens.reshape(b, tn * hw, dim) + pos[pos_idx.reshape(b, tn * hw)].to(tokens.dtype)
        mask = temporal_band_mask(tn, hw, window, dev)[None, None]
        ks, vs = [], []
        for block in enc.blocks():
            x, k, v = self._block_fwd(block, x, mask)
            ks.append(k)
            vs.append(v)
        kv = self._stack_kv(ks, vs, b, tn, hw, dim)
        return kv, x.reshape(b, tn, hw, dim).mean(dim=2)

    def _trunk_kv_step(self, new_tok, kv_cache, tpos, window: int, ring_slots: int):
        """The incremental trunk: the ns new slots' queries against the
        cached ring K/V plus their own -> (new per-layer K/V (B, L, 2, ns,
        hw, dim), new hidden means (B, ns, dim)). `tpos` (B,) is the
        absolute index of the first new slot; ring slot j holds absolute
        slot `newest - ((newest - j) mod T')`, so the slots this advance
        overwrites (abs <= tpos - T') fall outside every query's band.
        `kv_cache` (B, L, 2, T', hw, dim) arrives in the compute dtype."""
        enc = self.engine.model.encoder
        b, ns, hw, dim = new_tok.shape
        tn = ring_slots
        dev = new_tok.device
        j = torch.arange(tn, device=dev)[None, :]
        newest = (tpos - 1)[:, None]
        k_abs = newest - ((newest - j) % tn)                     # (B, tn)
        q_abs = tpos[:, None] + torch.arange(ns, device=dev)[None, :]
        band = banded_time_mask(q_abs, torch.cat([k_abs, q_abs], dim=1), window)
        mask = band.repeat_interleave(hw, dim=1).repeat_interleave(hw, dim=2)[:, None]
        pos = _pos_table(tn * hw, dim, dev)
        pos_idx = (q_abs % tn)[..., None] * hw + torch.arange(hw, device=dev)
        x = new_tok.reshape(b, ns * hw, dim) + pos[pos_idx.reshape(b, ns * hw)].to(new_tok.dtype)
        ks, vs = [], []
        for i, block in enumerate(enc.blocks()):
            cache = (kv_cache[:, i, 0].reshape(b, tn * hw, dim),
                     kv_cache[:, i, 1].reshape(b, tn * hw, dim))
            x, k, v = self._block_fwd(block, x, mask, kv_cache=cache)
            ks.append(k)
            vs.append(v)
        new_kv = self._stack_kv(ks, vs, b, ns, hw, dim)
        return new_kv, x.reshape(b, ns, hw, dim).mean(dim=2)

    def _write_kv(self, rings, kv_new, hid_new, slots, toffs) -> None:
        """Quantize (int8 engines) and write one step's new K/V and hidden
        slots into their rings."""
        if "kv_scale" in rings:
            q8, sc = quantize_kv(kv_new)
            _write(rings["kv"], q8, slots, toffs, axis=3)
            _write(rings["kv_scale"], sc, slots, toffs, axis=3)
        else:
            _write(rings["kv"], kv_new, slots, toffs, axis=3)
        _write(rings["hid"], hid_new, slots, toffs)

    # --- the MViT stem seam ------------------------------------------------

    def _stem_embed(self, frames: torch.Tensor, temporal_pad: int) -> torch.Tensor:
        """Normalized frames through MViT's patch-embed conv -> (B, t', h',
        w', dim) pre-positional stem tokens. `temporal_pad`: the model's own
        halo for establish and replay (a fresh stream's zero halo), 0 for
        an advance, whose real halo frames ride at the front of `frames`."""
        m = self._tok_meta
        model = self.engine.model
        pe = model.patch_embed
        d = model.dtype
        _, kh, kw = m["kernel"]
        y = F.conv3d(self._normalize(frames).to(d).permute(0, 4, 1, 2, 3),
                     pe.weight.to(d), pe.bias.to(d), pe.stride,
                     (temporal_pad, kh // 2, kw // 2))
        return y.permute(0, 2, 3, 4, 1)

    def _forward_stem(self, stem_windows: torch.Tensor) -> torch.Tensor:
        """The trunk from window-ordered stem tokens (B, T', H', W', dim):
        `MViT.forward(..., from_stem=True)` adds pos_embed inside."""
        return f32_island(self.engine.model(stem_windows, from_stem=True))

    # --- steps ------------------------------------------------------------

    def _get_fn(self, op: str, geom: tuple, stride: int, bucket: int):
        key = (op, self.kind, geom, int(stride), int(bucket))
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        with self._lock:
            fn = self._fns.get(key)
            if fn is None:
                if len(self._fns) >= MAX_STREAM_KEYS:
                    raise SessionError(
                        f"engine already compiled {len(self._fns)} stream "
                        "geometries; refusing a new one (clients should "
                        "send the serving stream geometry)")
                fn = self._build_fn(op, geom, stride)
                self._fns[key] = fn
                logger.info("stream: built %s for %s stride=%d B=%d",
                            op, geom, stride, bucket)
        return fn

    def _build_fn(self, op: str, geom: tuple, stride: int):
        """The step of one (op, geometry, stride): fn(rings, payload, slots,
        offs, tpos) -> f32 logits, writing the rings in place. `payload` is
        the windows (establish) or the new frames (advance), on the device;
        slots, offs and tpos are (B,) int64 device tensors (offs and tpos
        None where the op takes none)."""
        if op not in ("establish", "advance"):
            raise SessionError(f"unknown stream op {op!r}")
        establish = op == "establish"
        m = self._tok_meta
        t = geom[0]

        if self.kind == "tokens" and self.trunk != "full":
            tt = m["tt"]
            tn = t // tt
            window = self._band_width(geom)

            def fn(rings, x, slots, offs, tpos):
                if establish:
                    offs = torch.zeros_like(slots)
                _write(rings["raw"], x, slots, offs)
                new_tok = self._embed_tokens(x)
                toffs = offs // tt
                _write(rings["tok"], new_tok, slots, toffs)
                if establish:
                    slot_idx = torch.arange(tn, device=x.device).expand(x.shape[0], tn)
                    kv_new, hid_new = self._trunk_kv_full(new_tok, slot_idx, window, tn)
                    self._write_kv(rings, kv_new, hid_new, slots, toffs)
                    return self._head_logits(hid_new.mean(dim=1))
                kv_rows = rings["kv"][slots]
                if "kv_scale" in rings:
                    kv_rows = dequantize_kv(kv_rows, rings["kv_scale"][slots], m["dtype"])
                kv_new, hid_new = self._trunk_kv_step(new_tok, kv_rows, tpos, window, tn)
                self._write_kv(rings, kv_new, hid_new, slots, toffs)
                return self._head_logits(rings["hid"][slots].mean(dim=1))

            return fn

        if self.kind == "tokens":
            tt = m["tt"]

            def fn(rings, x, slots, offs, tpos):
                if establish:
                    offs = torch.zeros_like(slots)
                _write(rings["raw"], x, slots, offs)
                new_tok = self._embed_tokens(x)
                _write(rings["tok"], new_tok, slots, offs // tt)
                if establish:
                    return self._forward_tokens(new_tok)
                return self._forward_tokens(
                    _rolled(rings["tok"], slots, (offs + stride) // tt))

            return fn

        if self.kind == "stem":
            ts, halo = m["ts"], m["halo"]

            def fn(rings, x, slots, offs, tpos):
                if establish:
                    zeros = torch.zeros_like(slots)
                    _write(rings["raw"], x, slots, zeros)
                    new_stem = self._stem_embed(x, halo)
                    _write(rings["stem"], new_stem, slots, zeros)
                    return self._forward_stem(new_stem)
                _write(rings["raw"], x, slots, offs)
                # the real left halo: the newest frames before this write's
                # offset (the write covers [off, off + stride))
                halo_idx = (offs[:, None] - halo
                            + torch.arange(halo, device=x.device)[None, :]) % t
                halo_frames = rings["raw"][slots[:, None], halo_idx]
                new_stem = self._stem_embed(
                    torch.cat([halo_frames.to(x.dtype), x], dim=1), 0)
                _write(rings["stem"], new_stem, slots, offs // ts)
                return self._forward_stem(
                    _rolled(rings["stem"], slots, (offs + stride) // ts))

            return fn

        if self.kind == "dual":
            alpha = m["alpha"]

            def fn(rings, x, slots, offs, tpos):
                if establish:
                    offs = torch.zeros_like(slots)
                _write(rings["raw"], x, slots, offs)
                _write(rings["slow"], x[:, ::alpha], slots, offs // alpha)
                if establish:
                    return self._forward_dual(x[:, ::alpha], x)
                return self._forward_dual(
                    _rolled(rings["slow"], slots, (offs + stride) // alpha),
                    _rolled(rings["raw"], slots, offs + stride))

            return fn

        def fn(rings, x, slots, offs, tpos):
            if establish:
                # the freshly written rings ARE the input windows (offset 0)
                _write(rings["raw"], x, slots, torch.zeros_like(slots))
                return self._forward_windows(x)
            _write(rings["raw"], x, slots, offs)
            return self._forward_windows(_rolled(rings["raw"], slots, offs + stride))

        return fn

    # --- the session surface ---------------------------------------------

    def advance_batch(self, items: List[dict]) -> List[Any]:
        """Score one launch of session advances. Each item: ``{"sid": str,
        "frames": (s, H, W, C), "window": optional resendable (T, H, W, C),
        "stride": optional int, "end": bool}``.

        A session this replica holds advances incrementally; an unknown or
        mismatched one re-establishes from the item's resendable window, or
        fails with `SessionUnknownError` when none rides along. Items are
        grouped into same-(geometry, stride) launches; duplicate sids of one
        call run in waves (a ring is never read and written by two rows of
        one launch). Returns one entry per item, in order: f32 logits, or
        the exception that item earned (a malformed item fails its own
        future, never its neighbours')."""
        self.table.sweep()
        results: List[Any] = [None] * len(items)
        pending = list(enumerate(items))
        while pending:
            wave: List[tuple] = []
            seen: set = set()
            rest: List[tuple] = []
            for idx, item in pending:
                sid = str(item.get("sid", ""))
                if sid in seen:
                    rest.append((idx, item))
                else:
                    seen.add(sid)
                    wave.append((idx, item))
            self._run_wave(wave, results)
            pending = rest
        for item in items:
            if item.get("end"):
                self.table.end(str(item.get("sid", "")))
        return results

    def _classify(self, item: dict) -> tuple:
        """-> (mode, sid, payload, geom, stride) of one item: advance or
        re-establish, checked against the session and ring contract."""
        sid = str(item.get("sid") or "")
        if not sid:
            raise SessionError("stream item carries no session id")
        frames = item.get("frames")
        window = item.get("window")
        if frames is None and window is None:
            raise SessionError(f"stream item for {sid!r} carries neither "
                               "frames nor a window")
        dtype = self.input_dtype
        if window is not None:
            window = np.asarray(window, dtype)
            if window.ndim != 4:
                raise SessionError(
                    f"window for {sid!r} must be (T, H, W, C), got "
                    f"{window.shape}")
        if frames is not None:
            frames = np.asarray(frames, dtype)
            if frames.ndim != 4:
                raise SessionError(
                    f"frames for {sid!r} must be (s, H, W, C), got "
                    f"{frames.shape}")
        state = self.table.get(sid)
        if state is not None and frames is not None:
            geom = state.pool_key
            if (frames.shape[0] == state.stride
                    and tuple(frames.shape[1:]) == tuple(geom[1:4])):
                return ("advance", sid, frames, geom, state.stride)
            # stride or geometry drift: re-establish (a window is required:
            # writing drifted frames would corrupt the ring)
        if window is None:
            raise SessionUnknownError(
                f"session {sid!r} is not established on this replica and "
                "the request carries no resendable window")
        t, h, w, c = window.shape
        stride = int(item.get("stride") or
                     (frames.shape[0] if frames is not None else 0) or 0)
        if stride <= 0:
            raise SessionError(
                f"establish for {sid!r} needs a stride (frames payload or "
                "explicit 'stride')")
        geom = self.geom_key(t, h, w, c, dtype)
        self._validate(geom, stride)
        return ("establish", sid, window, geom, stride)

    def _run_wave(self, wave: List[tuple], results: List[Any]) -> None:
        """Group one duplicate-free wave by (mode, geom, stride) and run each
        group as one bucketed launch. Per-item failures land in `results`
        as exceptions; the rest of the wave still launches."""
        groups: Dict[tuple, List[tuple]] = {}
        for idx, item in wave:
            try:
                mode, sid, payload, geom, stride = self._classify(item)
            except Exception as e:  # noqa: BLE001 - per-item verdict
                results[idx] = e
                continue
            groups.setdefault((mode, geom, stride), []).append((idx, sid, payload))
        for (mode, geom, stride), rows in groups.items():
            try:
                if mode == "establish":
                    self._launch_establish(geom, stride, rows, results)
                else:
                    self._launch_advance(geom, stride, rows, results)
            except Exception as e:  # noqa: BLE001 - contain to THIS group
                # a group-level failure (the MAX_STREAM_KEYS refusal, a
                # launch error) fails the group that caused it, never the
                # other geometries of the same flush
                for idx, _, _ in rows:
                    if results[idx] is None:
                        results[idx] = e

    def _stack(self, rows, pool) -> tuple:
        """Pad a group to its bucket: payload rows stacked with zero rows,
        slots padded with the pool's scratch row, offsets 0."""
        n = len(rows)
        bucket = self.bucket_for(n)
        payload = np.stack([p for _, _, p in rows])
        if bucket > n:
            pad = np.zeros((bucket - n,) + payload.shape[1:], payload.dtype)
            payload = np.concatenate([payload, pad], axis=0)
        return payload, bucket, pool["cap"]

    def _tpos_of(self, state) -> int:
        """A session's absolute token-slot counter: the index the next
        advance's first new slot carries (T' just after establish).
        `tpos % T' == off // tt` is what lets the hot-swap rebuild recover
        every slot's absolute index from the adopted table."""
        return (state.window + state.frames_seen) // self._tok_meta["tt"]

    def _launch_establish(self, geom, stride, rows, results) -> None:
        pool = self._pool(geom)
        live, states = [], []
        for idx, sid, payload in rows:
            try:
                # admission (TTL eviction or 503) happens here, per session,
                # against the budget
                states.append(self.table.establish(sid, geom, stride=stride,
                                                   window=geom[0]))
                live.append((idx, sid, payload))
            except Exception as e:  # noqa: BLE001 - per-item verdict
                results[idx] = e
        if not live:
            return
        payload, bucket, scratch = self._stack(live, pool)
        slots = np.asarray([s.slot for s in states]
                           + [scratch] * (bucket - len(live)), np.int64)
        fn = self._get_fn("establish", geom, stride, bucket)
        logits = self._guarded_call(fn, geom, pool, payload, slots, None)
        for i, (idx, _, _) in enumerate(live):
            results[idx] = np.asarray(logits[i], np.float32)

    def _launch_advance(self, geom, stride, rows, results) -> None:
        pool = self._pool(geom)
        live, states = [], []
        for idx, sid, payload in rows:
            s = self.table.get(sid)
            if s is None:  # evicted between classify and launch
                results[idx] = SessionUnknownError(
                    f"session {sid!r} evicted mid-launch; resend window")
                continue
            states.append(s)
            live.append((idx, sid, payload))
        if not live:
            return
        payload, bucket, scratch = self._stack(live, pool)
        pad = bucket - len(live)
        slots = np.asarray([s.slot for s in states] + [scratch] * pad, np.int64)
        offs = np.asarray([s.off for s in states] + [0] * pad, np.int64)
        tpos = None
        if self._kv_meta is not None:
            # scratch rows get the just-established counter (T'), which
            # keeps their band and position arithmetic consistent with
            # their zero offsets
            tn = geom[0] // self._tok_meta["tt"]
            tpos = np.asarray([self._tpos_of(s) for s in states] + [tn] * pad,
                              np.int64)
        fn = self._get_fn("advance", geom, stride, bucket)
        logits = self._guarded_call(fn, geom, pool, payload, slots, offs, tpos)
        for i, (idx, sid, _) in enumerate(live):
            self.table.advanced(sid, stride)
            results[idx] = np.asarray(logits[i], np.float32)

    def _guarded_call(self, fn, geom, pool, payload, slots, offs, tpos=None):
        """`_call`, dropping the pool when a step fails part way: its rings
        may hold one ring's new rows and not another's, so every session
        on it ends and its clients re-establish from their resendable
        windows; only this group's futures see the error."""
        try:
            return self._call(fn, pool, payload, slots, offs, tpos)
        except Exception:
            dropped = self._invalidate_pool(geom)
            logger.exception(
                "stream: launch failed on %s; dropped the pool and its %d "
                "session(s) (clients re-establish from their resendable "
                "windows)", geom, dropped)
            raise

    def _invalidate_pool(self, geom) -> int:
        """Forget a pool whose rings are no longer consistent; ends every
        session leased on it. Returns the number of sessions dropped."""
        with self._lock:
            pool = self._pools.pop(geom, None)
            if pool is not None:
                self._release(pool)
        dropped = 0
        for s in self.table.sessions():
            if s.pool_key == geom and self.table.end(s.sid):
                dropped += 1
        return dropped

    def _to_device(self, arr: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        if arr is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _call(self, fn, pool, payload, slots, offs, tpos=None) -> np.ndarray:
        """Run one step: the payload and the per-row indices to the device,
        the rings written in place, the logits back to the host."""
        with torch.inference_mode():
            logits = fn(pool, self._to_device(payload), self._to_device(slots),
                        self._to_device(offs), self._to_device(tpos))
            return logits.cpu().numpy()

    def end_session(self, sid: str) -> bool:
        return self.table.end(sid)

    def warmup_stream(self, window: int, h: int, w: int, c: int,
                      stride: int) -> int:
        """Run establish and advance once at every bucket for one stream
        geometry (the stream counterpart of `InferenceEngine.warmup`):
        scratch-slot launches, so no session is made and no ring disturbed,
        and the first session at each bucket pays no first-call cost
        (kernel builds, cuDNN's algorithm search) on the flush thread."""
        geom = self.geom_key(window, h, w, c, self.input_dtype)
        self._validate(geom, stride)
        pool = self._pool(geom)
        t, _, _, _, dtype = geom
        scratch = pool["cap"]
        n = 0
        for b in self.buckets:
            slots = np.full((b,), scratch, np.int64)
            fn = self._get_fn("establish", geom, stride, b)
            self._guarded_call(fn, geom, pool, np.zeros((b, t, h, w, c), dtype),
                               slots, None)
            fn = self._get_fn("advance", geom, stride, b)
            tpos = None
            if self._kv_meta is not None:
                tpos = np.full((b,), t // self._tok_meta["tt"], np.int64)
            self._guarded_call(fn, geom, pool, np.zeros((b, stride, h, w, c), dtype),
                               slots, np.zeros((b,), np.int64), tpos)
            n += 2
        return n

    # --- parity oracles ---------------------------------------------------

    def full_recompute(self, windows: np.ndarray) -> np.ndarray:
        """The parity baseline: the host windows (B, T, H, W, C) padded to
        the engine's bucket through the ordinary one-shot `predict` (full
        host-to-device copy, embed and trunk). For the dual rings the slow
        pathway is the window's phase-0 subsample."""
        n = windows.shape[0]
        bucket = self.bucket_for(n)
        if bucket > n:
            pad = np.zeros((bucket - n,) + windows.shape[1:], windows.dtype)
            windows = np.concatenate([windows, pad], axis=0)
        if self.kind == "dual":
            alpha = self._tok_meta["alpha"]
            return self.engine.predict(
                {"slow": windows[:, ::alpha], "fast": windows})[:n]
        return self.engine.predict({"video": windows})[:n]

    def full_recompute_history(self, histories: np.ndarray,
                               window: int) -> np.ndarray:
        """The parity oracle of the stateful rings: what the incremental
        path should give from each session's whole frame history since
        establish (B, F, H, W, C), F >= window.

        - K/V trunks: one masked forward over the whole history with the
          band on absolute slot indices and ring-stable positions (the
          last window's one-shot recompute is not equivalent: cached K/V
          attended context that has since left the ring).
        - stem ring: the stem conv over the whole history (a real halo
          wherever the stream had one), its last T' slots through the
          trunk.
        - the exact-window rings: `full_recompute` of the trailing window."""
        histories = np.asarray(histories, self.input_dtype)
        stateful_kv = self.kind == "tokens" and self.trunk != "full"
        if not (stateful_kv or self.kind == "stem"):
            return np.asarray(self.full_recompute(histories[:, -window:]), np.float32)
        t = int(window)
        with torch.inference_mode():
            hist = self._to_device(histories)
            if stateful_kv:
                tn = t // self._tok_meta["tt"]
                geom = self.geom_key(t, *histories.shape[2:5], self.input_dtype)
                tok = self._embed_tokens(hist)  # (B, F', hw, dim)
                fslots = tok.shape[1]
                slot_idx = (torch.arange(fslots, device=tok.device) % tn).expand(
                    tok.shape[0], fslots)
                _, hid = self._trunk_kv_full(tok, slot_idx, self._band_width(geom), tn)
                out = self._head_logits(hid[:, -tn:].mean(dim=1))
            else:
                tn = t // self._tok_meta["ts"]
                stem = self._stem_embed(hist, self._tok_meta["halo"])
                out = self._forward_stem(stem[:, -tn:])
            return out.cpu().numpy()

    def compiled_stream_keys(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._fns, key=repr))

    # --- hot-swap state carry ---------------------------------------------

    def carry_state_from(self, blue: "StreamingEngine") -> int:
        """The cutover-time state carry (`Scheduler.swap_engine` calls this
        under its launch lock, with `blue` quiesced): adopt blue's session
        table and raw-family rings (raw and slow frames are
        weight-independent), then derive every weight-derived ring (tok,
        kv, hid, stem) again under THIS engine's weights: cached
        activations never outlive the weights that made them. The K/V and
        stem rebuild runs over each adopted raw ring with per-row offsets
        and position counters from the adopted table (fresh-establish
        semantics: the rebuilt state carries the current window's context
        only). Returns the number of sessions carried."""
        with trace.span("stream_state_carry", engine=self.name):
            self.table.adopt(blue.table)
            carried = len(self.table.sessions())
            with blue._lock:
                blue_pools = dict(blue._pools)
            # derive outside self._lock: `_pool`'s lock is not reentrant,
            # and the scheduler's launch lock already serialises the carry
            # against launches
            adopted = {geom: self._derive_rings(geom, pool)
                       for geom, pool in blue_pools.items()}
            with self._lock:
                for geom, mine in adopted.items():
                    prior = self._pools.pop(geom, None)
                    if prior is not None:
                        self._release(prior)
                    self._pools[geom] = mine
                    self._register(mine)
        # the adopted raw rings now belong to this engine's ledger
        # component; blue retires
        obs_memory.release(blue._mem_component)
        logger.info("stream: carried %d session(s), %d pool(s) across "
                    "hot-swap", carried, len(blue_pools))
        return carried

    def _derive_rings(self, geom, blue_pool) -> Dict[str, Any]:
        """This engine's ring dict for one adopted blue pool, its bytes
        counted under this engine's own `ring_bytes` (a trunk mismatch
        across the swap changes the ring family)."""
        raw = blue_pool["raw"]
        rows = raw.shape[0]
        mine: Dict[str, Any] = {"cap": blue_pool["cap"],
                                "bytes": rows * max(self.ring_bytes(geom), 1),
                                "raw": raw}
        with torch.inference_mode():
            if self.kind == "dual":
                # a blue without a slow ring (another family) gets one from
                # the raw ring's phase-0 subsample
                slow = blue_pool.get("slow")
                mine["slow"] = (slow if slow is not None
                                else raw[:, ::self._tok_meta["alpha"]].contiguous())
            elif self.kind == "tokens":
                mine["tok"] = self._reembed_pool(geom, raw)
                if self.trunk != "full":
                    offs, tpos = self._pool_positions(geom, rows)
                    derived = self._rebuild_kv(geom, raw, self._to_device(offs),
                                               self._to_device(tpos))
                    mine.update(zip([nm for nm in self._ring_names
                                     if nm in ("kv", "kv_scale", "hid")], derived))
            elif self.kind == "stem":
                offs, _ = self._pool_positions(geom, rows)
                mine["stem"] = self._rebuild_stem(geom, raw, self._to_device(offs))
        return mine

    def _pool_positions(self, geom, rows: int):
        """Per-pool-row (off, tpos) host arrays from the adopted table; rows
        without a live session get the just-established values (off 0,
        tpos T')."""
        gran = self._tok_meta["tt"] if self.kind == "tokens" \
            else self._tok_meta["ts"]
        tn = geom[0] // gran
        offs = np.zeros((rows,), np.int64)
        tpos = np.full((rows,), tn, np.int64)
        for s in self.table.sessions():
            if s.pool_key == geom and s.slot < rows:
                offs[s.slot] = s.off
                tpos[s.slot] = (s.window + s.frames_seen) // gran
        return offs, tpos

    def _reembed_pool(self, geom, raw: torch.Tensor) -> torch.Tensor:
        """A whole raw pool (rows, T, H, W, C) re-embedded into a token pool
        under this engine's weights, in one batch."""
        m = self._tok_meta
        tok = self._embed_tokens(raw)
        expect = (raw.shape[0], geom[0] // m["tt"],
                  (geom[1] // m["p"]) * (geom[2] // m["p"]), m["dim"])
        assert tuple(tok.shape) == expect, (tok.shape, expect)
        return tok

    def _rebuild_kv(self, geom, raw, offs, tpos) -> list:
        """The whole pool's K/V (and scale) and hidden rings under this
        engine's weights (the JAX package's `_rebuild_fn`): every raw ring
        embedded, rolled to logical order by its token offset, the masked
        trunk run with ring-stable positions from the position counter
        (`tpos % T' == off // tt`), the results rolled back to ring order."""
        m = self._tok_meta
        tt = m["tt"]
        tn = geom[0] // tt
        toffs = offs // tt
        tok_l = _rolled(self._embed_tokens(raw), torch.arange(raw.shape[0],
                                                              device=raw.device), toffs)
        slot_idx = (tpos[:, None] + torch.arange(tn, device=raw.device)[None, :]) % tn
        kv_l, hid_l = self._trunk_kv_full(tok_l, slot_idx, self._band_width(geom), tn)
        # logical position i of row r sits at ring slot (i + toff_r) % tn
        back = (torch.arange(tn, device=raw.device)[None, :] - toffs[:, None]) % tn
        rows = torch.arange(raw.shape[0], device=raw.device)[:, None]
        kv_r = kv_l.movedim(3, 1)[rows, back].movedim(1, 3).contiguous()
        hid_r = hid_l[rows, back]
        if "kv_scale" in self._ring_names:
            q8, sc = quantize_kv(kv_r)
            return [q8, sc, hid_r]
        return [kv_r, hid_r]

    def _rebuild_stem(self, geom, raw, offs) -> torch.Tensor:
        """The whole pool's stem ring under this engine's weights (the JAX
        package's `_rebuild_stem_fn`): each raw ring rolled to logical
        order, the model-padded stem conv (fresh-establish semantics: the
        oldest slot's halo is the stream edge), rolled back to ring order."""
        m = self._tok_meta
        rows = torch.arange(raw.shape[0], device=raw.device)
        stem_l = self._stem_embed(_rolled(raw, rows, offs), m["halo"])
        tn = stem_l.shape[1]
        back = (torch.arange(tn, device=raw.device)[None, :]
                - (offs // m["ts"])[:, None]) % tn
        return stem_l[rows[:, None], back].contiguous()

    def prepare_carry_from(self, blue: "StreamingEngine") -> int:
        """The prewarm half of the state carry: run every stream step blue
        serves (`warmup_stream` per geometry and stride) and the whole-pool
        re-derives on dummy rings of blue's pool shapes, so the cutover
        pays no first-call cost. Touches no blue tensor: blue keeps
        launching meanwhile."""
        n = 0
        seen = set()
        for key in blue.compiled_stream_keys():
            _, _, geom, stride, _ = key
            if (geom, stride) in seen:
                continue
            seen.add((geom, stride))
            t, h, w, c, _ = geom
            n += self.warmup_stream(t, h, w, c, stride)
        if self.kind in ("tokens", "stem"):
            with blue._lock:
                shapes = {g: tuple(p["raw"].shape) for g, p in blue._pools.items()}
            with torch.inference_mode():
                for geom, shape in shapes.items():
                    dummy = torch.zeros(shape, dtype=_torch_dtype(geom[4]),
                                        device=self.device)
                    zero = torch.zeros((shape[0],), dtype=torch.int64,
                                       device=self.device)
                    if self.kind == "stem":
                        self._rebuild_stem(geom, dummy, zero)
                    else:
                        self._reembed_pool(geom, dummy)
                        if self.trunk != "full":
                            self._rebuild_kv(geom, dummy, zero,
                                             zero + geom[0] // self._tok_meta["tt"])
                    n += 1
        return n

    def snapshot(self) -> Dict[str, float]:
        snap = self.table.snapshot()
        with self._lock:
            snap["stream_compiled"] = float(len(self._fns))
            snap["stream_pools"] = float(len(self._pools))
        return snap
