"""VideoMAE: masked-autoencoder pretraining and fine-tuning of video ViTs,
counterpart of the JAX package's `models/videomae.py` (Tong et al. 2022,
ViT-B constants):

- cube embedding: a (2,16,16) conv with stride (2,16,16), 768 dims ->
  (T/2)(H/16)(W/16) tokens, t-major (1568 for 16 frames at 224^2), plus a
  fixed sin-cos position table (`sincos_pos_embed`, no parameters);
- tube masking: one random spatial mask shared by every temporal index
  (ratio 0.9), drawn from an explicit `torch.Generator`
  (`tube_mask_indices`); the encoder (12 blocks, 12 heads) sees the
  visible tokens only;
- decoder: 384 dims, 4 blocks, 6 heads, over the visible tokens then the
  learned `mask_token` at every masked position, each plus its sin-cos
  position; an f32 `dec_pred` Linear predicts the per-patch-normalised
  pixel cube of every masked patch; loss: MSE over the masked patches;
- classifier: the encoder over all tokens without its final norm, the mean
  over tokens, `fc_norm`, dropout, an f32 `head` (normal(0.01) init).

Attention goes through `ops/attention.py` with `attention_backend`
dense|pallas; `attn_mask` causal|windowed (dense only) bands the
classifier's trunk in time. Submodules carry the flax names (`encoder.
block0.qkv.weight`, `dec_block1.mlp_fc2.bias`, `mask_token`).

`remat` checkpoints every ViTBlock, encoder and decoder
(`models/common.py remat_call`, the JAX package's `nn.remat(ViTBlock)`).
On the model axis (`parallel/tensor_parallel.py apply_model_axis`) a
ViTBlock whose heads divide it runs its local heads (`split_heads`: `qkv`
column-parallel and head-aligned, `proj` row-parallel) and every block's
MLP splits as a column / row pair; the decoder's attention stays
replicated (the JAX rules name no `dec_block*` `proj`). `--model.attention
ring|ulysses` splits the attention's tokens over the same axis instead.
`set_pipeline(plan)` (`parallel/pipeline.py`) streams the encoder's blocks,
and the decoder's when its depth divides into the stages, through the
stage pipeline in training (`run_vit_blocks`); the parameter tree is the
same either way. Not ported: block-boundary sharding.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pytorchvideo_accelerate_tpu_torch.models.common import (
    Dense,
    LayerNorm,
    SeededDropout,
    batch_rand,
    check_remat_block,
    remat_call,
)
from pytorchvideo_accelerate_tpu_torch.ops.attention import (
    dot_product_attention,
    temporal_band_mask,
)
from pytorchvideo_accelerate_tpu_torch.parallel.pipeline import (
    PipelinePlan,
    apply_pipelined_blocks,
    is_active,
)
from pytorchvideo_accelerate_tpu_torch.precision import f32_island

ATTN_MASKS = ("none", "causal", "windowed")


def sincos_pos_embed(n_pos: int, dim: int) -> np.ndarray:
    """Fixed 1-D sin-cos table (n_pos, dim) float32, interleaved: sin on
    even dims, cos on odd, angle pos * 10000^(-2 (j // 2) / dim) (the
    original-transformer convention of VideoMAE's checkpoints)."""
    pos = np.arange(n_pos, dtype=np.float64)[:, None]
    omega = 10000.0 ** (-(np.arange(dim, dtype=np.float64) // 2 * 2) / dim)
    ang = pos * omega[None, :]
    emb = np.empty((n_pos, dim))
    emb[:, 0::2] = np.sin(ang[:, 0::2])
    emb[:, 1::2] = np.cos(ang[:, 1::2])
    return emb.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _pos_table(n: int, dim: int, device: torch.device) -> torch.Tensor:
    """`sincos_pos_embed` on `device`, made once per (n, dim, device) as a
    normal tensor even under inference mode (callers never write to it)."""
    with torch.inference_mode(False):
        return torch.from_numpy(sincos_pos_embed(n, dim)).to(device)


class ViTBlock(nn.Module):
    """Pre-LN transformer block: norm1 -> qkv -> attention -> proj,
    residual; norm2 -> mlp_fc1 -> erf GELU -> mlp_fc2, residual. `remat`:
    the block runs under activation checkpointing."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attention_backend: str = "dense", dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.dim = dim
        self.num_heads = num_heads
        self.backend = attention_backend
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, dtype)
        self.local_heads, self.local_dim = num_heads, dim
        if remat:
            check_remat_block(self)

    def split_heads(self, count: int, index: int) -> None:
        """Run this rank's 1/count of the heads (the model axis's `qkv` and
        `proj` shards hold them; `index` places them there)."""
        del index
        self.local_heads = self.num_heads // count
        self.local_dim = self.dim // count

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        if self.remat:
            return remat_call(self, self._forward, x, mask)
        return self._forward(x, mask)

    def _forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        b, n, _ = x.shape
        shape = (b, n, self.local_heads, self.dim // self.num_heads)
        q, k, v = self.qkv(self.norm1(x)).split(self.local_dim, dim=-1)
        attn = dot_product_attention(q.reshape(shape), k.reshape(shape),
                                     v.reshape(shape), backend=self.backend,
                                     mask=mask)
        x = x + self.proj(attn.reshape(b, n, self.local_dim))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class CubeEmbed(nn.Module):
    """(B, T, H, W, 3) -> ((B, t*h*w, dim) t-major tokens, (t, h, w)): a
    conv with kernel = stride = tubelet, no padding, with bias."""

    def __init__(self, dim: int = 768, tubelet: Sequence[int] = (2, 16, 16),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv3d(3, dim, tuple(tubelet), tuple(tubelet))

    def forward(self, x: torch.Tensor):
        d = self.dtype
        y = F.conv3d(x.to(d).permute(0, 4, 1, 2, 3), self.proj.weight.to(d),
                     self.proj.bias.to(d), self.proj.stride)
        b, c, t, h, w = y.shape
        return y.permute(0, 2, 3, 4, 1).reshape(b, t * h * w, c), (t, h, w)


def run_vit_blocks(blocks: Sequence[nn.Module], tokens: torch.Tensor,
                   mask=None, pipeline: Optional[PipelinePlan] = None) -> torch.Tensor:
    """A stack of ViTBlocks in order, through the stage pipeline when
    `pipeline` is active (`parallel/pipeline.py apply_pipelined_blocks`,
    which refuses a band mask with the JAX error)."""
    return apply_pipelined_blocks(blocks, tokens, pipeline, mask)


class VideoMAEEncoder(nn.Module):
    """ViT encoder over (a subset of) cube tokens: `patch_embed`, sin-cos
    positions, `block{i}`, and the final `norm` when `final_norm`."""

    def __init__(self, dim: int = 768, depth: int = 12, num_heads: int = 12,
                 tubelet: Sequence[int] = (2, 16, 16),
                 attention_backend: str = "dense", final_norm: bool = True,
                 attn_mask: str = "none", attn_window: int = 0,
                 dtype=torch.float32, remat: bool = False):
        super().__init__()
        if attn_mask not in ATTN_MASKS:
            raise ValueError(f"unknown attn_mask {attn_mask!r} (none|causal|windowed)")
        self.dim = dim
        self.depth = depth
        self.attn_mask = attn_mask
        self.attn_window = attn_window
        self.patch_embed = CubeEmbed(dim, tubelet, dtype)
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, num_heads,
                                                  attention_backend=attention_backend,
                                                  dtype=dtype, remat=remat))
        self.norm = LayerNorm(dim, dtype=dtype) if final_norm else None
        self.pipeline: Optional[PipelinePlan] = None

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    def set_pipeline(self, plan: Optional[PipelinePlan]) -> None:
        """Pipeline the blocks under `plan` (None: the plain loop)."""
        self.pipeline = plan

    def pipelined_blocks(self):
        return [f"block{i}" for i in range(self.depth)] if is_active(self.pipeline) else []

    def band_mask(self, t: int, hw: int, device):
        """The temporal band of `attn_mask` over t slots of hw tokens, or
        None for a bidirectional trunk."""
        if self.attn_mask == "none":
            return None
        window = t
        if self.attn_mask == "windowed":
            if not 1 <= self.attn_window <= t:
                raise ValueError(f"attn_mask='windowed' needs 1 <= attn_window "
                                 f"<= {t} temporal slots, got {self.attn_window}")
            window = self.attn_window
        return temporal_band_mask(t, hw, window, device)[None, None]

    def forward(self, x: torch.Tensor, keep_idx: Optional[torch.Tensor] = None):
        """x (B, T, H, W, 3); `keep_idx` (B, n_vis) token indices to encode
        (pretraining), None for all. Returns (tokens, (t, h, w))."""
        tokens, (t, h, w) = self.patch_embed(x)
        tokens = tokens + _pos_table(tokens.shape[1], self.dim,
                                     tokens.device).to(tokens.dtype)
        mask = self.band_mask(t, h * w, tokens.device)
        if mask is not None and keep_idx is not None:
            raise ValueError("attn_mask trunks do not compose with tube-masked "
                             "pretraining; finetune the classifier instead")
        if keep_idx is not None:
            tokens = torch.gather(tokens, 1, keep_idx[..., None].expand(
                -1, -1, tokens.shape[-1]))
        tokens = run_vit_blocks(self.blocks(), tokens, mask, self.pipeline)
        if self.norm is not None:
            tokens = self.norm(tokens)
        return tokens, (t, h, w)


def tube_mask_indices(generator: torch.Generator, batch: int, t: int, h: int,
                      w: int, mask_ratio: float, device=None):
    """One spatial mask shared across time: (keep_idx (B, n_vis), masked_idx
    (B, n_masked)) int64 indices into the t-major (t*h*w) token axis, n_vis
    = t * round(h*w*(1 - ratio)). The uniform noise is drawn on the CPU from
    `generator`, so a seed gives the same mask on every device; under data
    parallelism each rank takes its rows of the global batch's noise
    (`batch_rand`)."""
    spatial = h * w
    n_vis = max(1, int(round(spatial * (1.0 - mask_ratio))))
    noise = batch_rand((batch, spatial), generator)
    order = torch.argsort(noise, dim=1)
    toff = (torch.arange(t) * spatial)[None, :, None]

    def tube(sp):  # (B, s) spatial -> (B, t*s) spatio-temporal, t-major
        return (sp[:, None, :] + toff).reshape(batch, -1).to(device)

    return tube(order[:, :n_vis]), tube(order[:, n_vis:])


def patchify(x: torch.Tensor, tubelet: Sequence[int]) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, n_tokens, prod(tubelet) * C) pixel cubes in
    CubeEmbed's token order (t-major, then h, then w)."""
    b, t_, h_, w_, c = x.shape
    tt, p, _ = tubelet
    t, h, w = t_ // tt, h_ // p, w_ // p
    x = x.reshape(b, t, tt, h, p, w, p, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, t * h * w, tt * p * p * c)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) rows `idx` (B, n) -> (B, n, C)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class VideoMAEForPretraining(nn.Module):
    """Masked-autoencoder pretraining. `forward(x, keep_idx=None,
    masked_idx=None, generator=None)` encodes the visible tokens, decodes
    them with the mask tokens and returns {"loss", "pred", "target",
    "masked_idx"}. The tube mask is the injected (keep_idx, masked_idx), or
    drawn by `tube_mask_indices` from `generator` (a generator seeded 0 when
    none is given: the deterministic eval mask)."""

    def __init__(self, dim: int = 768, depth: int = 12, num_heads: int = 12,
                 decoder_dim: int = 384, decoder_depth: int = 4,
                 decoder_heads: int = 6, tubelet: Sequence[int] = (2, 16, 16),
                 mask_ratio: float = 0.9, norm_pix: bool = True,
                 attention_backend: str = "dense", dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.tubelet = tuple(tubelet)
        self.mask_ratio = mask_ratio
        self.norm_pix = norm_pix
        self.decoder_dim = decoder_dim
        self.decoder_depth = decoder_depth
        self.encoder = VideoMAEEncoder(dim, depth, num_heads, tubelet,
                                       attention_backend, dtype=dtype,
                                       remat=remat)
        self.enc_to_dec = Dense(dim, decoder_dim, dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_dim))
        for i in range(decoder_depth):
            self.add_module(f"dec_block{i}", ViTBlock(
                decoder_dim, decoder_heads, attention_backend=attention_backend,
                dtype=dtype, remat=remat))
        self.dec_norm = LayerNorm(decoder_dim, dtype=dtype)
        tt, p, _ = self.tubelet
        self.dec_pred = nn.Linear(decoder_dim, tt * p * p * 3)
        self.dec_pipeline: Optional[PipelinePlan] = None

    def set_pipeline(self, plan: Optional[PipelinePlan]) -> None:
        """Pipeline the encoder under `plan`, and the decoder too when its
        depth divides into the stages (else it runs unpipelined on every
        stage rank, as in the JAX package)."""
        self.encoder.set_pipeline(plan)
        self.dec_pipeline = plan if plan is not None and plan.covers(self.decoder_depth) else None

    def pipelined_blocks(self):
        if not is_active(self.dec_pipeline):
            return []
        return [f"dec_block{i}" for i in range(self.decoder_depth)]

    def grid(self, x: torch.Tensor) -> Tuple[int, int, int]:
        tt, p, _ = self.tubelet
        return x.shape[1] // tt, x.shape[2] // p, x.shape[3] // p

    def forward(self, x: torch.Tensor, keep_idx=None, masked_idx=None,
                generator: Optional[torch.Generator] = None) -> dict:
        t, h, w = self.grid(x)
        b, n = x.shape[0], t * h * w
        if keep_idx is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            keep_idx, masked_idx = tube_mask_indices(
                generator, b, t, h, w, self.mask_ratio, x.device)
        enc, _ = self.encoder(x, keep_idx)                   # (B, n_vis, dim)
        dec_in = self.enc_to_dec(enc)
        pos = _pos_table(n, self.decoder_dim, x.device)[None].expand(b, -1, -1)
        dec_tokens = torch.cat(
            [dec_in + _take(pos, keep_idx).to(dec_in.dtype),
             self.mask_token.to(dec_in.dtype) + _take(pos, masked_idx).to(dec_in.dtype)],
            dim=1)                                           # (B, n, dec_dim)
        dec_tokens = run_vit_blocks(
            [getattr(self, f"dec_block{i}") for i in range(self.decoder_depth)],
            dec_tokens, pipeline=self.dec_pipeline)
        dec_tokens = self.dec_norm(dec_tokens)
        pred = self.dec_pred(f32_island(dec_tokens[:, enc.shape[1]:]))
        target = _take(patchify(f32_island(x), self.tubelet), masked_idx)
        if self.norm_pix:
            mu = target.mean(-1, keepdim=True)
            var = target.var(-1, keepdim=True, unbiased=False)  # jnp.var: ddof 0
            target = (target - mu) / torch.sqrt(var + 1e-6)
        loss = ((pred - target) ** 2).mean()
        return {"loss": loss, "pred": pred, "target": target,
                "masked_idx": masked_idx}


class VideoMAEClassifier(nn.Module):
    """Fine-tuning model: the full-token encoder without its final norm,
    the token mean, `fc_norm`, dropout, an f32 `head` (the official VideoMAE
    fine-tune arrangement)."""

    def __init__(self, num_classes: int, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, tubelet: Sequence[int] = (2, 16, 16),
                 dropout_rate: float = 0.0, attention_backend: str = "dense",
                 attn_mask: str = "none", attn_window: int = 0,
                 dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.encoder = VideoMAEEncoder(dim, depth, num_heads, tubelet,
                                       attention_backend, final_norm=False,
                                       attn_mask=attn_mask,
                                       attn_window=attn_window, dtype=dtype,
                                       remat=remat)
        self.fc_norm = LayerNorm(dim, dtype=dtype)
        self.dropout = SeededDropout(dropout_rate)
        self.head = nn.Linear(dim, num_classes)

    def set_pipeline(self, plan: Optional[PipelinePlan]) -> None:
        """Pipeline the encoder's blocks under `plan`."""
        self.encoder.set_pipeline(plan)

    def reset_parameters_like_jax(self, generator: torch.Generator) -> None:
        """The head's normal(0.01) kernel and zero bias."""
        with torch.no_grad():
            nn.init.normal_(self.head.weight, 0.0, 0.01, generator=generator)
            self.head.bias.zero_()

    @staticmethod
    def backbone_param_filter(path: Tuple[str, ...]) -> bool:
        """True for backbone params: fc_norm is fresh at fine-tune time,
        like the head, so freeze-backbone training keeps both trainable."""
        return path[0] not in ("head", "fc_norm")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens, _ = self.encoder(x)
        feat = self.fc_norm(tokens.mean(dim=1))
        return self.head(f32_island(self.dropout(feat)))
