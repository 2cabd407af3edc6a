"""Model registry for the families this slice of the port carries.

`create_model(cfg, mixed_precision, seed)` returns an `nn.Module` whose
weights are drawn as the JAX package initialises them (`init_like_jax`),
from a `torch.Generator` seeded with `seed`; the caller sets the mode
(`.train()` is torch's default, the serving engine calls `.eval()`). Ported
here: slowfast_r50, slowfast_r101, slowfast_t, slow_r50, c2d_r50, tiny3d,
x3d_xs, x3d_s, x3d_m, x3d_l, csn_r101, r2plus1d_r50, mvit_b, mvit_b_32x3,
mvit_t, videomae_b, videomae_b_pretrain, videomae_t and videomae_t_pretrain,
every name of the JAX package's registry. `--model.remat` checkpoints
every block of the transformer families (MViT, VideoMAE), as the JAX
package does. `model_axis` (a `parallel/tensor_parallel.ModelAxis`) lays
the model out on the train mesh's model axis: every rank builds the
full-width model from the seed, then keeps its shards
(`apply_model_axis`), so the init equals one process's slice for slice.
MViT's `pos_embed` is sized by the clip geometry, `data_cfg` (num_frames,
crop_size; `DataConfig()` when none is given). Each classifier class carries
`backbone_param_filter(path)` (True for the backbone, `path` the
state_dict key split on ".") for `--model.freeze_backbone`.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from pytorchvideo_accelerate_tpu_torch.config import DataConfig, ModelConfig
from pytorchvideo_accelerate_tpu_torch.models.common import (
    FUSED_MODES,
    BNAffine,
    LayerNorm,
    lecun_normal_,
)
from pytorchvideo_accelerate_tpu_torch.models.csn import CSN
from pytorchvideo_accelerate_tpu_torch.models.heads import ResBasicHead
from pytorchvideo_accelerate_tpu_torch.models.mvit import MViT
from pytorchvideo_accelerate_tpu_torch.models.r2plus1d import R2Plus1D
from pytorchvideo_accelerate_tpu_torch.models.resnet3d import SlowR50
from pytorchvideo_accelerate_tpu_torch.models.slowfast import SlowFast
from pytorchvideo_accelerate_tpu_torch.models.videomae import (
    VideoMAEClassifier,
    VideoMAEForPretraining,
)
from pytorchvideo_accelerate_tpu_torch.models.x3d import X3D
from pytorchvideo_accelerate_tpu_torch.ops.attention import check_backend
from pytorchvideo_accelerate_tpu_torch.parallel.pipeline import is_active
from pytorchvideo_accelerate_tpu_torch.precision import policy_compute_dtype

# each entry: (ModelConfig, compute dtype, DataConfig) -> module
_REGISTRY: Dict[str, Callable] = {
    "slow_r50": lambda cfg, dtype, data: SlowR50(
        cfg.num_classes, dropout_rate=cfg.dropout_rate,
        fused=cfg.fused_kernels, dtype=dtype),
    # deliberately tiny Slow-style net for tests and CLI smokes
    "tiny3d": lambda cfg, dtype, data: SlowR50(
        cfg.num_classes, depths=(1, 1, 1, 1), stem_features=8,
        dropout_rate=cfg.dropout_rate, fused=cfg.fused_kernels, dtype=dtype),
    # c2d_r50: no temporal convs, plus the (2,1,1) pool after res2
    "c2d_r50": lambda cfg, dtype, data: SlowR50(
        cfg.num_classes, temporal_kernels=(1, 1, 1, 1),
        stage1_temporal_pool=True, dropout_rate=cfg.dropout_rate,
        fused=cfg.fused_kernels, dtype=dtype),
    "slowfast_r50": lambda cfg, dtype, data: SlowFast(
        cfg.num_classes, alpha=cfg.slowfast_alpha,
        dropout_rate=cfg.dropout_rate, fused=cfg.fused_kernels, dtype=dtype),
    # deliberately tiny SlowFast: one block per stage, 16-channel stem
    "slowfast_t": lambda cfg, dtype, data: SlowFast(
        cfg.num_classes, depths=(1, 1, 1, 1), stem_features=16,
        alpha=cfg.slowfast_alpha, dropout_rate=cfg.dropout_rate,
        fused=cfg.fused_kernels, dtype=dtype),
    "slowfast_r101": lambda cfg, dtype, data: SlowFast(
        cfg.num_classes, depths=(3, 4, 23, 3), alpha=cfg.slowfast_alpha,
        dropout_rate=cfg.dropout_rate, fused=cfg.fused_kernels, dtype=dtype),
    # XS, S and M share the trunk; they differ in sampling (frames, crop)
    "x3d_xs": lambda cfg, dtype, data: _x3d(cfg, dtype),
    "x3d_s": lambda cfg, dtype, data: _x3d(cfg, dtype),
    "x3d_m": lambda cfg, dtype, data: _x3d(cfg, dtype),
    # depth factor 5.0: pytorchvideo create_x3d stage depths (1,2,5,3) x 5
    "x3d_l": lambda cfg, dtype, data: _x3d(cfg, dtype, depths=(5, 10, 25, 15)),
    "csn_r101": lambda cfg, dtype, data: CSN(
        cfg.num_classes, dropout_rate=cfg.dropout_rate,
        depthwise_impl=cfg.depthwise_impl, fused=cfg.fused_kernels,
        dtype=dtype),
    # hub r2plus1d_r50 (Kinetics-400 16x4)
    "r2plus1d_r50": lambda cfg, dtype, data: R2Plus1D(
        cfg.num_classes, dropout_rate=cfg.dropout_rate,
        fused=cfg.fused_kernels, dtype=dtype),
    "mvit_b": lambda cfg, dtype, data: _mvit(cfg, dtype, data),
    # hub mvit_base_32x3: the same trunk, drop_path 0.3, 32 frames x stride 3
    "mvit_b_32x3": lambda cfg, dtype, data: _mvit(cfg, dtype, data,
                                                  drop_path_rate=0.3),
    # deliberately tiny MViT: depth 2, dim 16, uniform schedule
    "mvit_t": lambda cfg, dtype, data: _mvit(
        cfg, dtype, data, depth=2, embed_dim=16, num_heads=2, stage_starts=(),
        drop_path_rate=0.0),
    "videomae_b": lambda cfg, dtype, data: _videomae(cfg, dtype),
    "videomae_b_pretrain": lambda cfg, dtype, data: VideoMAEForPretraining(
        mask_ratio=cfg.mask_ratio, attention_backend=cfg.attention,
        dtype=dtype, remat=cfg.remat),
    # deliberately tiny VideoMAE classifier and its pretraining twin
    "videomae_t": lambda cfg, dtype, data: _videomae(
        cfg, dtype, dim=32, depth=4, num_heads=2, tubelet=(2, 8, 8)),
    "videomae_t_pretrain": lambda cfg, dtype, data: VideoMAEForPretraining(
        dim=32, depth=4, num_heads=2, decoder_dim=16, decoder_depth=2,
        decoder_heads=2, tubelet=(2, 8, 8), mask_ratio=cfg.mask_ratio,
        attention_backend=cfg.attention, dtype=dtype, remat=cfg.remat),
}

_TRANSFORMERS = ("mvit", "videomae")


def _mvit(cfg: ModelConfig, dtype, data: DataConfig, **kw) -> MViT:
    return MViT(cfg.num_classes,
                input_grid=(data.num_frames, data.crop_size, data.crop_size),
                dropout_rate=cfg.dropout_rate, attention_backend=cfg.attention,
                depthwise_impl=cfg.depthwise_impl, dtype=dtype,
                remat=cfg.remat, **kw)


def _videomae(cfg: ModelConfig, dtype, **kw) -> VideoMAEClassifier:
    return VideoMAEClassifier(
        cfg.num_classes, dropout_rate=cfg.dropout_rate,
        attention_backend=cfg.attention, attn_mask=cfg.attn_mask,
        attn_window=cfg.attn_window, dtype=dtype, remat=cfg.remat, **kw)


def _x3d(cfg: ModelConfig, dtype, **kw) -> X3D:
    return X3D(cfg.num_classes, dropout_rate=cfg.dropout_rate,
               depthwise_impl=cfg.depthwise_impl, fused=cfg.fused_kernels,
               dtype=dtype, **kw)


def available_models():
    return sorted(_REGISTRY)


def init_like_jax(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight as the JAX package's init does: lecun-normal conv
    kernels (models/common.py `ConvKernelParam`, flax `nn.Conv`; a
    depthwise kernel's fan-in is its taps) with zero biases (X3D's SE
    `fc1`/`fc2`, the transformers' patch embeds), BN scale 1, bias 0,
    running mean 0, var 1, LayerNorm scale 1, bias 0, the
    `ResBasicHead`'s and `VideoMAEClassifier`'s normal(0.01) head kernel
    with a zero bias, and any other Linear (X3D's `proj`, MViT's `head`,
    every flax `nn.Dense`) lecun-normal with a zero bias. MViT's
    `pos_embed` is flax's `truncated_normal(0.02)`: a standard normal cut at
    +-2, times 0.02; VideoMAE's `mask_token` is normal(0.02). Modules are
    visited in registration order, so one seed gives one set of weights."""
    heads = set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv3d, nn.Linear)) and m not in heads:
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BNAffine):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, ResBasicHead):
                m.reset_parameters_like_jax(generator)
                heads.add(m.proj)
            elif isinstance(m, VideoMAEClassifier):
                m.reset_parameters_like_jax(generator)
                heads.add(m.head)
            elif isinstance(m, MViT):
                nn.init.trunc_normal_(m.pos_embed, 0.0, 0.02, -0.04, 0.04,
                                      generator=generator)
            elif isinstance(m, VideoMAEForPretraining):
                nn.init.normal_(m.mask_token, 0.0, 0.02, generator=generator)


def create_model(cfg: ModelConfig, mixed_precision: str = "bf16",
                 seed: int = 0, data_cfg: DataConfig = None,
                 model_axis=None, pipeline=None, init: bool = True) -> nn.Module:
    """Build the module for `cfg.name`, initialised by `init_like_jax` from
    a generator seeded with `seed`. `mixed_precision` "bf16"/"fp16" computes
    in bf16 with f32 parameters, else f32. `data_cfg` gives the clip
    geometry that sizes MViT's `pos_embed` (default `DataConfig()`).
    `model_axis` (a `parallel/tensor_parallel.ModelAxis`): cut the model
    to that rank's shards after the init. `pipeline` (an active
    `parallel/pipeline.PipelinePlan`): the transformer trunk trains through
    the stage pipeline (the model's `set_pipeline`); a family without that
    seam (the conv nets) refuses with the JAX package's error. `init=False`
    skips `init_like_jax` (the Trainer's FLOP count builds a copy on `meta`
    tensors, whose values it never reads)."""
    if cfg.name not in _REGISTRY:
        raise ValueError(
            f"unknown model {cfg.name!r}; available: {available_models()}")
    if is_active(pipeline) and not cfg.name.startswith(_TRANSFORMERS):
        raise ValueError(
            f"model {cfg.name!r} has no pipeline stage-cut seam "
            "(parallel.pipeline_stages > 1 needs a transformer block "
            "stack — mvit/videomae families); conv families spend the "
            "model axis on replication, not stages")
    if cfg.fused_kernels not in FUSED_MODES:
        raise ValueError(
            f"model.fused_kernels must be one of {FUSED_MODES}, got "
            f"{cfg.fused_kernels!r}")
    if cfg.name.startswith(_TRANSFORMERS):
        check_backend(cfg.attention)
    model = _REGISTRY[cfg.name](cfg, policy_compute_dtype(mixed_precision),
                                data_cfg or DataConfig())
    if init:
        init_like_jax(model, torch.Generator().manual_seed(seed))
    if is_active(pipeline):
        model.set_pipeline(pipeline)
    if model_axis is not None:
        # here, not at the top: tensor_parallel builds on models/common.py
        from pytorchvideo_accelerate_tpu_torch.parallel.tensor_parallel import (
            apply_model_axis,
        )

        apply_model_axis(model, model_axis)
    return model


def model_input_spec(cfg: ModelConfig, data_cfg) -> dict:
    """Shapes the model expects for one clip batch (B=1), NDHWC."""
    t, s = data_cfg.num_frames, data_cfg.crop_size
    if cfg.name.startswith("slowfast"):
        return {
            "slow": (1, max(t // cfg.slowfast_alpha, 1), s, s, 3),
            "fast": (1, t, s, s, 3),
        }
    return {"video": (1, t, s, s, 3)}
