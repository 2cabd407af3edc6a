"""PyTorch/CUDA port of pytorchvideo_accelerate_tpu for NVIDIA Hopper.

The JAX package beside it is the reference. This package imports neither
JAX nor the JAX package; it keeps its own copy of what it needs (config,
the inference-artifact format, the serving stack). Ported so far: every
model family of the JAX registry, served and trained through the
hand-written CUDA kernels (ops/csrc), on synthetic clips, real videos or a
frame cache (data/). See ROADMAP.md for the queue.
"""
