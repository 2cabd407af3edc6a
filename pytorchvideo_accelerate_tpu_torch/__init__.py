"""PyTorch/CUDA port of pytorchvideo_accelerate_tpu for NVIDIA Hopper.

The JAX package beside it is the reference. This package imports neither
JAX nor the JAX package; it keeps its own copy of what it needs (config,
the inference-artifact format, the serving stack). Ported so far: serving
of the SlowFast/Slow ResNet families through the hand-written fused
conv + BN + act CUDA kernels (ops/csrc). See ROADMAP.md for the queue.
"""
