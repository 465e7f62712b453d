"""PyTorch/CUDA port of guided_diffusion_clip_tpu for one NVIDIA H100.

The JAX package ``guided_diffusion_clip_tpu`` is the reference; this package
mirrors its module paths. It imports torch and never jax. Ported so far: the
serving path (``python -m guided_diffusion_clip_tpu_torch.serve``) with the
hand-written CUDA kernels for attention and GroupNorm (``ops/csrc``).
"""
