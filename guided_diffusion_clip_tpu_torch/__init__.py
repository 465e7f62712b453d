"""PyTorch/CUDA port of guided_diffusion_clip_tpu for one NVIDIA H100.

The JAX package ``guided_diffusion_clip_tpu`` is the reference; this package
mirrors its module paths. It imports torch and never jax. Ported so far:
sampling (``python -m guided_diffusion_clip_tpu_torch.serve`` and
``.classifier_sample``) and one-GPU training (``.image_train``), with the
hand-written CUDA kernels for attention, GroupNorm and the int8 convs
(``ops/csrc``).
"""
