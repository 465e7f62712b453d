"""Measurement tools of the port, each run as ``python -m
guided_diffusion_clip_tpu_torch.tools.<name>``."""
