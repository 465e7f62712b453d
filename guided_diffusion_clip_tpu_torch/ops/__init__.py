"""Ops: attention and GroupNorm, each a plain PyTorch version beside its CUDA kernel."""
