"""The PyTorch port stands alone: no module of guided_diffusion_clip_tpu_torch
(nor chip_smoke.py) imports jax, flax, optax or the JAX package, found by an
AST scan of the sources; and every module imports on a machine without a
card, nvcc or triton."""

import ast
import importlib
import os
import pkgutil

import pytest

import guided_diffusion_clip_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "guided_diffusion_clip_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "guided_diffusion_clip_tpu")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_every_module_imports_without_a_card():
    names = [
        m.name for m in pkgutil.walk_packages(
            guided_diffusion_clip_tpu_torch.__path__, "guided_diffusion_clip_tpu_torch."
        )
    ]
    assert "guided_diffusion_clip_tpu_torch.serve" in names
    assert "guided_diffusion_clip_tpu_torch.classifier_sample" in names
    for name in names:
        importlib.import_module(name)


def test_kernel_sources_are_in_the_package():
    from guided_diffusion_clip_tpu_torch.ops import build

    srcs = sorted(os.path.basename(s) for s in build._sources())
    assert srcs == [  # the .cuh headers are hashed with the .cu files that include them, and compiled with them
        "attention_bwd.cu", "attention_bwd_mma.cu", "attention_fwd.cu", "attention_fwd_mma.cu", "conv_fused.cu",
        "conv_mma.cuh", "conv_s8.cu", "conv_s8_mma.cu", "groupnorm.cu", "mma.cuh", "mma_probe.cu", "quantize.cu",
    ]
    assert build.library_path().startswith(os.path.join(REPO, "build", "gdc_torch_kernels"))
