"""FLOP accounting: the closed-form attention count and a count of any call.

Counterpart of ``guided_diffusion_clip_tpu/utils/flops.py`` (the reference's
``count_flops_attn``, unet.py:308-325):

  * ``attention_matmul_flops``: the same closed-form count, usable without
    running anything;
  * ``compiled_cost``: the operations of one call of any function, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` from the shapes of the aten
    ops it dispatches (matrix products, convolutions and their backwards,
    2 operations a multiply-add); the JAX package reads XLA's cost model of the
    compiled program instead.

Count on the CPU. The port's kernels are ctypes calls (``ops/build.py``), not
aten ops, so on the card the counter would never see K1-K5 or the quantize
kernels; ``meta`` tensors do not help either, since the dispatchers take the
CPU or CUDA only. On the CPU every kernel's plain version is made of PyTorch
ops, so the count is that of the same arithmetic whatever implements it: the
int8 path counts as the bf16 one (its plain s8 conv is an f32 conv of the
integer values), and the count is linear in the batch. A tool that times a
model on the card therefore builds the same model on the CPU at batch 1
(weights do not matter to a count), counts one call and multiplies by the
batch.

What the count leaves out, and how it differs from XLA's:

  * elementwise work (GroupNorm, SiLU, softmax, the optimizer) is not counted:
    FlopCounterMode has formulas for products only;
  * a 3x3 conv counts every tap, the zero padding's too; XLA's count leaves
    out the taps that fall on the padding, so at 16 px the port counts ~8 %
    more for the same conv (``tests/test_torch_flops.py``);
  * the attention's plain backward recomputes its scores, as K2 does, and
    the count includes that product;
  * bytes are not counted: XLA's ``bytes accessed`` is the traffic of the
    fused program it compiled, and the plain versions' traffic is not the
    kernels', so no count on the CPU stands for the card's.
"""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def attention_matmul_flops(batch: int, num_spatial: int, channels: int) -> int:
    """FLOPs of one attention block's two big matmuls (unet.py:308-325).

    QK^T and weight@V each cost B * S^2 * C multiply-accumulates; following
    the reference's convention each MAC counts once per matmul.
    """
    return 2 * batch * (num_spatial**2) * channels


class _WholeCall:
    """A stand-in for ``FlopCounterMode``'s module tracker that attributes
    every operation to the whole call (``"Global"``) and hooks nothing."""

    parents = frozenset({"Global"})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def compiled_cost(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode``.

    Returns ``{"flops": total, "by_op": {aten op name: flops}}``, the
    operations of every aten op that the call dispatched, its autograd
    backward included where ``fn`` runs one. Call it with CPU tensors (see
    the module's docstring).
    """
    counter = FlopCounterMode(display=False)
    # its module tracker hooks every module's inputs for the backward, which
    # breaks ``torch.autograd.grad`` on a leaf (the guidance gradient's x):
    # count the whole call only
    counter.mod_tracker = _WholeCall()
    with counter:
        fn(*args, **kwargs)
    by_op = counter.get_flop_counts().get("Global", {})
    return {"flops": counter.get_total_flops(), "by_op": {str(op): n for op, n in by_op.items()}}


def flops_per_step(fn, *args, **kwargs) -> float:
    """Convenience: just the FLOP count of one call to ``fn``."""
    return float(compiled_cost(fn, *args, **kwargs)["flops"])

