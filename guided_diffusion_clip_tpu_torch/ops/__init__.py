"""Ops: attention and GroupNorm, each a plain PyTorch version beside its CUDA kernel."""


def kernel_wrappers() -> dict:
    """Kernel name -> the wrapper that launches it and counts its launches
    (``.launches``; K1's, K2's and K5's also ``.launches_mma``, those that ran
    on the tensor-core kernels (K5's: ``conv_s8_mma.cu``), K1's and K2's
    ``.launches_f32``, those on float32 input, and K5's ``.launches_thin``,
    those on ``conv_s8_thin.cu``'s stem and head kernels): K1 ``attention``,
    K2 ``attention_bwd``, K3 ``group_norm``, K4 ``group_norm_quant``, K5
    ``conv_s8``, the quantize kernels ``quantize``, K6 ``conv_fused``, K7
    ``mma_probe``; and the entries
    that K3, K4 and the quantize kernels are split into on a row shard
    (spatial partitioning; K4 also on a channel shard, tensor parallelism),
    each counted apart: ``group_norm_stats`` (K3's and K4's statistics),
    ``group_norm_apply`` (K3's apply), ``group_norm_quant_apply`` (K4's),
    ``quantize_amax`` and ``quantize_apply``. A wrapper counts where it
    launches its kernel and nowhere else."""
    from . import attention as A
    from . import fused_conv as FC
    from . import groupnorm as G
    from . import mma_probe as MP
    from . import quant as Q

    return {"attention": A.attention_fwd_cuda, "attention_bwd": A.attention_bwd_cuda,
            "group_norm": G.fused_group_norm, "group_norm_quant": G.fused_group_norm_quant,
            "conv_s8": Q.conv_s8_cuda, "quantize": Q.quantize_per_tensor_cuda,
            "conv_fused": FC.fused_conv3x3_cuda, "mma_probe": MP.accumulating_dots_cuda,
            "group_norm_stats": G.group_norm_stats_cuda, "group_norm_apply": G.group_norm_apply_cuda,
            "group_norm_quant_apply": G.group_norm_quant_apply_cuda, "quantize_amax": Q.absmax_cuda,
            "quantize_apply": Q.quantize_given_cuda}


def launch_counts() -> dict:
    """Every kernel's launches in this process, by ``kernel_wrappers``' names,
    as ``<name>_mma`` the tensor-core share of K1's, K2's and K5's, as
    ``<name>_f32`` the float32 share of K1's and K2's, and as ``conv_s8_thin``
    K5's launches of the stem and head kernels."""
    wrappers = kernel_wrappers()
    out = {name: fn.launches for name, fn in wrappers.items()}
    for part in ("mma", "f32", "thin"):
        out.update({f"{name}_{part}": getattr(fn, f"launches_{part}") for name, fn in wrappers.items()
                    if hasattr(fn, f"launches_{part}")})
    return out
