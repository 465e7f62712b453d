"""How far the int8 path moves ADM-G 256's output and its guidance gradient.

    python -m guided_diffusion_clip_tpu_torch.tools.int8_quality_check [batch] [--device cuda]

Counterpart of ``tools/int8_quality_check.py``: ADM-G 256 and its classifier
(``_timing.make_models``, N(0, 0.02) weights, bf16 torsos) built twice from
the same seeds, once with ``conv_impl`` xla (cuDNN in bf16) and once int8
(K4, K5 and the quantize kernels), each run on the same x (``RandomState(2)``,
``batch`` images, 4 by default), t = 128 and y = 0: the UNet's output, and
the classifier's guidance gradient (``classifier_cond_fn``, scale 1). The
JAX tool switches the s8 emission with ``int8_emit``; here it follows
autograd (the UNet under ``no_grad`` emits s8, the classifier's forward
inside the gradient integer values in x's dtype), so the tool calls the
modules as the sampling loop calls them.

``QC_IMAGE_SIZE`` (256) sets the size, as the JAX tool's. One JSON line with
the JAX tool's keys, ``unet_out`` and ``guidance_grad``, each with
``rel_rmse_vs_signal_std``, ``max_abs_rel`` and ``corr`` of int8 against xla
(``_timing.deviation``, the JAX formulas, unrounded), plus ``card``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..diffusion.guidance import classifier_cond_fn
from ._timing import card_label, deviation, make_models, on_card_defaults, pick_device

T = 128.0


def inputs(batch: int, size: int, device) -> tuple:
    """(x, t, y) as the JAX tool draws them: x from ``RandomState(2)`` in
    NHWC, here in NCHW."""
    x = np.random.RandomState(2).randn(batch, size, size, 3).astype(np.float32)
    x = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(device)
    return x, torch.full((batch,), T, device=device), torch.zeros(batch, dtype=torch.long, device=device)


def outputs(model, classifier, x, t, y) -> tuple:
    """(the UNet's output, the guidance gradient) as float32 numpy arrays:
    the UNet under ``no_grad``, as the sampling loop runs it, and
    ``classifier_cond_fn``'s gradient with respect to x."""
    with torch.no_grad():
        eps = model(x, t, y=y)
        grad = classifier_cond_fn(classifier, 1.0)(x, t, y=y)
    return eps.float().cpu().numpy(), grad.float().cpu().numpy()


def stats(a, b) -> dict:
    """The JAX tool's three numbers for ``b`` against the reference ``a``."""
    d = deviation(a, b)
    return {"rel_rmse_vs_signal_std": d["rel_rmse"], "max_abs_rel": d["max_abs_rel"], "corr": d["corr"]}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("batch", nargs="?", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    size = int(os.environ.get("QC_IMAGE_SIZE", 256))
    card = card_label(device)
    on_card_defaults(device)
    x, t, y = inputs(args.batch, size, device)
    outs = {}
    for impl in ("xla", "int8"):
        model, classifier, _ = make_models(size, impl, device=device)
        outs[impl] = outputs(model, classifier, x, t, y)
        del model, classifier
    results = {name: stats(outs["xla"][i], outs["int8"][i]) for i, name in enumerate(("unet_out", "guidance_grad"))}
    results["card"] = card
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
