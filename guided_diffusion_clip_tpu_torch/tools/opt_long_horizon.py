"""Long-horizon check of the optimizer layouts: tree, flat and zero1 loss
curves from the same data and seeds.

    python -m guided_diffusion_clip_tpu_torch.tools.opt_long_horizon [--device cuda]

Counterpart of ``tools/opt_long_horizon.py``. Over a few steps the three
``opt_impl`` values agree to float rounding (``tests/test_torch_train.py``);
over hundreds, Adam's normalization amplifies rounding differences, so the
curves are compared statistically: a drift-class fault (a wrong bias
correction, a missed weight-decay term, a moment that aliases another)
would part them far beyond the step-to-step noise. Each layout trains the
16 px proxy (``_proxies``; lr 2e-3, weight decay 0.01, EMA 0.99) on
``RandomState(0)``'s blobs from the same initial weights and seeds, and
the loss of each step is read from what ``TrainLoop.flush_metrics``
fetches. ``zero1`` needs a process group: outside torchrun the tool starts
a one-rank group of its own (``parallel/dist.py::one_rank_group``) around
all three runs and ends it after them.

Printed for each layout after the first, against the first: the mean of
|delta loss| over the last third of the steps, that over the first
curve's step-to-step noise (the deviation of its first differences), and
the difference of the last third's means in units of its standard error.

Environment, as the JAX tool's: ``OLH_STEPS`` (300), ``OLH_IMAGE`` (16),
``OLH_BATCH`` (16), ``OLH_IMPLS`` ("tree,flat,zero1"). One JSON line with
the JAX tool's keys (rounded as it rounds them) plus ``card``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..parallel import dist as pdist
from ..utils import logger
from ..utils.script_util import create_gaussian_diffusion
from . import _proxies as P
from ._timing import card_label, on_card_defaults, pick_device


def run_impl(impl: str, steps: int, size: int, batch: int, init: dict, device) -> np.ndarray:
    """The loss of each of ``steps`` steps of the proxy trained under
    ``opt_impl=impl`` from the weights ``init``."""
    logger.configure_dir(dir=tempfile.mkdtemp(prefix=f"olh_{impl}_"), format_strs=[])
    model = P.build_generator(P.generator_config(size), device=device)
    model.load_state_dict(init, strict=True)
    diffusion = create_gaussian_diffusion(steps=100, noise_schedule="cosine")
    _, _, losses = P.train_generator(model, diffusion, P.blob_stream(np.random.RandomState(0), batch, size), batch,
                                     steps, losses=True, opt_impl=impl, weight_decay=0.01)
    return np.asarray(losses)


def compare(curves: dict, impls: list, steps: int, size: int, batch: int) -> dict:
    """The JAX tool's criteria of each layout's curve against the first's."""
    tail = slice(steps - steps // 3, steps)
    base = curves[impls[0]]
    base_tail = base[tail]
    base_noise = float(np.diff(base_tail).std())
    result = {
        "config": f"{size}px ch64, {steps} steps, batch {batch}, lr 2e-3 wd 0.01",
        "impls": impls,
        f"{impls[0]}_final_third_loss_mean": round(float(base_tail.mean()), 6),
        f"{impls[0]}_step_noise_sd": round(base_noise, 6),
    }
    for impl in impls[1:]:
        c = curves[impl][tail]
        delta = np.abs(c - base_tail)
        sem = base_tail.std() / np.sqrt(base_tail.size)
        result.update({
            f"{impl}_final_third_loss_mean": round(float(c.mean()), 6),
            f"{impl}_mean_abs_delta_vs_{impls[0]}": round(float(delta.mean()), 6),
            f"{impl}_delta_over_step_noise": round(float(delta.mean() / (base_noise + 1e-12)), 3),
            f"{impl}_mean_diff_in_sems": round(float(abs(c.mean() - base_tail.mean()) / (sem + 1e-12)), 3),
        })
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    t0 = time.time()
    steps = int(os.environ.get("OLH_STEPS", 300))
    size = int(os.environ.get("OLH_IMAGE", 16))
    batch = int(os.environ.get("OLH_BATCH", 16))
    impls = os.environ.get("OLH_IMPLS", "tree,flat,zero1").split(",")
    device = pick_device(args.device)
    card = card_label(device)
    on_card_defaults(device)
    torch.manual_seed(0)
    init = P.build_generator(P.generator_config(size)).state_dict()
    curves = {}
    with pdist.one_rank_group(device.type) as dev:
        for impl in impls:
            print(f"[olh +{time.time() - t0:.0f}s] running {impl}", file=sys.stderr, flush=True)
            curves[impl] = run_impl(impl, steps, size, batch, init, dev)
    result = {**compare(curves, impls, steps, size, batch), "card": card}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
