"""The evaluator's feature-extraction throughput on the card.

    python -m guided_diffusion_clip_tpu_torch.tools.evaluator_bench [--device cuda]

Counterpart of ``tools/evaluator_bench.py``: the metrics protocol runs 50k
samples and 50k reference images through InceptionV3, so at that scale the
extractor is a pipeline stage of its own. This times the port's InceptionV3
(``evaluations/inception.py``, float32 with TF32 off, cuDNN's convs) on
architecture-shaped random weights (``random_params(0)``; the time does not
depend on the weights), from uint8 images in device memory: one warm-up
call, then ``EVB_ITERS`` calls between two CUDA events.

Env: ``EVB_BATCH`` (64), ``EVB_ITERS`` (10), ``EVB_IMAGE`` (256). Prints the
JAX tool's keys, the rate per GPU as ``images_per_sec_per_gpu``
(``compile_s``: the first call, cuDNN's algorithm search included), and
``card``. ``--device cpu`` runs it on the CPU, to rehearse the tool only: it
prints no rate.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..evaluations import inception as inc
from ._timing import card_label, pick_device


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    B = int(os.environ.get("EVB_BATCH", 64))
    iters = int(os.environ.get("EVB_ITERS", 10))
    size = int(os.environ.get("EVB_IMAGE", 256))

    model = inc.build_inception(inc.random_params(0), device)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(0, 256, (B, size, size, 3)).astype(np.uint8)).to(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    with torch.no_grad():
        t0 = time.perf_counter()
        pool, spatial = model(x)
        sync()
        compile_s = time.perf_counter() - t0
        print(f"[evb] first call {compile_s:.1f}s, pool {tuple(pool.shape)} spatial {tuple(spatial.shape)}",
              flush=True)
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                model(x)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t1 = time.perf_counter()
            for _ in range(iters):
                model(x)
            secs = time.perf_counter() - t1
    ips = B * iters / secs
    row = {
        "batch": B, "image": size, "iters": iters,
        "images_per_sec_per_gpu": ips if on_card else None,
        "sec_for_50k_pair": 2 * 50_000 / ips if on_card else None,
        "compile_s": compile_s,
        "seconds": secs,
        "card": card_label(device),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
