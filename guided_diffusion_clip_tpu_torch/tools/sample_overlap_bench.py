"""What overlapping the host's writes with the card's next chain saves.

    python -m guided_diffusion_clip_tpu_torch.tools.sample_overlap_bench [--device cuda]

Counterpart of ``tools/sample_overlap_bench.py``: the two loop structures a
sampling CLI can have, timed by the host clock over ``OB_BATCHES`` batches:

    serial    chain k queued, copied to the host, written; then chain k + 1
    overlap   chain k + 1 queued before batch k is written
              (``utils/sample_util.overlap_device_host``, as ``image_sample``
              and ``super_res_sample`` run it)

The chain is ADM-G 256's UNet (``_timing.make_models``, N(0, 0.02) weights,
label 0), unguided DDIM over ``ddim25``, a batch of 16 images. The host's
work is the CLIs': the batch's copy into pinned memory queued behind an
event (``to_host``; never ``.cpu()``, which would wait at the call), the
wait on that event, the uint8 conversion and the PNG grid written with
``tensor2img``/``save_img``. The runs go in the order serial, overlap,
overlap, serial, each from its own seeds, and each structure's better run
counts. In eager PyTorch "queueing" chain k + 1 means running its Python
step loop, so batch k's write starts only once chain k + 1's last kernel
is queued (or the launch queue is full): the saving may be smaller than
under ``jax.jit``, where a dispatch returns at once.

Environment, as the JAX tool's: ``OB_BATCHES`` (4), ``OB_MODE`` (int8 or
bf16, the cuDNN path) and ``OB_IMAGE_SIZE`` (256); ``OB_BATCH`` (16, the JAX
tool's fixed batch) for rehearsing the tool at a small batch only. One JSON
line with the JAX tool's numbers: ``host_s`` (one write of a fetched
batch), ``serial_a``, ``overlap_a``, ``overlap_b``, ``serial_b`` (s a
batch), ``serial`` and ``overlapped`` (the better of each), ``saved`` (s a
batch) and ``saved_pct``, plus ``card``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..utils.sample_util import overlap_device_host, to_host
from ..utils.saving_imgs import save_img, tensor2img
from ._timing import card_label, make_models, on_card_defaults, pick_device

MODES = {"int8": "int8", "bf16": "xla"}


def make_chain(model, diffusion, batch: int, device):
    """``run_chain(seed) -> samples`` (NHWC, on the device): one unguided
    DDIM chain from a generator seeded ``seed``, label 0."""
    size = model.config.image_size
    classes = torch.zeros(batch, dtype=torch.long, device=device)

    def run_chain(seed: int):
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            sample = diffusion.ddim_sample_loop(model, (batch, 3, size, size), g, model_kwargs={"y": classes})
        return sample.permute(0, 2, 3, 1)

    return run_chain


def writer(out_dir: str, written: list):
    """``write_batch((counter, (host, event)))``: wait for the batch's copy,
    convert it to uint8 as the CLIs do for their ``.npz``, and write its
    grid as ``s{counter}.png`` in ``out_dir``; ``written`` records the
    counters in the order written."""

    def write_batch(item):
        counter, (host, event) = item
        if event is not None:
            event.synchronize()
        sample_np = host.numpy()
        _u8 = ((sample_np + 1) * 127.5).clip(0, 255).astype(np.uint8)
        save_img(tensor2img(sample_np), os.path.join(out_dir, f"s{counter}.png"))
        written.append(counter)

    return write_batch


def run_serial(run_chain, write_batch, n: int, seed0: int) -> float:
    """Seconds a batch: each chain queued, copied and written before the next."""
    t0 = time.perf_counter()
    for i in range(n):
        write_batch((i, to_host(run_chain(seed0 + i))))
    return (time.perf_counter() - t0) / n


def run_overlapped(run_chain, write_batch, n: int, seed0: int) -> float:
    """Seconds a batch: chain i + 1 queued before batch i is written."""

    def dispatched():
        for i in range(n):
            yield i, to_host(run_chain(seed0 + i))

    t0 = time.perf_counter()
    overlap_device_host(dispatched(), write_batch)
    return (time.perf_counter() - t0) / n


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    n = int(os.environ.get("OB_BATCHES", 4))
    mode = os.environ.get("OB_MODE", "int8")
    if mode not in MODES:
        raise SystemExit(f"OB_MODE {mode!r}: choose from {sorted(MODES)}")
    size = int(os.environ.get("OB_IMAGE_SIZE", 256))
    batch = int(os.environ.get("OB_BATCH", 16))
    device = pick_device(args.device)
    card = card_label(device)
    on_card_defaults(device)
    model, _, diffusion = make_models(size, MODES[mode], respacing="ddim25", device=device)
    run_chain = make_chain(model, diffusion, batch, device)
    with tempfile.TemporaryDirectory(prefix="overlap_bench_") as out_dir:
        write_batch = writer(out_dir, [])
        write_batch((999, to_host(run_chain(0))))  # warm-up
        # the host's work alone, on a batch already on the host
        host, event = to_host(run_chain(1))
        if event is not None:
            event.synchronize()
        t0 = time.perf_counter()
        write_batch((998, (host, None)))
        results = {"host_s": time.perf_counter() - t0}
        # the two structures in turns, so that drift falls on both
        for name, fn, seed in (("serial_a", run_serial, 100), ("overlap_a", run_overlapped, 200),
                               ("overlap_b", run_overlapped, 300), ("serial_b", run_serial, 400)):
            results[name] = fn(run_chain, write_batch, n, seed)
            print(f"[ob] {name}: {results[name]:.3f} s a batch ({mode}, {size} px, {diffusion.num_timesteps} DDIM "
                  f"steps, batch {batch}; {card})", flush=True)
    serial = min(results["serial_a"], results["serial_b"])
    overlapped = min(results["overlap_a"], results["overlap_b"])
    results.update(serial=serial, overlapped=overlapped, saved=serial - overlapped,
                   saved_pct=100 * (serial - overlapped) / serial, card=card)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
