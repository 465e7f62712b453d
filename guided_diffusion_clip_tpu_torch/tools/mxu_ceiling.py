"""Measure the tensor cores' matmul rate for s8 and bf16 products (kernel K7).

    python -m guided_diffusion_clip_tpu_torch.tools.mxu_ceiling [--device cuda]

Counterpart of ``tools/pallas_mxu_ceiling.py``. ``accumulating_dots`` runs T
accumulating (512 x 2048) @ (2048 x 512) products in one kernel, whose
``mma.sync`` instructions are written by hand; each block keeps its slices of
the operands in shared memory for all T repeats, so neither device memory nor
the L2 cache is in the loop. Two values of T
(2000 and 6000) are timed with CUDA events, best of ``MXU_REPS`` (default 3),
and the rate is the slope, which cancels the launch and the prologue:

    rate = (T_hi - T_lo) * 2 * 512 * 2048 * 512 / (t_hi - t_lo)

The tool fails if the slope is not positive (the loop-invariant product was
hoisted, or the timer is broken) or if the rate reads above the card's
data-sheet peak (1,979 TOP/s s8, 989 TFLOP/s bf16, dense). It prints the rate
beside the card's name and power limit: the measured ceiling of hand-issued
``mma.sync`` on this card, to set beside the data-sheet peak.

``--device cpu`` runs the plain version once per T, for rehearsing the tool
only: it computes one product whatever T is, so no rate is reported.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..ops.mma_probe import BK, BM, BN, accumulating_dots
from ._timing import card_label, pick_device, seconds_per_call

# dense data-sheet peaks of one H100 SXM, in operations per second
PEAK = {"s8": 1979e12, "bf16": 989e12}
T_LO, T_HI = 2000, 6000


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    reps = int(os.environ.get("MXU_REPS", 3))
    rs = np.random.RandomState(0)
    results = {"device": card_label(device)}
    for name in ("s8", "bf16"):
        if name == "s8":
            x = torch.from_numpy(rs.randint(-127, 127, (BM, BK)).astype(np.int8)).to(device)
            w = torch.from_numpy(rs.randint(-127, 127, (BK, BN)).astype(np.int8)).to(device)
        else:
            x = torch.from_numpy(rs.randn(BM, BK).astype(np.float32)).to(device).bfloat16()
            w = torch.from_numpy(rs.randn(BK, BN).astype(np.float32)).to(device).bfloat16()
        s_lo = seconds_per_call(lambda: accumulating_dots(x, w, T_LO), device, 1, reps)
        s_hi = seconds_per_call(lambda: accumulating_dots(x, w, T_HI), device, 1, reps)
        row = {"ms_lo": round(s_lo * 1e3, 4), "ms_hi": round(s_hi * 1e3, 4), "tf_per_sec_slope": None}
        if device.type == "cuda":
            if s_hi <= s_lo:
                raise SystemExit(
                    f"{name}: T={T_HI} took {s_hi * 1e3:.3f} ms, T={T_LO} {s_lo * 1e3:.3f} ms: "
                    "no positive slope, the repeated product did not run T times"
                )
            rate = (T_HI - T_LO) * 2 * BM * BK * BN / (s_hi - s_lo)
            if rate > PEAK[name]:
                raise SystemExit(
                    f"{name}: {rate / 1e12:.1f} T/s reads above the card's peak of {PEAK[name] / 1e12:.0f}"
                )
            row["tf_per_sec_slope"] = round(rate / 1e12, 2)
            row["share_of_peak"] = round(rate / PEAK[name], 4)
        results[name] = row
        print(f"{name}: {row} ({results['device']})", flush=True)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
