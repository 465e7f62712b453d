"""Repeated sampling runs: the port of scripts/image_sample_repeat.py.

    python -m guided_diffusion_clip_tpu_torch.image_sample_repeat --repeats 3 --seed 10 -d sweep \\
        <image_sample's flags>

Runs ``image_sample.main`` ``--repeats`` times (default 1), run r with the
seed ``--seed`` + r (default 0) and the description ``{-d}_rep{r}`` (or
``rep{r}``), so that each run gets a run directory of its own; the logger is
reset between runs.
"""

from __future__ import annotations

import sys

from . import image_sample
from .utils import logger


def _pop(argv: list, flags, default):
    """The value after the first of ``flags`` in ``argv``, removed with it, or ``default``."""
    for flag in flags:
        if flag in argv:
            i = argv.index(flag)
            value = argv[i + 1]
            del argv[i : i + 2]
            return value
    return default


def main(argv=None) -> list:
    """Run the repeats; returns each run's ``image_sample.main`` result."""
    argv = list(sys.argv[1:] if argv is None else argv)
    repeats = int(_pop(argv, ("--repeats",), 1))
    base_seed = int(_pop(argv, ("--seed",), 0))
    desc = _pop(argv, ("-d", "--description"), "")
    results = []
    for r in range(repeats):
        rep_desc = f"{desc}_rep{r}" if desc else f"rep{r}"
        results.append(image_sample.main([*argv, "--seed", str(base_seed + r), "-d", rep_desc]))
        logger.reset()  # the next run makes a run directory of its own
    return results


if __name__ == "__main__":
    main()
