"""The run-directory logger, the part the sampling CLIs use.

Counterpart of ``guided_diffusion_clip_tpu/utils/logger.py``'s ``configure``,
``log`` and ``get_dir``: a run directory ``{main_path}/{yymmdd_HHMMSS}_
{description}`` when ``--main_path`` is given, else ``$OPENAI_LOGDIR``, else a
fresh directory under the temporary directory; lines go to stdout and to
``log.txt`` there. The key-value writers (csv, json, tensorboard) and the
per-rank formats are not ported yet.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile


class Logger:
    """Writes each logged line to stdout and to ``{dir}/log.txt``."""

    def __init__(self, dir: str):
        self.dir = dir
        self.file = open(os.path.join(dir, "log.txt"), "a")

    def log(self, *args) -> None:
        line = " ".join(map(str, args)) + "\n"
        for out in (sys.stdout, self.file):
            out.write(line)
            out.flush()

    def close(self) -> None:
        self.file.close()


_current: Logger | None = None


def configure_dir(dir: str | None = None) -> str:
    """Make ``dir`` (default: $OPENAI_LOGDIR, else a new temporary directory)
    the current log directory; returns it."""
    global _current
    if dir is None:
        dir = os.getenv("OPENAI_LOGDIR")
    if dir is None:
        stamp = datetime.datetime.now().strftime("openai-%Y-%m-%d-%H-%M-%S-%f")
        dir = os.path.join(tempfile.gettempdir(), stamp)
    dir = os.path.expanduser(dir)
    os.makedirs(dir, exist_ok=True)
    if _current is not None:
        _current.close()
    _current = Logger(dir)
    log(f"Logging to {dir}")
    return dir


def configure(args=None) -> str:
    """Fork-style configure (reference logger.py:442-466): a run directory
    ``{main_path}/{yymmdd_HHMMSS}_{description}`` when ``args.main_path`` is
    set, else ``configure_dir()``."""
    if args is None or not getattr(args, "main_path", None):
        return configure_dir()
    stamp = datetime.datetime.now().strftime("%y%m%d_%H%M%S")
    desc = getattr(args, "description", "") or ""
    return configure_dir(os.path.join(args.main_path, f"{stamp}_{desc}" if desc else stamp))


def _get_current() -> Logger:
    if _current is None:
        configure_dir()
    return _current


def log(*args) -> None:
    _get_current().log(*args)


def get_dir() -> str:
    return _get_current().dir
