"""Run-directory logger with key-value writers (reference logger.py,
OpenAI-baselines style).

Counterpart of ``guided_diffusion_clip_tpu/utils/logger.py`` for one
process: ``configure`` makes the run directory ``{main_path}/{yymmdd_HHMMSS}_
{description}`` when ``--main_path`` is given, else ``$OPENAI_LOGDIR``, else a
fresh directory under the temporary directory. The writers are picked by
``$OPENAI_LOG_FORMAT`` (default ``stdout,log,csv``): ``stdout`` and ``log``
(``log.txt``) take the logged lines and a table of each dump, ``csv``
(``progress.csv``, its header rewritten when keys appear) and ``json``
(``progress.json``, one object a line) the dumps. ``logkv`` /
``logkv_mean`` collect values until ``dumpkvs``; ``profile_kv`` adds wall
time to ``wait_*`` keys (logger.py:293-317); ``reset`` closes the run
directory, so that the next ``configure`` makes another. ``tensorboard``
(``tb{suffix}/``) writes each dump's numbers as scalars at the dump's
``step`` through ``torch.utils.tensorboard.SummaryWriter``, and does nothing
where that does not import. ``log_suffix`` names the files
(``log{suffix}.txt``, ...); ``scoped_configure`` logs to another directory
for the length of a block. The per-rank formats (``OPENAI_LOG_FORMAT_MPI``,
``-rank%03i``) wait for more than one process.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager


class HumanOutputFormat:
    """Logged lines as they are, and each dump as a two-column table."""

    def __init__(self, file, own_file: bool):
        self.file = file
        self.own_file = own_file

    def writekvs(self, kvs):
        key2str = {
            self._truncate(k): self._truncate(f"{v:<8.3g}" if hasattr(v, "__float__") else str(v))
            for k, v in sorted(kvs.items())
        }
        if not key2str:
            return
        keywidth = max(map(len, key2str))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in sorted(key2str.items(), key=lambda kv: kv[0].lower()):
            lines.append(f"| {key}{' ' * (keywidth - len(key))} | {val}{' ' * (valwidth - len(val))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    @staticmethod
    def _truncate(s, maxlen=30):
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s

    def writeseq(self, seq):
        self.file.write(" ".join(seq) + "\n")
        self.file.flush()

    def close(self):
        if self.own_file:
            self.file.close()


class JSONOutputFormat:
    def __init__(self, filename):
        self.file = open(filename, "wt")

    def writekvs(self, kvs):
        self.file.write(json.dumps({k: float(v) if hasattr(v, "dtype") else v for k, v in sorted(kvs.items())}) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat:
    """CSV whose header is rewritten when new keys appear (logger.py:119-143)."""

    def __init__(self, filename):
        self.file = open(filename, "w+t")
        self.keys = []

    def writekvs(self, kvs):
        extra_keys = sorted(kvs.keys() - set(self.keys))
        if extra_keys:
            self.keys.extend(extra_keys)
            self.file.seek(0)
            lines = self.file.readlines()
            self.file.seek(0)
            self.file.write(",".join(self.keys) + "\n")
            for line in lines[1:]:
                self.file.write(line[:-1] + "," * len(extra_keys) + "\n")
        else:
            self.file.seek(0, 2)
        self.file.write(",".join("" if kvs.get(k) is None else str(kvs[k]) for k in self.keys) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class TensorBoardOutputFormat:
    """Each dump's numbers as TensorBoard scalars at its ``step`` key (else one
    past the last dump's); a no-op where no TensorBoard backend imports
    (JAX ``utils/logger.py:138-163``)."""

    def __init__(self, logdir):
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(logdir)
        except Exception:  # no tensorboard package: log without it
            pass
        self.step = 0

    def writekvs(self, kvs):
        if self.writer is None:
            return
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            if hasattr(v, "__float__"):
                self.writer.add_scalar(k, float(v), step)
        self.writer.flush()
        self.step = step + 1

    def close(self):
        if self.writer is not None:
            self.writer.close()


def make_output_format(fmt: str, ev_dir: str, log_suffix: str = ""):
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout, own_file=False)
    if fmt == "log":
        return HumanOutputFormat(open(os.path.join(ev_dir, f"log{log_suffix}.txt"), "a"), own_file=True)
    if fmt == "json":
        return JSONOutputFormat(os.path.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(os.path.join(ev_dir, f"progress{log_suffix}.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(os.path.join(ev_dir, f"tb{log_suffix}"))
    raise ValueError(f"log format {fmt!r}: choose from stdout, log, json, csv, tensorboard")


class Logger:
    """Key-value store and the writers of one run directory."""

    def __init__(self, dir: str, output_formats):
        self.name2val = defaultdict(float)
        self.name2cnt = defaultdict(int)
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self) -> dict:
        out = dict(self.name2val)
        for fmt in self.output_formats:
            fmt.writekvs(out)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args):
        for fmt in self.output_formats:
            if isinstance(fmt, HumanOutputFormat):
                fmt.writeseq(map(str, args))

    def close(self):
        for fmt in self.output_formats:
            fmt.close()


_current: Logger | None = None


def configure_dir(dir: str | None = None, format_strs=None, log_suffix: str = "") -> str:
    """Make ``dir`` (default: $OPENAI_LOGDIR, else a new temporary directory)
    the current log directory, with the writers ``format_strs`` (default:
    $OPENAI_LOG_FORMAT, else stdout, log, csv), their files named with
    ``log_suffix``; returns it."""
    global _current
    if dir is None:
        dir = os.getenv("OPENAI_LOGDIR")
    if dir is None:
        stamp = datetime.datetime.now().strftime("openai-%Y-%m-%d-%H-%M-%S-%f")
        dir = os.path.join(tempfile.gettempdir(), stamp)
    dir = os.path.expanduser(dir)
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        format_strs = os.getenv("OPENAI_LOG_FORMAT", "stdout,log,csv").split(",")
    if _current is not None:
        _current.close()
    _current = Logger(dir, [make_output_format(f, dir, log_suffix) for f in format_strs if f])
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


def reset() -> None:
    """Close the current run directory's writers; the next ``configure``
    starts a new one (``image_sample_repeat`` between its runs)."""
    global _current
    if _current is not None:
        _current.close()
        _current = None


def get_current() -> Logger:
    if _current is None:
        configure_dir()
    return _current


def log(*args) -> None:
    get_current().log(*args)


def get_dir() -> str:
    return get_current().dir


def logkv(key, val) -> None:
    get_current().logkv(key, val)


def logkv_mean(key, val) -> None:
    get_current().logkv_mean(key, val)


def logkvs(d) -> None:
    for k, v in d.items():
        logkv(k, v)


def dumpkvs() -> dict:
    return get_current().dumpkvs()


def getkvs():
    return get_current().name2val


@contextmanager
def profile_kv(scopename):
    """Add the wall time of the block to the key ``wait_{scopename}``."""
    logkey = "wait_" + scopename
    tstart = time.time()
    try:
        yield
    finally:
        get_current().name2val[logkey] += time.time() - tstart


@contextmanager
def scoped_configure(dir=None, format_strs=None):
    """Log to ``dir`` with ``format_strs`` inside the block, then close those
    writers and log where the block began (JAX ``utils/logger.py:398-406``)."""
    global _current
    prev = _current
    _current = None  # configure_dir would close the writers it replaces
    configure_dir(dir=dir, format_strs=format_strs)
    try:
        yield
    finally:
        _current.close()
        _current = prev
