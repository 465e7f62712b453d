"""Remote-blob-capable file IO: the port's copy of ``guided_diffusion_clip_tpu/utils/bf_io.py``.

The reference does all checkpoint and dataset IO through ``blobfile``
(train_util.py:243-267 bf.BlobFile; image_datasets.py:76-85 bf.listdir),
which handles gs:// paths. Here, as in the JAX package: local paths use plain
os and builtins (no overhead, no change of behaviour), and any URL-style path
(gs://, s3://, memory://, file://, ...) goes through ``fsspec``, imported
only for such a path. The port's data loader (``data/image_datasets.py``) and
its checkpoints (``utils/checkpoint.py``) read and write through it.
"""

from __future__ import annotations

import os


def is_remote(path: str) -> bool:
    return "://" in str(path)


def _fs(path: str):
    import fsspec

    fs, _ = fsspec.core.url_to_fs(str(path))
    return fs


def open_file(path: str, mode: str = "rb"):
    """bf.BlobFile parity: a file object for local or remote paths."""
    if is_remote(path):
        import fsspec

        return fsspec.open(str(path), mode).open()
    return open(path, mode)


def exists(path: str) -> bool:
    if is_remote(path):
        return _fs(path).exists(str(path))
    return os.path.exists(path)


def isdir(path: str) -> bool:
    if is_remote(path):
        return _fs(path).isdir(str(path))
    return os.path.isdir(path)


def listdir(path: str) -> list[str]:
    """bf.listdir parity: base names of entries under `path`, sorted."""
    if is_remote(path):
        fs = _fs(path)
        return sorted(
            os.path.basename(p.rstrip("/")) for p in fs.ls(str(path), detail=False)
        )
    return sorted(os.listdir(path))


def makedirs(path: str) -> None:
    if is_remote(path):
        _fs(path).makedirs(str(path), exist_ok=True)
        return
    os.makedirs(path, exist_ok=True)


def join(path: str, *parts: str) -> str:
    """os.path.join that keeps URL schemes intact."""
    if is_remote(path):
        return "/".join([str(path).rstrip("/")] + [p.strip("/") for p in parts])
    return os.path.join(path, *parts)
