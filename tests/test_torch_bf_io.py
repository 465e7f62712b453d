"""The port's remote-blob IO (``utils/bf_io.py``) on fsspec's memory://
filesystem: the four cases of ``tests/test_bf_io.py`` through the port's
loader and checkpoints, and the JAX ``bf_io``'s answers on the same paths."""

import io
import os

import numpy as np
import pytest
import torch

fsspec = pytest.importorskip("fsspec")

from guided_diffusion_clip_tpu.utils import bf_io as jbf_io
from guided_diffusion_clip_tpu_torch.data.image_datasets import ImageDataset, list_image_files_recursively, load_data
from guided_diffusion_clip_tpu_torch.utils import bf_io
from guided_diffusion_clip_tpu_torch.utils import checkpoint as ckpt


def _wipe(fs):
    try:
        fs.rm("/", recursive=True)
    except FileNotFoundError:
        pass


@pytest.fixture
def memfs():
    fs = fsspec.filesystem("memory")
    _wipe(fs)  # memory:// is process-global: isolate each test
    yield fs
    _wipe(fs)


def _png_bytes(seed, size=(8, 8)):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(seed).randint(0, 255, (*size, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _put(fs, path, data):
    with fs.open(path, "wb") as f:
        f.write(data)


def test_listdir_and_recursive_listing(memfs):
    _put(memfs, "/data/a.png", _png_bytes(0))
    _put(memfs, "/data/b.jpg", _png_bytes(1))
    _put(memfs, "/data/sub/c.png", _png_bytes(2))
    _put(memfs, "/data/notes.txt", b"not an image")

    assert bf_io.is_remote("memory://data") and not bf_io.is_remote("/tmp/x")
    names = bf_io.listdir("memory://data")
    assert names == ["a.png", "b.jpg", "notes.txt", "sub"] == jbf_io.listdir("memory://data")
    assert bf_io.isdir("memory://data/sub") and not bf_io.isdir("memory://data/a.png")
    files = list_image_files_recursively("memory://data")
    assert [f.rsplit("/", 1)[-1] for f in files] == ["a.png", "b.jpg", "c.png"]


def test_dataset_reads_remote_images_as_the_local_folder(memfs, tmp_path):
    """The remote folder's batches equal the local copy's, crops, flips,
    classes and order included."""
    local = tmp_path / "data"
    local.mkdir()
    for i in range(6):
        data = _png_bytes(i, size=(12, 10))
        _put(memfs, f"/data/c{i % 3}_{i}.png", data)
        (local / f"c{i % 3}_{i}.png").write_bytes(data)

    ds = ImageDataset(8, list_image_files_recursively("memory://data"), random_flip=False, deterministic=True)
    img, _ = ds[0]
    assert img.shape == (3, 8, 8) and img.dtype == np.float32

    kw = dict(batch_size=2, image_size=8, class_cond=True, class_cond_from_filenames=True, random_crop=True,
              prefetch=0)
    remote, here = load_data(data_dir="memory://data", **kw), load_data(data_dir=str(local), **kw)
    for _ in range(4):
        (rx, rc), (lx, lc) = next(remote), next(here)
        np.testing.assert_array_equal(rx, lx)
        np.testing.assert_array_equal(rc["y"], lc["y"])


def test_checkpoint_save_resume_remote(memfs):
    sd = {"dense.weight": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    base = "memory://ckpts"
    model_path = bf_io.join(base, ckpt.checkpoint_name("model", 5))
    ema_path = bf_io.join(base, ckpt.checkpoint_name("ema", 5, 0.9999))

    ckpt.save_state_dict(model_path, sd)
    ckpt.save_state_dict(ema_path, {"dense.weight": sd["dense.weight"] * 2})

    assert bf_io.exists(model_path) and jbf_io.exists(model_path)
    assert ckpt.parse_resume_step_from_filename(model_path) == 5
    torch.testing.assert_close(ckpt.load_state_dict(model_path)["dense.weight"], sd["dense.weight"], rtol=0, atol=0)

    # the EMA file beside the model checkpoint (train_util.py:371-378 parity)
    found = ckpt.find_ema_checkpoint(model_path, 5, 0.9999)
    assert found == ema_path
    torch.testing.assert_close(ckpt.load_state_dict(found)["dense.weight"], sd["dense.weight"] * 2, rtol=0, atol=0)
    assert ckpt.find_ema_checkpoint(model_path, 5, 0.5) is None

    # a model loads from the remote file with strict=True
    model = torch.nn.Module()
    model.dense = torch.nn.Linear(3, 2, bias=False)
    ckpt.load_model_weights(model, model_path)
    torch.testing.assert_close(model.dense.weight.detach(), sd["dense.weight"], rtol=0, atol=0)


@pytest.mark.parametrize("path,parts", [
    ("gs://bucket/dir", ("f.pt",)), ("gs://bucket/dir/", ("a", "b")), ("/tmp/x", ("y",)), ("memory://c/", ("/d/",)),
])
def test_join_keeps_scheme(path, parts):
    assert bf_io.join(path, *parts) == jbf_io.join(path, *parts)
    if not bf_io.is_remote(path):
        assert bf_io.join(path, *parts) == os.path.join(path, *parts)
    else:
        assert bf_io.join(path, *parts).startswith(path.split("://")[0] + "://")
