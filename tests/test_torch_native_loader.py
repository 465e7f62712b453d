"""The port's native C++ loader (``data/native_loader.py`` over
``native/gdc_loader.cpp``), built at first use into ``build/gdc_loader/``.

The cases of tests/test_native_loader.py on the port's ``ImageDataset``
(images CHW): bit-identical pixels to the PIL path at the target size, down a
chain of BOX halvings, through a fractional BICUBIC step, at odd sizes and
upscales, and through JPEG decoding; the flip indicator and determinism by
seed; a decode failure raises. Then whole batches of ``load_data`` with the
native path (``native=True`` and ``GDC_NATIVE_LOADER=1``) equal the Python
loader's bit for bit, conditioning included, and a library that cannot be
built or loaded raises instead of falling back to PIL.
"""

import os
import random

import numpy as np
import pytest
from PIL import Image

from guided_diffusion_clip_tpu_torch.data import image_datasets as TD
from guided_diffusion_clip_tpu_torch.data import native_loader


def _write(tmp_path, name, size, fmt="PNG"):
    rs = np.random.RandomState(sum(map(ord, name)))
    arr = rs.randint(0, 255, (size, size, 3) if isinstance(size, int) else (*size, 3), dtype=np.uint8)
    p = str(tmp_path / name)
    Image.fromarray(arr).save(p, format=fmt)
    return p


def _sample(path, image_size, native):
    ds = TD.ImageDataset(image_size, [path], random_flip=False, deterministic=True, native=native)
    return ds[0][0]


@pytest.mark.parametrize("name,src,tgt", [
    ("exact.png", 32, 32),  # at the target size
    ("pow2.png", 128, 32),  # BOX-halved twice, no bicubic step
    ("frac.png", 48, 32),  # an antialias-stretched BICUBIC step
    ("odd_37.png", 37, 16), ("odd_97.png", 97, 32),  # odd halving bounds
    ("up_24.png", 24, 32),  # an upscale: the unstretched kernel
    ("wide.png", (40, 72), 32),  # a center crop of a non-square image
])
def test_native_pixels_equal_pil(tmp_path, name, src, tgt):
    p = _write(tmp_path, name, src)
    nat, ref = _sample(p, tgt, True), _sample(p, tgt, False)
    assert nat.shape == ref.shape == (3, tgt, tgt) and nat.dtype == np.float32
    np.testing.assert_array_equal(nat, ref)
    assert nat.min() >= -1.0 and nat.max() <= 1.0


def test_jpeg_decode(tmp_path):
    # PIL and the native loader link the same system libjpeg, so decoding is bit-exact too
    p = _write(tmp_path, "photo.jpg", 64, fmt="JPEG")
    np.testing.assert_array_equal(_sample(p, 32, True), _sample(p, 32, False))


def test_flip_indicator_and_determinism(tmp_path):
    p = _write(tmp_path, "flip.png", 32)
    rng = random.Random(0)
    seeds = [rng.getrandbits(63) or 1 for _ in range(8)]  # as ImageDataset draws them
    batch, flipped = native_loader.process_batch([p] * 8, 32, random_flip=True, seeds=seeds)
    assert batch.shape == (8, 32, 32, 3) and flipped.shape == (8,)
    assert 0 < flipped.sum() < 8  # both outcomes among these 8 seeds
    batch2, flipped2 = native_loader.process_batch([p] * 8, 32, random_flip=True, seeds=seeds)
    np.testing.assert_array_equal(flipped, flipped2)
    np.testing.assert_array_equal(batch, batch2)
    ref = _sample(p, 32, False).transpose(1, 2, 0)
    for i in range(8):
        np.testing.assert_array_equal(batch[i], ref[:, ::-1] if flipped[i] else ref)


def test_decode_failure_raises(tmp_path):
    bad = str(tmp_path / "corrupt.png")
    with open(bad, "wb") as f:
        f.write(b"not an image at all")
    with pytest.raises(IOError):
        native_loader.process_batch([bad], 32, random_flip=False)
    with pytest.raises(IOError):
        _sample(bad, 32, True)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """12 PNGs and JPEGs of mixed sizes (one in a subfolder) and their flip-indexed CLIP dict."""
    root = tmp_path_factory.mktemp("native")
    img_dir = root / "imgs"
    (img_dir / "sub").mkdir(parents=True)
    rs = np.random.RandomState(0)
    clip = {}
    for i in range(12):
        name = f"img_{i:03d}." + ("jpg" if i % 4 == 3 else "png")
        h, w = (16, 16) if i % 3 else (24 + i, 40 - i)
        Image.fromarray(rs.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(
            img_dir / ("sub" if i == 7 else "") / name)
        clip[name] = rs.randn(2, 512).astype(np.float32)
    np.savez(root / "clip.npz", **clip)
    return str(img_dir), str(root / "clip.npz")


@pytest.mark.parametrize("route", ["argument", "environment"])
def test_load_data_batches_equal_the_python_loaders(folder, route, monkeypatch):
    img_dir, clip = folder
    kw = dict(data_dir=img_dir, batch_size=4, image_size=16, class_cond=True, deterministic=True,
              clip_file_path=clip, prefetch=0)
    python = TD.load_data(native=False, **kw)
    if route == "environment":
        monkeypatch.setenv("GDC_NATIVE_LOADER", "1")
        native = TD.load_data(**kw)
    else:
        native = TD.load_data(native=True, **kw)
    for _ in range(5):  # past one epoch
        (x, c), (rx, rc) = next(native), next(python)
        assert x.shape == (4, 3, 16, 16) and x.dtype == np.float32
        np.testing.assert_array_equal(x, rx)
        assert sorted(c) == sorted(rc) == ["clip_feat", "clip_feat2", "img2"]
        for k in c:
            np.testing.assert_array_equal(c[k], rc[k], err_msg=k)


def test_shuffled_native_batches_are_valid(folder):
    """With random crops and flips the native path draws from its own seeds:
    other crops and flips than PIL's, the same files in the same order."""
    img_dir, clip = folder
    kw = dict(data_dir=img_dir, batch_size=4, image_size=16, class_cond=True, random_crop=True,
              clip_file_path=clip, prefetch=0, seed=3)
    (x, c), (rx, rc) = next(TD.load_data(native=True, **kw)), next(TD.load_data(native=False, **kw))
    assert x.shape == rx.shape and np.isfinite(x).all() and np.abs(x).max() <= 1.0
    for feat, ref in zip(c["clip_feat"], rc["clip_feat"]):
        # the flip picks one of the file's two embeddings; the same file either way
        pair = next(v for v in np.load(clip).values() if np.array_equal(v[0], ref) or np.array_equal(v[1], ref))
        assert any(np.array_equal(feat, v) for v in pair)


def test_unloadable_library_raises(tmp_path, monkeypatch):
    bogus = tmp_path / "libgdc_loader.so"
    bogus.write_text("not a shared object")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "library_path", lambda: str(bogus))
    with pytest.raises(OSError):
        native_loader.load_library()


def test_failed_build_raises_and_the_loader_does_not_fall_back(folder, tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_loader, "library_path", lambda: str(tmp_path / "build" / "lib.so"))
    monkeypatch.setenv("CXX", "false")  # native/Makefile's CXX ?= gives way to the environment
    with pytest.raises(OSError, match="build failed"):
        native_loader.load_library()
    with pytest.raises(OSError, match="build failed"):
        TD.load_data(data_dir=folder[0], batch_size=2, image_size=16, native=True, prefetch=0)
    assert not os.path.exists(tmp_path / "build" / "lib.so")


def test_build_follows_the_makefile():
    cmd = native_loader._command("out.so")
    with open(os.path.join(native_loader.NATIVE_DIR, "Makefile")) as f:
        text = f.read()
    for flag in ("-O3", "-fPIC", "-std=c++17", "-ljpeg", "-lpng"):
        assert flag in text and flag in cmd
    assert os.path.dirname(native_loader.library_path()) == native_loader.BUILD_DIR
    assert not native_loader.BUILD_DIR.startswith(native_loader.NATIVE_DIR)


def test_library_is_kept_apart_for_each_cpu(monkeypatch):
    # the flags hold -march=native: a library built on one CPU is not loaded on another
    here = native_loader.library_path()
    assert native_loader._host_cpu()
    monkeypatch.setattr(native_loader, "_host_cpu", lambda: "model name\t: another CPU\nflags\t\t: sse2\n")
    assert native_loader.library_path() != here
