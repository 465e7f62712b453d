"""Image data pipeline with CLIP-embedding pairing (reference image_datasets.py).

The port's copy of ``guided_diffusion_clip_tpu/data/image_datasets.py``: a
host-side numpy pipeline with a background prefetch thread. Each rank reads
its shard of the files, ``files[rank::world]`` (``shard``/``num_shards``
override the process group's rank and world), its crops, flips and pairings
drawn from ``random.Random(seed + shard)``. The same files, crops, flips,
pairings and batch order as the JAX loader for the same folder and seed; images go out NCHW f32 in [-1, 1]
(the JAX loader's are NHWC).

  - recursive listing of {jpg, jpeg, png, gif} files (:76-85);
  - BOX-halving, then BICUBIC resize, then a center or random crop (:167-208);
  - a random flip selects the flip's CLIP embedding: the dict stores one
    embedding per flip, picked by ``[int(flipped)]`` (:159-162; a ``caleba``
    dict keeps one);
  - ``img2`` / ``clip_feat2``: the image itself 15 % of the time and a random
    partner 85 %; under ``deterministic``, idx pairs with idx - 1 for idx >= 4
    (:117-137);
  - batches from ``random.Random(1234 + rank)``'s shuffle of the shard's
    indices, ``rank`` the process's (JAX :67-81, :156-173).

The CLIP dict is ``.npz`` or a ``.pt`` of tensors (loaded with
``weights_only=True``). Folders, images and the dict may be URLs (gs://,
memory://, ...), read through ``utils/bf_io.py``; the native decoder takes
local paths only. ``load_data(native=True)`` or ``GDC_NATIVE_LOADER=1``
decodes through the native C++ library (``data/native_loader.py``): one call
an image, its crop and flip drawn from a seed that the dataset's ``random``
gives, the GIL released for the call. Its pixels are the PIL path's bit for
bit; its random crops and flips are not the same draws. Where the library
cannot be built or loaded, ``load_data`` raises (the JAX loader falls back to
PIL without a word).
"""

from __future__ import annotations

import math
import os
import queue
import random
import threading
from typing import Iterator

import numpy as np
from PIL import Image

from ..parallel import dist as pdist
from ..utils import bf_io


def load_data(
    *,
    data_dir: str,
    batch_size: int,
    image_size: int,
    class_cond: bool = False,
    deterministic: bool = False,
    random_crop: bool = False,
    random_flip: bool = True,
    clip_file_path: str | None = None,
    class_cond_from_filenames: bool = False,
    seed: int = 0,
    prefetch: int = 2,
    native: bool | None = None,
    shard: int | None = None,
    num_shards: int | None = None,
) -> Iterator:
    """Infinite generator of (images (B, 3, H, W) f32 in [-1, 1], cond dict)
    batches of this rank's shard. ``native`` None reads ``GDC_NATIVE_LOADER``;
    ``shard``/``num_shards`` None take the process group's rank and world."""
    if not data_dir:
        raise ValueError("unspecified data directory")
    all_files = list_image_files_recursively(data_dir)
    classes = None
    if class_cond and class_cond_from_filenames:
        class_names = [os.path.basename(p).split("_")[0] for p in all_files]
        sorted_classes = {x: i for i, x in enumerate(sorted(set(class_names)))}
        classes = [sorted_classes[x] for x in class_names]
    dataset = ImageDataset(
        image_size,
        all_files,
        classes=classes,
        shard=pdist.rank() if shard is None else shard,
        num_shards=pdist.world_size() if num_shards is None else num_shards,
        random_crop=random_crop,
        random_flip=random_flip,
        clip_file_path=clip_file_path,
        deterministic=deterministic,
        seed=seed,
        native=native,
    )
    return _batched_iterator(dataset, batch_size, deterministic, prefetch)


def _batched_iterator(dataset, batch_size, deterministic, prefetch):
    def gen():
        order_rng = random.Random(1234 + pdist.rank())
        while True:
            order = list(range(len(dataset)))
            if not deterministic:
                order_rng.shuffle(order)
            for start in range(0, len(order) - batch_size + 1, batch_size):
                imgs, conds = zip(*(dataset[i] for i in order[start : start + batch_size]))
                yield np.stack(imgs), {k: np.stack([c[k] for c in conds]) for k in conds[0]}

    if prefetch <= 0:
        yield from gen()
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = object()

    def worker():
        try:
            for item in gen():
                q.put(item)
        except Exception as e:  # the consumer raises it
            q.put(e)
        q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        if isinstance(item, Exception):
            raise item
        yield item


def list_image_files_recursively(data_dir: str) -> list[str]:
    """Image files under ``data_dir``, sorted by name at each level; a URL
    (gs://, memory://, ...) is listed through ``bf_io`` (bf.listdir parity)."""
    results = []
    for entry in bf_io.listdir(data_dir):
        full_path = bf_io.join(data_dir, entry)
        ext = entry.split(".")[-1]
        if "." in entry and ext.lower() in ["jpg", "jpeg", "png", "gif"]:
            results.append(full_path)
        elif bf_io.isdir(full_path):
            results.extend(list_image_files_recursively(full_path))
    return results


def _load_clip_dict(path: str) -> dict:
    """The precomputed {filename: embedding(s)} dict, from ``.npz`` or ``.pt``."""
    with bf_io.open_file(path, "rb") as f:
        if path.endswith(".npz"):
            with np.load(f) as data:
                return {k: data[k] for k in data.files}
        import torch

        data = torch.load(f, map_location="cpu", weights_only=True)
    return {k: np.asarray(v) for k, v in data.items()}


class ImageDataset:
    def __init__(
        self,
        resolution: int,
        image_paths: list[str],
        classes=None,
        shard: int = 0,
        num_shards: int = 1,
        random_crop: bool = False,
        random_flip: bool = True,
        clip_file_path: str | None = None,
        deterministic: bool = False,
        seed: int = 0,
        native: bool | None = None,
    ):
        self.resolution = resolution
        self.local_images = image_paths[shard:][::num_shards]
        self.local_classes = None if classes is None else classes[shard:][::num_shards]
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.clip_file_path = clip_file_path
        self.clip_data = _load_clip_dict(clip_file_path) if clip_file_path else None
        self.deterministic = deterministic
        self.rng = random.Random(seed + shard)
        if native is None:
            native = os.environ.get("GDC_NATIVE_LOADER", "") == "1"
        self.native = bool(native)
        if self.native:
            from . import native_loader

            native_loader.load_library()  # builds it, or raises

    def __len__(self):
        return len(self.local_images)

    def __getitem__(self, idx: int):
        img, out_dict = self.get_sample(idx)
        if self.clip_data is None:
            return img, out_dict
        if not self.deterministic:
            if self.rng.random() < 0.15:
                img2, out_dict2 = img, out_dict
            else:
                img2, out_dict2 = self.get_sample(self.rng.randint(0, len(self) - 1))
        else:
            img2, out_dict2 = (img, out_dict) if idx < 4 else self.get_sample(idx - 1)
        return img, {**out_dict, "img2": img2, "clip_feat2": out_dict2["clip_feat"]}

    def get_sample(self, idx: int):
        """(image (3, H, W) f32 in [-1, 1], {"y"?, "clip_feat"?}) of file ``idx``."""
        path = self.local_images[idx]
        if self.native:
            from . import native_loader

            batch, flipped = native_loader.process_batch(
                [path], self.resolution, random_crop=self.random_crop,
                random_flip=self.random_flip and not self.deterministic,
                seeds=[self.rng.getrandbits(63) or 1], num_threads=1,
            )
            arr, img_flipped = batch[0], bool(flipped[0])
        else:
            with bf_io.open_file(path, "rb") as f, Image.open(f) as pil_image:
                pil_image.load()
                pil_image = pil_image.convert("RGB")
            if self.random_crop:
                arr = random_crop_arr(pil_image, self.resolution, rng=self.rng)
            else:
                arr = center_crop_arr(pil_image, self.resolution)
            img_flipped = self.random_flip and (not self.deterministic) and self.rng.random() < 0.5
            if img_flipped:
                arr = arr[:, ::-1]
            arr = arr.astype(np.float32) / 127.5 - 1

        out_dict = {}
        if self.local_classes is not None:
            out_dict["y"] = np.array(self.local_classes[idx], dtype=np.int32)
        if self.clip_data is not None:
            feat = self.clip_data[os.path.basename(path)]
            if "caleba" not in (self.clip_file_path or ""):
                feat = feat[int(img_flipped)]
            out_dict["clip_feat"] = np.asarray(feat, dtype=np.float32).reshape(-1)
        return np.ascontiguousarray(arr.transpose(2, 0, 1)), out_dict


def center_crop_arr(pil_image: Image.Image, image_size: int) -> np.ndarray:
    """BOX-halve to under twice the target, then BICUBIC, then a center crop (:167-184)."""
    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC)
    arr = np.array(pil_image)
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return arr[crop_y : crop_y + image_size, crop_x : crop_x + image_size]


def random_crop_arr(
    pil_image: Image.Image,
    image_size: int,
    min_crop_frac: float = 0.8,
    max_crop_frac: float = 1.0,
    rng: random.Random | None = None,
) -> np.ndarray:
    """Random-scale BOX + BICUBIC resize, then a random crop (:187-208)."""
    rng = rng or random
    min_smaller_dim_size = math.ceil(image_size / max_crop_frac)
    max_smaller_dim_size = math.ceil(image_size / min_crop_frac)
    smaller_dim_size = rng.randrange(min_smaller_dim_size, max_smaller_dim_size + 1)
    while min(*pil_image.size) >= 2 * smaller_dim_size:
        pil_image = pil_image.resize(tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = smaller_dim_size / min(*pil_image.size)
    pil_image = pil_image.resize(tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC)
    arr = np.array(pil_image)
    crop_y = rng.randrange(arr.shape[0] - image_size + 1)
    crop_x = rng.randrange(arr.shape[1] - image_size + 1)
    return arr[crop_y : crop_y + image_size, crop_x : crop_x + image_size]
