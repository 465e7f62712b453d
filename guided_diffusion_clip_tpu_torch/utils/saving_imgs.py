"""Sample-grid images (counterpart of guided_diffusion_clip_tpu/utils/saving_imgs.py).

``tensor2img``: [-1, 1] float NHWC batch -> uint8 HWC grid with sqrt(N)
columns, torchvision.make_grid semantics, in numpy; ``save_img`` writes it as
a PNG (RGB, with PIL: the reference's cv2 BGR write gives the same pixels).
"""

from __future__ import annotations

import math

import numpy as np


def make_grid(batch: np.ndarray, nrow: int, padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """NHWC float batch -> single HWC grid (torchvision.make_grid semantics)."""
    n, h, w, c = batch.shape
    ncol = nrow
    nrows = int(math.ceil(n / ncol))
    grid = np.full(
        (h * nrows + padding * (nrows + 1), w * ncol + padding * (ncol + 1), c),
        pad_value,
        dtype=batch.dtype,
    )
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = batch[idx]
    return grid


def tensor2img(tensor, min_max=(-1.0, 1.0)) -> np.ndarray:
    """Batch/array in [min, max] -> uint8 grid."""
    arr = np.asarray(tensor, dtype=np.float32)
    arr = np.clip(arr, *min_max)
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    if arr.ndim == 4:
        n = arr.shape[0]
        grid = make_grid(arr, nrow=int(math.sqrt(n)) if n > 1 else 1)
    elif arr.ndim == 3:
        grid = arr
    else:
        raise TypeError(f"Only support 4D/3D array, got {arr.ndim}D")
    return (grid * 255.0).round().astype(np.uint8)


def save_img(img: np.ndarray, img_path: str) -> None:
    """Write a uint8 HWC RGB image to disk (saving_imgs_utils.py:35-37)."""
    from PIL import Image

    Image.fromarray(img).save(img_path)
