"""Precompute the per-image CLIP embedding dict the fork's datasets consume:
the port of scripts/compute_clip_embeddings.py.

    python -m guided_diffusion_clip_tpu_torch.compute_clip_embeddings \\
        --data_dir <images> --out clip_dict.pt --clip_model_path ViT-B-32.pt

Each image under ``--data_dir`` (recursively, as the loader lists them) is
center-cropped to ``--image_size`` (``center_crop_arr``), then it and its
horizontal flip, in that order, go through ``preprocess_for_clip`` and the
CLIP vision encoder in batches of ``--batch_size`` images (2 x that many
rows). The result ``{basename: (2, embed_dim)}`` is written as a ``.pt`` of
torch tensors or, for any other suffix, an ``.npz``; ``image_train
--clip_file_path`` reads it and picks row ``int(flipped)``.

The weights (``--clip_model_path``) are an OpenAI CLIP ``.pt`` or an HF
``CLIPModel`` state_dict (``models/clip_vit.py::load_clip_params``). The JAX
script imports a ``load_clip_vision_params`` that does not exist and stops
there; the port takes the vision encoder of ``load_clip_params``.
``GDC_CLIP_TINY=1`` builds the tiny CLIP of ``clip_guided_sample`` instead of
ViT-B/32, for tests with small random weights. ``--device`` (default
``cuda``; a missing card is an error) is where the encoder runs.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from PIL import Image

from .data.image_datasets import center_crop_arr, list_image_files_recursively
from .models.clip_vit import clip_config, load_clip_params, preprocess_for_clip
from .utils import bf_io

def image_pair(path: str, image_size: int) -> np.ndarray:
    """(2, 3, S, S) f32 in [-1, 1]: the center crop of ``path`` and its horizontal flip."""
    with bf_io.open_file(path, "rb") as f, Image.open(f) as img:
        arr = center_crop_arr(img.convert("RGB"), image_size).astype(np.float32) / 127.5 - 1.0
    arr = arr.transpose(2, 0, 1)
    return np.stack([arr, arr[:, :, ::-1]])


def main(argv=None) -> dict:
    """Run the CLI; returns {"path", "images", "seconds": the wall time of the
    batches' encoding, each with its copy back to the host}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--out", required=True, help=".pt or .npz output path")
    parser.add_argument("--clip_model_path", required=True)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    cfg = clip_config()
    vision = load_clip_params(args.clip_model_path, cfg, device)[0].requires_grad_(False)
    files = list_image_files_recursively(args.data_dir)
    result, seconds = {}, 0.0
    for start in range(0, len(files), args.batch_size):
        chunk = files[start:start + args.batch_size]
        x = torch.from_numpy(np.concatenate([image_pair(p, args.image_size) for p in chunk])).to(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            emb = vision(preprocess_for_clip(x, cfg.image_size)).cpu().numpy()
        seconds += time.perf_counter() - t0
        # pairs: [unflipped, flipped] per image (the loader's flip-indexed lookup)
        for i, path in enumerate(chunk):
            result[os.path.basename(path)] = emb[2 * i:2 * i + 2]

    with bf_io.open_file(args.out, "wb") as f:
        if args.out.endswith(".pt"):
            torch.save({k: torch.from_numpy(v) for k, v in result.items()}, f)
        else:
            np.savez(f, **result)
    print(f"wrote {len(result)} embeddings to {args.out}")
    return {"path": args.out, "images": len(result), "seconds": seconds}


if __name__ == "__main__":
    main()
