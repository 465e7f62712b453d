"""FID / sFID / Inception Score / precision / recall on PyTorch: the port of
``evaluations/evaluator.py``.

    python -m guided_diffusion_clip_tpu_torch.evaluations.evaluator ref_batch.npz sample_batch.npz

The same arguments and the same metric lines as the JAX evaluator, plus
``--device`` (default ``cuda``; a missing card is an error, ``--device cpu``
runs on the CPU) and ``--inception_npz`` (the converted weights; by default
``$INCEPTION_NPZ``, then ``inception_v3_fid.npz`` in the working directory or
beside this file). Each npz holds the images as ``arr_0`` (uint8 NHWC, as
every sampling CLI writes them), read in row batches without loading it
whole; a reference batch with ``mu``/``sigma``/``mu_s``/``sigma_s`` gives its
statistics as they are.

  - The metric math is numpy and scipy: the Frechet distance of two
    Gaussians (with the eps retry on a singular product), the softmax-KL
    Inception Score over splits of 5000, and improved precision/recall with
    k = 3 manifold radii in row and column blocks of 10 000.
  - The distance blocks of precision/recall are one float32 product on the
    device, TF32 off (``pairwise_l2_sq``); the k-th smallest distance of each
    row is taken on the host (``np.partition``), the membership test on the
    device.
  - The extractor: ``flax-inception`` (the name kept, so that one command
    line works with both packages) is the port's ``InceptionV3``
    (``inception.py``) from the converted weights; ``inception`` the frozen
    TF graph (needs TensorFlow and the pb); ``pixel`` a weights-free debug
    extractor whose every metric line is tagged ``[pixel-debug]``; ``auto``
    takes the first of these that it finds, in that order.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import warnings
import zipfile
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from .inception import build_inception, full_f32

INCEPTION_PB_ENV = "INCEPTION_PB"
DEFAULT_PB_NAMES = (
    "classify_image_graph_def.pb",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "classify_image_graph_def.pb"),
)
INCEPTION_NPZ_ENV = "INCEPTION_NPZ"
DEFAULT_NPZ_NAMES = (
    "inception_v3_fid.npz",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "inception_v3_fid.npz"),
)
METRIC_LINES = ("Inception Score", "FID", "sFID", "Precision", "Recall")


def main(argv=None) -> dict:
    """Run the CLI; returns {metric line's name: value}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("ref_batch", help="path to reference batch npz file")
    parser.add_argument("sample_batch", help="path to sample batch npz file")
    parser.add_argument(
        "--extractor", default="auto",
        choices=["auto", "inception", "flax-inception", "pixel"],
        help="feature extractor; 'auto' prefers the converted Inception "
             "npz, then the TF pb, then the pixel debug extractor",
    )
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--inception_npz", default="", help="the converted Inception weights")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    extractor = make_extractor(args.extractor, device, args.inception_npz or None)
    print(f"feature extractor: {extractor.name}")

    print("computing reference batch activations...")
    ref_acts = extractor.read_activations(args.ref_batch)
    print("computing/reading reference batch statistics...")
    ref_stats, ref_stats_spatial = extractor.read_statistics(args.ref_batch, ref_acts)

    print("computing sample batch activations...")
    sample_acts = extractor.read_activations(args.sample_batch)
    print("computing/reading sample batch statistics...")
    sample_stats, sample_stats_spatial = extractor.read_statistics(args.sample_batch, sample_acts)

    print("Computing evaluations...")
    # the tag marks a debug extractor's numbers on every line, so that they are never quoted as FID
    tag = extractor.tag
    values = (
        extractor.compute_inception_score(sample_acts[0]),
        sample_stats.frechet_distance(ref_stats),
        sample_stats_spatial.frechet_distance(ref_stats_spatial),
        *compute_prec_recall(ref_acts[0], sample_acts[0], device=device),
    )
    for name, value in zip(METRIC_LINES, values):
        print(f"{name}{tag}:", value)
    return dict(zip(METRIC_LINES, values))


# ---------------------------------------------------------------------------
# Metric math (extractor-agnostic)
# ---------------------------------------------------------------------------


class FIDStatistics:
    """mu/sigma of a feature distribution + Frechet distance
    (reference evaluator.py:62-115)."""

    def __init__(self, mu: np.ndarray, sigma: np.ndarray):
        self.mu = mu
        self.sigma = sigma

    def frechet_distance(self, other: "FIDStatistics", eps: float = 1e-6) -> float:
        import scipy.linalg

        mu1, mu2 = np.atleast_1d(self.mu), np.atleast_1d(other.mu)
        sigma1, sigma2 = np.atleast_2d(self.sigma), np.atleast_2d(other.sigma)
        diff = mu1 - mu2
        # the matrix alone: scipy 1.16 dropped ``disp`` (the JAX evaluator's ``disp=False`` also returned an
        # error estimate, which it never read)
        covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            warnings.warn(
                f"fid calculation produces singular product; adding {eps} to diagonal of cov estimates"
            )
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
            covmean = covmean.real
        return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def statistics_from_activations(acts: np.ndarray) -> FIDStatistics:
    return FIDStatistics(np.mean(acts, axis=0), np.cov(acts, rowvar=False))


def inception_score_from_preds(preds: np.ndarray, split_size: int = 5000) -> float:
    """Softmax-KL IS over splits (reference evaluator.py:179-192)."""
    scores = []
    for i in range(0, len(preds), split_size):
        part = preds[i : i + split_size]
        kl = part * (np.log(part) - np.log(np.expand_dims(np.mean(part, 0), 0)))
        kl = np.mean(np.sum(kl, 1))
        scores.append(np.exp(kl))
    return float(np.mean(scores))


def pairwise_l2_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances of the rows of ``a`` to those of ``b``: one
    float32 block a2 - 2 a b^T + b2, clamped at 0, TF32 off."""
    with full_f32():
        a2 = (a * a).sum(dim=1, keepdim=True)
        b2 = (b * b).sum(dim=1, keepdim=True)
        return torch.clamp(a2 - 2.0 * (a @ b.T) + b2.T, min=0.0)


class ManifoldEstimator:
    """k-NN manifold radii + membership (reference evaluator.py:217-323,
    k = 3), the features on ``device``."""

    def __init__(self, features, nhood_size: int = 3, row_batch: int = 10000, col_batch: int = 10000,
                 device="cpu"):
        self.features = torch.as_tensor(np.asarray(features, np.float32)).to(device)
        self.nhood_size = nhood_size
        self.row_batch = row_batch
        self.col_batch = col_batch
        self.radii = self._compute_radii()

    def _compute_radii(self) -> torch.Tensor:
        feats, n = self.features, len(self.features)
        radii = np.zeros(n, np.float32)
        for i in range(0, n, self.row_batch):
            rows = feats[i : i + self.row_batch]
            d = torch.cat([pairwise_l2_sq(rows, feats[j : j + self.col_batch]) for j in range(0, n, self.col_batch)],
                          dim=1).cpu().numpy()
            # kth-NN excluding self: self-distance 0 occupies slot 0
            radii[i : i + len(rows)] = np.partition(d, self.nhood_size, axis=1)[:, self.nhood_size]
        return torch.from_numpy(radii).to(feats.device)

    def evaluate_membership(self, points) -> np.ndarray:
        """For each point: does it fall inside ANY manifold ball?"""
        points = torch.as_tensor(np.asarray(points, np.float32)).to(self.features.device)
        out = []
        for i in range(0, len(points), self.row_batch):
            rows = points[i : i + self.row_batch]
            inside = torch.zeros(len(rows), dtype=torch.bool, device=rows.device)
            for j in range(0, len(self.features), self.col_batch):
                d = pairwise_l2_sq(rows, self.features[j : j + self.col_batch])
                inside |= (d <= self.radii[j : j + self.col_batch][None, :]).any(dim=1)
            out.append(inside)
        return torch.cat(out).cpu().numpy()


def compute_prec_recall(ref_features, sample_features, nhood_size: int = 3, device="cpu"):
    """Improved precision & recall (reference evaluate_pr, evaluator.py:325-359)."""
    ref_manifold = ManifoldEstimator(ref_features, nhood_size, device=device)
    sample_manifold = ManifoldEstimator(sample_features, nhood_size, device=device)
    precision = float(ref_manifold.evaluate_membership(sample_features).mean())
    recall = float(sample_manifold.evaluate_membership(ref_features).mean())
    return precision, recall


# ---------------------------------------------------------------------------
# npz streaming (reference evaluator.py:433-531)
# ---------------------------------------------------------------------------


def iter_npz_batches(npz_path: str, batch_size: int = 256) -> Iterator[np.ndarray]:
    """Stream ``arr_0`` out of an npz in row batches without materializing it.

    An npz is a zip archive whose members are .npy files: read the npy
    header for shape and dtype, then whole rows from the (possibly deflated)
    zip stream. Works for both np.savez (stored) and np.savez_compressed.
    """
    with zipfile.ZipFile(npz_path, "r") as zf:
        name = "arr_0.npy" if "arr_0.npy" in zf.namelist() else zf.namelist()[0]
        with zf.open(name, "r") as member:
            version = np.lib.format.read_magic(member)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(member)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(member)
            else:
                shape, fortran, dtype = np.lib.format._read_array_header(member, version)
            if fortran or dtype.hasobject:
                # rare layouts: fall back to full load
                arr = np.load(io.BytesIO(zf.read(name)), allow_pickle=False)
                for i in range(0, len(arr), batch_size):
                    yield arr[i : i + batch_size]
                return
            n = shape[0] if shape else 0
            row_shape = shape[1:]
            row_nbytes = int(np.prod(row_shape, dtype=np.int64)) * dtype.itemsize
            for i in range(0, n, batch_size):
                rows = min(batch_size, n - i)
                buf = member.read(rows * row_nbytes)
                if len(buf) != rows * row_nbytes:
                    raise IOError(f"truncated npz member {name} at row {i}")
                yield np.frombuffer(buf, dtype=dtype).reshape((rows,) + row_shape)


def npz_has_statistics(npz_path: str) -> bool:
    with np.load(npz_path) as obj:
        return "mu" in obj.files


# ---------------------------------------------------------------------------
# Extractors
# ---------------------------------------------------------------------------


class Extractor:
    name = "base"
    tag = ""  # appended to metric labels; non-empty for debug extractors

    def extract(self, batch_uint8: np.ndarray):
        """-> (pool_features [B, D], spatial_features [B, D2], preds [B, K])."""
        raise NotImplementedError

    def read_activations(self, npz_path: str):
        pools, spatials, preds = [], [], []
        for batch in iter_npz_batches(npz_path):
            p, s, pr = self.extract(batch)
            pools.append(p)
            spatials.append(s)
            preds.append(pr)
        self._last_preds = np.concatenate(preds, 0)
        return np.concatenate(pools, 0), np.concatenate(spatials, 0)

    def read_statistics(self, npz_path: str, acts):
        """Use cached mu/sigma from the npz when present (reference :164-177)."""
        with np.load(npz_path) as obj:
            if "mu" in obj.files:
                return (
                    FIDStatistics(obj["mu"], obj["sigma"]),
                    FIDStatistics(obj["mu_s"], obj["sigma_s"]),
                )
        return statistics_from_activations(acts[0]), statistics_from_activations(acts[1])

    def compute_inception_score(self, pool_acts: np.ndarray) -> float:
        return inception_score_from_preds(self._last_preds)


class TFInceptionExtractor(Extractor):
    """The original frozen InceptionV3 graph via tf.compat.v1, bit-exact with
    the reference evaluator when classify_image_graph_def.pb is on disk;
    needs TensorFlow, imported here."""

    name = "inception (frozen TF graph)"

    def __init__(self, pb_path: str):
        import tensorflow.compat.v1 as tf

        tf.disable_eager_execution()
        self.tf = tf
        config = tf.ConfigProto(allow_soft_placement=True)
        self.sess = tf.Session(config=config)
        with open(pb_path, "rb") as f:
            graph_def = tf.GraphDef()
            graph_def.ParseFromString(f.read())
        self.image_input = tf.placeholder(tf.uint8, [None, None, None, 3], name="image_input")
        pool3, spatial = tf.import_graph_def(
            graph_def,
            input_map={"ExpandDims:0": self.image_input},
            return_elements=["pool_3:0", "mixed_6/conv:0"],
            name="inception",
        )
        pool3 = tf.squeeze(tf.squeeze(pool3, 2), 1)
        spatial = spatial[..., :7]
        spatial = tf.reshape(spatial, [tf.shape(spatial)[0], -1])
        w = self.sess.graph.get_operation_by_name("inception/softmax/logits/MatMul").inputs[1]
        logits = tf.matmul(pool3, w)
        self.pool3, self.spatial, self.softmax = pool3, spatial, tf.nn.softmax(logits)

    def extract(self, batch_uint8: np.ndarray):
        p, s, sm = self.sess.run(
            [self.pool3, self.spatial, self.softmax], {self.image_input: batch_uint8}
        )
        return p, s, sm


class InceptionExtractor(Extractor):
    """The port's InceptionV3 (``inception.py``) from the converted weights,
    on ``device``, in sub-batches of ``batch``."""

    name = "inception (PyTorch port of the frozen FID graph)"

    def __init__(self, npz_path: str, device="cpu", batch: int = 64):
        self.device = torch.device(device)
        self.model = build_inception(npz_path, self.device)
        self._batch = batch

    def extract(self, batch_uint8: np.ndarray):
        outs = [[], [], []]
        with torch.no_grad():
            for i in range(0, len(batch_uint8), self._batch):
                x = torch.tensor(batch_uint8[i : i + self._batch], device=self.device)
                pool3, spatial = self.model(x)
                preds = self.model.softmax(pool3)
                for o, v in zip(outs, (pool3, spatial.reshape(len(x), -1), preds)):
                    o.append(v.cpu().numpy())
        return tuple(np.concatenate(o, 0) for o in outs)


class PixelExtractor(Extractor):
    """Weights-free debug extractor: downsampled pixels + channel stats.

    Lets the full evaluator pipeline run without the Inception weights.
    Relative comparisons only — NOT comparable to published FID numbers. The
    resize is bilinear with half-pixel centers and, where it shrinks, the
    antialiasing filter of ``jax.image.resize(..., "linear")``.
    """

    name = "pixel (debug; NOT comparable to published FID)"
    tag = "[pixel-debug]"

    def __init__(self, side: int = 8, device="cpu"):
        self.side = side
        self.device = torch.device(device)

    def extract(self, batch_uint8: np.ndarray):
        x = batch_uint8.astype(np.float32) / 127.5 - 1.0
        b = len(x)
        x = torch.from_numpy(x).to(self.device).permute(0, 3, 1, 2)

        def resize(side):
            y = F.interpolate(x, size=(side, side), mode="bilinear", align_corners=False, antialias=True)
            return y.permute(0, 2, 3, 1).reshape(b, -1).cpu().numpy()

        pool, spatial = resize(self.side), resize(self.side * 2)
        # fake "preds": softmax over pooled-pixel bins
        logits = pool[:, :64]
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        preds = e / e.sum(axis=1, keepdims=True)
        return pool, spatial, preds


def _find(env: str, names) -> str | None:
    cand = os.environ.get(env)
    if cand and os.path.exists(cand):
        return cand
    for name in names:
        if os.path.exists(name):
            return name
    return None


def find_inception_pb() -> str | None:
    return _find(INCEPTION_PB_ENV, DEFAULT_PB_NAMES)


def find_inception_npz() -> str | None:
    return _find(INCEPTION_NPZ_ENV, DEFAULT_NPZ_NAMES)


def make_extractor(kind: str, device="cpu", npz: str | None = None) -> Extractor:
    """The extractor ``kind`` names (``auto``: the converted npz, then the TF
    pb, then the pixel debug extractor, with a warning); ``npz`` in place of
    the search for the converted weights."""
    if kind in ("auto", "inception", "flax-inception"):
        npz = npz or find_inception_npz()
        if npz is not None and kind != "inception":
            return InceptionExtractor(npz, device)
        if kind == "flax-inception":
            raise SystemExit(
                "converted Inception weights not found. Run "
                "`python -m guided_diffusion_clip_tpu_torch.evaluations.inception convert <pb> "
                f"inception_v3_fid.npz` or set {INCEPTION_NPZ_ENV}."
            )
        pb = find_inception_pb()
        if pb is not None:
            return TFInceptionExtractor(pb)
        if kind == "inception":
            raise SystemExit(
                "InceptionV3 graph not found. Place classify_image_graph_def.pb "
                f"locally and set {INCEPTION_PB_ENV} (the reference downloads it "
                "from openaipublic, evaluator.py:573-583)."
            )
        print(
            "WARNING: Inception pb not found; using the pixel debug extractor. "
            "Metrics are for relative comparison only.",
            file=sys.stderr,
        )
    return PixelExtractor(device=device)


if __name__ == "__main__":
    main()
