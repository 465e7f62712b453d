"""A set-level fidelity metric on the synthetic blob domain, with the power
to tell sets apart.

Counterpart of ``tools/fidelity.py``, which the quality tools share
(``int8_chain_quality``, ``guidance_quality_sweep``):

  - ``make_blob_batch``: smooth two-blob images in [-1, 1], NHWC, and their
    12 generator parameters; the same bytes as the JAX tool's for the same
    ``RandomState``;
  - ``BlobFeatureNet``: three 3x3 stride-2 convs (32, 64, 128 channels),
    the tanh GELU after each, a global mean and ``Linear(128, 32)``: the
    32-d features; a 32 -> 64 -> 12 head regresses the blob parameters in
    training only. flax's ``padding="SAME"`` at stride 2 pads an even size
    by (0, 1) (the output keeps ceil(n / 2) rows), which the forward pads
    explicitly: ``nn.Conv2d(padding=1)`` would shift every map by a pixel;
  - ``train_feature_extractor``: the latent regression under AdamW at optax
    ``adamw(1e-3)``'s settings (weight decay 1e-4, not torch's 1e-2) on
    fresh draws from ``RandomState(seed)``;
  - ``frechet`` and ``score_sets``: the Frechet distance of the
    evaluator's statistics (``evaluations.evaluator``'s ``FIDStatistics``:
    scipy's ``sqrtm``, the eps retry on a singular product, the check of the
    imaginary part), each candidate set scored against two independent base
    draws, beside a floor from three base pairs; every value unrounded.

The network takes NCHW at its edge; the data stay NHWC as the JAX tools
make them, and ``feats_fn`` takes NHWC arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..evaluations.evaluator import statistics_from_activations

FEAT_DIM = 32
FLAX_CONVS = ("Conv_0", "Conv_1", "Conv_2")
# flax's compact names: Dense(feat_dim) is built first; in ``Dense(12)(gelu(Dense(64)(...)))`` the
# outer call's module is constructed, and named, before its argument's
FLAX_DENSES = {"feat": "Dense_0", "out": "Dense_1", "hidden": "Dense_2"}


def make_blob_batch(rs, n, size, s_lo=0.08, s_hi=0.25, return_latents=False):
    """Smooth colored 2-blob images in [-1, 1], (n, size, size, 3) float32;
    with ``return_latents`` also the (n, 12) generator parameters (cx, cy, s,
    r, g, b of each blob, the blobs ordered by cx). The JAX tool's draws, in
    its order, from ``rs``."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size, 3), np.float32)
    lat = np.empty((n, 2, 6), np.float32)
    for i in range(n):
        img = np.zeros((size, size, 3), np.float32)
        blobs = []
        for _ in range(2):
            cx, cy = rs.uniform(0.2, 0.8, 2)
            s = rs.uniform(s_lo, s_hi)
            color = rs.uniform(-1, 1, 3)
            g = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
            img += g[..., None] * color[None, None, :]
            blobs.append([cx, cy, s, *color])
        blobs.sort(key=lambda r: r[0])
        lat[i] = np.array(blobs, np.float32)
        out[i] = np.clip(img, -1, 1)
    if return_latents:
        return out, lat.reshape(n, -1)
    return out


def same_pads(size: int, kernel: int = 3, stride: int = 2) -> tuple:
    """(before, after) padding of flax's ``SAME`` along one axis: the output
    keeps ceil(size / stride) positions, and the odd pixel of padding goes
    after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _flax_init_(layer: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults: the kernel from lecun_normal (a normal truncated at
    two standard deviations, of variance 1 / fan_in once truncated) and a
    zero bias."""
    w = layer.weight
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        layer.bias.zero_()


class BlobFeatureNet(nn.Module):
    """The JAX tool's ``BlobFeatureNet``: ``forward(x)`` of an NCHW batch
    returns (features (n, 32), the regressed blob parameters (n, 12))."""

    def __init__(self):
        super().__init__()
        chans = (3, 32, 64, 128)
        self.convs = nn.ModuleList(nn.Conv2d(i, o, 3, stride=2) for i, o in zip(chans, chans[1:]))
        self.feat = nn.Linear(128, FEAT_DIM)
        self.hidden = nn.Linear(FEAT_DIM, 64)
        self.out = nn.Linear(64, 12)
        g = torch.Generator().manual_seed(0)
        for layer in (*self.convs, self.feat, self.hidden, self.out):
            _flax_init_(layer, g)

    def forward(self, x):
        for conv in self.convs:
            (top, bottom), (left, right) = same_pads(x.shape[2]), same_pads(x.shape[3])
            x = F.gelu(conv(F.pad(x, (left, right, top, bottom))), approximate="tanh")
        f = self.feat(x.mean(dim=(2, 3)))
        pred = self.out(F.gelu(self.hidden(F.gelu(f, approximate="tanh")), approximate="tanh"))
        return f, pred


def state_dict_from_flax(params) -> dict:
    """The JAX tool's feature-net params (a nested dict of arrays) as
    ``BlobFeatureNet``'s state_dict: conv kernels HWIO -> OIHW, dense kernels
    (in, out) -> (out, in), biases as they are."""
    sd = {}
    for i, name in enumerate(FLAX_CONVS):
        sd[f"convs.{i}.weight"] = torch.from_numpy(np.asarray(params[name]["kernel"])).permute(3, 2, 0, 1)
        sd[f"convs.{i}.bias"] = torch.from_numpy(np.asarray(params[name]["bias"]))
    for ours, theirs in FLAX_DENSES.items():
        sd[f"{ours}.weight"] = torch.from_numpy(np.asarray(params[theirs]["kernel"])).T
        sd[f"{ours}.bias"] = torch.from_numpy(np.asarray(params[theirs]["bias"]))
    return {k: v.contiguous().float() for k, v in sd.items()}


def nchw(x: np.ndarray, device) -> torch.Tensor:
    """An NHWC host array as an NCHW float32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device).permute(0, 3, 1, 2)


def regression_loss(net: BlobFeatureNet, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The mean squared error of the regressed blob parameters."""
    return ((net(x)[1] - y) ** 2).mean()


def feature_optimizer(net: BlobFeatureNet, device) -> torch.optim.Optimizer:
    """optax ``adamw(1e-3)``: b1 0.9, b2 0.999, eps 1e-8 outside the root,
    weight decay 1e-4 times the rate."""
    kw = {"fused": True} if torch.device(device).type == "cuda" else {"foreach": True}
    return torch.optim.AdamW(net.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4, **kw)


def train_feature_extractor(size: int, steps: int = 300, batch: int = 64, seed: int = 5, log=None,
                            device="cpu"):
    """Train the latent-regression extractor on fresh blob draws from
    ``RandomState(seed)``, on ``device``. Returns (feats_fn, final_loss):
    ``feats_fn`` maps an (n, size, size, 3) array in [-1, 1] to (n, 32)
    float32 features, in batches of ``batch``."""
    device = torch.device(device)
    net = BlobFeatureNet().to(device)
    opt = feature_optimizer(net, device)
    rs = np.random.RandomState(seed)
    loss = None
    for i in range(steps):
        xb, yb = make_blob_batch(rs, batch, size, return_latents=True)
        opt.zero_grad(set_to_none=True)
        loss = regression_loss(net, nchw(xb, device), torch.from_numpy(yb).to(device))
        loss.backward()
        opt.step()
        loss = loss.detach()
        if log and i % 100 == 0:
            log(f"feature extractor step {i} loss {float(loss):.4f}")
    net.eval()

    def feats_fn(x: np.ndarray) -> np.ndarray:
        outs = []
        with torch.no_grad():
            for i in range(0, len(x), batch):
                outs.append(net(nchw(x[i:i + batch], device))[0].float().cpu().numpy())
        return np.concatenate(outs)

    return feats_fn, float(loss)


def frechet(fx: np.ndarray, fy: np.ndarray) -> float:
    """The unrounded Frechet distance of two feature sets' means and
    covariances (the evaluator's ``FIDStatistics``)."""
    return statistics_from_activations(fx).frechet_distance(statistics_from_activations(fy))


def score_sets(feats_fn, sets: dict) -> dict:
    """Score candidate sets against independent base draws (the JAX tool's
    ``score_sets``). ``sets`` holds ``base_a``, ``base_b`` and ``base_c``
    (disjoint-seed base draws; ``base_a`` may share seeds with candidates,
    which are scored against b and c only) and the candidates, each scored
    as the mean of d(x, base_b) and d(x, base_c). The features are
    standardized by base_b's per-dimension mean and deviation.

    Returns {"floor": {values, mean, max}, candidate: {vs_b, vs_c, mean,
    over_floor_max}}, unrounded.
    """
    feats = {k: feats_fn(v) for k, v in sets.items()}
    mu = feats["base_b"].mean(0)
    sd = feats["base_b"].std(0) + 1e-8
    z = {k: (v - mu) / sd for k, v in feats.items()}
    floor_vals = [frechet(z["base_a"], z["base_b"]), frechet(z["base_a"], z["base_c"]),
                  frechet(z["base_b"], z["base_c"])]
    out = {"floor": {"values": floor_vals, "mean": float(np.mean(floor_vals)), "max": float(np.max(floor_vals))}}
    for k in sets:
        if k in ("base_a", "base_b", "base_c"):
            continue
        vb, vc = frechet(z[k], z["base_b"]), frechet(z[k], z["base_c"])
        out[k] = {"vs_b": vb, "vs_c": vc, "mean": float((vb + vc) / 2),
                  "over_floor_max": float((vb + vc) / 2 / max(out["floor"]["max"], 1e-12))}
    return out
