"""What the quality tools share: the trained proxies and their blob data.

The JAX tools (``tools/int8_chain_quality.py``, ``tools/guidance_quality_sweep.py``,
``tools/opt_long_horizon.py``) each inline this; here it is one module:

  - the proxy UNets at 16, >= 64 and >= 128 px (``int8_chain_quality.py:127-152``)
    and the noised classifier of the guided studies
    (``int8_chain_quality.py:236-241``, ``guidance_quality_sweep.py:178-185``),
    on the port's ``UNetConfig``;
  - the blob stream the generator trains on: ``RandomState(0)``, batch by
    batch, the labels (``blob_labels``: the dominant color) and the 16-d
    conditioning rows (``feats_for``: ``RandomState(7)``) taken from the
    NHWC arrays before the transpose to NCHW;
  - ``train_generator``: the port's ``TrainLoop`` (AdamW 2e-3, EMA 0.99),
    ``run_step`` called on each ``next(data)`` as the JAX tools call it. The
    JAX loop's constructor takes one batch from the stream to initialize the
    parameters; the port's takes none, so ``train_generator`` draws that
    batch and drops it: both frameworks then train on the same images, and
    the classifier after them draws the same ones too. The positive
    control's snapshot of the EMA is a clone (the port updates the EMA in
    place; a reference would follow it to the end);
  - the noised classifier's trainer: ``q_sample`` at a uniform t, the
    cross-entropy of the label, ``AdamW(3e-4, weight_decay=0.05)`` as optax
    ``adamw(3e-4, weight_decay=0.05)``; t and the noise from a generator
    seeded 3 on the device (the JAX tools' ``jax.random.key(3)`` cannot be
    drawn here), or handed in;
  - the sampling copies: the EMA's weights in a model whose torso runs in
    bf16 on the card and in float32 on the CPU (the JAX tools'
    ``sample_dtype``), with the conv path asked for (``xla``: cuDNN; ``int8``:
    K4, K5 and the quantize kernels).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..models.clip_models import UNetModel_clip_feat
from ..models.unet import EncoderUNetModel, UNetConfig, UNetModel
from ..training.train_loop import TrainLoop
from .fidelity import make_blob_batch

N_CLASSES = 3
# the fixed random projection of a blob's dominant-color label to a 16-d conditioning row (the cfgc
# study's clip_feat stand-in)
FEAT_ROWS = np.random.RandomState(7).randn(3, 16).astype(np.float32)


def generator_config(size: int, clip_feat: bool = False) -> UNetConfig:
    """The generator proxy: at >= 128 px the headline-class topology
    (attention at ds 4, 8, 16), at >= 64 px the 64 px ADM topology at half
    width, below a 2-level UNet; with ``clip_feat`` a 16-d conditioning row
    (``num_classes`` 16, the cfgc study's)."""
    if size >= 64:
        cfg = UNetConfig(image_size=size, in_channels=3, model_channels=128, out_channels=3, num_res_blocks=2,
                         attention_resolutions=(4, 8, 16) if size >= 128 else (4, 8), channel_mult=(1, 2, 3, 4),
                         num_heads=4, use_scale_shift_norm=True, resblock_updown=True)
    else:
        cfg = UNetConfig(image_size=size, in_channels=3, model_channels=64, out_channels=3, num_res_blocks=1,
                         attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2, use_scale_shift_norm=True)
    return dataclasses.replace(cfg, num_classes=16) if clip_feat else cfg


def classifier_config(size: int) -> UNetConfig:
    """The noised classifier of the guided studies (3 classes)."""
    big = size >= 64
    return UNetConfig(image_size=size, in_channels=3, model_channels=64 if big else 32, out_channels=N_CLASSES,
                      num_res_blocks=1, attention_resolutions=(4,) if big else (2,),
                      channel_mult=(1, 2, 3) if big else (1, 2), num_heads=2, use_scale_shift_norm=True)


def build_generator(cfg: UNetConfig, dtype=torch.float32, conv_impl: str = "auto", device="cpu") -> UNetModel:
    """The generator of ``cfg`` (a ``clip_feat`` UNet when it has
    ``num_classes``), its torso in ``dtype``."""
    if cfg.num_classes is not None:
        return UNetModel_clip_feat(cfg, dtype=dtype, conv_impl=conv_impl).to(device)
    return UNetModel(cfg, dtype=dtype, conv_impl=conv_impl).to(device)


def build_classifier(size: int, conv_impl: str = "auto", device="cpu") -> EncoderUNetModel:
    """The noised classifier, float32 as the JAX tools' (adaptive pool)."""
    return EncoderUNetModel(classifier_config(size), pool="adaptive", conv_impl=conv_impl).to(device)


def sample_dtype(device) -> torch.dtype:
    """The sampling torso's dtype: bf16 on the card, float32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def blob_labels(batch: np.ndarray) -> np.ndarray:
    """The dominant-color label of each NHWC image: the argmax of its
    channel means."""
    return batch.mean(axis=(1, 2)).argmax(axis=-1).astype(np.int32)


def feats_for(batch: np.ndarray) -> np.ndarray:
    """The 16-d conditioning row of each NHWC image's label."""
    return FEAT_ROWS[blob_labels(batch)]


def to_nchw(batch: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(batch.transpose(0, 3, 1, 2))


def blob_stream(rs: np.random.RandomState, batch: int, size: int, clip_feat: bool = False):
    """Batches of ``make_blob_batch(rs, batch, size)`` as (NCHW array,
    cond): cond holds the images' ``feats_for`` rows as ``clip_feat`` when
    asked for, computed before the transpose."""
    while True:
        x = make_blob_batch(rs, batch, size)
        yield to_nchw(x), ({"clip_feat": feats_for(x)} if clip_feat else {})


def class_matched_real_set(seed: int, n: int, size: int) -> np.ndarray:
    """n real blobs whose labels cycle 0, 1, 2, ... (the class balance the
    guided sets target), NHWC: rejection-sampled from ``RandomState(seed)``
    (``tools/guidance_quality_sweep.py``'s)."""
    rs = np.random.RandomState(seed)
    want = np.arange(n) % N_CLASSES
    out = np.empty((n, size, size, 3), np.float32)
    have = np.zeros(n, bool)
    while not have.all():
        cand = make_blob_batch(rs, 4 * n, size)
        for img, lb in zip(cand, blob_labels(cand)):
            idx = np.where((~have) & (want == lb))[0]
            if len(idx):
                out[idx[0]] = img
                have[idx[0]] = True
    return out


def train_generator(model, diffusion, data, batch: int, steps: int, *, cond_dropout: float = 0.0,
                    snapshot_at: int = 0, losses: bool = False, note=None, **loop_kw) -> tuple:
    """Train ``model`` (float32) ``steps`` steps on ``data`` (a
    ``blob_stream``) through the port's ``TrainLoop`` with the JAX tools'
    settings (``loop_kw`` on top), after dropping the batch the JAX loop's
    constructor takes. Returns (the loop, a clone of the EMA after
    ``snapshot_at`` steps or None, the loss of each step as
    ``flush_metrics`` fetches it, or with ``losses`` False an empty list:
    reading it waits for each step)."""
    next(data)  # the batch the JAX TrainLoop draws at construction to initialize its parameters
    loop = TrainLoop(model=model, diffusion=diffusion, data=data, batch_size=batch, microbatch=-1, lr=2e-3,
                     ema_rate="0.99", log_interval=10**9, save_interval=10**9, seed=0, cond_dropout=cond_dropout,
                     **loop_kw)
    snapshot, curve = None, []
    for i in range(steps):
        b, c = next(loop.data)
        loop.run_step(b, c)
        loop.step += 1
        if losses:
            curve.append(float(loop.flush_metrics()["loss"]))
        if i + 1 == snapshot_at:
            snapshot = [e.clone() for e in loop.ema_params[0]]
        if note and i % 50 == 0:
            note(f"generator step {i}")
    loop.flush_metrics()
    return loop, snapshot, curve


def sample_set(chain, n_samples: int, batch: int, seed0: int) -> np.ndarray:
    """``n_samples`` samples of ``chain`` (a ``_chains`` runner), NHWC
    float32: batch i drawn from the seed ``seed0 + i``."""
    outs = [chain(seed=seed0 + i).permute(0, 2, 3, 1).float().cpu().numpy() for i in range(-(-n_samples // batch))]
    return np.concatenate(outs)[:n_samples]


def ema_values(loop: TrainLoop, i: int = 0) -> dict:
    """The i-th EMA's full values by parameter name."""
    return dict(zip(loop.names, loop._full(loop.ema_params[i])))


def sampling_copy(cfg: UNetConfig, values: dict, device, conv_impl: str = "auto") -> UNetModel:
    """A frozen eval-mode copy of the generator with ``values`` (parameter
    name -> tensor), its torso in ``sample_dtype(device)`` and its convs on
    ``conv_impl``."""
    model = build_generator(cfg, sample_dtype(device), conv_impl, device)
    model.load_state_dict(values, strict=True)
    return model.eval().requires_grad_(False)


def classifier_copy(clf: EncoderUNetModel, conv_impl: str) -> EncoderUNetModel:
    """A frozen eval-mode copy of the trained classifier on ``conv_impl``."""
    dev = next(clf.parameters()).device
    out = build_classifier(clf.config.image_size, conv_impl, dev)
    out.load_state_dict(clf.state_dict(), strict=True)
    return out.eval().requires_grad_(False)


def classifier_optimizer(clf: EncoderUNetModel) -> torch.optim.Optimizer:
    """optax ``adamw(3e-4, weight_decay=0.05)``."""
    dev = next(clf.parameters()).device
    kw = {"fused": True} if dev.type == "cuda" else {"foreach": True}
    return torch.optim.AdamW(clf.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.05, **kw)


def classifier_step(clf, opt, diffusion, x, y, t, noise) -> torch.Tensor:
    """One update of the noised classifier on NCHW ``x`` with labels ``y``
    at timesteps ``t`` with ``noise``: the mean cross-entropy of the
    labels at ``q_sample(x, t, noise)``. Returns the loss."""
    xt = diffusion.q_sample(x, t, noise)
    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(clf(xt, t.float()).float(), y.long())
    loss.backward()
    opt.step()
    return loss.detach()


def train_classifier(clf, diffusion, rs: np.random.RandomState, batch: int, steps: int, note=None) -> float:
    """Train the noised classifier ``steps`` steps on fresh blob draws from
    ``rs`` (the stream the generator trained on, continued), t uniform over
    the schedule; returns the last loss."""
    dev = next(clf.parameters()).device
    size = clf.config.image_size
    clf.train()
    opt = classifier_optimizer(clf)
    g = torch.Generator(device=dev).manual_seed(3)
    loss = None
    for i in range(steps):
        xb = make_blob_batch(rs, batch, size)
        y = torch.from_numpy(blob_labels(xb)).to(dev)
        x = torch.from_numpy(to_nchw(xb)).to(dev)
        t = torch.randint(0, diffusion.num_timesteps, (batch,), generator=g, device=dev)
        noise = torch.randn(x.shape, generator=g, device=dev)
        loss = classifier_step(clf, opt, diffusion, x, y, t, noise)
        if note and i % 50 == 0:
            note(f"classifier step {i} loss {float(loss):.3f}")
    clf.eval().requires_grad_(False)
    return float(loss)
