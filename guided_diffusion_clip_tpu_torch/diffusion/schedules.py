"""Beta schedules and per-timestep coefficient tables.

Counterpart of ``guided_diffusion_clip_tpu/diffusion/schedules.py``. Tables
are computed host-side in np.float64 exactly as the reference does
(guided_diffusion/gaussian_diffusion.py:18-62, :133-169), then frozen into a
``DiffusionSchedule`` of f32 torch tensors, so every sampling step is a
gather plus elementwise math on the device.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Sequence

import numpy as np
import torch


class ModelMeanType(enum.Enum):
    """What the model's mean head predicts (reference gaussian_diffusion.py:65-72)."""

    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType(enum.Enum):
    """Variance parameterization (reference gaussian_diffusion.py:75-86)."""

    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class LossType(enum.Enum):
    """Training loss (reference gaussian_diffusion.py:89-98)."""

    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"

    @property
    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Build betas that realize a given cumulative alpha_bar(t) curve.

    Mirrors reference gaussian_diffusion.py:45-62 (Nichol & Dhariwal IDDPM).
    """
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Named beta schedule in float64 (reference gaussian_diffusion.py:18-42).

    "linear": Ho et al. DDPM schedule, rescaled so that any T behaves like the
    original T=1000 ("scaled linear").
    "cosine": Nichol & Dhariwal squared-cosine alpha_bar.
    """
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        beta_start = scale * 0.0001
        beta_end = scale * 0.02
        return np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)
    elif schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    else:
        raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep coefficient tables, each a length-T tensor.

    The reference computes these in f64 (gaussian_diffusion.py:133-169); they
    are computed the same way on the host and stored as f32 tensors for the
    device. ``timestep_map`` carries respacing: model-facing timesteps are
    ``timestep_map[t]`` (reference respace.py:123-127).
    """

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    # log of the FIXED_LARGE variance table: log(append(posterior_var[1], betas[1:]))
    log_fixed_large_variance: torch.Tensor
    # maps local timestep -> original-model timestep (respace.py:123-127)
    timestep_map: torch.Tensor
    # original (pre-respacing) T, for the x1000/T timestep rescale
    original_num_steps: int
    rescale_timesteps: bool

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        """The same tables on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    def model_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """Timesteps as seen by the model: respace map + optional rescale."""
        mapped = self.timestep_map[t]
        if self.rescale_timesteps:
            return mapped.float() * (1000.0 / self.original_num_steps)
        return mapped

    def scale_loss_timestep_factor(self) -> float:
        """The T/1000 factor for RESCALED_MSE vb terms (gaussian_diffusion.py:808)."""
        return self.num_timesteps / 1000.0


def _tables_from_betas(betas: np.ndarray) -> dict:
    """Compute the 13 coefficient tables in float64 (gaussian_diffusion.py:133-169)."""
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1, "betas must be 1-D"
    assert (betas > 0).all() and (betas <= 1).all()

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # Clipped because posterior_variance[0] == 0 at the start of the chain.
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )
    fixed_large_variance = np.append(posterior_variance[1], betas[1:])

    return dict(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        alphas_cumprod_next=alphas_cumprod_next,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1.0),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=posterior_log_variance_clipped,
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
        log_fixed_large_variance=np.log(fixed_large_variance),
    )


def schedule_from_betas(
    betas: np.ndarray,
    *,
    timestep_map: np.ndarray | None = None,
    original_num_steps: int | None = None,
    rescale_timesteps: bool = False,
    dtype=torch.float32,
) -> DiffusionSchedule:
    """Freeze f64 host tables into a ``DiffusionSchedule`` (CPU tensors; ``.to(device)``)."""
    tables = _tables_from_betas(betas)
    T = len(betas)
    if timestep_map is None:
        timestep_map = np.arange(T, dtype=np.int32)
    if original_num_steps is None:
        original_num_steps = T
    return DiffusionSchedule(
        **{k: torch.as_tensor(v).to(dtype) for k, v in tables.items()},
        timestep_map=torch.as_tensor(np.asarray(timestep_map, dtype=np.int64)),
        original_num_steps=int(original_num_steps),
        rescale_timesteps=bool(rescale_timesteps),
    )


def named_schedule(name: str, num_timesteps: int, **kw) -> DiffusionSchedule:
    return schedule_from_betas(get_named_beta_schedule(name, num_timesteps), **kw)


# ---------------------------------------------------------------------------
# Timestep respacing (reference respace.py)
# ---------------------------------------------------------------------------


def _exact_stride_subset(total: int, want: int) -> set:
    """The "ddimN" schedule: the unique integer stride hitting exactly N steps."""
    for stride in range(1, total):
        if len(range(0, total, stride)) == want:
            return set(range(0, total, stride))
    raise ValueError(f"cannot create exactly {want} steps with an integer stride")


def _spread_within(length: int, count: int):
    """`count` indices spread evenly over [0, length): accumulate the
    fractional stride and round each position.

    NB: accumulation (not multiplication) matters bit-for-bit — round() at
    exact .5 boundaries must see the same float the reference produced
    (respace.py:39-57 behavior contract, pinned by golden tests).
    """
    if length < count:
        raise ValueError(f"cannot divide section of {length} steps into {count}")
    stride = 1 if count <= 1 else (length - 1) / (count - 1)
    pos = 0.0
    out = []
    for _ in range(count):
        out.append(round(pos))
        pos += stride
    return out


def lambda_uniform_subset(base_betas: np.ndarray, want: int) -> set:
    """Pick `want` original timesteps whose log-SNR (lambda = log(alpha/
    sigma)) values are as uniform as possible — the natural grid for
    exponential-integrator samplers (DPM-Solver++). Beyond-reference
    capability: the reference only spaces by INDEX (respace.py:7-60), which
    concentrates lambda steps badly on cosine schedules at low step counts.

    Three phases, always returning EXACTLY `want` unique indices with both
    endpoints: (1) greedy monotone nearest-index assignment — targets ascend
    from lambda[T-1] to lambda[0], each picking the nearest index strictly
    below the previous pick (this placement measures best: colliding targets
    get pushed onto adjacent discrete steps instead of dropped); (2) if the
    greedy pass exhausted indices early (dense targets near the clean end),
    farthest-point fill adds the unchosen index with the greatest lambda
    distance to its nearest chosen neighbor until the count is exact;
    (3) if forcing the endpoints overshot by one, drop the interior pick
    whose removal least disturbs lambda uniformity.
    """
    tables = _tables_from_betas(np.asarray(base_betas, dtype=np.float64))
    ab = tables["alphas_cumprod"]
    lam = 0.5 * (np.log(ab) - np.log1p(-ab))  # decreasing in t
    n = len(lam)
    if want < 2 or want > n:
        raise ValueError(f"lambda grid needs 2 <= N <= {n}, got {want}")
    targets = np.linspace(lam[-1], lam[0], want)
    chosen: set = set()
    prev = n  # exclusive upper bound; greedy picks descend in t
    for tgt in targets:
        if prev == 0:
            break
        i = int(np.argmin(np.abs(lam[:prev] - tgt)))
        chosen.add(i)
        prev = i
    chosen.update((0, n - 1))
    if len(chosen) < want:  # farthest-point fill into the largest gaps
        chosen_lam = np.array(sorted(lam[i] for i in chosen))
        dist = np.abs(lam[:, None] - chosen_lam[None, :]).min(axis=1)
        dist[list(chosen)] = -np.inf
        while len(chosen) < want:
            i = int(np.argmax(dist))
            chosen.add(i)
            dist = np.minimum(dist, np.abs(lam - lam[i]))
            dist[i] = -np.inf
    while len(chosen) > want:  # endpoint forcing overshot
        srt = sorted(chosen, key=lambda i: float(lam[i]))
        k, _ = min(
            ((srt[j], lam[srt[j + 1]] - lam[srt[j - 1]]) for j in range(1, len(srt) - 1)),
            key=lambda p: p[1],
        )
        chosen.remove(k)
    return chosen


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Pick a subset of original timesteps (reference respace.py:7-60).

    `section_counts` is either a list of per-section counts, or a string:
    comma-separated ints, or "ddimN" for an exact-stride DDIM schedule. The
    chain is split into len(counts) near-equal sections (earlier sections get
    the remainder) and each contributes its own evenly-spread picks.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            return _exact_stride_subset(num_timesteps, int(section_counts[4:]))
        section_counts = [int(x) for x in section_counts.split(",")]
    n_sections = len(section_counts)
    base_len, remainder = divmod(num_timesteps, n_sections)
    chosen: set = set()
    offset = 0
    for i, count in enumerate(section_counts):
        length = base_len + (1 if i < remainder else 0)
        chosen.update(offset + p for p in _spread_within(length, count))
        offset += length
    return chosen


def respaced_schedule(
    base_betas: np.ndarray,
    use_timesteps: Sequence[int] | set,
    *,
    rescale_timesteps: bool = False,
    dtype=torch.float32,
) -> DiffusionSchedule:
    """Re-derive betas over a timestep subset (reference respace.py:63-91).

    new_beta_i = 1 - alpha_bar[t_i] / alpha_bar[t_{i-1}], so that the respaced
    chain has the same marginal alpha_bar at the kept timesteps.
    """
    base_tables = _tables_from_betas(np.asarray(base_betas, dtype=np.float64))
    alphas_cumprod = base_tables["alphas_cumprod"]
    use = sorted(set(int(t) for t in use_timesteps))
    last_alpha_cumprod = 1.0
    new_betas = []
    for t in use:
        new_betas.append(1 - alphas_cumprod[t] / last_alpha_cumprod)
        last_alpha_cumprod = alphas_cumprod[t]
    return schedule_from_betas(
        np.array(new_betas, dtype=np.float64),
        timestep_map=np.array(use, dtype=np.int32),
        original_num_steps=len(base_betas),
        rescale_timesteps=rescale_timesteps,
        dtype=dtype,
    )


def build_schedule(
    *,
    steps: int = 1000,
    noise_schedule: str = "linear",
    timestep_respacing: str | Sequence[int] = "",
    rescale_timesteps: bool = False,
    dtype=torch.float32,
) -> DiffusionSchedule:
    """The factory used by script_util parity (reference script_util.py:392-430).

    Always goes through the respacing path like the reference (which always
    wraps in SpacedDiffusion, script_util.py:413); an empty respacing string
    means "all timesteps".
    """
    betas = get_named_beta_schedule(noise_schedule, steps)
    if not timestep_respacing:
        timestep_respacing = [steps]
    if isinstance(timestep_respacing, str) and timestep_respacing.startswith("lambda"):
        # "lambdaN": log-SNR-uniform grid (needs the schedule itself, so it
        # is resolved here rather than in index-only space_timesteps)
        use = lambda_uniform_subset(betas, int(timestep_respacing[6:]))
    else:
        use = space_timesteps(steps, timestep_respacing)
    return respaced_schedule(
        betas, use, rescale_timesteps=rescale_timesteps, dtype=dtype
    )
