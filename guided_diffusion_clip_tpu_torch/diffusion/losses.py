"""Gaussian KL and the discretized decoder likelihood, on tensors.

Counterpart of ``guided_diffusion_clip_tpu/diffusion/losses.py`` (reference
guided_diffusion/losses.py: normal_kl :12, approx_standard_normal_cdf :42,
discretized_gaussian_log_likelihood :50). Elementwise, so the layout does not
matter; ``mean_flat`` averages every axis but the first, in NCHW as in NHWC.
"""

from __future__ import annotations

import math

import torch


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, exp(logvar1)) || N(mean2, exp(logvar2))) in nats, elementwise.

    Any argument may be a Python number; at least one is a tensor.
    """
    tensor = next(a for a in (mean1, logvar1, mean2, logvar2) if isinstance(a, torch.Tensor))
    logvar1, logvar2 = (torch.as_tensor(v, dtype=tensor.dtype, device=tensor.device) for v in (logvar1, logvar2))
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    """Fast tanh approximation of the standard normal CDF (Page, 1977)."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of x in [-1, 1] under a Gaussian discretized to 1/255 bins:
    the CDF difference over the +-1/255 bin, open bins at the extremes, and a
    1e-12 floor before the log (reference losses.py:50-77)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(
        x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta)
    )


def mean_flat(x):
    """Mean over all non-batch dims (reference nn.py:86-90)."""
    return x.mean(dim=tuple(range(1, x.dim())))
