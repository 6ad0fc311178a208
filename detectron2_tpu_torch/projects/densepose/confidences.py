"""UV confidence losses (counterpart of
``detectron2_tpu/projects/densepose/confidences.py``; Neverova et al.,
"Correlated Uncertainty for Learning Dense Correspondences from Noisy
Labels", NeurIPS 2019): elementwise negative log likelihoods with per-point
validity weights, their weighted mean over the valid points."""

import math

import torch
import torch.nn.functional as F

__all__ = ["iid_isotropic_gaussian_uv_loss", "indep_anisotropic_gaussian_uv_loss"]

_LOG2PI = math.log(2.0 * math.pi)


def _weighted_mean(loss: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return (loss * weights).sum() / weights.sum().clamp_min(1.0)


def iid_isotropic_gaussian_uv_loss(u, v, sigma_u, target_u, target_v, weights, sigma_lower_bound: float = 0.01):
    """iid residuals with isotropic covariance sigma^2 I:
    1/2 (log 2pi + 2 log sigma^2 + ||delta||^2 / sigma^2)."""
    sigma2 = F.softplus(sigma_u) + sigma_lower_bound
    delta2 = (u - target_u) ** 2 + (v - target_v) ** 2
    return _weighted_mean(0.5 * (_LOG2PI + 2.0 * torch.log(sigma2) + delta2 / sigma2), weights)


def indep_anisotropic_gaussian_uv_loss(
    u, v, sigma_u, kappa_u, kappa_v, target_u, target_v, weights, sigma_lower_bound: float = 0.01
):
    """Independent residuals with anisotropic covariance sigma^2 I + r r^T:
    1/2 (log 2pi + log(sigma^2 (sigma^2 + ||r||^2)) + ||delta||^2 / sigma^2
    - <delta, r>^2 / (sigma^2 (sigma^2 + ||r||^2)))."""
    sigma2 = F.softplus(sigma_u) + sigma_lower_bound
    r2 = kappa_u**2 + kappa_v**2
    du = u - target_u
    dv = v - target_v
    delta2 = du**2 + dv**2
    dr = du * kappa_u + dv * kappa_v
    denom2 = sigma2 * (sigma2 + r2)
    return _weighted_mean(0.5 * (_LOG2PI + torch.log(denom2) + delta2 / sigma2 - dr**2 / denom2), weights)
