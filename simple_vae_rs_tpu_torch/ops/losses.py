"""Gaussian ELBO terms for the VAE family (port of the JAX package's
``ops/losses.py``).

The reference formulas term by term, with the ``d = B*C*H*W`` scaling of
the Gaussian negative log-likelihood and the learned scalar decoder std
``gamma``. All math is float32. This module is the plain reference of the
fused row reductions in :mod:`simple_vae_rs_tpu_torch.ops.fused_elbo`.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _f32(*ts: Tensor):
    return tuple(t.float() for t in ts)


def gaussian_nll(recon: Tensor, target: Tensor, gamma: Tensor) -> Tensor:
    """``d * (MSE_mean / (2*gamma^2) + log(gamma))`` with d = total elements."""
    recon, target, gamma = _f32(recon, target, gamma)
    d = recon.numel()
    mse_mean = torch.mean((recon - target) ** 2)
    return d * (mse_mean / (2.0 * gamma**2) + torch.log(gamma))


def kl_standard_normal(mu: Tensor, logvar: Tensor) -> Tensor:
    """KL(q || N(0, I)): ``0.5 * mean_b sum_d(mu^2 + e^lv - 1 - lv)``."""
    mu, logvar = _f32(mu, logvar)
    kl = 0.5 * torch.sum(mu**2 + torch.exp(logvar) - 1.0 - logvar, dim=1)
    return torch.mean(kl)


def kl_gaussian_gaussian(mu_q: Tensor, logvar_q: Tensor, mu_p: Tensor,
                         logvar_p: Tensor) -> Tensor:
    """KL(q || p) between diagonal Gaussians:
    ``0.5 * mean_b [sum(lv_p - lv_q - 1) + sum(e^(lv_q - lv_p))
    + sum((mu_q - mu_p)^2 e^(-lv_p))]``."""
    mu_q, logvar_q, mu_p, logvar_p = _f32(mu_q, logvar_q, mu_p, logvar_p)
    term = (
        torch.sum(logvar_p - logvar_q - 1.0, dim=1)
        + torch.sum(torch.exp(logvar_q - logvar_p), dim=1)
        + torch.sum((mu_q - mu_p) ** 2 * torch.exp(-logvar_p), dim=1)
    )
    return 0.5 * torch.mean(term)


def base_loss(recon_x: Tensor, x: Tensor, mu: Tensor, logvar: Tensor,
              gamma: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain-VAE loss terms ``(mse, kld)``."""
    return gaussian_nll(recon_x, x, gamma), kl_standard_normal(mu, logvar)


def cond_loss(recon_x: Tensor, x: Tensor, recon_y: Tensor, y: Tensor,
              mu_u: Tensor, logvar_u: Tensor, mu_z: Tensor, logvar_z: Tensor,
              mu_z_uy: Tensor, logvar_z_uy: Tensor, gammax: Tensor,
              gammay: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Cond_SRVAE loss terms ``(mse_x, kld_u, mse_y, kld_z)``."""
    mse_x = gaussian_nll(recon_x, x, gammax)
    mse_y = gaussian_nll(recon_y, y, gammay)
    kld_u = kl_standard_normal(mu_u, logvar_u)
    kld_z = kl_gaussian_gaussian(mu_z, logvar_z, mu_z_uy, logvar_z_uy)
    return mse_x, kld_u, mse_y, kld_z
