"""Image quality metrics of the port (the JAX package's ``ops/metrics.py``):
SSIM, PSNR and the per-image MSE, as plain tensor ops on the images' device.

SSIM is ``skimage.metrics.structural_similarity`` with ``win_size=11``,
``data_range=1``, uniform windows, the sample covariance (``NP/(NP-1)``) and
the mean over channels (the reference computes it per image on the host,
``models/vae.py:162-168``); skimage's centred windows with the border cropped
are the VALID windows here. Images are NHWC; each function returns one value
per image, in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _uniform_filter_valid(x: Tensor, win: int) -> Tensor:
    """Mean over every VALID ``win`` x ``win`` window of NHWC ``x``: (B, H',
    W', C) with H' = H - win + 1."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), win, stride=1).permute(0, 2, 3, 1)


def ssim(a: Tensor, b: Tensor, win_size: int = 11, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> Tensor:
    """Per-image SSIM of (B, H, W, C) images: (B,). An image smaller than the
    window has no VALID window, and its SSIM is NaN, the mean over none (as
    the JAX function gives)."""
    a, b = a.float(), b.float()
    if min(a.shape[1], a.shape[2]) < win_size:
        return torch.full((a.shape[0],), float("nan"), device=a.device)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ua = _uniform_filter_valid(a, win_size)
    ub = _uniform_filter_valid(b, win_size)
    uaa = _uniform_filter_valid(a * a, win_size)
    ubb = _uniform_filter_valid(b * b, win_size)
    uab = _uniform_filter_valid(a * b, win_size)
    va = cov_norm * (uaa - ua * ua)
    vb = cov_norm * (ubb - ub * ub)
    vab = cov_norm * (uab - ua * ub)
    s = ((2 * ua * ub + c1) * (2 * vab + c2)) / ((ua * ua + ub * ub + c1) * (va + vb + c2))
    return s.mean(dim=(1, 2, 3))


def batch_mse(a: Tensor, b: Tensor) -> Tensor:
    """Per-image mean squared error: (B,)."""
    return ((a.float() - b.float()) ** 2).mean(dim=(1, 2, 3))


def psnr(a: Tensor, b: Tensor, data_range: float = 1.0) -> Tensor:
    """Per-image PSNR in dB: (B,); an MSE below 1e-12 counts as 1e-12."""
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(batch_mse(a, b), 1e-12))
