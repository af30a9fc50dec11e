"""Bicubic 2x upsampling, the reference's super-resolution baseline (port of
the JAX package's ``ops/resize.py``).

The reference computes ``F.interpolate(y, scale_factor=2, mode="bicubic")``
(``models/cond_vae.py:451,555``): cubic convolution with a = -0.75,
``align_corners=False`` and replicated borders. At an exact 2x scale that is
a fixed separable filter of four taps in two phases, applied here as
weighted shifted slices of the edge-padded input, in float32.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# Output pixel 2j samples the input at j - 0.25 (taps on rows j-2..j+1), pixel
# 2j+1 at j + 0.25 (rows j-1..j+2).
_W_EVEN = (-0.03515625, 0.26171875, 0.87890625, -0.10546875)
_W_ODD = (-0.10546875, 0.87890625, 0.26171875, -0.03515625)


def _upsample_axis(x: Tensor, axis: int) -> Tensor:
    n = x.shape[axis]
    xp = torch.cat([x.narrow(axis, 0, 1)] * 2 + [x] + [x.narrow(axis, n - 1, 1)] * 2, dim=axis)
    even = sum(w * xp.narrow(axis, k, n) for k, w in enumerate(_W_EVEN))
    odd = sum(w * xp.narrow(axis, 1 + k, n) for k, w in enumerate(_W_ODD))
    shape = list(x.shape)
    shape[axis] = 2 * n
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def bicubic_upsample_2x(x: Tensor) -> Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C) float32, torch-bicubic semantics."""
    return _upsample_axis(_upsample_axis(x.float(), 1), 2)
