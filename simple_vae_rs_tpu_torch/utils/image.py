"""Image normalization (reference ``utils.py:4-23``), NHWC."""

from __future__ import annotations

import torch


def normalize_image(image: torch.Tensor) -> torch.Tensor:
    """Min-max normalize per channel over the spatial dims, with the
    reference's ``+1e-5`` denominator guard. Accepts (H, W, C) or
    (B, H, W, C); 4-D inputs are normalized per image."""
    if image.dim() == 3:
        spatial = (0, 1)
    elif image.dim() == 4:
        spatial = (1, 2)
    else:
        raise ValueError("Input image must be a 3-D or 4-D array.")
    min_val = torch.amin(image, dim=spatial, keepdim=True)
    max_val = torch.amax(image, dim=spatial, keepdim=True)
    return (image - min_val) / (max_val - min_val + 1e-5)
