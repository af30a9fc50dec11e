"""Space/depth regroupings between latent-grid factorizations, NHWC.

Channel order is the JAX package's ``(i, j, c)`` with ``c`` fastest, which is
not ``F.pixel_shuffle``'s ``c * r * r + i * r + j``; the ``cmajor_*`` pair is
the reference's C-major Flatten/Unflatten reinterpretation.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def space_to_depth(x: Tensor, block: int = 2) -> Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, C*b*b)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


def depth_to_space(x: Tensor, block: int = 2) -> Tensor:
    """(B, H, W, C) -> (B, H*b, W*b, C/(b*b)); inverse of :func:`space_to_depth`."""
    b, h, w, c = x.shape
    c_out = c // (block * block)
    x = x.reshape(b, h, w, block, block, c_out)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * block, w * block, c_out)


def cmajor_regroup_down(x: Tensor, block: int = 2) -> Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, C*b*b) as the NCHW reshape
    ``(B, C, H, W) -> (B, C*b*b, H/b, W/b)``."""
    b, h, w, c = x.shape
    x = x.permute(0, 3, 1, 2).reshape(b, c * block * block, h // block, w // block)
    return x.permute(0, 2, 3, 1).contiguous()


def cmajor_regroup_up(x: Tensor, block: int = 2) -> Tensor:
    """(B, H, W, C) -> (B, H*b, W*b, C/(b*b)); inverse of :func:`cmajor_regroup_down`."""
    b, h, w, c = x.shape
    x = x.permute(0, 3, 1, 2).reshape(b, c // (block * block), h * block, w * block)
    return x.permute(0, 2, 3, 1).contiguous()


def flatten_map(x: Tensor) -> Tensor:
    """(B, H, W, C) -> (B, H*W*C), the canonical latent order."""
    return x.reshape(x.shape[0], -1)


def unflatten_map(v: Tensor, h: int, w: int, c: int) -> Tensor:
    """(B, H*W*C) -> (B, H, W, C); inverse of :func:`flatten_map`."""
    return v.reshape(v.shape[0], h, w, c)
