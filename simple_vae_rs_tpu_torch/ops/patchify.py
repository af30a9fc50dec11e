"""Grid patchification + normalization on the device (port of the grid mode of
the JAX package's ``ops/patchify.py``).

A tile batch crosses to the card once; the grid split and the per-patch,
per-channel min-max normalization run there as reshapes and reductions.
Grid-patch order is row-major within a tile.
"""

from __future__ import annotations

from typing import Tuple

import torch

from simple_vae_rs_tpu_torch.utils.image import normalize_image

Tensor = torch.Tensor


def grid_patchify(tiles: Tensor, patch: int) -> Tensor:
    """(B, H, W, C) -> (B * (H/p) * (W/p), p, p, C), row-major within a tile;
    a ragged right or bottom edge is dropped."""
    b, h, w, c = tiles.shape
    gh, gw = h // patch, w // patch
    x = tiles[:, : gh * patch, : gw * patch, :]
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * gh * gw, patch, patch, c)


def grid_unpatchify(patches: Tensor, grid: int) -> Tensor:
    """Inverse of :func:`grid_patchify` for square grids."""
    n, p, _, c = patches.shape
    b = n // (grid * grid)
    x = patches.reshape(b, grid, grid, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid * p, grid * p, c)


def grid_sr_batch(lr_tiles: Tensor, hr_tiles: Tensor, patch: int) -> Tuple[Tensor, Tensor]:
    """Tile pair batch -> normalized (LR p/2, HR p) patch pairs, on the
    tiles' device. LR patch i covers the ground of HR patch i (2x SR);
    normalization is per patch and channel, after the crop."""
    lr = grid_patchify(torch.as_tensor(lr_tiles).float(), patch // 2)
    hr = grid_patchify(torch.as_tensor(hr_tiles).float(), patch)
    return normalize_image(lr).contiguous(), normalize_image(hr).contiguous()
