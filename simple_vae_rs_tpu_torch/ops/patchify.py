"""Patchification + normalization on the device (port of the JAX package's
``ops/patchify.py``).

A tile batch crosses to the card once; the grid split or the aligned random
crops, and the per-patch, per-channel min-max normalization run there as
reshapes, gathers and reductions. Integer tiles are cast to float32 on the
device before the crop. Grid-patch order is row-major within a tile.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def crop_offsets(batch: int, lr_hw: Tuple[int, int], patch: int,
                 generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
    """The random crops' (top, left) in LR pixels for ``batch`` tiles of LR
    spatial ``lr_hw``: int64 CPU tensors drawn from ``generator``, each in
    ``[0, extent - patch // 2)`` as the JAX draws are."""
    p2 = patch // 2
    top = torch.randint(0, max(lr_hw[0] - p2, 1), (batch,), generator=generator)
    left = torch.randint(0, max(lr_hw[1] - p2, 1), (batch,), generator=generator)
    return top, left


def _crop(tiles: Tensor, top: Tensor, left: Tensor, size: int) -> Tensor:
    """(B, size, size, C) windows of (B, H, W, C) ``tiles`` at per-tile
    offsets, clamped so that each window fits (``lax.dynamic_slice``)."""
    b, h, w, _ = tiles.shape
    dev = tiles.device
    top = top.to(dev).clamp(0, h - size)
    left = left.to(dev).clamp(0, w - size)
    span = torch.arange(size, device=dev)
    rows = (top[:, None] + span)[:, :, None]
    cols = (left[:, None] + span)[:, None, :]
    return tiles[torch.arange(b, device=dev)[:, None, None], rows, cols]


def random_sr_crop_batch(lr_tiles: Tensor, hr_tiles: Tensor, patch: int,
                         generator: Optional[torch.Generator] = None,
                         offsets: Optional[Tuple[Tensor, Tensor]] = None
                         ) -> Tuple[Tensor, Tensor]:
    """Random mode: one aligned (LR p/2, HR p) crop per tile pair, normalized,
    on the tiles' device (reference ``sr_randomcrop``, ``dataset.py:193-218``).
    top and left are LR coordinates, drawn by :func:`crop_offsets` from
    ``generator`` unless ``offsets`` gives them; the HR crop sits at exactly
    twice them. Normalization comes after the crop, per patch and channel."""
    lr = torch.as_tensor(lr_tiles).float()
    hr = torch.as_tensor(hr_tiles).float()
    if offsets is None:
        offsets = crop_offsets(lr.shape[0], lr.shape[1:3], patch, generator)
    top, left = (torch.as_tensor(o, dtype=torch.int64) for o in offsets)
    lr = _crop(lr, top, left, patch // 2)
    hr = _crop(hr, 2 * top, 2 * left, patch)
    return normalize_image(lr).contiguous(), normalize_image(hr).contiguous()


def grid_single_batch(tiles: Tensor, patch: int) -> Tensor:
    """Single-resolution grid patchify + normalize (the plain VAE's path)."""
    return normalize_image(grid_patchify(torch.as_tensor(tiles).float(), patch)).contiguous()
