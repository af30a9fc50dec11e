"""Cond_SRVAE (``models/cond_vae.py``): HR patches ``patch_size``, LR
patches half of it, 2x super-resolution; the program's ``CondSRVAE``."""

from __future__ import annotations

from port_bench.reference import models
from port_bench.reference.train import grid_patches, normalize

CONFIG_KEYS = frozenset({"patch_size", "lr_patch_size", "cr", "channels", "latent_size",
                         "latent_size_y"})
TERMS = ("loss", "mse_x", "kld_u", "mse_y", "kld_z")


def port_model(cfg: dict, dtype, device):
    from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig

    return CondSRVAE(CondSRVAEConfig(cr=float(cfg["cr"]), patch_size=int(cfg["patch_size"])),
                     device=device, dtype=dtype)


def lr_patch(cfg: dict) -> int:
    return int(cfg["patch_size"]) // 2


def program_batch(cfg: dict, lr_tiles, hr_tiles):
    from simple_vae_rs_tpu_torch.ops.patchify import grid_sr_batch

    return grid_sr_batch(lr_tiles, hr_tiles, int(cfg["patch_size"]))


def param_spec(cfg: dict):
    return models.param_spec(cfg)


def trainable(cfg: dict):
    return models.trainable(cfg)


def streams(cfg: dict, lr_tiles, hr_tiles):
    """``[y, x]``: the LR and HR patches, normalized per patch."""
    ps = int(cfg["patch_size"])
    return [normalize(grid_patches(lr_tiles.float(), ps // 2)),
            normalize(grid_patches(hr_tiles.float(), ps))]


def noise_shapes(cfg: dict, batch: int):
    return models.train_noise_shapes(cfg, batch)


def loss(cfg: dict, params, streams, noise, rounding, stats):
    return models.cond_loss(params, streams[0], streams[1], noise[0], noise[1], rounding, stats)


def conv_sites(cfg: dict, batch: int, part: str = "all"):
    return models.conv_sites(cfg, batch, part)


def draws(cfg: dict, params, y, gen, samples: int, rounding):
    """``samples`` draws (NCHW) given one normalized LR image, the noise in
    the served path's chunk order."""
    chunk = models.draw_chunk(samples, int(cfg["patch_size"]))
    return models.cond_draws(params, y, gen, samples, chunk, rounding)
