"""The plain Gaussian VAE (``models/vae.py``), trained on the LR stream:
its patch is ``patch_size`` LR pixels; the program's ``VAE``."""

from __future__ import annotations

from port_bench.reference import models
from port_bench.reference.train import grid_patches, normalize

CONFIG_KEYS = frozenset({"patch_size", "script_patch_size", "cr", "channels", "latent_size",
                         "latent_channels"})
TERMS = ("loss", "mse", "kld")


def port_model(cfg: dict, dtype, device):
    from simple_vae_rs_tpu_torch import VAE, VAEConfig

    return VAE(VAEConfig(cr=float(cfg["cr"]), patch_size=int(cfg["patch_size"])),
               device=device, dtype=dtype)


def lr_patch(cfg: dict) -> int:
    return int(cfg["patch_size"])


def program_batch(cfg: dict, lr_tiles, hr_tiles):
    from simple_vae_rs_tpu_torch.ops.patchify import grid_single_batch

    return (grid_single_batch(lr_tiles, int(cfg["patch_size"])),)


def param_spec(cfg: dict):
    return models.param_spec(cfg)


def trainable(cfg: dict):
    return models.trainable(cfg)


def streams(cfg: dict, lr_tiles, hr_tiles):
    """``[y]``: the LR patches, normalized per patch (the HR tiles unused)."""
    return [normalize(grid_patches(lr_tiles.float(), int(cfg["patch_size"])))]


def noise_shapes(cfg: dict, batch: int):
    return models.train_noise_shapes(cfg, batch)


def loss(cfg: dict, params, streams, noise, rounding, stats):
    return models.vae_loss(params, streams[0], noise[0], cfg, rounding, stats)


def conv_sites(cfg: dict, batch: int, part: str = "all"):
    return models.conv_sites(cfg, batch, part)
