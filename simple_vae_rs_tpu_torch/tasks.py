"""Evaluation tasks of the port: the N-draw posterior decode and its
per-pixel statistics (port of the JAX package's ``tasks.sample_chunked``,
``auto_chunk``, ``error_statistics`` and ``uncertainty_maps``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE, decode_draws
from simple_vae_rs_tpu_torch.ops.quantize import unpack_weights

Tensor = torch.Tensor


def auto_chunk(samples: int, patch_size: int, budget_bytes: int = 1 << 30) -> int:
    """Decode chunk size that keeps the widest decoder activation (the
    full-resolution 64-channel tail, counted at 2 bytes with 2x headroom as
    in the JAX package) under ``budget_bytes``. At the canonical 64 px patch
    the 1000-draw task decodes in one chunk."""
    per_draw = patch_size * patch_size * 64 * 2 * 2
    return max(1, min(samples, budget_bytes // per_draw))


@torch.no_grad()
def sample_chunked(model, y: Tensor, generator: Optional[torch.Generator] = None,
                   samples: int = 1000, chunk: int = 100,
                   eps_u: Optional[Tensor] = None, eps_z: Optional[Tensor] = None,
                   packed=None) -> Tensor:
    """``samples`` posterior draws of one image ``y``, decoded in chunks:
    (samples, ps, ps, C).

    Cond_SRVAE and SRVAE (``y`` the LR image (1, ps/2, ps/2, C); an SRVAE also
    takes an HR-sized one and downsamples it): the conditioning pass runs
    once, with one ``u`` draw shared by all samples, and only the decoder
    runs per chunk (``CondSRVAE.sample``). VAE (``y`` (1, ps, ps, C)): the
    encoder runs once and chunks of ``mu + eps * std`` are decoded. Noise
    comes from ``generator`` unless injected: ``eps_u`` shaped like the u
    grid and ``eps_z`` (samples, z grid), or for a VAE ``eps_z`` (samples,
    latent_dim) alone. ``packed`` is the payload of a model in the
    weights-only int8 mode (``ops/quantize.pack_int8_weights``): its weights
    are dequantized for the length of this call. The noise and the draws are
    float32 for a model of either compute dtype (its decoder casts).
    """
    with unpack_weights(model, packed):
        if isinstance(model, (CondSRVAE, SRVAE)):
            return model.sample(y, generator, samples, chunk, eps_u, eps_z)
        if not isinstance(model, VAE):
            raise TypeError(f"sample_chunked takes a CondSRVAE, SRVAE or VAE, not "
                            f"{type(model).__name__}")
        mu, logvar = model.encode(y)
        return decode_draws(model.decode, mu, torch.exp(0.5 * logvar), samples, chunk, eps_z,
                            generator)


def error_statistics(samples: Tensor, target: Tensor) -> Dict[str, Tensor]:
    """Per-pixel statistics of draws (N, H, W, C) against ``target``
    (1, H, W, C) (reference ``base.py:309-344``): mean (H, W, C) and
    channel-averaged std of the draws, MAE and MSE of ``samples - target``
    over (draw, channel), the mean-bias map, each (H, W), and the scalar MMSE."""
    samples, target = samples.float(), target.float()
    diff = samples - target
    mean = samples.mean(dim=0)
    return {
        "mean": mean,
        "std": samples.std(dim=0, correction=0).mean(dim=-1),
        "mae": diff.abs().mean(dim=(0, 3)),
        "mse": (diff**2).mean(dim=(0, 3)),
        "mean_bias": (target[0] - mean).mean(dim=-1),
        "mmse": (diff**2).mean(),
    }


def uncertainty_maps(model, y: Tensor, generator: Optional[torch.Generator] = None,
                     samples: int = 32, chunk: int = 32) -> Dict[str, Tensor]:
    """Per-pixel mean, variance and std maps over ``samples`` posterior
    draws, in float32 whatever the model's compute dtype."""
    draws = sample_chunked(model, y, generator, samples=samples, chunk=chunk).float()
    return {
        "mean": draws.mean(dim=0),
        "variance": draws.var(dim=0, correction=0),
        "std": draws.std(dim=0, correction=0),
    }
