"""N-draw posterior decode for uncertainty maps (port of the Cond_SRVAE branch
of the JAX package's ``tasks.sample_chunked``)."""

from __future__ import annotations

from typing import Optional

import torch

from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.vae import reparameterize
from simple_vae_rs_tpu_torch.ops.quantize import unpack_weights


def auto_chunk(samples: int, patch_size: int, budget_bytes: int = 1 << 30) -> int:
    """Decode chunk size that keeps the widest decoder activation (the
    full-resolution 64-channel tail, counted at 2 bytes with 2x headroom as
    in the JAX package) under ``budget_bytes``. At the canonical 64 px patch
    the 1000-draw task decodes in one chunk."""
    per_draw = patch_size * patch_size * 64 * 2 * 2
    return max(1, min(samples, budget_bytes // per_draw))


@torch.no_grad()
def sample_chunked(model: CondSRVAE, y: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   samples: int = 1000, chunk: int = 100,
                   eps_u: Optional[torch.Tensor] = None,
                   eps_z: Optional[torch.Tensor] = None,
                   packed=None) -> torch.Tensor:
    """``samples`` posterior draws of one LR image ``y`` (1, ps/2, ps/2, C),
    decoded in chunks: (samples, ps, ps, C).

    The conditioning pass (q(u|y), the y-embedding and the prior) runs once,
    with one ``u`` draw shared by all samples (reference ``cond_vae.py:299-318``);
    only the decoder runs per chunk. Noise comes from ``generator`` unless
    injected: ``eps_u`` shaped like the u grid, ``eps_z`` (samples, z grid).
    ``packed`` is the payload of a model in the weights-only int8 mode
    (``ops/quantize.pack_int8_weights``): its weights are dequantized for
    the length of this call.
    """
    if samples < 1:
        raise ValueError(f"samples must be >= 1 (got {samples})")
    with unpack_weights(model, packed):
        return _sample_chunked(model, y, generator, samples, chunk, eps_u, eps_z)


def _sample_chunked(model, y, generator, samples, chunk, eps_u, eps_z):
    mu_u, logvar_u = model.encode_y(y)
    u = reparameterize(mu_u, logvar_u, eps_u, generator)
    y_feat = model.y_embedding(y)
    mu_p, logvar_p = model.z_cond(y_feat, u)
    std = torch.exp(0.5 * logvar_p)
    chunk = max(1, min(chunk, samples))
    outs = []
    for lo in range(0, samples, chunk):
        if eps_z is None:
            eps = torch.randn((chunk,) + tuple(mu_p.shape[1:]), generator=generator,
                              device=mu_p.device, dtype=mu_p.dtype)
        else:
            eps = eps_z[lo:lo + chunk]
        z = mu_p + eps * std
        yf = y_feat.expand((z.shape[0],) + tuple(y_feat.shape[1:]))
        outs.append(model.decode_x_from_features(z, yf))
    return torch.cat(outs)[:samples]
