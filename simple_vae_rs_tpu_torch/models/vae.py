"""VAE helpers shared by the port's models."""

from __future__ import annotations

from typing import Optional

import torch


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``mu + eps * exp(0.5 * logvar)`` (reference ``models/vae.py:94-98``).

    ``eps`` is drawn from ``generator`` on ``mu``'s device unless passed in.
    """
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + eps * torch.exp(0.5 * logvar)
