"""Plain Gaussian VAE for single-image reconstruction (port of the JAX
package's ``models/vae.py``), and the reparameterization the models share.

- encoder ``enc_*``: 2 DownBlocks (C -> 16 -> 64, spatial /4) + 4 convs
  (64 -> 64 -> 128 -> 128 -> 2 * latent_channels), split into (mu, logvar);
- decoder ``dec_*``: latent map (ps/4, ps/4, latent_channels) -> 2 UpBlocks
  (-> 128 -> 64) + 4 convs (-> 64 -> 16 -> 16 -> C) + sigmoid;
- ``gamma``: the decoder's learnable std.

NHWC; latent vectors flatten in HWC order (``ops/reshape.flatten_map``).
Parameters and buffers carry the flax tree's names. In ``eval()`` mode, on a
float32 model whose chain is switched on (``ops/conv_blocks.use_chain``),
the four convs that end the encoder and the decoder are one launch of the
chain kernel each.

``dtype`` (float32 or bfloat16) is the convs' compute dtype, as the JAX
model's; parameters stay float32. As there, the heads (mu, logvar) are cast
to float32, the decoder's input to ``dtype`` and the pre-sigmoid output to
float32; the noise is float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from simple_vae_rs_tpu_torch.config import VAEConfig
from simple_vae_rs_tpu_torch.ops.conv_blocks import (
    Conv3x3,
    DownBlock,
    Routed,
    UpBlock,
    conv_tail,
    reset_parameters,
    set_dtype,
)
from simple_vae_rs_tpu_torch.ops.reshape import flatten_map, unflatten_map
from simple_vae_rs_tpu_torch.utils.trace import span

Tensor = torch.Tensor


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``mu + eps * exp(0.5 * logvar)`` (reference ``models/vae.py:94-98``).

    ``eps`` is drawn (float32) from ``generator`` on ``mu``'s device unless
    passed in.
    """
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=torch.float32)
    return mu + eps * torch.exp(0.5 * logvar)


def decode_draws(decode: Callable[[torch.Tensor], torch.Tensor], mu: torch.Tensor,
                 std: torch.Tensor, samples: int, chunk: int,
                 eps: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``samples`` draws ``decode(mu + eps * std)``, decoded ``chunk`` at a
    time so that only one chunk's activations are live: ``mu`` and ``std``
    are (1, ...) and ``eps`` (samples, ...), drawn per chunk from
    ``generator`` unless passed in."""
    if samples < 1:
        raise ValueError(f"samples must be >= 1 (got {samples})")
    chunk = max(1, min(chunk, samples))
    outs = []
    for lo in range(0, samples, chunk):
        with span("svrs.uq.decode"):
            if eps is None:
                noise = torch.randn((chunk,) + tuple(mu.shape[1:]), generator=generator,
                                    device=mu.device, dtype=torch.float32)
            else:
                noise = eps[lo:lo + chunk]
            outs.append(decode(mu + noise * std))
    return torch.cat(outs)[:samples]


class VAE(Routed):
    """Gaussian VAE; ``forward`` returns ``(x_hat, mu, logvar)``. ``plain``
    (set by ``use_plain_path``) also routes the training loss's row
    reductions to their plain versions."""

    def __init__(self, config: VAEConfig, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = cfg = config
        lc = cfg.latent_channels
        if lc < 1:
            raise ValueError(
                f"latent_channels < 1 for patch_size={cfg.patch_size}, cr={cfg.cr}"
            )
        d = device

        def conv(cin, cout):
            return Conv3x3(cin, cout, device=d)

        self.gamma = nn.Parameter(torch.empty((), device=d))

        self.enc_down1 = DownBlock(cfg.channels, 16, device=d)
        self.enc_down2 = DownBlock(16, 64, device=d)
        self.enc_conv1 = conv(64, 64)
        self.enc_conv2 = conv(64, 128)
        self.enc_conv3 = conv(128, 128)
        self.enc_head = conv(128, 2 * lc)

        self.dec_up1 = UpBlock(lc, 128, device=d)
        self.dec_up2 = UpBlock(128, 64, device=d)
        self.dec_conv1 = conv(64, 64)
        self.dec_conv2 = conv(64, 16)
        self.dec_conv3 = conv(16, 16)
        self.dec_conv4 = conv(16, cfg.channels)
        set_dtype(self, dtype)

    def init_weights(self, seed: int) -> "VAE":
        """Random weights from a numpy seed with torch's default init bounds
        (the flax package's initializers); BatchNorm and gamma at identity."""
        with torch.no_grad():
            self.gamma.fill_(1.0)
        reset_parameters(self, np.random.default_rng(seed))
        return self

    def encode(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """x (B, ps, ps, C) -> flattened (mu, logvar), each (B, latent_dim)."""
        h = self.enc_down1(x)
        h = self.enc_down2(h)
        h = conv_tail(self, (self.enc_conv1, self.enc_conv2, self.enc_conv3, self.enc_head), h)
        lc = self.config.latent_channels
        return flatten_map(h[..., :lc]).float(), flatten_map(h[..., lc:]).float()

    def decode(self, z: Tensor) -> Tensor:
        """z (B, latent_dim) -> reconstruction (B, ps, ps, C) in [0, 1]."""
        cfg = self.config
        h = unflatten_map(z, cfg.latent_spatial, cfg.latent_spatial, cfg.latent_channels)
        h = self.dec_up1(h.to(self.dtype).contiguous())
        h = self.dec_up2(h)
        h = conv_tail(self, (self.dec_conv1, self.dec_conv2, self.dec_conv3, self.dec_conv4), h)
        return torch.sigmoid(h.float())

    def forward(self, x: Tensor, eps: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
        """``(x_hat, mu, logvar)``; ``eps`` (B, latent_dim) is drawn from
        ``generator`` unless passed in."""
        mu, logvar = self.encode(x)
        z = reparameterize(mu, logvar, eps, generator)
        return self.decode(z), mu, logvar

    @torch.no_grad()
    def sample(self, y: Tensor, generator: Optional[torch.Generator] = None,
               samples: int = 1000, eps: Optional[Tensor] = None) -> Tensor:
        """``samples`` posterior draws from q(z|y) of one image ``y``
        (1, ps, ps, C), decoded: (samples, ps, ps, C) (reference
        ``vae.py:240-252``); ``eps`` (samples, latent_dim) is drawn from
        ``generator`` unless passed in."""
        mu, logvar = self.encode(y)
        if eps is None:
            eps = torch.randn((samples, self.config.latent_dim), generator=generator,
                              device=mu.device, dtype=torch.float32)
        return self.decode(mu + torch.exp(0.5 * logvar) * eps)
