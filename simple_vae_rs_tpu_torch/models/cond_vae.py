"""Conditional super-resolution VAE (port of the JAX package's
``models/cond_vae.py``).

Six sub-networks, NHWC, with the flax module names:

- ``ey_*``  q(u|y): LR (ps/2) -> 2 DownBlocks + 4 convs -> u grid (mu, logvar);
- ``dy_*``  p(y|u): u grid -> 2 UpBlocks + 4 convs + sigmoid -> LR;
- ``ex_*``  q(z|x): HR (ps) -> 3 DownBlocks + 4 convs -> z grid (mu, logvar);
- ``dx_*``  p(x|z,y): [y-embedding regrouped up, z] -> 3 UpBlocks + 4 convs
  + sigmoid;
- ``yz_*``  y-embedding: LR -> 3 DownBlocks + 2 convs (ps/16 grid);
- ``uz_*``, ``pz_*``  conditional prior p(z|u, y), logvar clamped to [-7, 7];
- ``gammax``, ``gammay``: the decoders' learnable stds.

Training runs :meth:`CondSRVAE.forward` (the reference 8-tuple) in
``train()`` mode, where BatchNorm uses batch statistics; serving runs
:meth:`CondSRVAE.conditional_generation_eps` and the pieces
:mod:`simple_vae_rs_tpu_torch.tasks` chains for the N-draw decode, in
``eval()`` mode. Noise is always passed in.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.vae import reparameterize
from simple_vae_rs_tpu_torch.ops.conv_blocks import (
    BatchNorm,
    Conv3x3,
    ConvWeights,
    DownBlock,
    Routed,
    UpBlock,
)
from simple_vae_rs_tpu_torch.ops.reshape import (
    cmajor_regroup_down,
    cmajor_regroup_up,
    depth_to_space,
    flatten_map,
    space_to_depth,
)

Tensor = torch.Tensor


class CondSRVAE(Routed):
    """Conditional SR-VAE; parameters and buffers carry the flax tree's names.
    ``plain`` (set by ``use_plain_path``) also routes the training loss's
    row reductions to their plain versions."""

    def __init__(self, config: CondSRVAEConfig, device=None) -> None:
        super().__init__()
        self.config = cfg = config
        ch = cfg.channels
        lz64 = cfg.latent_size // 64  # z-grid channels
        lz16 = cfg.latent_size // 16  # prior-head channels (ps/16 grid)
        ly64 = cfg.latent_size_y // 64  # u-grid channels
        ly16 = cfg.latent_size_y // 16
        if min(lz64, ly64) < 1:
            raise ValueError(
                f"latent channels < 1 for patch_size={cfg.patch_size}, cr={cfg.cr}"
            )
        d = device

        def conv(cin, cout):
            return Conv3x3(cin, cout, device=d)

        self.gammax = nn.Parameter(torch.empty((), device=d))
        self.gammay = nn.Parameter(torch.empty((), device=d))

        self.ey_down1 = DownBlock(ch, 16, device=d)
        self.ey_down2 = DownBlock(16, 64, device=d)
        self.ey_conv1 = conv(64, 64)
        self.ey_conv2 = conv(64, 128)
        self.ey_conv3 = conv(128, 128)
        self.ey_head = conv(128, 2 * ly64)

        self.dy_up1 = UpBlock(ly64, 128, device=d)
        self.dy_up2 = UpBlock(128, 64, device=d)
        self.dy_conv1 = conv(64, 64)
        self.dy_conv2 = conv(64, 16)
        self.dy_conv3 = conv(16, 16)
        self.dy_conv4 = conv(16, ch)

        self.ex_down1 = DownBlock(ch, 16, device=d)
        self.ex_down2 = DownBlock(16, 64, device=d)
        self.ex_down3 = DownBlock(64, 128, device=d)
        self.ex_conv1 = conv(128, 128)
        self.ex_conv2 = conv(128, 128)
        self.ex_conv3 = conv(128, 128)
        self.ex_head = conv(128, 2 * lz64)

        self.dx_up1 = UpBlock(2 * lz64, 256, device=d)
        self.dx_up2 = UpBlock(256, 128, device=d)
        self.dx_up3 = UpBlock(128, 64, device=d)
        self.dx_conv1 = conv(64, 64)
        self.dx_conv2 = conv(64, 16)
        self.dx_conv3 = conv(16, 16)
        self.dx_conv4 = conv(16, ch)

        self.yz_down1 = DownBlock(ch, 16, device=d)
        self.yz_down2 = DownBlock(16, 64, device=d)
        self.yz_down3 = DownBlock(64, 128, device=d)
        self.yz_conv1 = conv(128, 128)
        self.yz_conv2 = conv(128, lz16)

        self.uz_conv1 = conv(ly16, ly16)
        self.uz_conv2 = conv(ly16, lz16)

        self.pz_mu_conv1 = conv(2 * lz16, lz16)
        self.pz_mu_conv2 = conv(lz16, lz16)
        self.pz_lv_conv1 = conv(2 * lz16, lz16)
        self.pz_lv_conv2 = conv(lz16, lz16)

    def init_weights(self, seed: int) -> "CondSRVAE":
        """Random weights from a numpy seed with torch's default init bounds
        (the flax package's initializers); BatchNorm and gammas at identity."""
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            self.gammax.fill_(1.0)
            self.gammay.fill_(1.0)
        for mod in self.modules():
            if isinstance(mod, (ConvWeights, BatchNorm)):
                mod.reset_parameters(rng)
        return self

    # ------------------------------------------------------------ regroups
    def _regroup_down(self, x: Tensor) -> Tensor:
        if self.config.torch_regroup:
            return cmajor_regroup_down(x, 2)
        return space_to_depth(x, 2).contiguous()

    def _regroup_up(self, x: Tensor) -> Tensor:
        if self.config.torch_regroup:
            return cmajor_regroup_up(x, 2)
        return depth_to_space(x, 2).contiguous()

    # ------------------------------------------------------------ pieces
    def encode_y(self, y: Tensor) -> Tuple[Tensor, Tensor]:
        """LR (B, ps/2, ps/2, C) -> (mu_u, logvar_u) on the u grid."""
        h = self.ey_down1(y)
        h = self.ey_down2(h)
        h = self.ey_conv1(h)
        h = self.ey_conv2(h)
        h = self.ey_conv3(h)
        h = self.ey_head(h)
        c = self.config.u_channels
        return h[..., :c], h[..., c:]

    def encode_x(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """HR (B, ps, ps, C) -> (mu_z, logvar_z) on the z grid."""
        h = self.ex_down1(x)
        h = self.ex_down2(h)
        h = self.ex_down3(h)
        h = self.ex_conv1(h)
        h = self.ex_conv2(h)
        h = self.ex_conv3(h)
        h = self.ex_head(h)
        c = self.config.z_channels
        return h[..., :c], h[..., c:]

    def y_embedding(self, y: Tensor) -> Tensor:
        """Shared conditioning features (B, ps/16, ps/16, latent//16)."""
        h = self.yz_down1(y)
        h = self.yz_down2(h)
        h = self.yz_down3(h)
        h = self.yz_conv1(h)
        return self.yz_conv2(h)

    def z_cond(self, y_feat: Tensor, u_map: Tensor) -> Tuple[Tensor, Tensor]:
        """p(z|u, y): prior (mu, logvar) on the z grid, logvar in [-7, 7]."""
        u_feat = self.uz_conv1(self._regroup_down(u_map))
        u_feat = self.uz_conv2(u_feat)
        joint = torch.cat([y_feat, u_feat], dim=-1)
        mu = self.pz_mu_conv2(self.pz_mu_conv1(joint))
        logvar = self.pz_lv_conv2(self.pz_lv_conv1(joint)).clamp(-7.0, 7.0)
        return self._regroup_up(mu), self._regroup_up(logvar)

    def decode_x_from_features(self, z_map: Tensor, y_feat: Tensor) -> Tensor:
        """z grid + y features -> HR reconstruction (B, ps, ps, C) in [0, 1]."""
        h = torch.cat([self._regroup_up(y_feat), z_map], dim=-1)
        h = self.dx_up1(h)
        h = self.dx_up2(h)
        h = self.dx_up3(h)
        h = self.dx_conv1(h)
        h = self.dx_conv2(h)
        h = self.dx_conv3(h)
        h = self.dx_conv4(h)
        return torch.sigmoid(h)

    def decode_y(self, u_map: Tensor) -> Tensor:
        """u grid -> LR reconstruction (B, ps/2, ps/2, C) in [0, 1]."""
        h = self.dy_up1(u_map)
        h = self.dy_up2(h)
        h = self.dy_conv1(h)
        h = self.dy_conv2(h)
        h = self.dy_conv3(h)
        h = self.dy_conv4(h)
        return torch.sigmoid(h)

    def decode_x(self, z_map: Tensor, y: Tensor) -> Tensor:
        """Parity API: recomputes the y embedding (reference ``cond_vae.py:270``)."""
        return self.decode_x_from_features(z_map, self.y_embedding(y))

    # ------------------------------------------------------------ training
    def forward(self, x: Tensor, y: Tensor, eps_u: Tensor, eps_z: Tensor
                ) -> Tuple[Tensor, ...]:
        """The reference 8-tuple ``(x_hat, y_hat, mu_z, logvar_z, mu_u,
        logvar_u, mu_z_uy, logvar_z_uy)``, the mu/logvar entries flattened to
        (B, dim); ``eps_u``/``eps_z`` are shaped like the u and z grids
        (:meth:`generation_noise_shapes`)."""
        mu_u, logvar_u = self.encode_y(y)
        u = reparameterize(mu_u, logvar_u, eps_u)
        mu_z, logvar_z = self.encode_x(x)
        z = reparameterize(mu_z, logvar_z, eps_z)
        y_feat = self.y_embedding(y)
        mu_z_uy, logvar_z_uy = self.z_cond(y_feat, u)
        x_hat = self.decode_x_from_features(z, y_feat)
        y_hat = self.decode_y(u)
        return (x_hat, y_hat, flatten_map(mu_z), flatten_map(logvar_z),
                flatten_map(mu_u), flatten_map(logvar_u),
                flatten_map(mu_z_uy), flatten_map(logvar_z_uy))

    # ------------------------------------------------------------ serving
    def generation_noise_shapes(self, batch: int, lr_hw: Tuple[int, int]):
        """Shapes of ``(eps_u, eps_z)`` for an LR batch of spatial ``lr_hw``:
        both latents live on the (lr/4, lr/4) grid."""
        gh, gw = lr_hw[0] // 4, lr_hw[1] // 4
        cfg = self.config
        return (batch, gh, gw, cfg.u_channels), (batch, gh, gw, cfg.z_channels)

    def conditional_generation_eps(self, y: Tensor, eps_u: Tensor, eps_z: Tensor) -> Tensor:
        """y -> u ~ q(u|y) -> z ~ p(z|u, y) -> x_hat, with the noise passed in
        (reference ``cond_vae.py:288-297``)."""
        mu_u, logvar_u = self.encode_y(y)
        u = reparameterize(mu_u, logvar_u, eps_u)
        y_feat = self.y_embedding(y)
        mu_z, logvar_z = self.z_cond(y_feat, u)
        z = reparameterize(mu_z, logvar_z, eps_z)
        return self.decode_x_from_features(z, y_feat)
