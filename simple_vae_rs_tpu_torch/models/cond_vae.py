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
:meth:`CondSRVAE.conditional_generation_eps` and :meth:`CondSRVAE.sample`
(the N-draw decode) in ``eval()`` mode. Noise is passed in, or drawn from a
``torch.Generator`` the caller passes.

The four convs that end ``ey``, ``ex``, ``dy`` and ``dx`` have nothing
between them; in ``eval()`` mode, on a float32 model whose chain is switched
on (``ops/conv_blocks.use_chain``), each of these tails is one launch of the
chain kernel (``ops/conv_blocks.conv_tail``).

``dtype`` (float32 or bfloat16) is the convs' compute dtype, as the JAX
model's; parameters stay float32. The casts sit where the JAX model has
them: the encoder heads and the prior's (mu, logvar) to float32, ``u`` to
the y features' dtype, the decoders' inputs to ``dtype``, the pre-sigmoid
outputs to float32. The reparameterisation and its noise are float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.vae import decode_draws, reparameterize
from simple_vae_rs_tpu_torch.ops.conv_blocks import (
    Conv3x3,
    DownBlock,
    Routed,
    UpBlock,
    conv_tail,
    reset_parameters,
    set_dtype,
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

    def __init__(self, config: CondSRVAEConfig, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
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
        set_dtype(self, dtype)

    def init_weights(self, seed: int) -> "CondSRVAE":
        """Random weights from a numpy seed with torch's default init bounds
        (the flax package's initializers); BatchNorm and gammas at identity."""
        with torch.no_grad():
            self.gammax.fill_(1.0)
            self.gammay.fill_(1.0)
        reset_parameters(self, np.random.default_rng(seed))
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
        h = conv_tail(self, (self.ey_conv1, self.ey_conv2, self.ey_conv3, self.ey_head), h)
        c = self.config.u_channels
        return h[..., :c].float(), h[..., c:].float()

    def encode_x(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """HR (B, ps, ps, C) -> (mu_z, logvar_z) on the z grid."""
        h = self.ex_down1(x)
        h = self.ex_down2(h)
        h = self.ex_down3(h)
        h = conv_tail(self, (self.ex_conv1, self.ex_conv2, self.ex_conv3, self.ex_head), h)
        c = self.config.z_channels
        return h[..., :c].float(), h[..., c:].float()

    def y_embedding(self, y: Tensor) -> Tensor:
        """Shared conditioning features (B, ps/16, ps/16, latent//16)."""
        h = self.yz_down1(y)
        h = self.yz_down2(h)
        h = self.yz_down3(h)
        h = self.yz_conv1(h)
        return self.yz_conv2(h)

    def z_cond(self, y_feat: Tensor, u_map: Tensor) -> Tuple[Tensor, Tensor]:
        """p(z|u, y): prior (mu, logvar) on the z grid, logvar in [-7, 7]."""
        u_feat = self.uz_conv1(self._regroup_down(u_map.to(y_feat.dtype)))
        u_feat = self.uz_conv2(u_feat)
        joint = torch.cat([y_feat, u_feat], dim=-1)
        mu = self.pz_mu_conv2(self.pz_mu_conv1(joint))
        logvar = self.pz_lv_conv2(self.pz_lv_conv1(joint)).clamp(-7.0, 7.0)
        return self._regroup_up(mu.float()), self._regroup_up(logvar.float())

    def decode_x_from_features(self, z_map: Tensor, y_feat: Tensor) -> Tensor:
        """z grid + y features -> HR reconstruction (B, ps, ps, C) in [0, 1]."""
        y_grid = self._regroup_up(y_feat).to(z_map.dtype)
        h = torch.cat([y_grid, z_map], dim=-1).to(self.dtype)
        h = self.dx_up1(h)
        h = self.dx_up2(h)
        h = self.dx_up3(h)
        h = conv_tail(self, (self.dx_conv1, self.dx_conv2, self.dx_conv3, self.dx_conv4), h)
        return torch.sigmoid(h.float())

    def decode_y(self, u_map: Tensor) -> Tensor:
        """u grid -> LR reconstruction (B, ps/2, ps/2, C) in [0, 1]."""
        h = self.dy_up1(u_map.to(self.dtype))
        h = self.dy_up2(h)
        h = conv_tail(self, (self.dy_conv1, self.dy_conv2, self.dy_conv3, self.dy_conv4), h)
        return torch.sigmoid(h.float())

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

    def lr_autoencode(self, y: Tensor, eps_u: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """The LR branch alone, q(u|y) -> p(y|u): ``(y_hat, mu_u, logvar_u)``,
        the last two flattened to (B, dim); ``eps_u`` is shaped like the u
        grid. Staged pre-training runs it (``Trainer.pretrain_lr_branch``)."""
        mu_u, logvar_u = self.encode_y(y)
        y_hat = self.decode_y(reparameterize(mu_u, logvar_u, eps_u))
        return y_hat, flatten_map(mu_u), flatten_map(logvar_u)

    # ------------------------------------------------------------ serving
    def generation_noise_shapes(self, batch: int, lr_hw: Tuple[int, int]):
        """Shapes of ``(eps_u, eps_z)`` for an LR batch of spatial ``lr_hw``:
        both latents live on the (lr/4, lr/4) grid."""
        gh, gw = lr_hw[0] // 4, lr_hw[1] // 4
        cfg = self.config
        return (batch, gh, gw, cfg.u_channels), (batch, gh, gw, cfg.z_channels)

    def conditional_generation_eps(self, y: Tensor, eps_u: Optional[Tensor],
                                   eps_z: Optional[Tensor],
                                   generator: Optional[torch.Generator] = None) -> Tensor:
        """y -> u ~ q(u|y) -> z ~ p(z|u, y) -> x_hat, with the noise passed in
        (reference ``cond_vae.py:288-297``); a noise given as None is drawn
        from ``generator``."""
        mu_u, logvar_u = self.encode_y(y)
        u = reparameterize(mu_u, logvar_u, eps_u, generator)
        y_feat = self.y_embedding(y)
        mu_z, logvar_z = self.z_cond(y_feat, u)
        z = reparameterize(mu_z, logvar_z, eps_z, generator)
        return self.decode_x_from_features(z, y_feat)

    def conditional_generation(self, y: Tensor,
                               generator: Optional[torch.Generator] = None) -> Tensor:
        """Single-draw 2x super-resolution with the noise drawn from
        ``generator`` (``eps_u`` first, then ``eps_z``)."""
        return self.conditional_generation_eps(y, None, None, generator)

    @torch.no_grad()
    def sample(self, y: Tensor, generator: Optional[torch.Generator] = None,
               samples: int = 1000, chunk: int = 128, eps_u: Optional[Tensor] = None,
               eps_z: Optional[Tensor] = None, replicas=None) -> Tensor:
        """``samples`` posterior-prior draws of one LR image ``y``
        (1, ps/2, ps/2, C), decoded in chunks: (samples, ps, ps, C)
        (reference ``cond_vae.py:299-318``). The conditioning pass (q(u|y),
        the y-embedding and the prior) runs once, with one ``u`` draw shared
        by all samples; only the decoder runs per chunk. Noise comes from
        ``generator`` unless injected: ``eps_u`` shaped like the u grid,
        ``eps_z`` (samples, z grid). ``replicas`` (``parallel/mesh.Replicas``
        of this model) splits each chunk's decode over a device mesh."""
        mu_u, logvar_u = self.encode_y(y)
        u = reparameterize(mu_u, logvar_u, eps_u, generator)
        y_feat = self.y_embedding(y)
        mu_p, logvar_p = self.z_cond(y_feat, u)

        def decode_on(m, z: Tensor) -> Tensor:
            yf = y_feat.to(z.device).expand((z.shape[0],) + tuple(y_feat.shape[1:]))
            return m.decode_x_from_features(z, yf)

        def decode(z: Tensor) -> Tensor:
            if replicas is not None:
                return replicas.map(decode_on, z)
            return decode_on(self, z)

        return decode_draws(decode, mu_p, torch.exp(0.5 * logvar_p), samples, chunk, eps_z,
                            generator)

    @torch.no_grad()
    def generation(self, generator: Optional[torch.Generator] = None
                   ) -> Tuple[Tensor, Tensor]:
        """Unconditional generation ``(y_hat, x_hat)``: u ~ N(0, I) -> y_hat
        = p(y|u) -> x_hat = SR(y_hat) (reference ``cond_vae.py:320-324``)."""
        cfg = self.config
        u = torch.randn((1, cfg.u_spatial, cfg.u_spatial, cfg.u_channels),
                        generator=generator, device=self.gammax.device)
        y_hat = self.decode_y(u)
        return y_hat, self.conditional_generation(y_hat, generator)
