"""Hierarchical srVAE over single HR images (port of the JAX package's
``models/srvae.py``): the six sub-networks of :class:`CondSRVAE` under the
name ``core``, with the LR view ``y`` computed inside the model as the 2x2
box downsample of ``x`` (of the float32 input, whatever the compute
``dtype`` the core is given). No parameter beyond the core's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.ops.conv_blocks import Routed

Tensor = torch.Tensor


def box_downsample_2x(x: Tensor) -> Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, C), the 2x2 mean: the deterministic
    downscaling ``y = d(x)`` of the srVAE paper."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class SRVAE(Routed):
    """Two-level hierarchical srVAE; ``core`` holds every parameter, so the
    flax tree ``core/...`` is the port's ``core. ...``."""

    def __init__(self, config: CondSRVAEConfig, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        self.core = CondSRVAE(config, device=device, dtype=dtype)
        self.dtype = dtype

    def init_weights(self, seed: int) -> "SRVAE":
        self.core.init_weights(seed)
        return self

    def lr_view(self, y: Tensor) -> Tensor:
        """``y`` itself, or its 2x2 box downsample when it is HR-sized."""
        if y.shape[1] == self.config.patch_size:
            return box_downsample_2x(y).contiguous()
        return y

    def forward(self, x: Tensor, eps_u: Tensor, eps_z: Tensor) -> Tuple[Tensor, ...]:
        """The Cond_SRVAE 8-tuple with the internal ``y`` appended:
        ``(x_hat, y_hat, mu_z, lv_z, mu_u, lv_u, mu_z_uy, lv_z_uy, y)``."""
        y = box_downsample_2x(x).contiguous()
        return self.core(x, y, eps_u, eps_z) + (y,)

    def generation_noise_shapes(self, batch: int, hw: Tuple[int, int]):
        """Shapes of ``(eps_u, eps_z)`` for a batch of LR images, or of HR
        images that are downsampled first, of spatial ``hw``."""
        if hw[0] == self.config.patch_size:
            hw = (hw[0] // 2, hw[1] // 2)
        return self.core.generation_noise_shapes(batch, hw)

    def conditional_generation_eps(self, y: Tensor, eps_u: Optional[Tensor],
                                   eps_z: Optional[Tensor],
                                   generator: Optional[torch.Generator] = None) -> Tensor:
        """Single-draw 2x SR of an LR image (or of an HR one, downsampled
        first) with the noise passed in."""
        return self.core.conditional_generation_eps(self.lr_view(y), eps_u, eps_z, generator)

    def conditional_generation(self, y: Tensor,
                               generator: Optional[torch.Generator] = None) -> Tensor:
        return self.core.conditional_generation(self.lr_view(y), generator)

    def sample(self, y: Tensor, generator: Optional[torch.Generator] = None,
               samples: int = 1000, chunk: int = 128, eps_u: Optional[Tensor] = None,
               eps_z: Optional[Tensor] = None, replicas=None) -> Tensor:
        """Posterior-prior draws given an image, HR (downsampled first) or
        LR; then :meth:`CondSRVAE.sample` (on the replicas' cores)."""
        if replicas is not None:
            replicas = type(replicas)(replicas.mesh, [m.core for m in replicas])
        return self.core.sample(self.lr_view(y), generator, samples, chunk, eps_u, eps_z,
                                replicas)

    def generation(self, generator: Optional[torch.Generator] = None
                   ) -> Tuple[Tensor, Tensor]:
        """Unconditional: u ~ N(0, I) -> y_hat -> z ~ p(z|u, y_hat) -> x_hat."""
        return self.core.generation(generator)
