"""Model configuration of the PyTorch port (its own copy of the JAX package's
``CondSRVAEConfig``, with the same latent-size formula)."""

from __future__ import annotations

import dataclasses


def _cond_latent_size(patch_size: int, cr: float) -> int:
    """Latent size of Cond_SRVAE (reference ``models/cond_vae.py:21``).

    The literal ``4`` is the reference's band count baked into its formula;
    it stays 4 for other ``channels`` so ``cr`` keeps the reference's meaning.
    """
    return int((patch_size * patch_size * 4 / cr) // 256) * 256


@dataclasses.dataclass(frozen=True)
class CondSRVAEConfig:
    """Conditional SR-VAE. ``patch_size`` is the high-resolution patch edge;
    the low-resolution input patch is ``patch_size // 2`` (2x SR)."""

    cr: float = 1.2
    patch_size: int = 64
    channels: int = 4
    # The reference's C-major Flatten/Unflatten latent regrouping instead of
    # the structure-preserving pixel shuffle (needed for converted reference
    # checkpoints); same parameters either way.
    torch_regroup: bool = False
    # Fixed latent budget overriding the cr formula when > 0; a positive
    # multiple of 256 so both latent regroupings stay integral.
    latent_size_override: int = 0

    def __post_init__(self) -> None:
        if self.latent_size_override and (
            self.latent_size_override < 0 or self.latent_size_override % 256
        ):
            raise ValueError(
                "latent_size_override must be a positive multiple of 256 "
                f"(got {self.latent_size_override})"
            )

    @property
    def lr_patch_size(self) -> int:
        return self.patch_size // 2

    @property
    def latent_size(self) -> int:
        if self.latent_size_override > 0:
            return self.latent_size_override
        return _cond_latent_size(self.patch_size, self.cr)

    @property
    def latent_size_y(self) -> int:
        return self.latent_size // 4

    @property
    def z_channels(self) -> int:
        """Channels of z, which lives on a (ps/8, ps/8) grid."""
        return self.latent_size // 64

    @property
    def z_spatial(self) -> int:
        return self.patch_size // 8

    @property
    def u_channels(self) -> int:
        """Channels of u, which lives on a (ps/8, ps/8) grid of the LR encoder."""
        return self.latent_size_y // 64

    @property
    def u_spatial(self) -> int:
        return self.patch_size // 8
