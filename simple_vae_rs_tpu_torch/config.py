"""Configuration of the PyTorch port: its own copies of the JAX package's
``CondSRVAEConfig`` (the same latent-size formula) and of the fields of
``TrainConfig`` that a training step reads."""

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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training step's hyper-parameters (JAX ``TrainConfig`` defaults).

    ``use_bfloat16=True`` is not ported yet and raises ``NotImplementedError``;
    the JAX config's other fields (``remat``, ``bf16_moments``, ``zero1``,
    ``scan_steps``, ``train_elbo``, the epoch loop's) do not exist here.
    """

    learning_rate: float = 1e-4
    grad_clip_norm: float = 1.0
    seed: int = 0
    batch_size: int = 16  # tiles per loader batch; a step takes the batch it is given
    # microbatches per optimizer update: grads and loss terms averaged,
    # BatchNorm statistics threaded through them in order
    accum_steps: int = 1
    use_bfloat16: bool = False

    def __post_init__(self) -> None:
        if self.use_bfloat16:
            raise NotImplementedError("use_bfloat16: the port trains in float32 only")
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1 (got {self.accum_steps})")
        if not self.grad_clip_norm > 0:
            raise ValueError(f"grad_clip_norm must be > 0 (got {self.grad_clip_norm})")
