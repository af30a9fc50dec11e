"""Configuration of the PyTorch port: its own copies of the JAX package's
``VAEConfig`` and ``CondSRVAEConfig`` (the same latent-size formulas) and of
the fields of ``TrainConfig`` that the training step and the epoch loop
read."""

from __future__ import annotations

import dataclasses


def _vae_latent_size(patch_size: int, cr: float) -> int:
    """Latent size of the plain VAE (reference ``models/vae.py:29-31``): note
    the floor division by ``cr`` before the one by 16, which
    :func:`_cond_latent_size` does not have. The literal ``4`` is the
    reference's band count, as there."""
    return int((patch_size * patch_size * 4 // cr) // 16) * 16


def _cond_latent_size(patch_size: int, cr: float) -> int:
    """Latent size of Cond_SRVAE (reference ``models/cond_vae.py:21``).

    The literal ``4`` is the reference's band count baked into its formula;
    it stays 4 for other ``channels`` so ``cr`` keeps the reference's meaning.
    """
    return int((patch_size * patch_size * 4 / cr) // 256) * 256


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Plain Gaussian VAE. ``latent_size`` reproduces the reference's
    attribute; the flattened latent dimension the encoder really has is
    ``latent_dim``, which equals it only at canonical configurations."""

    cr: float = 1.5
    patch_size: int = 32
    channels: int = 4
    # Fixed latent budget overriding the cr formula when > 0; a positive
    # multiple of 64 so the (ps/4)-grid channel count stays integral.
    latent_size_override: int = 0

    def __post_init__(self) -> None:
        if self.latent_size_override and (
            self.latent_size_override < 0 or self.latent_size_override % 64
        ):
            raise ValueError(
                "latent_size_override must be a positive multiple of 64 "
                f"(got {self.latent_size_override})"
            )

    @property
    def latent_size(self) -> int:
        if self.latent_size_override > 0:
            return self.latent_size_override
        return _vae_latent_size(self.patch_size, self.cr)

    @property
    def latent_channels(self) -> int:
        return self.latent_size // 64

    @property
    def latent_spatial(self) -> int:
        return self.patch_size // 4

    @property
    def latent_dim(self) -> int:
        """Flattened latent dimension of the encoder graph."""
        return self.latent_channels * self.latent_spatial**2


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
    """The training step's and the epoch loop's hyper-parameters (JAX
    ``TrainConfig`` defaults).

    ``use_bfloat16`` is recorded, as in the JAX package: the model's
    ``dtype`` (``CondSRVAE(cfg, dtype=torch.bfloat16)``) is what computes in
    bfloat16, and a caller sets both from one flag. ``bf16_moments`` keeps
    Adam's first moment in bfloat16 (optax ``mu_dtype``). The JAX config's
    ``zero1``, ``scan_steps`` and ``train_elbo`` do not exist here.
    """

    epochs: int = 200
    learning_rate: float = 1e-4
    grad_clip_norm: float = 1.0
    # ReduceLROnPlateau on the val loss (reference models/base.py:51-53)
    plateau_factor: float = 0.5
    plateau_patience: int = 500
    # EarlyStopping (reference train.py:32), for a caller that builds one
    early_stop_patience: int = 25
    early_stop_delta: float = 0.01
    # SSIM/PSNR/LPIPS over the val set every this many epochs (and at the
    # first and the last)
    val_metrics_every: int = 5
    seed: int = 0
    batch_size: int = 16  # tiles per loader batch; a step takes the batch it is given
    # microbatches per optimizer update: grads and loss terms averaged,
    # BatchNorm statistics threaded through them in order
    accum_steps: int = 1
    # numerical policy, recorded: the model's dtype computes the convs in bf16
    use_bfloat16: bool = False
    # Adam's first moment stored in bf16 (second moment float32)
    bf16_moments: bool = False
    # a torch.profiler trace of the second trained epoch (or the only one)
    # is written here
    profile_dir: str = ""
    # recompute each microbatch's forward during the backward instead of
    # keeping its activations (torch.utils.checkpoint)
    remat: bool = False

    def __post_init__(self) -> None:
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1 (got {self.accum_steps})")
        if not self.grad_clip_norm > 0:
            raise ValueError(f"grad_clip_norm must be > 0 (got {self.grad_clip_norm})")
