"""The tiling names where the JAX package's ``ops/tiling.py`` re-exports
them: the logic lives in ``simple_vae_rs_tpu_torch.tiling`` (numpy only, so
the HTTP client imports without torch)."""

from simple_vae_rs_tpu_torch.tiling import (  # noqa: F401
    TileEndpoints,
    feather_profile,
    grid_starts,
    stitch,
    subseed,
)

__all__ = ["grid_starts", "feather_profile", "stitch", "subseed", "TileEndpoints"]
