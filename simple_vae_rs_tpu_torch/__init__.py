"""PyTorch/CUDA port of simple_vae_rs_tpu: the Cond_SRVAE, SRVAE and VAE
models, serving (float32, int8, chained tails; from a checkpoint; whole
rasters, the ``raster`` command and the HTTP server; ``torch.export``
artifacts), the training run (steps, evaluation, checkpoints, the epoch
loop) and the checkpoint and data tools (``make_index``,
``convert_checkpoint``).

Imports torch and numpy only; the JAX package is its reference, held against
it by the tests. Entry points run on a CUDA card unless given device="cpu".
The names below load on first use, so the numpy-only modules (``client``,
``tiling``, ``wire``) import without torch.
"""

import importlib

_EXPORTS = {
    "CondSRVAEConfig": "config", "TrainConfig": "config", "VAEConfig": "config",
    "CondSRVAE": "models.cond_vae", "SRVAE": "models.srvae", "VAE": "models.vae",
    "use_chain": "ops.conv_blocks", "use_plain_path": "ops.conv_blocks",
    "grid_sr_batch": "ops.patchify",
    "SuperResolver": "serve", "warmup": "serve",
    "Trainer": "train.engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
