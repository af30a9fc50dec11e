"""PyTorch/CUDA port of simple_vae_rs_tpu (Cond_SRVAE serving and training step).

Imports torch and numpy only; the JAX package is its reference, held against
it by the tests. Entry points run on a CUDA card unless given device="cpu".
"""

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.ops.patchify import grid_sr_batch
from simple_vae_rs_tpu_torch.serve import SuperResolver, warmup
from simple_vae_rs_tpu_torch.train.engine import Trainer

__all__ = ["CondSRVAEConfig", "CondSRVAE", "SuperResolver", "TrainConfig", "Trainer",
           "grid_sr_batch", "warmup"]
