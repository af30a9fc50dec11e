"""PyTorch/CUDA port of simple_vae_rs_tpu (Cond_SRVAE serving path).

Imports torch and numpy only; the JAX package is its reference, held against
it by the tests. Entry points run on a CUDA card unless given device="cpu".
"""

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.serve import SuperResolver, warmup

__all__ = ["CondSRVAEConfig", "CondSRVAE", "SuperResolver", "warmup"]
