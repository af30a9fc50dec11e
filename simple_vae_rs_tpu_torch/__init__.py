"""PyTorch/CUDA port of simple_vae_rs_tpu: the Cond_SRVAE, SRVAE and VAE
models, serving (float32, int8, chained tails; from a checkpoint) and the
training run (steps, evaluation, checkpoints, the epoch loop).

Imports torch and numpy only; the JAX package is its reference, held against
it by the tests. Entry points run on a CUDA card unless given device="cpu".
"""

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig, VAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.ops.conv_blocks import use_chain, use_plain_path
from simple_vae_rs_tpu_torch.ops.patchify import grid_sr_batch
from simple_vae_rs_tpu_torch.serve import SuperResolver, warmup
from simple_vae_rs_tpu_torch.train.engine import Trainer

__all__ = ["CondSRVAEConfig", "CondSRVAE", "SRVAE", "SuperResolver", "TrainConfig", "Trainer",
           "VAE", "VAEConfig", "grid_sr_batch", "use_chain", "use_plain_path", "warmup"]
