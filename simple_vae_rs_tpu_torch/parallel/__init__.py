from simple_vae_rs_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    param_shardings,
    replicate,
    shard_batch,
    shard_model,
    unshard_model,
)

__all__ = ["Mesh", "make_mesh", "replicate", "shard_batch", "param_shardings", "shard_model",
           "unshard_model"]
