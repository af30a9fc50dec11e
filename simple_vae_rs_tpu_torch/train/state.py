"""The training step's optimizer (port of the JAX package's ``train/state.py``
``make_optimizer``): a global-norm clip, then Adam.

It is ``optax.chain(clip_by_global_norm(max_norm), scale_by_adam(b1, b2,
eps))`` over a list of tensors, written with PyTorch's multi-tensor
(``_foreach``) ops: ``update`` returns the transformed updates ``u`` and the
caller applies ``p <- p - lr * u``, so the learning rate can change per call
without touching the optimizer state (as the JAX engine does for its plateau
scheduler). The clip and the step stay on the device: no host sync.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from simple_vae_rs_tpu_torch.config import TrainConfig

Tensor = torch.Tensor


class ClipAdam:
    """Global-norm clip to ``max_norm``, then Adam (optax ``scale_by_adam``
    with ``eps_root=0``, moments in float32)."""

    def __init__(self, params: Sequence[Tensor], max_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    @staticmethod
    def global_norm(grads: Sequence[Tensor]) -> Tensor:
        """``sqrt(sum_leaves sum(g^2))`` as a 0-dim tensor on the grads' device."""
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))

    def clip(self, grads: Sequence[Tensor]) -> List[Tensor]:
        """optax ``clip_by_global_norm``: ``g * max_norm / |g|`` when
        ``|g| >= max_norm``, else ``g`` (no ``+1e-6`` in the denominator, unlike
        ``torch.nn.utils.clip_grad_norm_``)."""
        norm = self.global_norm(grads)
        factor = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        return torch._foreach_mul(list(grads), factor)

    def _bias_correction(self, decay: float) -> float:
        # optax computes 1 - decay**count in float32
        return float(np.float32(1.0) - np.float32(decay) ** np.float32(self.count))

    @torch.no_grad()
    def update(self, grads: Sequence[Tensor]) -> List[Tensor]:
        """Clip, advance the moments, and return ``m_hat / (sqrt(v_hat) + eps)``."""
        g = self.clip(grads)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        self.count += 1
        denom = torch._foreach_div(self.nu, self._bias_correction(self.b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(self.mu, self._bias_correction(self.b1))
        torch._foreach_div_(updates, denom)
        return updates


def make_optimizer(cfg: TrainConfig, params: Sequence[Tensor]) -> ClipAdam:
    """Global-norm clip ``cfg.grad_clip_norm`` -> Adam (b1 0.9, b2 0.999,
    eps 1e-8), as the JAX package's ``make_optimizer``."""
    return ClipAdam(params, max_norm=cfg.grad_clip_norm)
