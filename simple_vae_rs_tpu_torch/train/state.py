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
    with ``eps_root=0``). The second moment is float32; the first is float32
    or, with ``mu_dtype=torch.bfloat16`` (``TrainConfig.bf16_moments``),
    stored in bfloat16 in optax's order: the new moment is computed in
    float32 from the stored one (whose decay term ``b1 * mu`` JAX rounds to
    bfloat16, with ``b1`` itself in bfloat16) and the float32 gradient, the
    update uses it, and only then is it rounded to bfloat16 and stored."""

    def __init__(self, params: Sequence[Tensor], max_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.float32) -> None:
        if mu_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"mu_dtype must be float32 or bfloat16, got {mu_dtype}")
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self.mu_dtype = mu_dtype
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in params]
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
        if self.mu_dtype == torch.float32:
            mu = self.mu
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        else:
            # optax: (1 - b1) * g + b1 * mu, where b1 * mu is bfloat16 math;
            # multi-tensor ops throughout (a loop over the leaves costs a
            # launch per leaf and operation)
            b1 = torch.tensor(self.b1, dtype=self.mu_dtype, device=g[0].device)
            decayed = [torch.empty_like(m, dtype=torch.float32) for m in self.mu]
            torch._foreach_copy_(decayed, torch._foreach_mul(self.mu, b1))
            mu = torch._foreach_mul(g, 1.0 - self.b1)
            torch._foreach_add_(mu, decayed)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        self.count += 1
        denom = torch._foreach_div(self.nu, self._bias_correction(self.b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, self._bias_correction(self.b1))
        torch._foreach_div_(updates, denom)
        if self.mu_dtype != torch.float32:
            torch._foreach_copy_(self.mu, mu)  # rounded to bfloat16, to nearest even
        return updates

    def state_dict(self) -> dict:
        """The moments (``mu`` in its ``mu_dtype``), as lists in parameter
        order, and the step count."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` in, from any device onto this optimizer's.
        Raises ``ValueError`` when the moments' number, shapes or dtypes
        differ (a bfloat16 first moment does not load into a float32 one, nor
        back)."""
        for key, mine in (("mu", self.mu), ("nu", self.nu)):
            theirs = state[key]
            if len(theirs) != len(mine):
                raise ValueError(f"{key}: {len(theirs)} moments for {len(mine)} parameters")
            for i, (m, t) in enumerate(zip(mine, theirs)):
                if t.shape != m.shape or t.dtype != m.dtype:
                    raise ValueError(f"{key}[{i}]: {tuple(t.shape)} {t.dtype} does not match "
                                     f"{tuple(m.shape)} {m.dtype}")
            for m, t in zip(mine, theirs):
                m.copy_(t)
        self.count = int(state["count"])


def make_optimizer(cfg: TrainConfig, params: Sequence[Tensor]) -> ClipAdam:
    """Global-norm clip ``cfg.grad_clip_norm`` -> Adam (b1 0.9, b2 0.999,
    eps 1e-8; the first moment in bfloat16 with ``cfg.bf16_moments``), as
    the JAX package's ``make_optimizer``."""
    return ClipAdam(params, max_norm=cfg.grad_clip_norm,
                    mu_dtype=torch.bfloat16 if cfg.bf16_moments else torch.float32)
