"""Plain reference of the training step: the patches cut from the tiles and
normalized, the loss (``models.cond_loss`` / ``models.vae_loss``), its gradient by
autograd, a clip of the global norm, then Adam (b1 0.9, b2 0.999, eps
1e-8, no eps inside the root, bias-corrected; the clip ``g * max / |g|``
where ``|g| >= max``), ``p <- p - lr * update``. Float32 with TF32 off.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from . import models

Tensor = torch.Tensor


def normalize(t: Tensor) -> Tensor:
    """Min-max per image and channel over (H, W) of an NHWC batch, with the
    reference's ``+1e-5`` in the denominator."""
    lo = t.amin(dim=(1, 2), keepdim=True)
    hi = t.amax(dim=(1, 2), keepdim=True)
    return (t - lo) / (hi - lo + 1e-5)


def grid_patches(tiles: Tensor, patch: int) -> Tensor:
    """(T, H, W, C) -> (T * (H/p) * (W/p), p, p, C), row-major in a tile."""
    t, h, w, c = tiles.shape
    x = tiles.reshape(t, h // patch, patch, w // patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, patch, patch, c)


class tf32_off:
    """TF32 off for float32 convs and matmuls on the card, within the block."""

    def __enter__(self):
        self.prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.prev


class ClipAdam:
    def __init__(self, params: Sequence[Tensor], max_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params: Sequence[Tensor], grads: Sequence[Tensor], lr: float) -> None:
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)).float()
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            g = g * factor
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


def run_steps(names: Sequence[str], loss: Callable, params: Dict[str, Tensor], batches, noises,
              lr: float, max_norm: float, rounding: models.Rounding = models.F32,
              moment_after: int = 1) -> Dict[str, object]:
    """Train ``len(batches)`` steps of the leaves ``names`` from ``params``
    (copied, not changed): each batch a list of streams, each noise the
    list of that step's draws, and ``loss(params, streams, noise, rounding,
    stats)`` the model's terms (BatchNorm on batch statistics, its running
    ones updated in ``stats``). Returns each step's terms (floats), the
    first moment of every trainable leaf after ``moment_after`` steps, the
    leaves after the last step, and the norm of each leaf's first gradient."""
    p = {k: v.detach().clone() for k, v in params.items()}
    leaves = [p[n] for n in names]
    for t in leaves:
        t.requires_grad_(True)
    opt = ClipAdam(leaves, max_norm=max_norm)
    stats = {k: v for k, v in p.items() if k.endswith((".mean", ".var"))}
    terms_seen: List[Dict[str, float]] = []
    moments: Dict[str, Tensor] = {}
    for i, (streams, eps) in enumerate(zip(batches, noises)):
        terms = loss(p, streams, eps, rounding, stats)
        grads = torch.autograd.grad(terms["loss"], leaves)
        if i == 0:
            first = torch.stack([g.double().norm() for g in grads]).cpu().tolist()
            first_grad_norms = dict(zip(names, first))
        opt.step(leaves, grads, lr)
        terms_seen.append({k: float(v.detach()) for k, v in terms.items()})
        del terms, grads
        if i + 1 == moment_after:
            moments = {n: m.clone() for n, m in zip(names, opt.mu)}
    return {"terms": terms_seen, "moments": moments, "first_grad_norms": first_grad_norms,
            "params": {n: t.detach() for n, t in zip(names, leaves)}}
