"""Training step of the port (the Cond_SRVAE branch of the JAX package's
``train/engine.py``: ``_loss_and_terms_inner``, ``_micro_grads``,
``accum_grads``, ``train_step`` and ``val_step``).

    model = CondSRVAE(CondSRVAEConfig(), device="cuda").init_weights(0)
    trainer = Trainer(model, TrainConfig())           # device="cuda" by default
    lr, hr = grid_sr_batch(lr_tiles, hr_tiles, 64)    # on the card
    terms = trainer.train_step((lr, hr), lr=1e-4)     # loss, mse_x, kld_u, mse_y, kld_z
    val = trainer.val_step((lr, hr))

A batch is ``(y, x)``: LR patches (B, ps/2, ps/2, C) and HR patches
(B, ps, ps, C), as the JAX engine takes them. A step runs the model in
``train()`` mode (BatchNorm with batch statistics, running statistics
updated in place), the four ELBO terms through the row kernels, the backward
through the conv kernels' input gradients, then the clip and Adam. Loss terms
come back as 0-dim float32 tensors on the trainer's device (no host sync).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from simple_vae_rs_tpu_torch.config import TrainConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.ops.fused_elbo import fused_cond_loss
from simple_vae_rs_tpu_torch.serve import resolve_device
from simple_vae_rs_tpu_torch.train.state import make_optimizer

Tensor = torch.Tensor
Noise = Tuple[Tensor, Tensor]
TERMS = ("loss", "mse_x", "kld_u", "mse_y", "kld_z")
_VAL_STREAM = 0xFFF1  # the JAX val_step's fold_in constant


class Trainer:
    """Optimizer state and the train/val steps of one CondSRVAE.

    Noise: each train step draws ``(eps_u, eps_z)`` per microbatch from the
    trainer's generator (seeded with ``seed``, default ``cfg.seed``), unless
    ``eps`` passes them in. A val step draws the same noise every call, from
    a generator of its own (the JAX val step folds a fixed key too).
    """

    def __init__(self, model: CondSRVAE, cfg: Optional[TrainConfig] = None, device="cuda",
                 seed: Optional[int] = None) -> None:
        if not isinstance(model, CondSRVAE):
            raise TypeError("Trainer trains CondSRVAE models")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg or TrainConfig()
        self.seed = self.cfg.seed if seed is None else int(seed)
        self.params: Dict[str, Tensor] = dict(self.model.named_parameters())
        self.opt = make_optimizer(self.cfg, list(self.params.values()))
        self.step = 0
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(self.seed)

    # ---------------------------------------------------------------- inputs
    def _batch(self, batch) -> Tuple[Tensor, Tensor]:
        y, x = (torch.as_tensor(t).to(self.device, torch.float32).contiguous() for t in batch)
        if y.shape[0] != x.shape[0]:
            raise ValueError(f"LR and HR batches differ: {tuple(y.shape)} vs {tuple(x.shape)}")
        return y, x

    def noise(self, batch: int, lr_hw, generator: torch.Generator) -> Noise:
        """``(eps_u, eps_z)`` for ``batch`` LR patches of spatial ``lr_hw``."""
        shape_u, shape_z = self.model.generation_noise_shapes(batch, tuple(lr_hw))
        return (torch.randn(shape_u, generator=generator, device=self.device),
                torch.randn(shape_z, generator=generator, device=self.device))

    # ------------------------------------------------------------------ loss
    def _loss_and_terms(self, y: Tensor, x: Tensor, eps: Noise) -> Tuple[Tensor, Dict[str, Tensor]]:
        m = self.model
        x_hat, y_hat, mu_z, lv_z, mu_u, lv_u, mu_p, lv_p = m(x, y, *eps)
        mse_x, kld_u, mse_y, kld_z = fused_cond_loss(
            x_hat, x, y_hat, y, mu_u, lv_u, mu_z, lv_z, mu_p, lv_p, m.gammax, m.gammay,
            plain=m.plain)
        loss = mse_x + kld_u + mse_y + kld_z
        return loss, dict(zip(TERMS, (loss, mse_x, kld_u, mse_y, kld_z)))

    def grads_and_terms(self, batch, eps: Optional[Sequence] = None
                        ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """Forward and backward in training mode (JAX ``_micro_grads``, or
        ``accum_grads`` over ``cfg.accum_steps`` equal microbatches): the
        gradient of every parameter by name and the loss terms, both averaged
        over the microbatches. Updates the BatchNorm running statistics,
        microbatch after microbatch. ``eps`` is one ``(eps_u, eps_z)`` pair,
        or one pair per microbatch."""
        y, x = self._batch(batch)
        accum = self.cfg.accum_steps
        if y.shape[0] % accum:
            raise ValueError(f"batch size {y.shape[0]} not divisible by accum_steps {accum}")
        mb = y.shape[0] // accum
        if eps is None:
            eps = [self.noise(mb, y.shape[1:3], self._rng) for _ in range(accum)]
        elif isinstance(eps[0], Tensor):
            eps = [eps]
        if len(eps) != accum:
            raise ValueError(f"eps holds {len(eps)} noise pairs for {accum} microbatches")
        self.model.train()
        params = list(self.params.values())
        gsum: Optional[list] = None
        tsum: Dict[str, Tensor] = {}
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            loss, terms = self._loss_and_terms(y[sl], x[sl], eps[i])
            grads = torch.autograd.grad(loss, params)
            if gsum is None:
                gsum, tsum = list(grads), {k: v.detach() for k, v in terms.items()}
            else:
                torch._foreach_add_(gsum, grads)
                tsum = {k: tsum[k] + v.detach() for k, v in terms.items()}
        if accum > 1:
            torch._foreach_mul_(gsum, 1.0 / accum)
            tsum = {k: v * (1.0 / accum) for k, v in tsum.items()}
        return dict(zip(self.params, gsum)), tsum

    @torch.no_grad()
    def apply_grads(self, grads: Dict[str, Tensor], lr: float) -> None:
        """Clip + Adam on ``grads``, then ``p <- p - lr * u`` for every parameter."""
        updates = self.opt.update([grads[n] for n in self.params])
        torch._foreach_add_(list(self.params.values()), updates, alpha=-float(lr))
        self.step += 1

    # ----------------------------------------------------------------- steps
    def train_step(self, batch, lr: Optional[float] = None,
                   eps: Optional[Sequence] = None) -> Dict[str, Tensor]:
        """One optimizer step on ``batch`` at learning rate ``lr`` (default
        ``cfg.learning_rate``); returns the loss terms."""
        grads, terms = self.grads_and_terms(batch, eps)
        self.apply_grads(grads, self.cfg.learning_rate if lr is None else lr)
        return terms

    @torch.no_grad()
    def val_step(self, batch, eps: Optional[Noise] = None) -> Dict[str, Tensor]:
        """Loss terms in eval mode (BatchNorm folded from its running
        statistics); no parameter or statistic changes."""
        y, x = self._batch(batch)
        if eps is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed + _VAL_STREAM)
            eps = self.noise(y.shape[0], y.shape[1:3], gen)
        self.model.eval()
        return self._loss_and_terms(y, x, eps)[1]
