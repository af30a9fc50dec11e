"""Training step of the port (the JAX package's ``train/engine.py``:
``_loss_and_terms_inner`` for its three kinds of model, ``_micro_grads``,
``accum_grads``, ``train_step`` and ``val_step``).

    model = CondSRVAE(CondSRVAEConfig(), device="cuda").init_weights(0)
    trainer = Trainer(model, TrainConfig())           # device="cuda" by default
    lr, hr = grid_sr_batch(lr_tiles, hr_tiles, 64)    # on the card
    terms = trainer.train_step((lr, hr), lr=1e-4)     # loss, mse_x, kld_u, mse_y, kld_z
    val = trainer.val_step((lr, hr))

A batch is ``(y, x)``: LR patches (B, ps/2, ps/2, C) and HR patches
(B, ps, ps, C), as the JAX engine takes them. A Cond_SRVAE trains on both; an
SRVAE on the HR stream ``batch[-1]`` alone (its LR view is internal), with the
same five terms; a VAE on the LR stream ``batch[0]``, with the terms ``loss,
mse, kld``. A step runs the model in
``train()`` mode (BatchNorm with batch statistics, running statistics
updated in place), the four ELBO terms through the row kernels, the backward
through the conv kernels' input gradients, then the clip and Adam. Loss terms
come back as 0-dim float32 tensors on the trainer's device (no host sync). A
val step runs in ``eval()`` mode, so on a model whose chain is switched on
(``ops/conv_blocks.use_chain``) its conv tails run through the chain kernel.

A bfloat16 model (``dtype=torch.bfloat16``) trains the same way: the batch
stays float32 (the model casts it), the loss is float32, and the gradients
reach the float32 parameters in float32; ``TrainConfig.bf16_moments``
keeps Adam's first moment in bfloat16.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from simple_vae_rs_tpu_torch.config import TrainConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.ops.fused_elbo import fused_base_loss, fused_cond_loss
from simple_vae_rs_tpu_torch.serve import resolve_device
from simple_vae_rs_tpu_torch.train.state import make_optimizer

Tensor = torch.Tensor
Noise = Tuple[Tensor, ...]  # (eps_u, eps_z), or (eps,) for a VAE
TERMS = ("loss", "mse_x", "kld_u", "mse_y", "kld_z")
VAE_TERMS = ("loss", "mse", "kld")
KINDS = {CondSRVAE: "cond", SRVAE: "srvae", VAE: "vae"}
_VAL_STREAM = 0xFFF1  # the JAX val_step's fold_in constant


class Trainer:
    """Optimizer state and the train/val steps of one CondSRVAE, SRVAE or
    VAE (``kind``: "cond", "srvae" or "vae").

    Noise: each train step draws ``(eps_u, eps_z)`` (a VAE: ``(eps,)``,
    shaped (B, latent_dim)) per microbatch from the
    trainer's generator (seeded with ``seed``, default ``cfg.seed``), unless
    ``eps`` passes them in. A val step draws the same noise every call, from
    a generator of its own (the JAX val step folds a fixed key too).
    """

    def __init__(self, model, cfg: Optional[TrainConfig] = None, device="cuda",
                 seed: Optional[int] = None) -> None:
        if type(model) not in KINDS:
            raise TypeError("Trainer trains CondSRVAE, SRVAE and VAE models")
        self.kind = KINDS[type(model)]
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
    def _batch(self, batch) -> Tuple[Tensor, ...]:
        """The streams the model trains on, on the device: ``(y, x)`` for a
        Cond_SRVAE, ``(x,)`` (HR) for an SRVAE, ``(y,)`` (LR) for a VAE."""
        batch = tuple(batch)
        if self.kind == "srvae":
            batch = batch[-1:]
        elif self.kind == "vae":
            batch = batch[:1]
        batch = tuple(torch.as_tensor(t).to(self.device, torch.float32).contiguous()
                      for t in batch)
        if self.kind == "cond" and (len(batch) != 2 or batch[0].shape[0] != batch[1].shape[0]):
            raise ValueError("a Cond_SRVAE batch is (LR, HR) of one length, got shapes "
                             f"{[tuple(t.shape) for t in batch]}")
        return batch

    def noise(self, batch: int, hw, generator: torch.Generator) -> Noise:
        """The noise of one forward pass on ``batch`` patches of spatial
        ``hw`` (those of the first stream the model trains on)."""
        if self.kind == "vae":
            shapes = [(batch, self.model.config.latent_dim)]
        else:
            shapes = self.model.generation_noise_shapes(batch, tuple(hw))
        return tuple(torch.randn(s, generator=generator, device=self.device) for s in shapes)

    # ------------------------------------------------------------------ loss
    def _loss_and_terms(self, streams: Tuple[Tensor, ...], eps: Noise
                        ) -> Tuple[Tensor, Dict[str, Tensor]]:
        m = self.model
        if self.kind == "vae":
            (x,) = streams
            x_hat, mu, logvar = m(x, *eps)
            mse, kld = fused_base_loss(x_hat, x, mu, logvar, m.gamma, plain=m.plain)
            loss = mse + kld
            return loss, dict(zip(VAE_TERMS, (loss, mse, kld)))
        if self.kind == "srvae":
            (x,) = streams
            x_hat, y_hat, mu_z, lv_z, mu_u, lv_u, mu_p, lv_p, y = m(x, *eps)
            core = m.core
        else:
            y, x = streams
            x_hat, y_hat, mu_z, lv_z, mu_u, lv_u, mu_p, lv_p = m(x, y, *eps)
            core = m
        mse_x, kld_u, mse_y, kld_z = fused_cond_loss(
            x_hat, x, y_hat, y, mu_u, lv_u, mu_z, lv_z, mu_p, lv_p, core.gammax, core.gammay,
            plain=m.plain)
        loss = mse_x + kld_u + mse_y + kld_z
        return loss, dict(zip(TERMS, (loss, mse_x, kld_u, mse_y, kld_z)))

    def grads_and_terms(self, batch, eps: Optional[Sequence] = None
                        ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """Forward and backward in training mode (JAX ``_micro_grads``, or
        ``accum_grads`` over ``cfg.accum_steps`` equal microbatches): the
        gradient of every parameter by name and the loss terms, both averaged
        over the microbatches. Updates the BatchNorm running statistics,
        microbatch after microbatch. ``eps`` is the noise of one forward pass
        (a tuple of tensors, see :meth:`noise`), or one such tuple per
        microbatch."""
        streams = self._batch(batch)
        n = streams[0].shape[0]
        accum = self.cfg.accum_steps
        if n % accum:
            raise ValueError(f"batch size {n} not divisible by accum_steps {accum}")
        mb = n // accum
        if eps is None:
            eps = [self.noise(mb, streams[0].shape[1:3], self._rng) for _ in range(accum)]
        elif isinstance(eps[0], Tensor):
            eps = [eps]
        if len(eps) != accum:
            raise ValueError(f"eps holds {len(eps)} noise tuples for {accum} microbatches")
        self.model.train()
        params = list(self.params.values())
        gsum: Optional[list] = None
        tsum: Dict[str, Tensor] = {}
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            loss, terms = self._loss_and_terms(tuple(t[sl] for t in streams), eps[i])
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
        streams = self._batch(batch)
        if eps is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed + _VAL_STREAM)
            eps = self.noise(streams[0].shape[0], streams[0].shape[1:3], gen)
        self.model.eval()
        return self._loss_and_terms(streams, eps)[1]
