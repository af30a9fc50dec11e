"""Training engine of the port (the JAX package's ``train/engine.py``): the
train and val steps, evaluation, LR-branch pre-training and the epoch loop.

    model = CondSRVAE(CondSRVAEConfig(), device="cuda").init_weights(0)
    trainer = Trainer(model, TrainConfig(), callbacks=[ModelCheckpoint("job", "ckpt")],
                      logger=JsonlLogger("runs/job"))    # device="cuda" by default
    lr, hr = grid_sr_batch(lr_tiles, hr_tiles, 64)       # on the card
    terms = trainer.train_step((lr, hr), lr=1e-4)        # loss, mse_x, kld_u, mse_y, kld_z
    val = trainer.val_step((lr, hr))
    trainer.pretrain_lr_branch(train_loader, pre_epochs=1)
    trainer.fit(train_loader, val_loader, epochs=200)    # any iterables of (LR, HR) batches

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
With ``TrainConfig.remat`` each microbatch's forward is recomputed during the
backward (``torch.utils.checkpoint``) and the recomputation leaves the
BatchNorm running statistics alone.

A bfloat16 model (``dtype=torch.bfloat16``) trains the same way: the batch
stays float32 (the model casts it), the loss is float32, and the gradients
reach the float32 parameters in float32; ``TrainConfig.bf16_moments``
keeps Adam's first moment in bfloat16.

``fit`` keeps the JAX epoch loop's order and metric names: the bicubic
baseline once, then per epoch the callbacks' begin, the train loop at the
plateau scheduler's lr (terms averaged over the steps, one host sync),
``Perf/train_epoch_seconds``, the NaN abort, the gammas and lr, the val loop,
``evaluate`` on its cadence (SSIM/PSNR, LPIPS where weights are on disk,
images), the scheduler, the callbacks' end; SIGTERM finishes the epoch and
writes ``<save_path>/<job_id>_preempt``. Not ported: ``scan_steps`` and its
dispatch probe.

Noise: every draw goes through :meth:`Trainer.stream_noise`. Train and
pre-training steps draw from the trainer's generator (seeded with ``seed``,
default ``cfg.seed``; saved in a checkpoint); the val, eval-metrics and
eval-image steps draw the same noise on every call, each from a generator of
its own seeded with ``seed`` plus the JAX engine's fold-in constant for that
stream (0xFFF1, 0xFFF2, 0xFFF3). An eval-metrics or eval-image step uses one
draw for both the forward and the super-resolution pass, as the JAX steps do
(one key for both).
"""

from __future__ import annotations

import contextlib
import functools
import os
import signal
import sys
import time
from math import isnan
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from simple_vae_rs_tpu_torch.config import TrainConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE, box_downsample_2x
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.ops.conv_blocks import frozen_statistics
from simple_vae_rs_tpu_torch.ops.fused_elbo import fused_base_loss, fused_cond_loss
from simple_vae_rs_tpu_torch.ops.metrics import psnr, ssim
from simple_vae_rs_tpu_torch.ops.resize import bicubic_upsample_2x
from simple_vae_rs_tpu_torch.serve import resolve_device
from simple_vae_rs_tpu_torch.train.callbacks import Callback, ModelCheckpoint
from simple_vae_rs_tpu_torch.train.checkpoint import save_checkpoint, wait_for_saves
from simple_vae_rs_tpu_torch.train.schedule import ReduceLROnPlateau
from simple_vae_rs_tpu_torch.train.state import make_optimizer
from simple_vae_rs_tpu_torch.utils import lpips_optional
from simple_vae_rs_tpu_torch.utils.logging import Logger, NullLogger

Tensor = torch.Tensor
Noise = Tuple[Tensor, ...]  # (eps_u, eps_z), or (eps,) for a VAE
TERMS = ("loss", "mse_x", "kld_u", "mse_y", "kld_z")
VAE_TERMS = ("loss", "mse", "kld")
KINDS = {CondSRVAE: "cond", SRVAE: "srvae", VAE: "vae"}
# the JAX engine's fold-in constants of the eval streams
_STREAMS = {"val": 0xFFF1, "metrics": 0xFFF2, "images": 0xFFF3}
EVAL_IMAGES = 4  # images per eval-image step (the first of the batch)
PRETRAIN_KEY = "Loss/pretrain_y_loss"


def _fit_keys(kind: str) -> Tuple[str, ...]:
    terms = VAE_TERMS if kind == "vae" else TERMS
    gammas = (("HyperParameters/Gamma",) if kind == "vae"
              else ("HyperParameters/Gamma_X", "HyperParameters/Gamma_Y"))
    metrics = (("Metrics/SSIM_LR", "Metrics/SSIM_HR", "Metrics/SSIM_SR", "Metrics/PSNR_SR",
                "Metrics/SSIM_Baseline", "Metrics/PSNR_Baseline") if kind == "cond"
               else ("Metrics/SSIM", "Metrics/PSNR"))
    return (tuple("Loss/" + t for t in terms) + ("Perf/train_epoch_seconds",) + gammas
            + ("HyperParameters/Learning Rate",) + tuple("Loss/val_" + t for t in terms)
            + metrics)


# The metric names a JAX fit logs for each kind of model, with a full
# evaluation and no LPIPS weights on disk; pre-training adds PRETRAIN_KEY
# and LPIPS weights add LPIPS_KEYS.
FIT_KEYS = {kind: _fit_keys(kind) for kind in ("cond", "srvae", "vae")}
LPIPS_KEYS = {"cond": ("Metrics/LPIPS_LR", "Metrics/LPIPS_HR", "Metrics/LPIPS_SR",
                       "Metrics/LPIPS_Baseline"),
              "srvae": ("Metrics/LPIPS",), "vae": ("Metrics/LPIPS",)}
_META_NAMES = {CondSRVAE: "Cond_SRVAE", SRVAE: "SRVAE", VAE: "VAE"}


def _host(values: Dict[str, Any]) -> Dict[str, float]:
    """``values`` (0-dim tensors on one device, or numbers) as Python floats,
    in one device-to-host copy."""
    keys = [k for k, v in values.items() if isinstance(v, Tensor)]
    out = {k: float(v) for k, v in values.items() if not isinstance(v, Tensor)}
    if keys:
        out.update(zip(keys, torch.stack([values[k].float() for k in keys]).tolist()))
    return out


def _add(acc: Dict[str, Any], part: Dict[str, Any]) -> Dict[str, Any]:
    return dict(part) if not acc else {k: acc[k] + v for k, v in part.items()}


class Trainer:
    """Optimizer state, the steps and the epoch loop of one CondSRVAE, SRVAE
    or VAE (``kind``: "cond", "srvae" or "vae").

    ``callbacks`` get ``on_epoch_begin`` / ``on_epoch_end`` (True stops),
    ``logger`` every metric (``utils/logging``; none by default), ``job_id``
    names the preemption checkpoint. The plateau ``scheduler`` is made from
    the config. ``baseline_metrics`` holds the bicubic baseline once ``fit``
    has computed it.
    """

    def __init__(self, model, cfg: Optional[TrainConfig] = None, device="cuda",
                 seed: Optional[int] = None, callbacks: Sequence[Callback] = (),
                 logger: Optional[Logger] = None, job_id: str = "local") -> None:
        if type(model) not in KINDS:
            raise TypeError("Trainer trains CondSRVAE, SRVAE and VAE models")
        self.kind = KINDS[type(model)]
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg = cfg or TrainConfig()
        self.seed = cfg.seed if seed is None else int(seed)
        self.callbacks = list(callbacks)
        self.logger = logger or NullLogger()
        self.job_id = job_id
        self.params: Dict[str, Tensor] = dict(self.model.named_parameters())
        self.opt = make_optimizer(cfg, list(self.params.values()))
        self.scheduler = ReduceLROnPlateau(lr=cfg.learning_rate, factor=cfg.plateau_factor,
                                           patience=cfg.plateau_patience)
        self.step = 0
        self.current_epoch = 0
        self.baseline_metrics: Optional[Dict[str, float]] = None
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(self.seed)
        self._preempted = False

    def _model_meta(self) -> Dict[str, Any]:
        """The model config a checkpoint's meta carries, so that a
        checkpoint path alone rebuilds the network
        (``SuperResolver.from_checkpoint``); the JAX package's keys and
        type names."""
        cfg = self.model.config
        return {
            "type": _META_NAMES[type(self.model)],
            "cr": float(cfg.cr),
            "patch_size": int(cfg.patch_size),
            "channels": int(cfg.channels),
            "latent_size_override": int(getattr(cfg, "latent_size_override", 0)),
            "torch_regroup": bool(getattr(cfg, "torch_regroup", False)),
        }

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

    def stream_noise(self, stream: str, batch: int, hw) -> Noise:
        """The noise of one forward pass of ``stream``: "train" and
        "pretrain" (only ``eps_u``, the LR branch's) from the trainer's
        generator; "val", "metrics" and "images" from a generator seeded anew
        on every call (the same draw each time)."""
        if stream in ("train", "pretrain"):
            gen = self._rng
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed + _STREAMS[stream])
        if stream == "pretrain":
            shape_u = self.model.generation_noise_shapes(batch, tuple(hw))[0]
            return (torch.randn(shape_u, generator=gen, device=self.device),)
        return self.noise(batch, hw, gen)

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

    def _remat_contexts(self):
        # the recomputed forward normalises as the first did but must not
        # move the running statistics again
        return contextlib.nullcontext(), frozen_statistics(self.model)

    def grads_and_terms(self, batch, eps: Optional[Sequence] = None
                        ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """Forward and backward in training mode (JAX ``_micro_grads``, or
        ``accum_grads`` over ``cfg.accum_steps`` equal microbatches): the
        gradient of every parameter by name and the loss terms, both averaged
        over the microbatches. Updates the BatchNorm running statistics,
        microbatch after microbatch, once each (also under ``cfg.remat``).
        ``eps`` is the noise of one forward pass (a tuple of tensors, see
        :meth:`noise`), or one such tuple per microbatch."""
        streams = self._batch(batch)
        n = streams[0].shape[0]
        accum = self.cfg.accum_steps
        if n % accum:
            raise ValueError(f"batch size {n} not divisible by accum_steps {accum}")
        mb = n // accum
        if eps is None:
            eps = [self.stream_noise("train", mb, streams[0].shape[1:3]) for _ in range(accum)]
        elif isinstance(eps[0], Tensor):
            eps = [eps]
        if len(eps) != accum:
            raise ValueError(f"eps holds {len(eps)} noise tuples for {accum} microbatches")
        self.model.train()
        params = list(self.params.values())
        gsum: Optional[list] = None
        tsum: Dict[str, Tensor] = {}
        for i in range(accum):
            micro = tuple(t[i * mb:(i + 1) * mb] for t in streams)
            if self.cfg.remat:
                loss, terms = checkpoint(self._loss_and_terms, micro, tuple(eps[i]),
                                         use_reentrant=False, preserve_rng_state=False,
                                         context_fn=self._remat_contexts)
            else:
                loss, terms = self._loss_and_terms(micro, eps[i])
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
            eps = self.stream_noise("val", streams[0].shape[0], streams[0].shape[1:3])
        self.model.eval()
        return self._loss_and_terms(streams, eps)[1]

    # ------------------------------------------------------- LR pre-training
    def pretrain_step(self, batch, opt, lr: float) -> Tensor:
        """One step of the LR autoencoder alone (JAX ``pre_step``): q(u|y) ->
        p(y|u) on the LR stream (an SRVAE's is the box downsample of its HR
        stream), its loss through ``fused_base_loss`` with ``gammay``, and
        ``opt`` over every parameter, of which only the LR branch's
        (``ey_*``, ``dy_*``, ``gammay``) get a nonzero gradient. Advances
        ``step``; returns the loss."""
        streams = self._batch(batch)
        if self.kind == "srvae":
            y, core = box_downsample_2x(streams[0]).contiguous(), self.model.core
        else:
            y, core = streams[0], self.model
        (eps_u,) = self.stream_noise("pretrain", y.shape[0], y.shape[1:3])
        self.model.train()
        y_hat, mu_u, lv_u = core.lr_autoencode(y, eps_u)
        mse_y, kld_u = fused_base_loss(y_hat, y, mu_u, lv_u, core.gammay, plain=self.model.plain)
        loss = mse_y + kld_u
        params = list(self.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        with torch.no_grad():
            torch._foreach_add_(params, opt.update(grads), alpha=-float(lr))
        self.step += 1
        return loss.detach()

    def pretrain_lr_branch(self, train_loader: Iterable, pre_epochs: int) -> None:
        """Stage 1: ``pre_epochs`` passes of :meth:`pretrain_step` over
        ``train_loader`` with a throwaway optimizer (the main run starts with
        fresh Adam state), logging ``Loss/pretrain_y_loss`` (the last step's)
        per pre-epoch. A VAE has no LR branch: nothing happens."""
        if self.kind not in ("cond", "srvae") or pre_epochs <= 0:
            return
        opt = make_optimizer(self.cfg, list(self.params.values()))
        lr = self.cfg.learning_rate
        for epoch in range(1, pre_epochs + 1):
            last = None
            for batch in train_loader:
                last = self.pretrain_step(batch, opt, lr)
            loss = float(last) if last is not None else float("nan")
            self.logger.log({PRETRAIN_KEY: loss}, step=epoch)
            print(f"Pre-epoch {epoch}/{pre_epochs}, LR-branch loss: {loss:.4f}")

    # ------------------------------------------------------------ evaluation
    @torch.no_grad()
    def eval_metrics_step(self, batch) -> Dict[str, Any]:
        """Per-batch sums of the evaluation metrics, in eval mode: SSIM and
        PSNR of the reconstruction (a Cond_SRVAE: SSIM of both
        reconstructions, SSIM and PSNR of the super-resolution) and
        ``count``, the number of images."""
        streams = self._batch(batch)
        n = streams[0].shape[0]
        eps = self.stream_noise("metrics", n, streams[0].shape[1:3])
        self.model.eval()
        if self.kind != "cond":
            (x,) = streams
            x_hat = self.model(x, *eps)[0]
            return {"ssim": ssim(x, x_hat).sum(), "psnr": psnr(x, x_hat).sum(), "count": float(n)}
        y, x = streams
        x_hat, y_hat = self.model(x, y, *eps)[:2]
        x_sr = self.model.conditional_generation_eps(y, *eps)
        return {"ssim_y": ssim(y, y_hat).sum(), "ssim_x": ssim(x, x_hat).sum(),
                "ssim_sr": ssim(x, x_sr).sum(), "psnr_sr": psnr(x, x_sr).sum(),
                "count": float(n)}

    @torch.no_grad()
    def eval_images_step(self, batch) -> Dict[str, Tensor]:
        """The image panel of the batch's first :data:`EVAL_IMAGES` images,
        in eval mode, by the reference's names."""
        streams = tuple(t[:EVAL_IMAGES] for t in self._batch(batch))
        eps = self.stream_noise("images", streams[0].shape[0], streams[0].shape[1:3])
        self.model.eval()
        if self.kind != "cond":
            (x,) = streams
            return {"Images/Input": x, "Images/Reconstruction": self.model(x, *eps)[0]}
        y, x = streams
        x_hat, y_hat = self.model(x, y, *eps)[:2]
        return {"Images/LR_Input": y, "Images/HR_Input": x,
                "Images/LR_Bicubic": bicubic_upsample_2x(y), "Images/LR_Recon": y_hat,
                "Images/HR_Recon": x_hat,
                "Images/SR_Output": self.model.conditional_generation_eps(y, *eps)}

    @functools.cached_property
    def _lpips_params(self) -> Optional[Dict[str, Tensor]]:
        """The LPIPS weights on the trainer's device, read once; None
        without a weights file (the LPIPS metrics are then absent)."""
        return lpips_optional.load(self.device)

    @torch.no_grad()
    def compute_bicubic_baseline(self, val_loader) -> Dict[str, float]:
        """Mean SSIM and PSNR of the bicubic 2x upsample of each val LR image
        against its HR image (reference ``cond_vae.py:541-579``, the true
        mean), and its mean LPIPS over the first :data:`EVAL_IMAGES` images
        of each batch where LPIPS weights are on disk. {} for an empty
        loader."""
        lp = self._lpips_params
        sums: Dict[str, Any] = {}
        lp_sum, lp_n = 0.0, 0
        for batch in val_loader:
            y, x = (torch.as_tensor(t).to(self.device, torch.float32) for t in tuple(batch)[:2])
            up = bicubic_upsample_2x(y)
            sums = _add(sums, {"ssim": ssim(x, up).sum(), "psnr": psnr(x, up).sum(),
                               "count": float(x.shape[0])})
            if lp is not None:
                vals = lpips_optional.lpips_batch(x[:EVAL_IMAGES], up[:EVAL_IMAGES], lp)
                if vals is not None:
                    lp_sum, lp_n = lp_sum + vals.sum(), lp_n + len(vals)
        if not sums:
            return {}
        out = _host({**sums, "lpips": lp_sum})
        n = max(out["count"], 1.0)
        base = {"ssim_base": out["ssim"] / n, "psnr_base": out["psnr"] / n}
        if lp_n:
            base["lpips_base"] = out["lpips"] / lp_n
        return base

    def evaluate(self, val_loader, epoch: int, full_val: bool = False) -> None:
        """Full-val metrics, LPIPS and the image panel in one pass over the
        val loader (``full_val``); otherwise only the image panel, on its
        cadence (epoch 1 and every 10th, for a VAE or SRVAE every 5th)."""
        image_cadence = 10 if self.kind == "cond" else 5
        want_images = epoch % image_cadence == 0 or epoch == 1
        if not full_val:
            if want_images:
                self.logger.log_images(self.eval_images_step(next(iter(val_loader))),
                                       step=epoch)
            return
        lp = self._lpips_params
        sums: Dict[str, Any] = {}
        lp_sums: Dict[str, Any] = {}
        lp_counts: Dict[str, int] = {}
        first_images = None
        for batch in val_loader:
            sums = _add(sums, self.eval_metrics_step(batch))
            if lp is not None or (want_images and first_images is None):
                images = self.eval_images_step(batch)
                if first_images is None:
                    first_images = images
                if lp is not None:
                    self._acc_lpips(lp_sums, lp_counts, images, lp)
        if not sums:
            return
        out = _host({**sums, **lp_sums})
        n = max(out.pop("count"), 1.0)
        if self.kind != "cond":
            metrics = {"Metrics/SSIM": out["ssim"] / n, "Metrics/PSNR": out["psnr"] / n}
        else:
            metrics = {"Metrics/SSIM_LR": out["ssim_y"] / n, "Metrics/SSIM_HR": out["ssim_x"] / n,
                       "Metrics/SSIM_SR": out["ssim_sr"] / n, "Metrics/PSNR_SR": out["psnr_sr"] / n}
            if self.baseline_metrics:
                metrics["Metrics/SSIM_Baseline"] = self.baseline_metrics["ssim_base"]
                metrics["Metrics/PSNR_Baseline"] = self.baseline_metrics["psnr_base"]
                if "lpips_base" in self.baseline_metrics:  # reference cond_vae.py:473
                    metrics["Metrics/LPIPS_Baseline"] = self.baseline_metrics["lpips_base"]
        metrics.update({k: out[k] / lp_counts[k] for k in lp_sums if lp_counts[k]})
        self.logger.log(metrics, step=epoch)
        if want_images and first_images is not None:
            self.logger.log_images(first_images, step=epoch)

    def _acc_lpips(self, sums: Dict[str, Any], counts: Dict[str, int],
                   imgs: Dict[str, Tensor], params: Dict[str, Tensor]) -> None:
        """Add one batch's LPIPS (the eval images, BGR as the reference's
        LPIPS-alex) to ``sums`` and ``counts``."""
        def acc(key, a, b):
            vals = lpips_optional.lpips_batch(a, b, params)
            if vals is None:  # inputs below AlexNet's footprint
                return
            sums[key] = sums.get(key, 0.0) + vals.sum()
            counts[key] = counts.get(key, 0) + len(vals)

        if self.kind != "cond":
            acc("Metrics/LPIPS", imgs["Images/Input"], imgs["Images/Reconstruction"])
            return
        y, x = imgs["Images/LR_Input"], imgs["Images/HR_Input"]
        acc("Metrics/LPIPS_LR", y, imgs["Images/LR_Recon"])
        acc("Metrics/LPIPS_HR", x, imgs["Images/HR_Recon"])
        acc("Metrics/LPIPS_SR", x, imgs["Images/SR_Output"])

    def _on_train_epoch_end(self, epoch: int) -> None:
        m = self.model.core if self.kind == "srvae" else self.model
        if self.kind == "vae":
            logs = {"HyperParameters/Gamma": float(m.gamma.detach())}
        else:
            logs = {"HyperParameters/Gamma_X": float(m.gammax.detach()),
                    "HyperParameters/Gamma_Y": float(m.gammay.detach())}
        logs["HyperParameters/Learning Rate"] = self.scheduler.get_last_lr()[0]
        self.logger.log(logs, step=epoch)

    # ------------------------------------------------------------------- fit
    def fit(self, train_loader: Iterable, val_loader: Iterable, epochs: Optional[int] = None,
            start_epoch: int = 1, val_metrics_every: Optional[int] = None) -> None:
        """Train epochs ``start_epoch`` to ``epochs`` (default ``cfg.epochs``)
        over ``train_loader``, validating on ``val_loader`` (any iterables of
        ``(LR, HR)`` batches, iterated once per pass). The model and the
        trainer's state are updated in place. On return the logger is
        finished and every checkpoint written."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        if val_metrics_every is None:
            val_metrics_every = cfg.val_metrics_every
        if self.kind in ("cond", "srvae") and self.baseline_metrics is None:
            self.baseline_metrics = self.compute_bicubic_baseline(val_loader)

        # SIGTERM (how schedulers ask a job to leave) finishes the epoch,
        # writes a resumable checkpoint and returns
        self._preempted = False
        old_handler = None

        def _on_term(signum, frame):
            self._preempted = True
            print("SIGTERM: will checkpoint and stop at the end of this epoch")

        try:
            old_handler = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            pass  # not the main thread: no preemption checkpoint
        try:
            self._fit_epochs(train_loader, val_loader, epochs, start_epoch, val_metrics_every)
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            # every pending checkpoint is written before fit returns; a
            # writer error must surface, but not replace an exception that
            # is already leaving fit (it is printed instead)
            in_flight = sys.exc_info()[1]
            try:
                try:
                    wait_for_saves()
                except Exception as ckpt_err:
                    if in_flight is None:
                        raise
                    print(f"checkpoint writer error (suppressed by the original failure): "
                          f"{ckpt_err!r}")
            finally:
                self.logger.finish()

    def _fit_epochs(self, train_loader, val_loader, epochs: int, start_epoch: int,
                    val_metrics_every: int) -> None:
        for epoch in range(start_epoch, epochs + 1):
            self.current_epoch = epoch
            for cb in self.callbacks:
                if cb.on_epoch_begin(epoch=epoch, model=self.model, trainer=self):
                    print(f"Stopping training before epoch {epoch} due to "
                          f"{cb.__class__.__name__} condition.")
                    return

            # ---------------------------------------------------- train loop
            # the second trained epoch is traced (the first pays the kernel
            # builds), or the last when there is no second
            profiler = None
            if self.cfg.profile_dir and epoch == min(start_epoch + 1, epochs):
                activities = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            t0 = time.perf_counter()
            sums: Dict[str, Tensor] = {}
            n_train = 0
            lr = self.scheduler.lr
            for batch in train_loader:
                sums = _add(sums, self.train_step(batch, lr=lr))
                n_train += 1
            train_terms = {"Loss/" + k: v / n_train for k, v in _host(sums).items()}
            train_loss = train_terms["Loss/loss"]
            train_time = time.perf_counter() - t0
            if profiler is not None:
                profiler.stop()
                os.makedirs(self.cfg.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(self.cfg.profile_dir, f"train_epoch_{epoch}.json"))
            self.logger.log({**train_terms, "Perf/train_epoch_seconds": train_time}, step=epoch)
            if isnan(train_loss):
                raise ValueError(f"NaN detected in training loss at epoch {epoch}. "
                                 "Check your model and data.")
            self._on_train_epoch_end(epoch)

            # ------------------------------------------------------ val loop
            vsums: Dict[str, Tensor] = {}
            n_val = 0
            for batch in val_loader:
                vsums = _add(vsums, self.val_step(batch))
                n_val += 1
            val_terms = {"Loss/val_" + k: v / n_val for k, v in _host(vsums).items()}
            val_loss = val_terms["Loss/val_loss"]

            full_val = epoch % val_metrics_every == 0 or epoch in (1, epochs)
            self.evaluate(val_loader, epoch, full_val=full_val)
            self.scheduler.step(val_loss)
            self.logger.log(val_terms, step=epoch)

            for cb in self.callbacks:
                if cb.on_epoch_end(epoch=epoch, model=self.model, trainer=self, logs=val_terms,
                                   extra={"scheduler": self.scheduler.state_dict(),
                                          "model": self._model_meta()}):
                    print(f"Stopping training after epoch {epoch} due to "
                          f"{cb.__class__.__name__} condition.")
                    return
            print(f"Epoch {epoch}/{epochs}, Train Loss: {train_loss:.4f}, "
                  f"Val Loss: {val_loss:.4f}")
            if self._preempted:
                self._save_preempt(epoch)
                return

    def _save_preempt(self, epoch: int) -> None:
        """The current state (not the best) to ``<save_path>/<job_id>_preempt``
        of the first ``ModelCheckpoint`` (else ``ckpt/<job_id>_preempt``),
        written before returning, so the process can exit right after."""
        base = next((f"{cb.save_path}/{cb.job_id}" for cb in self.callbacks
                     if isinstance(cb, ModelCheckpoint)), f"ckpt/{self.job_id}")
        path = f"{base}_preempt"
        save_checkpoint(path, self, epoch=epoch, extra={
            "scheduler": self.scheduler.state_dict(), "model": self._model_meta()}, block=True)
        print(f"preemption checkpoint written: {path} (epoch {epoch})")
