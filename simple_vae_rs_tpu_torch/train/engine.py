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
writes ``<save_path>/<job_id>_preempt``.

``TrainConfig.scan_steps`` (JAX ``train_multi_step``): k full optimizer
steps, each on its own batch, in one dispatch. ``fit`` gathers k batches of
one shape and hands them to :meth:`Trainer.train_multi_step`; a batch of
another shape first trains the ones gathered as single steps, and so does an
epoch's ragged tail; the terms are summed over the steps, so the epoch mean
is the mean over every step. On the card the k steps are one CUDA graph
replay: the graph of each (k, batch shapes, dtype, plain path,
``accum_steps``, ``remat``, mesh) is captured once, after a warm-up on a side
stream that leaves no trace (the parameters, moments, BatchNorm statistics,
generator, count and step are restored), and replayed with the batches
copied into its input stacks, the plateau lr into its lr tensor and the bias
corrections into its table; the trainer's generator is registered with the
graph, so step i draws the noise the i-th eager step would. A capture that
fails raises with its cause (a host sync in the step, gloo collectives): no
eager loop steps in. The launch counters move by the tally of one replay,
taken at capture (``ops/fused_conv.counters``). On the CPU the k steps run
eagerly, with the same semantics. ``scan_steps=0`` (auto) trains single steps
until the first trained epoch of a ``fit`` ends, then decides once whether
to fuse ``utils/health.AUTO_SCAN_K`` steps a dispatch (rank 0 decides for a
mesh). On the CPU by JAX's rule: where one launch's probed round trip
exceeds a quarter of the step's wall time. On the card by a trial at the
head of the next epoch, on the batches it trains anyway: windows of eager
steps, one dispatch that captures the graph, as many windows of replays,
each window timed up to a synchronize; the replay is kept where it saves
``health.AUTO_SCAN_MIN_GAIN`` of the eager step, else its graph is dropped.
An epoch too short for the trial retries it in the next; a gloo mesh, which
cannot capture, takes one step a dispatch without a trial.

On a process mesh (``Trainer(..., mesh=parallel.make_mesh(...))``, one
process per card) every rank passes its contiguous slice of each global
batch (``parallel/mesh.shard_batch``; the loader's ``mesh=`` yields it) and
a step is the single-card step on the global batch: BatchNorm normalises
over the global batch (``ops/conv_blocks.sync_batchnorm``), each rank's loss
is its share of the global loss (``ops/fused_elbo``'s ``global_rows``), the
gradients are summed over the ranks in one flat buffer before the clip and
Adam (``torch.autograd.grad`` fires no DDP hook), and the terms come back
all-reduced to the global values. Every rank draws the global noise from
the shared generator and takes its rows. With ``accum_steps`` the global
batch is cut into contiguous microbatches and rank r's microbatch i is the
r-th slice of global microbatch i, as JAX reshapes the global array. The
evaluation sums and counts are all-reduced; LPIPS runs only where every
rank has the weights; the eval images are the global batch's first ones on
every rank; only rank 0 prints; a SIGTERM on any rank makes every rank save
(collectively: ``train/checkpoint.save_checkpoint``). With a ``model`` axis
above 1 the ranks of one batch shard hold the same rows and compute the
same loss: the wide heads run channel-sharded among them
(``parallel/mesh.shard_model``), and every batch reduction above (the
BatchNorm sums, the terms, the rows gathered, a sharded head's gradients)
runs over the mesh's data group. The replicated parameters' gradients are
summed over the world and divided by the model axis' size: the mean of the
model ranks' copies, so every rank holds the same bits (on the card the
copies differ in the last bits) and the replicas never drift apart.
Nothing else sums over the model group but the heads' own collectives and
the clip's norm.

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
import dataclasses
import functools
import os
import signal
import statistics
import sys
import time
from math import isnan
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from simple_vae_rs_tpu_torch.config import TrainConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE, box_downsample_2x
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import fused_elbo as fe
from simple_vae_rs_tpu_torch.ops.conv_blocks import frozen_statistics, sync_batchnorm
from simple_vae_rs_tpu_torch.ops.fused_elbo import fused_base_loss, fused_cond_loss
from simple_vae_rs_tpu_torch.ops.metrics import psnr, ssim
from simple_vae_rs_tpu_torch.ops.resize import bicubic_upsample_2x
from simple_vae_rs_tpu_torch.parallel import mesh as pm
from simple_vae_rs_tpu_torch.serve import resolve_device
from simple_vae_rs_tpu_torch.train.callbacks import Callback, ModelCheckpoint
from simple_vae_rs_tpu_torch.train.checkpoint import save_checkpoint, wait_for_saves
from simple_vae_rs_tpu_torch.train.schedule import ReduceLROnPlateau
from simple_vae_rs_tpu_torch.train.state import make_optimizer
from simple_vae_rs_tpu_torch.utils import health, lpips_optional
from simple_vae_rs_tpu_torch.utils.logging import Logger, NullLogger
from simple_vae_rs_tpu_torch.utils.trace import span

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


def _shapes(batch) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(np.shape(t)) for t in batch)


def stack_batches(batches) -> Tuple[Any, ...]:
    """Same-shape batches as one batch of ``(k, B, ...)`` stacks, each stacked
    where its parts lie: tensors on their device, anything else as float32
    numpy on the host (one copy to the card then, not k)."""
    out = []
    for parts in zip(*batches):
        if all(isinstance(p, Tensor) for p in parts):
            out.append(torch.stack(parts))
        else:
            out.append(np.stack([np.asarray(p, dtype=np.float32) for p in parts]))
    return tuple(out)


def _count_cells() -> List[Tuple[dict, str]]:
    """Every launch counter a training step moves (the conv and row
    kernels'), as ``(dict, key)`` pairs in a fixed order."""
    cells: List[Tuple[dict, str]] = []

    def walk(counts: dict) -> None:
        for key, v in counts.items():
            if isinstance(v, dict):
                walk(v)
            else:
                cells.append((counts, key))

    for counters in (fc.counters(), fe.counters()):
        walk(counters)
    return cells


@dataclasses.dataclass
class StepGraph:
    """k optimizer steps captured as one CUDA graph, and its static tensors:
    the ``(k, B, ...)`` input stacks it reads, the 0-dim learning rate, the
    table of bias corrections (a row a step, ``ClipAdam.corrections``),
    the loss terms it writes (summed over the k steps, and each step's), and
    the launches one replay makes (a count per :func:`_count_cells` cell)."""

    graph: Any
    inputs: Tuple[Tensor, ...]
    lr: Tensor
    table: Tensor
    terms: Dict[str, Tensor]
    step_terms: List[Dict[str, Tensor]]
    tally: List[int]


class _ScanTrial:
    """The card's trial of the auto ``scan_steps`` (:meth:`Trainer._train_epoch`):
    ``windows`` windows of ``steps`` eager steps, one dispatch of ``k`` steps
    that captures the graph (untimed), then ``windows`` windows of ``steps``
    steps as replays of ``k``. A window is timed on the host clock from its
    first batch to a synchronize after its last step; its batches all have
    the shape of the trial's first (``shape``). ``graphs`` are the keys of
    the graphs its capture made, ``reserved`` the card's reserved bytes
    before and after that capture."""

    def __init__(self, k: int, windows: int, steps: int) -> None:
        if windows < 1 or steps < k or steps % k:
            raise ValueError(f"a trial takes windows of a multiple of k={k} steps, "
                             f"got {windows} windows of {steps}")
        self.k, self.windows, self.steps = k, windows, steps
        self.plan = ["eager"] * windows + ["capture"] + ["replay"] * windows
        self.opened = False  # whether an epoch opened with it
        self.graphs: set = set()
        self.reserved: Optional[Tuple[int, int]] = None
        self.restart()

    def restart(self) -> None:
        """From the first window, with no timing (a new epoch)."""
        self.at = 0  # the plan's window
        self.shape = None
        self.seconds: Dict[str, List[float]] = {"eager": [], "replay": []}
        self.restart_window()

    def restart_window(self) -> None:
        self.done = 0  # steps of the window trained
        self.t0: Optional[float] = None

    @property
    def side(self) -> str:
        return self.plan[self.at]

    @property
    def dispatch_k(self) -> int:
        return 1 if self.side == "eager" else self.k

    def advance(self, k: int, clock) -> bool:
        """``k`` more steps of the window trained; a window that is full is
        timed. Returns whether the trial is over."""
        self.done += k
        if self.done == (self.k if self.side == "capture" else self.steps):
            if self.side != "capture":
                self.seconds[self.side].append(clock() - self.t0)
            self.at += 1
            self.restart_window()
        return self.at == len(self.plan)

    def seconds_a_step(self, side: str) -> Optional[float]:
        """The median over ``side``'s windows of their seconds a step."""
        times = self.seconds[side]
        return statistics.median(times) / self.steps if times else None


class Trainer:
    """Optimizer state, the steps and the epoch loop of one CondSRVAE, SRVAE
    or VAE (``kind``: "cond", "srvae" or "vae").

    ``callbacks`` get ``on_epoch_begin`` / ``on_epoch_end`` (True stops),
    ``logger`` every metric (``utils/logging``; none by default), ``job_id``
    names the preemption checkpoint. The plateau ``scheduler`` is made from
    the config. ``baseline_metrics`` holds the bicubic baseline once ``fit``
    has computed it. ``mesh`` is a process mesh (``parallel/mesh.make_mesh``)
    to train on: data-parallel over its batch axes, with ``cfg.zero1``
    sharding the large Adam moments over them, and with the wide heads
    channel-sharded over its ``model`` axis (``parallel/mesh.shard_model``).
    ``auto_scan_trial`` holds the card's ``scan_steps`` trial once it has
    decided (ms a step eager and replayed, the gain, the choice, the bytes
    the card reserved before and after the capture); None before.
    """

    def __init__(self, model, cfg: Optional[TrainConfig] = None, device="cuda",
                 seed: Optional[int] = None, callbacks: Sequence[Callback] = (),
                 logger: Optional[Logger] = None, job_id: str = "local",
                 mesh: Optional[pm.Mesh] = None) -> None:
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
        self.mesh = mesh
        self._shards = 1
        if mesh is not None:
            if not mesh.is_process:
                raise ValueError("a Trainer trains on a process mesh (make_mesh without "
                                 "devices); a device mesh serves")
            self._shards = mesh.n_shards
            sync_batchnorm(self.model, mesh.data_group if mesh.distributed and self._shards > 1
                           else None)
            pm.shard_model(self.model, mesh)  # from rank 0; the heads' blocks on a model axis
        self.params: Dict[str, Tensor] = dict(self.model.named_parameters())
        self._model_dims = pm.model_dims(self.model)  # None each without a model axis
        self.opt = self.make_optimizer()
        self.scheduler = ReduceLROnPlateau(lr=cfg.learning_rate, factor=cfg.plateau_factor,
                                           patience=cfg.plateau_patience)
        self.step = 0
        self.current_epoch = 0
        self.baseline_metrics: Optional[Dict[str, float]] = None
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(self.seed)
        self._preempted = False
        self.graphs: Dict[tuple, StepGraph] = {}  # the captured k-step graphs by key
        self.graph_captures = 0  # captures begun, failed ones and the auto trial's included
        self._side_stream = None  # the warm-up stream of the captures
        self._auto_scan_k: Optional[int] = None  # the auto mode's choice, once made
        # the auto mode's rule: the card's trial, else JAX's dispatch probe
        self._trial_rule = self.device.type == "cuda"
        self._scan_trial: Optional[_ScanTrial] = None  # due from a fit's second epoch
        self.auto_scan_trial: Optional[Dict[str, Any]] = None
        if mesh is not None:
            pm.shard_state(mesh, self, zero1=cfg.zero1)

    def make_optimizer(self):
        """A fresh clip + Adam over the trainer's parameters (its config's),
        laid out over the mesh's model axis where the model is sharded on
        one."""
        opt = make_optimizer(self.cfg, list(self.params.values()))
        if self.mesh is not None and self.mesh.model > 1:
            opt.over_model(self.mesh, self._model_dims)
        return opt

    @property
    def is_main(self) -> bool:
        """Whether this process prints: rank 0, or no mesh."""
        return self.mesh is None or self.mesh.rank == 0

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
    def _streams(self, batch) -> Tuple[Any, ...]:
        """The parts of ``batch`` the model trains on: ``(y, x)`` for a
        Cond_SRVAE, ``(x,)`` (HR) for an SRVAE, ``(y,)`` (LR) for a VAE."""
        batch = tuple(batch)
        if self.kind == "srvae":
            return batch[-1:]
        if self.kind == "vae":
            return batch[:1]
        return batch

    def _batch(self, batch) -> Tuple[Tensor, ...]:
        """The streams the model trains on (:meth:`_streams`), on the device."""
        batch = tuple(torch.as_tensor(t).to(self.device, torch.float32).contiguous()
                      for t in self._streams(batch))
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
    def _local(self, eps: Noise) -> Noise:
        """This rank's rows of the noise of a global batch."""
        if self._shards == 1:
            return tuple(eps)
        return tuple(e[pm.shard_rows(self.mesh, e.shape[0])] for e in eps)

    def _global_rows(self, n_global: int) -> Optional[int]:
        return n_global if self._shards > 1 else None

    def _reduce(self, values: Dict[str, Any]) -> Dict[str, Any]:
        """``values`` (0-dim tensors or numbers) summed over the mesh's ranks,
        in one all-reduce; as they are without a process group."""
        if self.mesh is None or not self.mesh.distributed:
            return values
        keys = list(values)
        flat = torch.stack([torch.as_tensor(values[k], dtype=torch.float32,
                                            device=self.device).detach() for k in keys])
        pm.all_reduce_(self.mesh, flat)
        return dict(zip(keys, flat.unbind()))

    def _loss_and_terms(self, streams: Tuple[Tensor, ...], eps: Noise,
                        global_rows: Optional[int] = None
                        ) -> Tuple[Tensor, Dict[str, Tensor]]:
        m = self.model
        if self.kind == "vae":
            (x,) = streams
            with span("svrs.step.forward"):
                x_hat, mu, logvar = m(x, *eps)
            with span("svrs.step.elbo"):
                mse, kld = fused_base_loss(x_hat, x, mu, logvar, m.gamma, plain=m.plain,
                                           global_rows=global_rows)
                loss = mse + kld
            return loss, dict(zip(VAE_TERMS, (loss, mse, kld)))
        with span("svrs.step.forward"):
            if self.kind == "srvae":
                (x,) = streams
                x_hat, y_hat, mu_z, lv_z, mu_u, lv_u, mu_p, lv_p, y = m(x, *eps)
                core = m.core
            else:
                y, x = streams
                x_hat, y_hat, mu_z, lv_z, mu_u, lv_u, mu_p, lv_p = m(x, y, *eps)
                core = m
        with span("svrs.step.elbo"):
            mse_x, kld_u, mse_y, kld_z = fused_cond_loss(
                x_hat, x, y_hat, y, mu_u, lv_u, mu_z, lv_z, mu_p, lv_p, core.gammax,
                core.gammay, plain=m.plain, global_rows=global_rows)
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
        :meth:`noise`), or one such tuple per microbatch; on a mesh, that of
        the global (micro)batch, of which each rank takes its rows. On a mesh
        the gradients and terms are the global ones on every rank."""
        streams = self._batch(batch)
        k = self._shards
        n = streams[0].shape[0] * k  # the global batch
        accum = self.cfg.accum_steps
        if n % accum:
            raise ValueError(f"batch size {n} not divisible by accum_steps {accum}")
        mbg = n // accum  # a global microbatch
        if mbg % k:
            raise ValueError(f"a microbatch of {mbg} does not split into {k} equal shards")
        mb = mbg // k
        if accum > 1 and k > 1:
            # JAX cuts the GLOBAL batch into contiguous microbatches and
            # shards each: rank r's microbatch i is the r-th slice of global
            # microbatch i, which other ranks' slices hold
            streams = tuple(pm.all_gather_rows(self.mesh, t) for t in streams)
            rows = pm.shard_rows(self.mesh, mbg)
            micros = [tuple(t[i * mbg:(i + 1) * mbg][rows] for t in streams)
                      for i in range(accum)]
        else:
            micros = [tuple(t[i * mb:(i + 1) * mb] for t in streams) for i in range(accum)]
        if eps is None:
            eps = [self.stream_noise("train", mbg, streams[0].shape[1:3]) for _ in range(accum)]
        elif isinstance(eps[0], Tensor):
            eps = [eps]
        if len(eps) != accum:
            raise ValueError(f"eps holds {len(eps)} noise tuples for {accum} microbatches")
        eps = [self._local(e) for e in eps]
        global_rows = self._global_rows(mbg)
        self.model.train()
        params = list(self.params.values())
        gsum: Optional[list] = None
        tsum: Dict[str, Tensor] = {}
        for i, micro in enumerate(micros):
            if self.cfg.remat:
                loss, terms = checkpoint(self._loss_and_terms, micro, tuple(eps[i]), global_rows,
                                         use_reentrant=False, preserve_rng_state=False,
                                         context_fn=self._remat_contexts)
            else:
                loss, terms = self._loss_and_terms(micro, eps[i], global_rows)
            with span("svrs.step.backward"):
                grads = torch.autograd.grad(loss, params)
            if gsum is None:
                gsum, tsum = list(grads), {k: v.detach() for k, v in terms.items()}
            else:
                torch._foreach_add_(gsum, grads)
                tsum = {k: tsum[k] + v.detach() for k, v in terms.items()}
        if accum > 1:
            torch._foreach_mul_(gsum, 1.0 / accum)
            tsum = {k: v * (1.0 / accum) for k, v in tsum.items()}
        # each rank's loss is its share of the global one: the global
        # gradient and terms are the sums over the ranks
        pm.all_reduce_flat_(self.mesh, gsum, self._model_dims)
        return dict(zip(self.params, gsum)), self._reduce(tsum)

    @torch.no_grad()
    def apply_grads(self, grads: Dict[str, Tensor], lr: float) -> None:
        """Clip + Adam on ``grads``, then ``p <- p - lr * u`` for every
        parameter (under ZeRO-1 per block, then all-gathered)."""
        lr_t = torch.full((), lr, dtype=torch.float32, device=self.device)
        self.opt.step(list(self.params.values()), [grads[n] for n in self.params], lr_t,
                      self.opt.corrections()[0])
        self.step += 1

    # ----------------------------------------------------------------- steps
    def train_step(self, batch, lr: Optional[float] = None,
                   eps: Optional[Sequence] = None) -> Dict[str, Tensor]:
        """One optimizer step on ``batch`` at learning rate ``lr`` (default
        ``cfg.learning_rate``); returns the loss terms."""
        with span("svrs.step"):
            grads, terms = self.grads_and_terms(batch, eps)
            self.apply_grads(grads, self.cfg.learning_rate if lr is None else lr)
            return terms

    def train_multi_step(self, batches, lr: Optional[float] = None) -> Dict[str, Tensor]:
        """``k`` full optimizer steps in one dispatch (JAX ``train_multi_step``):
        ``batches`` is a batch of ``(k, B, ...)`` stacks, ``(Y, X)`` as a
        batch is ``(y, x)``; step i trains on the i-th batch at learning rate
        ``lr`` (default ``cfg.learning_rate``) and draws the noise the i-th of
        k :meth:`train_step` calls would. Returns the loss terms summed over
        the k steps; ``step`` advances by k. On the card the k steps are one
        replay of the CUDA graph captured for them (:meth:`step_graph`); on
        the CPU, k eager steps."""
        lr = self.cfg.learning_rate if lr is None else float(lr)
        stacks = self._streams(batches)
        k = int(np.shape(stacks[0])[0])
        if self.device.type != "cuda":
            sums: Dict[str, Tensor] = {}
            for i in range(k):
                sums = _add(sums, self.train_step(tuple(s[i] for s in stacks), lr=lr))
            return sums
        with span("svrs.step"):
            stacks = tuple(torch.as_tensor(s) for s in stacks)
            g = self.step_graph(stacks)
            with span("svrs.step.copy_in"):
                for dst, src in zip(g.inputs, stacks):
                    dst.copy_(src)
                g.lr.fill_(lr)
                g.table.copy_(self.opt.corrections(k))
            with span("svrs.step.replay"):
                g.graph.replay()
            self.opt.count += k
            self.step += k
            for (counts, key), n in zip(_count_cells(), g.tally):
                counts[key] += n
            return {name: t.clone() for name, t in g.terms.items()}

    def step_graph(self, stacks: Tuple[Tensor, ...]) -> StepGraph:
        """The graph of ``len(stacks[0])`` steps on batch stacks of these
        shapes (the streams the model trains on), captured on first use.
        Raises on a mesh whose collectives run over gloo (they copy through
        the host), and with the cause where the capture fails."""
        mesh = self.mesh
        if self._host_collectives:
            raise ValueError(f"scan_steps on the card needs NCCL collectives; this mesh's "
                             f"run over {mesh.backend}, which copies through the host and "
                             "cannot be captured into a CUDA graph")
        k = int(stacks[0].shape[0])
        key = (k, _shapes(stacks), self.model.dtype, bool(self.model.plain),
               self.cfg.accum_steps, self.cfg.remat, id(mesh))
        if key not in self.graphs:
            with span("svrs.step.capture"):
                self.graphs[key] = self._capture(stacks, k)
        return self.graphs[key]

    @property
    def _host_collectives(self) -> bool:
        """Whether the mesh's collectives run over gloo (through the host),
        which a CUDA graph cannot capture."""
        mesh = self.mesh
        return mesh is not None and mesh.distributed and mesh.backend != "nccl"

    def _capture(self, stacks: Tuple[Tensor, ...], k: int) -> StepGraph:
        self.graph_captures += 1
        dev = self.device
        inputs = tuple(torch.empty(s.shape, dtype=torch.float32, device=dev) for s in stacks)
        for dst, src in zip(inputs, stacks):
            dst.copy_(src)
        lr = torch.full((), self.cfg.learning_rate, dtype=torch.float32, device=dev)
        table = self.opt.corrections(k)
        params = list(self.params.values())

        def steps() -> List[Dict[str, Tensor]]:
            out = []
            for i in range(k):
                grads, terms = self.grads_and_terms(tuple(t[i] for t in inputs))
                self.opt.step(params, [grads[n] for n in self.params], lr, table[i])
                out.append(terms)
            return out

        # warm-up on a side stream (the kernels built, the library handles and
        # workspaces made, the collectives' communicators up), then every
        # tensor a step writes, the generator, the count and the step as
        # they were
        tensors = [*self.params.values(), *self.model.buffers(), *self.opt.mu, *self.opt.nu]
        with torch.no_grad():
            saved = [t.clone() for t in tensors]
        count, step, rng = self.opt.count, self.step, self._rng.get_state()

        def restore(device: bool) -> None:
            if device:
                with torch.no_grad():
                    torch._foreach_copy_(tensors, saved)
            self.opt.count, self.step = count, step
            self._rng.set_state(rng)

        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(dev)
        side = self._side_stream
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(side):
                steps()
        finally:
            torch.cuda.current_stream(dev).wait_stream(side)
            restore(device=True)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._rng)
        cells = _count_cells()
        before = [counts[key] for counts, key in cells]
        causes: list = []
        try:
            # thread_local: a loader's thread may allocate or copy meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                try:
                    step_terms = steps()
                    terms = functools.reduce(_add, step_terms, {})
                except BaseException as e:
                    causes.append(e)
                    raise
        except Exception as e:
            self._after_failed_capture(dev)
            cause = causes[0] if causes else e
            raise RuntimeError(f"scan_steps={k}: capturing {k} training steps as one CUDA "
                               f"graph failed: {type(cause).__name__}: {cause}") from cause
        finally:
            tally = [counts[key] - n for (counts, key), n in zip(cells, before)]
            for (counts, key), n in zip(cells, before):
                counts[key] = n  # the capture launched nothing
            restore(device=False)  # nothing ran on the card
        return StepGraph(graph, inputs, lr, table, terms, step_terms, tally)

    def _after_failed_capture(self, dev: torch.device) -> None:
        """A capture that raised never reached its generators' epilogue, so
        they still take every draw for one made under capture: give the
        trainer's generator and the card's default one a fresh state of the
        same seed and offset. The graphs captured before read the old state:
        they go, and are captured again on their next use."""
        default = torch.cuda.default_generators[dev.index if dev.index is not None
                                                else torch.cuda.current_device()]
        for gen in (self._rng, default):
            gen.graphsafe_set_state(gen.clone_state())
        self.graphs.clear()

    @torch.no_grad()
    def val_step(self, batch, eps: Optional[Noise] = None) -> Dict[str, Tensor]:
        """Loss terms in eval mode (BatchNorm folded from its running
        statistics); no parameter or statistic changes. On a mesh: the global
        batch's terms (``eps`` that of the global batch)."""
        streams = self._batch(batch)
        n = streams[0].shape[0] * self._shards
        if eps is None:
            eps = self.stream_noise("val", n, streams[0].shape[1:3])
        self.model.eval()
        return self._reduce(self._loss_and_terms(streams, self._local(eps),
                                                 self._global_rows(n))[1])

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
        n = y.shape[0] * self._shards
        (eps_u,) = self._local(self.stream_noise("pretrain", n, y.shape[1:3]))
        self.model.train()
        y_hat, mu_u, lv_u = core.lr_autoencode(y, eps_u)
        mse_y, kld_u = fused_base_loss(y_hat, y, mu_u, lv_u, core.gammay, plain=self.model.plain,
                                       global_rows=self._global_rows(n))
        loss = mse_y + kld_u
        params = list(self.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        pm.all_reduce_flat_(self.mesh, grads, self._model_dims)
        lr_t = torch.full((), lr, dtype=torch.float32, device=self.device)
        opt.step(params, grads, lr_t, opt.corrections()[0])
        self.step += 1
        return self._reduce({"loss": loss.detach()})["loss"]

    def pretrain_lr_branch(self, train_loader: Iterable, pre_epochs: int) -> None:
        """Stage 1: ``pre_epochs`` passes of :meth:`pretrain_step` over
        ``train_loader`` with a throwaway optimizer (the main run starts with
        fresh Adam state), logging ``Loss/pretrain_y_loss`` (the last step's)
        per pre-epoch. A VAE has no LR branch: nothing happens."""
        if self.kind not in ("cond", "srvae") or pre_epochs <= 0:
            return
        opt = self.make_optimizer()
        lr = self.cfg.learning_rate
        for epoch in range(1, pre_epochs + 1):
            last = None
            for batch in train_loader:
                last = self.pretrain_step(batch, opt, lr)
            loss = float(last) if last is not None else float("nan")
            self.logger.log({PRETRAIN_KEY: loss}, step=epoch)
            if self.is_main:
                print(f"Pre-epoch {epoch}/{pre_epochs}, LR-branch loss: {loss:.4f}")

    # ------------------------------------------------------------ evaluation
    @torch.no_grad()
    def eval_metrics_step(self, batch) -> Dict[str, Any]:
        """Per-batch sums of the evaluation metrics, in eval mode: SSIM and
        PSNR of the reconstruction (a Cond_SRVAE: SSIM of both
        reconstructions, SSIM and PSNR of the super-resolution) and
        ``count``, the number of images (on a mesh, the global batch's)."""
        streams = self._batch(batch)
        n = streams[0].shape[0]
        eps = self._local(self.stream_noise("metrics", n * self._shards, streams[0].shape[1:3]))
        self.model.eval()
        if self.kind != "cond":
            (x,) = streams
            x_hat = self.model(x, *eps)[0]
            return self._reduce({"ssim": ssim(x, x_hat).sum(), "psnr": psnr(x, x_hat).sum(),
                                 "count": float(n)})
        y, x = streams
        x_hat, y_hat = self.model(x, y, *eps)[:2]
        x_sr = self.model.conditional_generation_eps(y, *eps)
        return self._reduce({"ssim_y": ssim(y, y_hat).sum(), "ssim_x": ssim(x, x_hat).sum(),
                             "ssim_sr": ssim(x, x_sr).sum(), "psnr_sr": psnr(x, x_sr).sum(),
                             "count": float(n)})

    @torch.no_grad()
    def eval_images_step(self, batch) -> Dict[str, Tensor]:
        """The image panel of the batch's first :data:`EVAL_IMAGES` images,
        in eval mode, by the reference's names (on a mesh, the global batch's
        first images, on every rank)."""
        streams = tuple(pm.first_rows(self.mesh, t, EVAL_IMAGES) for t in self._batch(batch))
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
        without a weights file (the LPIPS metrics are then absent). On a mesh,
        None unless every rank has them (they gate collectives)."""
        params = lpips_optional.load(self.device)
        return params if pm.agree(self.mesh, params is not None) else None

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
                # the global batch's first images (the upsample is per image)
                y4, x4 = (pm.first_rows(self.mesh, t, EVAL_IMAGES) for t in (y, x))
                vals = lpips_optional.lpips_batch(x4, bicubic_upsample_2x(y4), lp)
                if vals is not None:
                    lp_sum, lp_n = lp_sum + vals.sum(), lp_n + len(vals)
        if not sums:
            return {}
        out = _host({**self._reduce(sums), "lpips": lp_sum})
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
            self._close_trial(say=in_flight is None)
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

    def _resolve_scan_steps(self) -> int:
        """Steps per dispatch for this epoch: ``cfg.scan_steps`` where it is
        1 or more; in the auto mode (0) the choice once made, else 1."""
        k = int(self.cfg.scan_steps or 0)
        return k if k >= 1 else (self._auto_scan_k or 1)

    def _maybe_autotune_scan(self, train_time: float, n_steps: int) -> None:
        """The auto mode after a trained epoch, until it has decided. On the
        card the next epoch opens with the trial (:class:`_ScanTrial`), but
        on a gloo mesh, which cannot capture: one step a dispatch. On the CPU
        JAX's one decision: probe one launch's warm round trip
        (``utils/health.dispatch_latency``) and fuse ``health.AUTO_SCAN_K``
        steps a dispatch from the next epoch on where it exceeds
        ``health.AUTO_SCAN_THRESHOLD`` of the epoch's wall time a step
        (``health.choose_scan_steps``). On a mesh rank 0's choice is every
        rank's: the ranks must run the same collectives."""
        if (int(self.cfg.scan_steps or 0) >= 1 or self._auto_scan_k is not None or n_steps <= 0
                or self._scan_trial is not None):
            return
        if self._trial_rule:
            if not self._host_collectives:
                self._scan_trial = _ScanTrial(health.AUTO_SCAN_K, health.AUTO_SCAN_TRIAL_WINDOWS,
                                              health.AUTO_SCAN_TRIAL_STEPS)
                return
            self._auto_scan_k = 1
            if self.is_main:
                print(f"scan_steps auto: this mesh's collectives run over {self.mesh.backend}, "
                      "which a CUDA graph cannot capture; one step a dispatch")
            return
        latency = health.dispatch_latency(device=self.device)
        per_step = train_time / n_steps
        k = pm.broadcast_int(self.mesh, health.choose_scan_steps(per_step, latency))
        self._auto_scan_k = k
        if k > 1 and self.is_main:
            print(f"dispatch-bound: a launch's round trip {latency * 1e3:.3f} ms against "
                  f"{per_step * 1e3:.1f} ms a step; scan_steps={k} for the remaining epochs")

    def _trial_clock(self) -> float:
        """The host clock after the card has finished what was launched."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _reserved(self) -> Optional[int]:
        return torch.cuda.memory_reserved(self.device) if self.device.type == "cuda" else None

    def _trial_capture(self, trial: _ScanTrial, stacks, lr: float) -> Dict[str, Tensor]:
        """The trial's untimed dispatch of k steps, which captures their
        graph (a retried trial replays the one its first try captured)."""
        before, reserved = set(self.graphs), self._reserved()
        terms = self.train_multi_step(stacks, lr)
        captured = set(self.graphs) - before
        if captured:
            trial.graphs |= captured
            trial.reserved = (reserved, self._reserved())
        return terms

    def _drop_graphs(self, keys) -> None:
        """Drop these graphs and give their memory pools back to the card."""
        for key in keys:
            self.graphs.pop(key, None)
        if keys and self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _decide_by_trial(self, trial: _ScanTrial) -> int:
        """The card's one decision, from the trial's times
        (``health.choose_scan_steps_by_trial``; rank 0's on a mesh): k for the
        rest of the fit, and every later one. Where it is 1 the trial's graph
        goes."""
        eager, replay = trial.seconds_a_step("eager"), trial.seconds_a_step("replay")
        k = pm.broadcast_int(self.mesh, health.choose_scan_steps_by_trial(eager, replay))
        self._auto_scan_k, self._scan_trial = k, None
        if k == 1:
            self._drop_graphs(trial.graphs)
        gain = 1.0 - replay / eager
        before, after = trial.reserved or (None, None)
        self.auto_scan_trial = {
            "k": k, "eager_ms": eager * 1e3, "replay_ms": replay * 1e3, "gain": gain,
            "eager_windows_s": list(trial.seconds["eager"]),
            "replay_windows_s": list(trial.seconds["replay"]), "steps_a_window": trial.steps,
            "reserved_before_capture": before, "reserved_after_capture": after}
        if self.is_main:
            n = trial.windows * trial.steps
            memory = ("" if before is None else
                      f"; memory reserved {before / 2**30:.2f} GiB before the capture, "
                      f"{after / 2**30:.2f} GiB after it (the capture empties the cache)")
            print(f"scan_steps auto: {n} eager steps {eager * 1e3:.3f} ms a step, {n} replayed "
                  f"(k={trial.k}) {replay * 1e3:.3f} ms, a gain of {100 * gain:.1f}% (kept at "
                  f"{100 * health.AUTO_SCAN_MIN_GAIN:g}% or more): scan_steps={k}"
                  + (" from here on" if k > 1 else ", the graph dropped" if trial.graphs else "")
                  + memory)
        return k

    def _close_trial(self, say: bool) -> None:
        """The end of a fit: a trial that no epoch completed leaves one step
        a dispatch, said once where ``say``, and its graph goes."""
        trial, self._scan_trial = self._scan_trial, None
        if trial is None or not trial.opened:
            return
        self._drop_graphs(trial.graphs)
        if say and self.is_main:
            n = 2 * trial.windows * trial.steps + trial.k
            print(f"scan_steps auto: no epoch held the trial's {n} steps of one shape; one step "
                  "a dispatch")

    def _train_epoch(self, train_loader: Iterable, lr: float) -> Tuple[Dict[str, Tensor], int]:
        """One pass of training over ``train_loader`` at ``lr``: the terms
        summed over its steps, and their number. Batches of one shape go k a
        dispatch (:meth:`_resolve_scan_steps`); a batch of another shape
        first trains the ones gathered as single steps, and so does the
        ragged tail. Where the card's trial is due the epoch opens with it,
        and the choice holds from its end; a batch of another shape than the
        trial's trains alone and restarts the window, and an epoch that ends
        first drops the trial's timings."""
        sums: Dict[str, Tensor] = {}
        n = 0
        scan_k = self._resolve_scan_steps()
        trial = self._scan_trial
        if trial is not None:
            trial.restart()
            trial.opened = True
        pending: list = []

        def singles(batches) -> None:
            nonlocal sums, n
            for b in batches:
                sums = _add(sums, self.train_step(b, lr=lr))
            n += len(batches)

        for batch in train_loader:
            if trial is not None:
                trial.shape = trial.shape or _shapes(batch)
                if _shapes(batch) != trial.shape:
                    singles(pending + [batch])
                    pending = []
                    trial.restart_window()
                    continue
                if not pending and not trial.done and trial.side != "capture":
                    trial.t0 = self._trial_clock()
            k = scan_k if trial is None else trial.dispatch_k
            if k > 1 and pending and _shapes(batch) != _shapes(pending[0]):
                singles(pending)  # a shape change: what was gathered runs unfused
                pending = []
            pending.append(batch)
            if len(pending) < k:
                continue
            if k == 1:
                singles(pending)
            elif trial is not None and trial.side == "capture":
                sums = _add(sums, self._trial_capture(trial, stack_batches(pending), lr))
                n += k
            else:
                sums = _add(sums, self.train_multi_step(stack_batches(pending), lr))
                n += k
            pending = []
            if trial is not None and trial.advance(k, self._trial_clock):
                scan_k, trial = self._decide_by_trial(trial), None
        singles(pending)  # the ragged tail
        return sums, n

    def _fit_epochs(self, train_loader, val_loader, epochs: int, start_epoch: int,
                    val_metrics_every: int) -> None:
        for epoch in range(start_epoch, epochs + 1):
            self.current_epoch = epoch
            for cb in self.callbacks:
                if cb.on_epoch_begin(epoch=epoch, model=self.model, trainer=self):
                    if self.is_main:
                        print(f"Stopping training before epoch {epoch} due to "
                              f"{cb.__class__.__name__} condition.")
                    return

            # ---------------------------------------------------- train loop
            # the second trained epoch is traced (the first pays the kernel
            # builds), or the last when there is no second
            profiler = None
            if self.cfg.profile_dir and self.is_main and epoch == min(start_epoch + 1, epochs):
                activities = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            t0 = time.perf_counter()
            sums, n_train = self._train_epoch(train_loader, self.scheduler.lr)
            train_terms = {"Loss/" + k: v / n_train for k, v in _host(sums).items()}
            train_loss = train_terms["Loss/loss"]
            train_time = time.perf_counter() - t0
            if profiler is not None:
                profiler.stop()
                os.makedirs(self.cfg.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(self.cfg.profile_dir, f"train_epoch_{epoch}.json"))
            self._maybe_autotune_scan(train_time, n_train)
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
                    if self.is_main:
                        print(f"Stopping training after epoch {epoch} due to "
                              f"{cb.__class__.__name__} condition.")
                    return
            if self.is_main:
                print(f"Epoch {epoch}/{epochs}, Train Loss: {train_loss:.4f}, "
                      f"Val Loss: {val_loss:.4f}")
            # a SIGTERM to any rank: every rank saves (the save is collective)
            if pm.agree(self.mesh, self._preempted, "max"):
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
        if self.is_main:
            print(f"preemption checkpoint written: {path} (epoch {epoch})")
