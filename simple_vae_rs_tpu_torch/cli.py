"""The port's command line: train, resume or test a model from tiles on disk
(the counterpart of the JAX package's ``cli.py`` and ``train.py``).

    python -m simple_vae_rs_tpu_torch.cli --dataset s2v --data_root ARM \\
        --crop grid --batch_size 32 --patch_size 64 -cr 1.2 --epochs 200

The flags and their defaults are the JAX CLI's (reference ``train.py:83-148``
plus the JAX additions). ``main`` runs the JAX sequence: the job id, the
loaders, the model, ``ModelCheckpoint`` and ``EarlyStopping``, the logger,
the trainer, the resume from ``--model_ckpt`` (a port checkpoint, or a JAX
``.msgpack`` one: ``train/checkpoint.load_jax_checkpoint``; its generator
then comes from ``--seed``), LR-branch pre-training and
``fit``, ``--int8`` quantization of the trained model, then ``run_task``.
Everything runs on the CUDA card; ``--backend cpu`` runs the plain CPU path.
It writes ``ckpt/``, ``runs/`` and ``results/`` under the working directory.

Data-parallel training runs one process per card, launched by torchrun:

    torchrun --nproc_per_node 4 -m simple_vae_rs_tpu_torch.cli --multihost \
        --dataset s2v --data_root ARM --crop grid --batch_size 32 [--zero1]

``--multihost`` (or a ``WORLD_SIZE`` above 1) starts the process group from
torchrun's environment (``parallel/mesh.init_distributed``: NCCL with a card
per rank, gloo where ranks share a card) and ``--mesh_data`` /
``--mesh_model`` / ``--mesh_dcn`` lay the ranks out
(``parallel/mesh.make_mesh``; the default puts them all on the data axis).
``--batch_size`` stays the global batch in tiles: each batch shard loads,
trains on and evaluates its slice, and rank 0 alone logs, writes the
checkpoints and runs the task. ``--mesh_model N`` channel-shards the wide
heads over the N consecutive ranks of each batch shard (tensor parallel, as
JAX's ``model`` axis; the world is ``dcn x data x N`` ranks):

    torchrun --nproc_per_node 4 -m simple_vae_rs_tpu_torch.cli --multihost \
        --mesh_data 2 --mesh_model 2 --dataset s2v --data_root ARM --batch_size 32

the task then runs on the whole model, gathered from the shards on every
rank.

``--scan_steps k`` runs k optimizer steps a dispatch (one CUDA graph replay
on the card, ``Trainer.train_multi_step``); the default 0 decides once, after
the first epoch: on the card by a trial of eager against replayed steps at
the head of the second, on the CPU by JAX's dispatch probe
(``utils/health``). Flags that are not ported raise a
``ValueError`` at any value but their default: ``--train_elbo`` and
``--pallas_conv``, left out on purpose (ROADMAP A.3).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional, Sequence

# flag: (its default, why it raises at another value)
UNPORTED = {
    "train_elbo": ("xla", "train_elbo is not ported, on purpose: the row kernels always run "
                          "(ROADMAP A.3)"),
    "pallas_conv": (False, "pallas_conv is not ported, on purpose: every conv runs its CUDA "
                           "kernel (ROADMAP A.3)"),
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train a VAE model.")
    parser.add_argument("--pre_epochs", type=int, default=0,
                        help="Number of epochs to pre-train the low resolution model.")
    parser.add_argument("--epochs", type=int, default=200,
                        help="Number of epochs to train the model.")
    parser.add_argument("--dataset", type=str, default="s2v", help="Type of the dataset")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Batch size for training and validation.")
    parser.add_argument("--patch_size", type=int, default=None,
                        help="Patch size of the High-Res Images. (default: 64; with "
                        "--model_ckpt an unset flag comes from the checkpoint's config)")
    parser.add_argument("--test", action="store_true",
                        help="If set, the model will be tested instead of trained.")
    parser.add_argument("--model_ckpt", type=str,
                        help="Path to the model checkpoint to resume training.")
    parser.add_argument("--val_metrics_every", type=int, default=5,
                        help="Number of epochs between validation metrics computation.")
    parser.add_argument("-cr", "--compression_ratio", type=float, default=None,
                        help="Compression of the ratio. (default: 1.5; with --model_ckpt an "
                        "unset flag comes from the checkpoint's config)")
    parser.add_argument("--model_type", type=str, default=None,
                        choices=["Cond_SRVAE", "VAE", "SRVAE"],
                        help="Model to use. (default: Cond_SRVAE; with --model_ckpt an unset "
                        "flag comes from the checkpoint's config)")
    parser.add_argument("--latent_size", type=int, default=None,
                        help="Fixed latent budget: overrides the cr-derived latent size.")
    parser.add_argument("--crop", type=str, default="random", choices=["random", "grid"],
                        help="Patchification mode; grid yields patches_per_tile x batch_size.")
    parser.add_argument("--data_root", type=str, default=None, help="Dataset root dir.")
    parser.add_argument("--workers", type=int, default=1,
                        help="Tile-decode threads per loader; the batches are the same at "
                        "any count.")
    parser.add_argument("--mesh_data", type=int, default=-1,
                        help="Mesh data-axis size (-1 = every rank the other axes leave).")
    parser.add_argument("--mesh_model", type=int, default=1,
                        help="Mesh model-axis size (the wide heads channel-sharded over "
                        "this many ranks of each batch shard).")
    parser.add_argument("--mesh_dcn", type=int, default=1,
                        help="Mesh dcn-axis size (another factor of the ranks; same numbers).")
    parser.add_argument("--multihost", action="store_true",
                        help="Start the process group from torchrun's environment (one "
                        "process per card; also when WORLD_SIZE > 1).")
    parser.add_argument("--seed", type=int, default=0, help="Global RNG seed.")
    parser.add_argument("--bf16", action="store_true",
                        help="Compute the convs in bfloat16 (the model's dtype and "
                        "TrainConfig.use_bfloat16 from one flag).")
    parser.add_argument("--samples", type=int, default=1000,
                        help="Posterior draws for the uncertainty task.")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="Write a torch.profiler trace of one training epoch here.")
    parser.add_argument("--debug_nans", action="store_true",
                        help="Autograd anomaly detection: fail at the backward op that "
                        "produced a NaN.")
    parser.add_argument("--remat", action="store_true",
                        help="Recompute the forward in the backward (activation memory down).")
    parser.add_argument("--accum_steps", type=int, default=1,
                        help="Gradient accumulation over this many microbatches per update.")
    parser.add_argument("--scan_steps", type=int, default=0,
                        help="Full optimizer steps (each its own batch) per dispatch: one "
                        "CUDA graph replay on the card; composes with --accum_steps; an "
                        "epoch's ragged tail runs as single steps. Default 0 = auto: after "
                        "epoch 1, fuse 2 steps only where it pays: on the card where a trial "
                        "at the head of epoch 2 (8 eager steps against 8 replayed) finds the "
                        "replay at least 3% faster; on the CPU where a launch's probed round "
                        "trip rivals computing.")
    parser.add_argument("--train_elbo", default="xla", choices=("xla", "pallas"),
                        help="Not ported, on purpose (ROADMAP A.3).")
    parser.add_argument("--bf16_moments", action="store_true",
                        help="Keep Adam's first moment in bf16.")
    parser.add_argument("--zero1", action="store_true",
                        help="ZeRO-1: shard the large Adam moments over the mesh's ranks.")
    parser.add_argument("--backend", default="",
                        help="'cpu' runs on the host (the plain CPU path); the default runs "
                        "on the CUDA card.")
    parser.add_argument("--tensorboard", action="store_true",
                        help="Also write TensorBoard event files under runs/<name>/tb.")
    parser.add_argument("--async_ckpt", action="store_true",
                        help="Write checkpoints on a background thread (flushed when fit "
                        "returns).")
    parser.add_argument("--pallas_conv", action="store_true",
                        help="Not ported, on purpose (ROADMAP A.3).")
    parser.add_argument("--int8", action="store_true",
                        help="Run the posterior-sampling task through the W8A8 quantized "
                        "decoder (training runs in full precision).")
    args = parser.parse_args(argv)
    _resolve_model_flags(args)
    return args


def _resolve_model_flags(args: argparse.Namespace) -> None:
    """Fill the model-shape flags left unset: from the checkpoint's recorded
    config when ``--model_ckpt`` is given (a port checkpoint or a JAX
    ``.msgpack`` one: both keep it in ``<path>.meta.json``), else the
    reference defaults. An explicit flag always wins; ``_config_drift``
    warns when it differs from the recorded one."""
    recorded: Dict[str, Any] = {}
    if args.model_ckpt:
        from simple_vae_rs_tpu_torch.train.checkpoint import read_meta

        recorded = read_meta(args.model_ckpt).get("model", {})

    def pick(explicit, key, legacy):
        saved = recorded.get(key)
        return (legacy if saved is None else saved) if explicit is None else explicit

    args.model_type = str(pick(args.model_type, "type", "Cond_SRVAE"))
    args.compression_ratio = float(pick(args.compression_ratio, "cr", 1.5))
    args.latent_size = int(pick(args.latent_size, "latent_size_override", 0))
    if args.patch_size is None:
        saved = recorded.get("patch_size")
        # the recorded value is the model's patch size; the plain VAE trains
        # on the LR stream at --patch_size // 2, so the flag is twice it
        args.patch_size = (64 if saved is None
                           else int(saved) * (2 if args.model_type == "VAE" else 1))
    # converted reference checkpoints carry the C-major latent wiring
    args.torch_regroup = bool(recorded.get("torch_regroup", False))


def _config_drift(recorded: dict, current: dict) -> list:
    """Warnings for flags that disagree with the model config a checkpoint
    recorded: the models are fully convolutional, so a mismatch may load and
    silently train or test another network shape."""
    return [
        f"warning: {key}={current[key]} differs from the checkpoint's "
        f"recorded {key}={val}"
        for key, val in recorded.items()
        if key in current and current[key] != val
    ]


def _refuse_unported(args: argparse.Namespace) -> None:
    for flag, (default, why) in UNPORTED.items():
        value = getattr(args, flag, default)
        if value != default:
            raise ValueError(f"--{flag} {value}: {why}")


def main(args: argparse.Namespace) -> Dict[str, Any]:
    """Train (or with ``--test`` only evaluate) as the flags say, then run the
    task. Returns ``{"trainer", "start_epoch", "task", "job_id"}``."""
    import torch

    from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, MeshConfig, TrainConfig, VAEConfig
    from simple_vae_rs_tpu_torch.data.loader import init_dataloader
    from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
    from simple_vae_rs_tpu_torch.models.srvae import SRVAE
    from simple_vae_rs_tpu_torch.models.vae import VAE
    from simple_vae_rs_tpu_torch.parallel.mesh import init_distributed, make_mesh, unshard_model
    from simple_vae_rs_tpu_torch.serve import backend_device
    from simple_vae_rs_tpu_torch.tasks import run_task
    from simple_vae_rs_tpu_torch.train.callbacks import EarlyStopping, ModelCheckpoint
    from simple_vae_rs_tpu_torch.train.checkpoint import (
        SUFFIX,
        checkpoint_exists,
        load_checkpoint,
        load_jax_checkpoint,
    )
    from simple_vae_rs_tpu_torch.train.engine import Trainer
    from simple_vae_rs_tpu_torch.utils.logging import NullLogger, make_logger

    cr = args.compression_ratio
    if cr <= 0:
        raise ValueError("Compression ratio must be a positive integer.")
    # --test skips training (reference train.py:54-68); without a checkpoint
    # there is nothing to test
    if args.test and not args.model_ckpt:
        raise ValueError("--test requires --model_ckpt (nothing to test otherwise).")
    _refuse_unported(args)
    device = backend_device(args.backend)
    if args.multihost or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = init_distributed(device)  # one process per card: this rank's
    mesh = make_mesh(MeshConfig(data=args.mesh_data, model=args.mesh_model, dcn=args.mesh_dcn))
    print(f"Mesh: {dict(mesh.shape)} over {mesh.size} device(s)")
    # one process alone trains as it always has; ranks shard every batch
    dp = mesh if mesh.distributed else None

    job_id = os.environ.get("SLURM_JOB_ID", f"local_{time.strftime('%Y%m%d-%H%M%S')}")
    train_loader, val_loader = init_dataloader(
        args.dataset, args.batch_size, args.patch_size, crop=args.crop,
        data_root=args.data_root, seed=args.seed, workers=args.workers, device=device, mesh=dp)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.model_type == "VAE":
        # the reference trains the plain VAE on the LR stream at ps/2
        # (train.py:35-40)
        cfg = VAEConfig(cr=cr, patch_size=args.patch_size // 2,
                        latent_size_override=args.latent_size)
        model = VAE(cfg, device=device, dtype=dtype)
    elif args.model_type in ("Cond_SRVAE", "SRVAE"):
        cfg = CondSRVAEConfig(cr=cr, patch_size=args.patch_size,
                              latent_size_override=args.latent_size,
                              torch_regroup=getattr(args, "torch_regroup", False))
        cls = CondSRVAE if args.model_type == "Cond_SRVAE" else SRVAE
        model = cls(cfg, device=device, dtype=dtype)
    else:
        raise ValueError(f"Unknown model type: {args.model_type}. Choose 'Cond_SRVAE' or 'VAE'.")
    model.init_weights(args.seed)

    train_cfg = TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                            val_metrics_every=args.val_metrics_every, seed=args.seed,
                            use_bfloat16=args.bf16, profile_dir=args.profile_dir,
                            remat=args.remat, bf16_moments=args.bf16_moments,
                            accum_steps=args.accum_steps, zero1=args.zero1,
                            scan_steps=args.scan_steps)
    callbacks = [
        ModelCheckpoint(job_id, "ckpt", monitor="Loss/val_loss", mode="min",
                        async_save=args.async_ckpt),
        EarlyStopping(patience=train_cfg.early_stop_patience, delta=train_cfg.early_stop_delta),
    ]
    # one metrics stream per job: the other ranks train and evaluate alike
    # but log nowhere
    logger = NullLogger() if mesh.rank != 0 else make_logger(
        args.model_type,
        f"Latent-{cfg.latent_size}-Patch-{cfg.patch_size}-SLURM-{job_id}",
        config={"latent_size": cfg.latent_size, "patch_size": cfg.patch_size,
                "epochs": args.epochs, "batch_size": args.batch_size,
                "val_metrics_every": args.val_metrics_every, "slurm_job_id": job_id,
                "cr": cr},
        tensorboard=args.tensorboard)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    trainer = Trainer(model, train_cfg, device=device, seed=args.seed, callbacks=callbacks,
                      logger=logger, job_id=job_id, mesh=dp)
    # The JAX CLI builds its state from one train batch
    # (``trainer.init_state(next(iter(train_loader)))``), and that iter()
    # advances the loader's epoch counter, which seeds the shuffle and the
    # crops: the port takes no such batch but advances the counter alike, so
    # the same tiles land in the same steps.
    train_loader.epoch += 1

    start_epoch = 1
    if args.model_ckpt:
        print("Loading model from checkpoint...")
        if not checkpoint_exists(args.model_ckpt):
            raise FileNotFoundError(f"Model checkpoint {args.model_ckpt} not found.")
        full = os.path.abspath(args.model_ckpt)
        if os.path.exists(full + SUFFIX):
            meta = load_checkpoint(args.model_ckpt, trainer)  # the scheduler too
        else:
            # a JAX .msgpack: weights, statistics, Adam state, step and
            # scheduler; the generator stays the one --seed made
            meta = load_jax_checkpoint(args.model_ckpt, trainer)
        for line in _config_drift(meta.get("model", {}), trainer._model_meta()):
            print(line)
        start_epoch = int(meta.get("epoch", 0)) + 1
        print("Model loaded successfully.")

    if not args.test:
        if start_epoch == 1:
            trainer.pretrain_lr_branch(train_loader, args.pre_epochs)
        trainer.fit(train_loader, val_loader, epochs=args.epochs, start_epoch=start_epoch,
                    val_metrics_every=args.val_metrics_every)

    # the task runs on the whole model: heads sharded over the model axis
    # are gathered (on every rank: a collective)
    model = unshard_model(model)
    if args.int8:
        # quantize the trained model once; the task's decodes run the W8A8
        # kernels (training above ran in full precision)
        from simple_vae_rs_tpu_torch.ops import quantize as qz

        qz.attach_quant(model, qz.quantize_params_tree(model, args.seed))
    gen = torch.Generator(device=trainer.device).manual_seed(args.seed)
    task = run_task(model, val_loader, job_id, cr, generator=gen, samples=args.samples, mesh=dp)
    return {"trainer": trainer, "start_epoch": start_epoch, "task": task, "job_id": job_id,
            "mesh": mesh}


def entrypoint(argv: Optional[Sequence[str]] = None) -> None:
    import torch

    from simple_vae_rs_tpu_torch.serve import backend_device

    arguments = parse_args(argv)
    print("==========================")
    print("Initializing training with the following arguments:")
    print(arguments)
    print("--------------------------")
    print(f"Model checkpoint: "
          f"{'not' if arguments.model_ckpt is None else arguments.model_ckpt} provided")
    print("--------------------------")
    print("Device:", "cpu" if backend_device(arguments.backend) == "cpu" else
          (torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no CUDA card"))
    print("==========================")
    try:
        main(arguments)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    entrypoint()
