"""Evaluation tasks of the port (the JAX package's ``tasks.py``): the N-draw
posterior decode, its per-pixel statistics, and ``run_task``, the report a
training run ends with:

- ``results/<job>_CRx<cr>/error_mean_std_maps.png``: the input, one draw,
  the ground truth and the draws' mean, then the MAE, MSE, STD and mean-bias
  maps over N posterior draws (default 1000, reference ``base.py:306``),
  and the printed MMSE;
- ``results/<job>_CRx<cr>/generated_image.png``: the unconditional
  generation panel (reference ``task.py:71-81``), for a Cond_SRVAE or SRVAE.

The plots need matplotlib; without it they are left out silently, as in the
JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE, decode_draws
from simple_vae_rs_tpu_torch.ops.quantize import unpack_weights
from simple_vae_rs_tpu_torch.parallel.mesh import first_rows

Tensor = torch.Tensor


def auto_chunk(samples: int, patch_size: int, budget_bytes: int = 1 << 30) -> int:
    """Decode chunk size that keeps the widest decoder activation (the
    full-resolution 64-channel tail, counted at 2 bytes with 2x headroom as
    in the JAX package) under ``budget_bytes``. At the canonical 64 px patch
    the 1000-draw task decodes in one chunk."""
    per_draw = patch_size * patch_size * 64 * 2 * 2
    return max(1, min(samples, budget_bytes // per_draw))


@torch.no_grad()
def sample_chunked(model, y: Tensor, generator: Optional[torch.Generator] = None,
                   samples: int = 1000, chunk: int = 100,
                   eps_u: Optional[Tensor] = None, eps_z: Optional[Tensor] = None,
                   packed=None, replicas=None) -> Tensor:
    """``samples`` posterior draws of one image ``y``, decoded in chunks:
    (samples, ps, ps, C).

    Cond_SRVAE and SRVAE (``y`` the LR image (1, ps/2, ps/2, C); an SRVAE also
    takes an HR-sized one and downsamples it): the conditioning pass runs
    once, with one ``u`` draw shared by all samples, and only the decoder
    runs per chunk (``CondSRVAE.sample``). VAE (``y`` (1, ps, ps, C)): the
    encoder runs once and chunks of ``mu + eps * std`` are decoded. Noise
    comes from ``generator`` unless injected: ``eps_u`` shaped like the u
    grid and ``eps_z`` (samples, z grid), or for a VAE ``eps_z`` (samples,
    latent_dim) alone. ``packed`` is the payload of a model in the
    weights-only int8 mode (``ops/quantize.pack_int8_weights``): its weights
    are dequantized for the length of this call. The noise and the draws are
    float32 for a model of either compute dtype (its decoder casts).

    On a device mesh (JAX ``tasks.py:40-100``) each chunk's decode is split
    over ``replicas`` (``parallel/mesh.replicate(mesh, model)``: one replica
    of the model per device), the conditioning pass and the noise staying on
    the first device: the draws are the single-device ones for the same
    chunk.
    """
    with unpack_weights(model, packed):
        if isinstance(model, (CondSRVAE, SRVAE)):
            return model.sample(y, generator, samples, chunk, eps_u, eps_z, replicas)
        if not isinstance(model, VAE):
            raise TypeError(f"sample_chunked takes a CondSRVAE, SRVAE or VAE, not "
                            f"{type(model).__name__}")
        mu, logvar = model.encode(y)
        decode = model.decode
        if replicas is not None:
            def decode(z: Tensor) -> Tensor:
                return replicas.map(lambda m, zz: m.decode(zz), z)
        return decode_draws(decode, mu, torch.exp(0.5 * logvar), samples, chunk, eps_z,
                            generator)


def error_statistics(samples: Tensor, target: Tensor) -> Dict[str, Tensor]:
    """Per-pixel statistics of draws (N, H, W, C) against ``target``
    (1, H, W, C) (reference ``base.py:309-344``): mean (H, W, C) and
    channel-averaged std of the draws, MAE and MSE of ``samples - target``
    over (draw, channel), the mean-bias map, each (H, W), and the scalar MMSE."""
    samples, target = samples.float(), target.float()
    diff = samples - target
    mean = samples.mean(dim=0)
    return {
        "mean": mean,
        "std": samples.std(dim=0, correction=0).mean(dim=-1),
        "mae": diff.abs().mean(dim=(0, 3)),
        "mse": (diff**2).mean(dim=(0, 3)),
        "mean_bias": (target[0] - mean).mean(dim=-1),
        "mmse": (diff**2).mean(),
    }


def uncertainty_maps(model, y: Tensor, generator: Optional[torch.Generator] = None,
                     samples: int = 32, chunk: int = 32) -> Dict[str, Tensor]:
    """Per-pixel mean, variance and std maps over ``samples`` posterior
    draws, in float32 whatever the model's compute dtype."""
    draws = sample_chunked(model, y, generator, samples=samples, chunk=chunk).float()
    return {
        "mean": draws.mean(dim=0),
        "variance": draws.var(dim=0, correction=0),
        "std": draws.std(dim=0, correction=0),
    }


# ----------------------------------------------------------------- reports
def _rgb(img) -> np.ndarray:
    """A 4-band HWC image as displayable RGB, bands [2, 1, 0] (reference
    ``base.py:317``); fewer than three bands as gray."""
    img = np.asarray(img)
    if img.shape[-1] >= 3:
        img = img[..., [2, 1, 0]]
    else:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.clip(img, 0.0, 1.0)


def run_task(model, val_loader, job_id: str, cr: float,
             generator: Optional[torch.Generator] = None, samples: int = 1000,
             chunk: Optional[int] = None, results_root: str = "results",
             mesh=None) -> Dict[str, Any]:
    """The reference's task: the error and uncertainty report of ``samples``
    posterior draws of one validation image, and the generation panel.

    A Cond_SRVAE or SRVAE takes item 1 of the first val batch (reference
    ``get_task_data``, ``cond_vae.py:594-603``); a VAE reconstructs the LR
    stream it trains on, item 0. Noise comes from ``generator`` (on the
    model's device; default seeded with 0). Prints ``MMSE: ...``; returns
    ``{"mmse", "results_dir"}``.

    On a process ``mesh`` every rank calls it with its loader (which yields
    its slices): the global batch's first images are gathered, and rank 0
    alone decodes, prints and writes; the others return ``{}``."""
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    results_dir = os.path.join(results_root, f"{job_id}_CRx{cr}")

    batch = next(iter(val_loader), None)
    if batch is None:
        raise ValueError("Validation loader is empty (batch_size larger than the val "
                         "split with drop_last?). Reduce --batch_size.")
    y_b = torch.as_tensor(batch[0]).to(device, torch.float32)
    x_b = torch.as_tensor(batch[1]).to(device, torch.float32)
    if mesh is not None:
        y_b, x_b = (first_rows(mesh, t, 2) for t in (y_b, x_b))
        if mesh.rank != 0:
            return {}
    os.makedirs(results_dir, exist_ok=True)
    if isinstance(model, (CondSRVAE, SRVAE)):
        i = min(1, y_b.shape[0] - 1)
        pred, target = y_b[i:i + 1], x_b[i:i + 1]
    else:
        pred, target = y_b[0:1], y_b[0:1]
    if chunk is None:
        chunk = auto_chunk(samples, int(target.shape[1]))
    model.eval()
    draws = sample_chunked(model, pred, generator, samples=samples, chunk=chunk)
    stats = {k: v.cpu().numpy() for k, v in error_statistics(draws, target).items()}
    mmse = float(stats["mmse"])
    print(f"MMSE: {mmse:.4f}")

    _plot_error_maps(results_dir, pred.cpu().numpy(), target.cpu().numpy(),
                     draws[0:1].float().cpu().numpy(), stats)
    if isinstance(model, (CondSRVAE, SRVAE)):
        with torch.no_grad():
            y_gen, x_gen = model.generation(generator)
        _plot_generation(results_dir, y_gen.float().cpu().numpy(), x_gen.float().cpu().numpy())
    return {"mmse": mmse, "results_dir": results_dir}


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _plot_error_maps(results_dir, pred, target, sample0, stats) -> None:
    plt = _pyplot()
    if plt is None:
        return
    plt.figure(figsize=(20, 10))
    panels = ((_rgb(pred[0]), "Input Image", None), (_rgb(sample0[0]), "Sampled Image", None),
              (_rgb(target[0]), "Ground Truth Image", None),
              (_rgb(stats["mean"]), "Mean of Samples", None),
              (stats["mae"], "MAE Map", "hot"), (stats["mse"], "MSE Map", "hot"),
              (stats["std"], f"STD of Samples, Mean: {stats['std'].mean():.2f}", "hot"),
              (stats["mean_bias"], f"Mean Bias Map, Mean: {stats['mean_bias'].mean():.2f}",
               "hot"))
    for k, (img, title, cmap) in enumerate(panels, start=1):
        plt.subplot(2, 4, k)
        plt.imshow(img, cmap=cmap)
        if cmap is not None:
            plt.colorbar()
        plt.title(title)
    plt.savefig(f"{results_dir}/error_mean_std_maps.png", bbox_inches="tight")
    plt.close()


def _plot_generation(results_dir, y_gen, x_gen) -> None:
    plt = _pyplot()
    if plt is None:
        return
    plt.figure(figsize=(10, 10))
    plt.subplot(2, 1, 1)
    plt.imshow(_rgb(y_gen[0]))
    plt.title("Generated Image")
    plt.subplot(2, 1, 2)
    plt.imshow(_rgb(x_gen[0]))
    plt.title("Generated Image from x")
    plt.savefig(f"{results_dir}/generated_image.png", bbox_inches="tight")
    plt.close()
