"""Serving API of the port: super-resolve LR batches, quantify uncertainty.

    model = CondSRVAE(CondSRVAEConfig(), device="cuda").init_weights(0)
    sr = SuperResolver(model)                      # device="cuda" by default
    x_hat = sr.super_resolve(lr_batch)             # (B, ps, ps, C) in [0, 1]
    maps = sr.uncertainty(lr_image, samples=1000)  # mean/std/variance maps

Two quantized modes, one at most:

- ``SuperResolver(model, int8=True)``: W8A8. The decoder's conv kernels
  (``dx_*`` / ``dy_*``) are stochastic-round quantized once at construction
  from ``seed`` (``ops/quantize.quantize_params_tree``), and the decoder's
  convs run through the int8 kernels of ``ops/fused_int8.py``, activations
  quantized in the call. The resolver works on a copy of the model, so a
  float32 resolver of the same model is untouched; a model that already
  carries int8 weights is served as it is.
- ``SuperResolver(model, int8_weights=True)``: weights only. Every large
  conv kernel is round-to-nearest quantized at construction
  (``ops/quantize.pack_int8_weights``) and held as int8 plus scales; each
  request dequantizes them, runs the float32 graph and releases them, so
  between requests the resolver holds a quarter of the weight bytes.

A bfloat16 model (``CondSRVAE(cfg, dtype=torch.bfloat16)``) is served as
it is: its convs compute in bfloat16 and every output is float32. It takes
every mode a float32 model takes, as the JAX resolver does: with ``int8``
its decoder's convs run the int8 kernels on bfloat16 activations and return
bfloat16; with ``int8_weights`` the packed weights dequantize to float32
parameters, which each conv casts to bfloat16 as it does any parameter
(both quantizers work on the float32 parameters, in either dtype); with
``chain`` its tails run the chain kernel's bfloat16 instance.

``SuperResolver(model, chain=True)`` serves a copy of the model whose
eval-mode conv tails each run as one launch of the chain kernel
(``ops/conv_blocks.use_chain``; off by default). It combines with either
int8 mode: with ``int8`` no tail chains (the model carries int8 weights, on
which ``ops/conv_blocks.tail_chain`` steps aside, as the JAX package's
does), and with ``int8_weights`` the chain runs on the weights unpacked for
the request.

Whole rasters of any size are served through the ``tiling.TileEndpoints``
mixin: ``super_resolve_tile``, ``uncertainty_tile`` and the bounded-memory
``iter_tile_rows`` cover the raster with a grid of ``window``-sized LR
windows, dispatch them in fixed-size batches and stitch the outputs on the
host (numpy in, numpy out).

``SuperResolver.from_checkpoint(path)`` rebuilds the model a checkpoint was
trained as, from the config in its meta (``train/checkpoint.read_meta``),
and serves it: the port's own checkpoints and the JAX package's
``.msgpack`` ones.

Every endpoint takes ``seed=None``: an unseeded call draws its noise from the
resolver's rolling generator (fresh draws each call), ``seed=N`` from a
generator of its own seeded with N, so the same input, seed and options
reproduce the output on the same device, and seeded calls never perturb the
rolling stream. Inputs are NHWC numpy arrays or tensors; outputs are float32
tensors on the resolver's device.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.ops import quantize as qz
from simple_vae_rs_tpu_torch.ops.conv_blocks import use_chain
from simple_vae_rs_tpu_torch.tasks import auto_chunk, sample_chunked
from simple_vae_rs_tpu_torch.tiling import TileEndpoints
from simple_vae_rs_tpu_torch.train.checkpoint import (
    JAX_SUFFIX,
    SUFFIX,
    load_state,
    read_jax_checkpoint,
    read_meta,
)
from simple_vae_rs_tpu_torch.utils.image import normalize_image
from simple_vae_rs_tpu_torch.utils.jax_weights import load_jax_variables

Tensor = torch.Tensor


def backend_device(backend: str) -> str:
    """A command line's ``--backend`` as a device name: the card by default
    (``""`` or ``"cuda"``), the host with ``"cpu"``; anything else raises."""
    device = backend or "cuda"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"--backend {backend!r}: the port runs on 'cuda' (the default) or "
                         "'cpu'")
    return device


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but no CUDA card is available; "
            "pass device='cpu' to run the plain CPU path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Endpoints(TileEndpoints):
    """What a resolver serves, over one hook that generates a batch.

    The request paths shared by the live ``SuperResolver`` and the artifact's
    ``export.ExportedResolver``: the generators (the rolling one, or one of
    its own for ``seed=N``), the noise drawn for the whole request
    (``eps_u``, then ``eps_z``), ``super_resolve``, ``super_resolve_moments``
    and ``mmse_estimate``. A subclass gives ``window``, ``uncertainty`` and
    the hooks: ``_input(y)`` (the LR batch as a float32 tensor on
    ``device``), ``_noise_shapes(batch, lr_hw)``, ``_serving()`` (a context
    that holds for one request) and ``_generate(y, eps_u, eps_z,
    normalize)`` (one draw of the batch)."""

    def __init__(self, device, seed: int, normalize: bool) -> None:
        self.device = resolve_device(device)
        self.normalize = normalize
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(int(seed))

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        if seed is None:
            return self._rng
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def _noise(self, batch: int, lr_hw: Tuple[int, int],
               gen: torch.Generator) -> Tuple[Tensor, Tensor]:
        shape_u, shape_z = self._noise_shapes(batch, lr_hw)
        eps_u = torch.randn(shape_u, generator=gen, device=self.device)
        eps_z = torch.randn(shape_z, generator=gen, device=self.device)
        return eps_u, eps_z

    @torch.no_grad()
    def super_resolve(self, y, normalize: Optional[bool] = None,
                      seed: Optional[int] = None) -> Tensor:
        """LR batch (B, ps/2, ps/2, C) -> one posterior draw (B, ps, ps, C)."""
        y = self._input(y)
        eps_u, eps_z = self._noise(int(y.shape[0]), tuple(y.shape[1:3]), self._generator(seed))
        with self._serving():
            return self._generate(y, eps_u, eps_z,
                                  self.normalize if normalize is None else normalize)

    @torch.no_grad()
    def super_resolve_moments(self, y, samples: int, normalize: bool = False,
                              seed: Optional[int] = None) -> Tuple[Tensor, Tensor]:
        """Per-pixel sum and sum of squares over ``samples`` fresh draws of
        each LR window: ``(s1, s2)``, each (B, ps, ps, C)."""
        if samples < 1:
            raise ValueError(f"samples must be >= 1 (got {samples})")
        y = self._input(y)
        gen = self._generator(seed)
        s1 = s2 = None
        with self._serving():
            for _ in range(samples):
                eps_u, eps_z = self._noise(int(y.shape[0]), tuple(y.shape[1:3]), gen)
                out = self._generate(y, eps_u, eps_z, normalize)
                s1 = out if s1 is None else s1 + out
                s2 = out * out if s2 is None else s2 + out * out
        return s1, s2

    def mmse_estimate(self, y, samples: int = 32, chunk: Optional[int] = None,
                      seed: Optional[int] = None) -> Tensor:
        """Posterior-mean SR reconstruction (minimum-MSE estimator)."""
        return self.uncertainty(y, samples=samples, chunk=chunk, seed=seed)["mean"]


class SuperResolver(Endpoints):
    """2x super-resolution and uncertainty service for one CondSRVAE or
    SRVAE (which also takes HR-sized inputs and downsamples them first),
    with the whole-raster endpoints of ``TileEndpoints``."""

    def __init__(self, model, device="cuda", seed: int = 0,
                 normalize: bool = True, int8: bool = False,
                 int8_weights: bool = False, chain: bool = False) -> None:
        if not isinstance(model, (CondSRVAE, SRVAE)):
            raise TypeError("SuperResolver serves CondSRVAE/SRVAE models")
        if int8 and int8_weights:
            raise ValueError(
                "int8 (W8A8 decoder kernels) and int8_weights (weights only, "
                "dequantized per request) are different quantization modes: pick one"
            )
        super().__init__(device, seed, normalize)
        self.int8, self.int8_weights = int8, int8_weights
        self._packed = None
        if int8_weights or (int8 and not qz.has_quant(model)) or (chain and not model.chain):
            model = copy.deepcopy(model)  # the caller's model stays as it is
        self.model = model.to(self.device).eval()
        if chain:
            use_chain(self.model)
        if int8 and not qz.has_quant(self.model):
            qz.attach_quant(self.model, qz.quantize_params_tree(self.model, seed))
        if int8_weights:
            self._packed = qz.pack_int8_weights(self.model)

    @classmethod
    def from_checkpoint(cls, path: str, cr: Optional[float] = None,
                        patch_size: Optional[int] = None, channels: Optional[int] = None,
                        latent_size: Optional[int] = None, model_type: Optional[str] = None,
                        dtype: torch.dtype = torch.float32, seed: int = 0, int8: bool = False,
                        int8_weights: bool = False, chain: bool = False,
                        device="cuda") -> "SuperResolver":
        """Rebuild the model around the checkpoint at ``path`` (the port's
        ``<path>.pt`` or the JAX package's ``<path>.msgpack``; not both) and
        serve it on ``device``.

        A config argument left None comes from the model config recorded in
        the checkpoint's meta, then from the legacy defaults (cr=1.2, ps=64,
        4 bands, no latent override, Cond_SRVAE). An explicit argument wins,
        with a warning where it differs from the recorded one (the weights
        will then most likely not fit). ``torch_regroup`` (the reference's
        C-major latent wiring of converted checkpoints) is always the
        recorded one: the weights load under either wiring, only the
        generation would differ."""
        recorded = read_meta(path).get("model", {})

        def pick(explicit, key, legacy):
            saved = recorded.get(key)
            if explicit is None:
                return legacy if saved is None else saved
            if saved is not None and saved != explicit:
                print(f"warning: {key}={explicit} overrides the checkpoint's recorded "
                      f"{key}={saved}")
            return explicit

        cfg = CondSRVAEConfig(cr=float(pick(cr, "cr", 1.2)),
                              patch_size=int(pick(patch_size, "patch_size", 64)),
                              channels=int(pick(channels, "channels", 4)),
                              latent_size_override=int(pick(latent_size, "latent_size_override",
                                                            0)),
                              torch_regroup=bool(recorded.get("torch_regroup", False)))
        model_type = pick(model_type, "type", "Cond_SRVAE")
        classes = {"Cond_SRVAE": CondSRVAE, "SRVAE": SRVAE}
        if model_type not in classes:
            raise ValueError(f"SuperResolver serves Cond_SRVAE/SRVAE checkpoints, not "
                             f"{model_type!r} (recorded in {path}.meta.json)")
        dev = resolve_device(device)
        model = classes[model_type](cfg, device=dev, dtype=dtype)
        full = os.path.abspath(path)
        native, from_jax = os.path.exists(full + SUFFIX), os.path.exists(full + JAX_SUFFIX)
        if native and from_jax:
            raise ValueError(f"both {full}{SUFFIX} and {full}{JAX_SUFFIX} exist: remove the "
                             "one that is not meant")
        if native:
            model.load_state_dict(load_state(path)["model"])
        elif from_jax:
            tree = read_jax_checkpoint(path)
            load_jax_variables(model, {"params": tree["params"],
                                       "batch_stats": tree.get("batch_stats", {})})
        else:
            raise FileNotFoundError(f"no checkpoint at {full}({SUFFIX}|{JAX_SUFFIX})")
        return cls(model, device=dev, seed=seed, int8=int8, int8_weights=int8_weights,
                   chain=chain)

    def _input(self, y, normalize: bool = False) -> Tensor:
        y = y if isinstance(y, Tensor) else torch.as_tensor(np.asarray(y))
        y = y.to(self.device, torch.float32)
        if y.dim() == 3:
            y = y[None]
        if y.dim() != 4 or y.shape[-1] != self.model.config.channels:
            raise ValueError(
                f"expected (B, h, w, {self.model.config.channels}) LR input, "
                f"got {tuple(y.shape)}"
            )
        if y.shape[1] % 8 or y.shape[2] % 8:
            raise ValueError(
                f"LR height and width must be multiples of 8, got {tuple(y.shape)}"
            )
        if normalize:
            y = normalize_image(y)
        return y.contiguous()

    def _noise_shapes(self, batch: int, lr_hw: Tuple[int, int]):
        return self.model.generation_noise_shapes(batch, lr_hw)

    def _serving(self):
        """The int8-weights mode's float weights, unpacked for one request."""
        return qz.unpack_weights(self.model, self._packed)

    def _generate(self, y: Tensor, eps_u: Tensor, eps_z: Tensor, normalize: bool) -> Tensor:
        if normalize:
            y = normalize_image(y)
        return self.model.conditional_generation_eps(y, eps_u, eps_z)

    @property
    def window(self) -> int:
        """LR window size of the tile endpoints: one model patch in LR space."""
        return int(self.model.config.patch_size) // 2

    @torch.no_grad()
    def uncertainty(self, y, samples: int = 32, chunk: Optional[int] = None,
                    seed: Optional[int] = None) -> Dict[str, Tensor]:
        """Posterior SR statistics of one LR image: mean/std/variance maps
        over ``samples`` draws, decoded in chunks (``tasks.auto_chunk`` when
        ``chunk`` is None)."""
        y = self._input(y, self.normalize)[:1]
        if chunk is None:
            chunk = auto_chunk(samples, int(y.shape[1]) * 2)
        draws = sample_chunked(self.model, y, self._generator(seed),
                               samples=samples, chunk=chunk, packed=self._packed)
        return {
            "mean": draws.mean(dim=0),
            "std": draws.std(dim=0, correction=0),
            "variance": draws.var(dim=0, correction=0),
        }


def warmup(resolver: SuperResolver, lr_shape=(1, 32, 32, 4), tile_batch: Optional[int] = 16,
           uq_samples: Optional[int] = 32) -> None:
    """Run each endpoint once ahead of traffic (this builds the CUDA kernels
    on first use). ``tile_batch`` also runs the window batch the ``*_tile``
    endpoints dispatch (their default ``batch=16``), and ``uq_samples`` the
    moments request ``uncertainty_tile`` makes at its default draw count;
    ``None`` skips either."""
    y = np.zeros(lr_shape, np.float32)
    resolver.super_resolve(y, seed=0)
    resolver.uncertainty(y, samples=2, chunk=2, seed=0)
    if tile_batch:
        wins = np.zeros((tile_batch, *lr_shape[1:]), np.float32)
        resolver.super_resolve(wins, normalize=False, seed=0)
        if uq_samples:
            resolver.super_resolve_moments(wins, uq_samples, seed=0)
    if resolver.device.type == "cuda":
        torch.cuda.synchronize(resolver.device)
