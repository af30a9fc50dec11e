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

``SuperResolver(model, mesh=make_mesh(MeshConfig(data=N), devices=[...]))``
serves from one process over a device mesh (``parallel/mesh.py``): one
replica of the model per batch shard (after the int8 quantization and the
chain switch, so every replica serves the same weights; on a mesh with a
``model`` axis the parameters are replicated and the request split over the
batch axes alone, as JAX's resolver does, one replica on each shard's first
device), each request's batch
padded to the replica count and split over the replicas, every replica's
launches issued before the outputs are gathered on the first device. The
noise is drawn on the first device exactly as the single-card resolver
draws it for the unpadded batch, then split, so a meshed request is the
single-card one run on each replica's rows: within 1e-6 of the whole batch
in float32; in bfloat16 on the card within a bf16 rounding (which kernel a
launch takes follows its batch, ``ops/fused_conv.wg_route``); in W8A8 with
one activation scale per replica's rows, as JAX's ``shard_map`` takes one
per shard. ``uncertainty`` rounds its chunk up to the replica count (JAX
``serve.py:490-507``).

On the card, ``uncertainty`` replays a request as one CUDA graph, in every
mode but ``int8_weights`` (its weights are unpacked into new tensors per
request, which a graph would not see) and a mesh; on the CPU it runs
eagerly. The graphs are keyed by what the request's body branches on: the
LR shape, ``samples``, the chunk, ``normalize``, the model's dtype and its
plain, chain and training switches. The first request of a key runs eagerly
on a side stream, which serves it, then captures the graph
(``graph_captures``); each later one stages the image through a pinned
buffer, draws its noise outside the graph from the same generator in the
same order as the eager path (``eps_u``, then a whole chunk of ``eps_z``
for each chunk), replays (``graph_replays``; the normalization is in the
graph) and returns clones of the graph's maps, so the maps are the caller's
own and a replay adds the capture's tally to the launch counters. A capture
that raises is warned about and its key served eagerly from then on.

The gain rests on traffic that repeats a key: a capture costs about an
eager request more, besides the device synchronize, ``gc.collect`` and
``empty_cache`` that ``torch.cuda.graph`` makes. So a resolver holds at
most ``MAX_GRAPHS`` graphs, in one memory pool: its requests never overlap,
so the graphs share their intermediates, a dropped graph's blocks serve the
next capture, and the pool goes back to the card with the last graph. Once
it holds that many, a new key is served eagerly until it has been asked for
more often than the least recently used key held (of the last
``COUNTED_KEYS`` keys asked for), and then takes its place: one-off keys,
and a cycle over more keys than the bound, are served eagerly rather than
captured again and again. ``super_resolve``, ``super_resolve_moments`` and
the tile endpoints run eagerly.

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

import collections
import contextlib
import copy
import dataclasses
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
from simple_vae_rs_tpu_torch.ops import quantize as qz
from simple_vae_rs_tpu_torch.ops.conv_blocks import use_chain
from simple_vae_rs_tpu_torch.parallel.mesh import Mesh, replicate
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
from simple_vae_rs_tpu_torch.utils.trace import span

Tensor = torch.Tensor

MAX_GRAPHS = 4  # uncertainty's graphs a resolver holds
COUNTED_KEYS = 64  # the most recent request keys whose counts it keeps


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


def _launch_cells() -> List[Tuple[dict, str]]:
    """Every launch counter a request moves (the float and int8 conv
    kernels'), as ``(dict, key)`` pairs in a fixed order."""
    cells: List[Tuple[dict, str]] = []

    def walk(counts: dict) -> None:
        for key, v in counts.items():
            if isinstance(v, dict):
                walk(v)
            else:
                cells.append((counts, key))

    for counters in (fc.counters(), {"launches": f8.launches, "bf16_launches": f8.bf16_launches}):
        walk(counters)
    return cells


def _moments(draws: Tensor) -> Dict[str, Tensor]:
    with span("svrs.uq.moments"):
        return {
            "mean": draws.mean(dim=0),
            "std": draws.std(dim=0, correction=0),
            "variance": draws.var(dim=0, correction=0),
        }


@dataclasses.dataclass
class RequestGraph:
    """One uncertainty request of ``samples`` draws captured as a CUDA
    graph, and its static tensors: the raw LR image and the noise it reads
    (``eps_z`` a whole ``chunk`` for each chunk, as ``decode_draws`` decodes
    them), the maps it writes, and the launches one replay makes (``(counts,
    key, n)``: ``n`` more in the counter ``counts[key]``). On the card a
    pinned buffer stages a host image, and an event marks its last copy."""

    graph: Any
    y: Tensor
    eps_u: Tensor
    eps_z: Tensor
    samples: int
    chunk: int
    normalize: bool
    host: Optional[Tensor] = None
    copied: Any = None
    maps: Dict[str, Tensor] = dataclasses.field(default_factory=dict)
    tally: List[Tuple[dict, str, int]] = dataclasses.field(default_factory=list)

    @classmethod
    def static(cls, model, shape: Tuple[int, ...], samples: int, chunk: int,
               normalize: bool, device: torch.device) -> "RequestGraph":
        """The static tensors of a request of ``model`` on an LR image of
        ``shape`` (1, h, w, C) on ``device``; no graph yet."""
        shape_u, shape_z = model.generation_noise_shapes(1, tuple(shape[1:3]))
        draws = -(-samples // chunk) * chunk
        g = cls(None, torch.empty(shape, device=device), torch.empty(shape_u, device=device),
                torch.empty((draws, *shape_z[1:]), device=device), samples, chunk, normalize)
        if device.type == "cuda":
            g.host, g.copied = torch.empty(shape, pin_memory=True), torch.cuda.Event()
        return g

    def load(self, y: Tensor) -> None:
        """Copy the LR image in; from the host through the pinned buffer,
        the copy left to run while the host goes on."""
        if self.host is None or y.device.type != "cpu":
            self.y.copy_(y)
            return
        self.copied.synchronize()  # the buffer's last copy to the card has run
        self.host.copy_(y)
        self.y.copy_(self.host, non_blocking=True)
        self.copied.record()

    def draw(self, gen: torch.Generator) -> None:
        """The request's noise from ``gen``, as the eager path draws it:
        ``eps_u``, then one chunk of ``eps_z`` at a time."""
        self.eps_u.normal_(generator=gen)
        for lo in range(0, self.eps_z.shape[0], self.chunk):
            self.eps_z[lo:lo + self.chunk].normal_(generator=gen)

    def generate(self, model) -> Dict[str, Tensor]:
        """The request's maps from the static tensors: the eager request's
        body with the noise passed in (what the graph captures)."""
        y = normalize_image(self.y) if self.normalize else self.y
        draws = model.sample(y, None, self.eps_z.shape[0], self.chunk, self.eps_u, self.eps_z)
        return _moments(draws[:self.samples])


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
    with the whole-raster endpoints of ``TileEndpoints``. With a device
    ``mesh`` it serves from a replica per device, on ``mesh.devices[0]``
    (``device`` is then not read)."""

    def __init__(self, model, device="cuda", seed: int = 0,
                 normalize: bool = True, int8: bool = False,
                 int8_weights: bool = False, chain: bool = False,
                 mesh: Optional[Mesh] = None) -> None:
        if not isinstance(model, (CondSRVAE, SRVAE)):
            raise TypeError("SuperResolver serves CondSRVAE/SRVAE models")
        if int8 and int8_weights:
            raise ValueError(
                "int8 (W8A8 decoder kernels) and int8_weights (weights only, "
                "dequantized per request) are different quantization modes: pick one"
            )
        if mesh is not None:
            if mesh.is_process:
                raise ValueError("a SuperResolver serves over a device mesh "
                                 "(make_mesh(cfg, devices=[...]))")
            device = mesh.devices[0]
        super().__init__(device, seed, normalize)
        self.int8, self.int8_weights = int8, int8_weights
        self.mesh = mesh
        self._packed = None
        if int8_weights or (int8 and not qz.has_quant(model)) or (chain and not model.chain):
            model = copy.deepcopy(model)  # the caller's model stays as it is
        self.model = model.to(self.device).eval()
        if chain:
            use_chain(self.model)
        if int8 and not qz.has_quant(self.model):
            qz.attach_quant(self.model, qz.quantize_params_tree(self.model, seed))
        # one replica per device of the mesh, the first being self.model
        self._replicas = replicate(mesh, self.model) if mesh is not None else None
        self._replica_packed = []  # each replica's packed weights (int8_weights)
        if int8_weights:
            self._replica_packed = [qz.pack_int8_weights(m)
                                    for m in (self._replicas or [self.model])]
            self._packed = self._replica_packed[0]
        # uncertainty's graphs by key, least recently used first (None: its
        # capture failed, served eagerly), and the recent keys' request counts
        self.graphs: Dict[tuple, Optional[RequestGraph]] = collections.OrderedDict()
        self._requests: Dict[tuple, int] = collections.OrderedDict()
        self.graph_captures = 0  # captures begun, failed ones included
        self.graph_replays = 0  # requests served by a replay
        self._pool = None  # the graphs' memory pool
        self._side_stream = None

    @classmethod
    def from_checkpoint(cls, path: str, cr: Optional[float] = None,
                        patch_size: Optional[int] = None, channels: Optional[int] = None,
                        latent_size: Optional[int] = None, model_type: Optional[str] = None,
                        dtype: torch.dtype = torch.float32, seed: int = 0, int8: bool = False,
                        int8_weights: bool = False, chain: bool = False,
                        device="cuda", mesh: Optional[Mesh] = None) -> "SuperResolver":
        """Rebuild the model around the checkpoint at ``path`` (the port's
        ``<path>.pt`` or the JAX package's ``<path>.msgpack``; not both) and
        serve it on ``device``, or over the device ``mesh``.

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
        dev = resolve_device(mesh.devices[0] if mesh is not None else device)
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
                   chain=chain, mesh=mesh)

    def _input(self, y, normalize: bool = False) -> Tensor:
        y = self._checked(y).to(self.device)
        if normalize:
            y = normalize_image(y)
        return y.contiguous()

    def _checked(self, y) -> Tensor:
        """``y`` as a float32 (B, h, w, C) LR tensor where it lies, its shape
        checked."""
        y = y if isinstance(y, Tensor) else torch.as_tensor(np.asarray(y))
        y = y.to(torch.float32)
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
        return y

    def _noise_shapes(self, batch: int, lr_hw: Tuple[int, int]):
        return self.model.generation_noise_shapes(batch, lr_hw)

    def _serving(self):
        """The int8-weights mode's float weights (every replica's), unpacked
        for one request."""
        stack = contextlib.ExitStack()
        for m, packed in zip(self._replicas or [self.model], self._replica_packed):
            stack.enter_context(qz.unpack_weights(m, packed))
        return stack

    def _generate(self, y: Tensor, eps_u: Tensor, eps_z: Tensor, normalize: bool) -> Tensor:
        if normalize:
            y = normalize_image(y)
        if self._replicas is not None:
            return self._replicas.map(lambda m, yy, eu, ez: m.conditional_generation_eps(
                yy, eu, ez), y, eps_u, eps_z)
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
        ``chunk`` is None; on a mesh rounded up to the replica count, each
        chunk's decode split over the replicas). On the card one graph
        replay a request (the module's docstring says when)."""
        with span("svrs.uq.request"):
            graphs = self.device.type == "cuda" and self.mesh is None and not self.int8_weights
            with span("svrs.uq.input"):
                y = self._checked(y)[:1] if graphs else self._input(y, self.normalize)[:1]
            if chunk is None:
                chunk = auto_chunk(samples, int(y.shape[1]) * 2)
            if self._replicas is not None:
                n = len(self._replicas)
                chunk = -(-chunk // n) * n
            if graphs:
                maps = self._replayed(y, samples, chunk, seed)
                if maps is not None:
                    return maps
                with span("svrs.uq.input"):
                    y = self._input(y, self.normalize)
            with self._serving():
                draws = sample_chunked(self.model, y, self._generator(seed), samples=samples,
                                       chunk=chunk, replicas=self._replicas)
            return _moments(draws)

    def _replayed(self, y: Tensor, samples: int, chunk: int,
                  seed: Optional[int]) -> Optional[Dict[str, Tensor]]:
        """The maps of one request of the raw LR image ``y`` from its key's
        graph, captured on the key's first request it admits (``_admits``);
        None, before any draw, where the key is served eagerly."""
        if samples < 1:
            raise ValueError(f"samples must be >= 1 (got {samples})")
        chunk = max(1, min(chunk, samples))  # as models/vae.decode_draws
        m = self.model
        key = (tuple(y.shape), samples, chunk, self.normalize, m.dtype, bool(m.plain),
               bool(m.chain), m.training)
        if not self._admits(key):
            return None
        if key not in self.graphs:
            with span("svrs.uq.capture"):
                return self._capture(key, y, samples, chunk, self._generator(seed))
        g = self.graphs[key]
        if g is None:
            return None
        with span("svrs.uq.replay"):
            g.load(y)
            g.draw(self._generator(seed))
            g.graph.replay()  # may overwrite another graph's maps: they share a pool
            self.graph_replays += 1
            for counts, name, n in g.tally:
                counts[name] += n
            return {name: t.clone() for name, t in g.maps.items()}

    def _admits(self, key: tuple) -> bool:
        """Count a request of ``key``: whether it is served from a graph, one
        held or one captured now. Past ``MAX_GRAPHS`` a key takes the least
        recently used one's place once it has been asked for more often than
        that one's key (the module's docstring says why)."""
        n = self._requests.pop(key, 0) + 1
        self._requests[key] = n
        if len(self._requests) > COUNTED_KEYS:
            self._requests.popitem(last=False)
        if key in self.graphs:
            self.graphs.move_to_end(key)
            return True
        if len(self.graphs) < MAX_GRAPHS:
            return True
        oldest = next(iter(self.graphs))
        if n < 2 or n <= self._requests.get(oldest, 0):
            return False
        del self.graphs[oldest]  # its graph and static tensors go
        return True

    def _capture(self, key: tuple, y: Tensor, samples: int, chunk: int,
                 gen: torch.Generator) -> Dict[str, Tensor]:
        """Serve the first request of ``key`` eagerly on a side stream, then
        capture it into ``self.graphs[key]``; the maps are the eager run's."""
        self.graph_captures += 1
        dev = self.device
        g = RequestGraph.static(self.model, tuple(y.shape), samples, chunk, self.normalize,
                                dev)
        g.load(y)
        g.draw(gen)
        # the request itself, on a side stream (the kernels built on first use)
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(dev)
        side, main = self._side_stream, torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            maps = g.generate(self.model)
        main.wait_stream(side)
        for t in maps.values():
            t.record_stream(main)  # made on the side stream, read on the caller's
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cells = _launch_cells()
        before = [counts[name] for counts, name in cells]
        causes: list = []
        g.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g.graph, pool=self._pool, capture_error_mode="thread_local"):
                try:
                    g.maps = g.generate(self.model)
                except BaseException as e:
                    causes.append(e)
                    raise
        except Exception as e:
            self._after_failed_capture(key, causes[0] if causes else e)
        else:
            g.tally = [(counts, name, counts[name] - n)
                       for (counts, name), n in zip(cells, before) if counts[name] != n]
            self.graphs[key] = g
        finally:
            for (counts, name), n in zip(cells, before):
                counts[name] = n  # the capture launched nothing
        return maps

    def _after_failed_capture(self, key: tuple, cause: BaseException) -> None:
        """A capture that raised never reached its generators' epilogue: give
        the resolver's generator and the card's default one a fresh state of
        the same seed and offset (as ``Trainer._after_failed_capture``), and
        serve ``key`` eagerly from now on."""
        dev = self.device
        default = torch.cuda.default_generators[dev.index if dev.index is not None
                                                else torch.cuda.current_device()]
        for gen in (self._rng, default):
            gen.graphsafe_set_state(gen.clone_state())
        self.graphs[key] = None
        warnings.warn(f"uncertainty: capturing the request {key} as a CUDA graph failed "
                      f"({type(cause).__name__}: {cause}); it is served eagerly",
                      RuntimeWarning, stacklevel=3)


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
    mesh = getattr(resolver, "mesh", None)
    for dev in dict.fromkeys(mesh.devices if mesh is not None else [resolver.device]):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
