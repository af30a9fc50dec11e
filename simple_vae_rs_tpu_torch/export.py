"""Portable serving artifacts: the SR endpoint as one ``torch.export`` file
(the counterpart of the JAX package's ``export.py``).

The artifact is ``torch.export`` of the **plain-PyTorch** generation graph
(normalize switch, then ``conditional_generation_eps``) with the weights in
it, saved with ``torch.export.save`` beside a ``path + ".meta.json"``
sidecar (the JAX sidecar's keys, under this package's own ``format``). It

- needs only ``torch`` to load and run (none of this package: the loader
  below is a convenience);
- holds only ``aten`` ops, checked at export (:func:`graph_ops`): the model
  is traced as a CPU copy in eval mode with every conv on its plain version,
  the tail chain off and no int8 weights. The hand-written CUDA kernels are
  ctypes calls that ``torch.export`` cannot carry, and are kept out just as
  the JAX artifact keeps Pallas custom calls out (traced with every Pallas
  gate forced to XLA, without the ``quant`` collection). The live
  ``SuperResolver`` goes on serving through the kernels; the artifact
  trades them for a file that runs wherever PyTorch does;
- is device-neutral: :class:`ExportedResolver` places it on the device it
  is given (``torch.export.passes.move_to_device_pass``), and every call runs
  with TF32 off, as the plain versions do (the switch is not recorded in an
  exported graph);
- is deterministic given its inputs ``(y, eps_u, eps_z, do_norm)``:
  ``torch.export`` takes no ``Generator``, so the reparameterization noise is
  an input, and :class:`ExportedResolver` draws it as the live
  ``SuperResolver`` does (the request paths of ``serve.Endpoints``: the same
  generator, order and per-seed rule). A seeded request off
  the artifact is then the live resolver's plain path on the same seed, and
  two replays agree bit for bit. ``do_norm`` is a traced bool, so one
  artifact serves both the direct path (normalize on) and the tile path
  (windows arrive normalized).

``weights="bf16"`` or ``"int8"`` stores every floating tensor of at least
two dimensions and :data:`_PACK_MIN_SIZE` elements (the conv kernels) as
bfloat16, or as int8 with per-output-channel float32 scales
(round-to-nearest, :func:`_rtn_numpy`); the graph upcasts or dequantizes
them with plain ops, so the file is about a half or a quarter of the f32
one. A bfloat16 model exports as it serves: float32 parameters cast inside
the graph, float32 outputs. A W8A8 resolver exports its float weights.

    sr = SuperResolver.from_checkpoint("ckpt/job", device="cpu")
    export_resolver(sr, "model.pt2")             # model.pt2 + model.pt2.meta.json
    esr = load_exported("model.pt2")             # on the card by default
    x_hat = esr.super_resolve(lr_batch)          # re-batched into the fixed batch
    big = esr.super_resolve_tile(lr_raster)      # whole-raster serving

Command line (the export runs on the host; ``--verify`` loads the artifact
and runs one batch on ``--backend``'s device, the card by default)::

    python -m simple_vae_rs_tpu_torch.export ckpt/job model.pt2 \\
        [--batch 16] [--weights f32|bf16|int8] [--verify]
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from simple_vae_rs_tpu_torch.serve import Endpoints, backend_device
from simple_vae_rs_tpu_torch.utils.image import normalize_image

Tensor = torch.Tensor

FORMAT = "svrs-torch-export/1"
JAX_FORMAT = "svrs-export/1"  # the JAX package's StableHLO artifacts

# Tensors smaller than this stay float32 under weight compression: biases,
# BatchNorm parameters and statistics and the gammas are numerically
# load-bearing and a rounding error of the file's size.
_PACK_MIN_SIZE = 4096

WEIGHT_MODES = ("f32", "bf16", "int8")


def _rtn_numpy(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Round-to-nearest int8 and per-last-axis symmetric scales, in numpy:
    absmax / 127 per output channel, scale 1 for a channel of zeros."""
    a = arr.astype(np.float32)
    absmax = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)))
    scale = np.where(absmax == 0.0, 1.0, absmax / 127.0).astype(np.float32)
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, scale


def _pack_variables(variables: Dict[str, Tensor], weights: str) -> Dict[str, tuple]:
    """``{name: tensor}`` with its large floating tensors compressed: each
    entry ``("raw", t)``, ``("bf16", t_bf16)`` or ``("int8", q, scale)``.
    Only floating tensors with ``ndim >= 2`` and at least
    :data:`_PACK_MIN_SIZE` elements (the conv kernels) are compressed, so the
    scheme is per-output-channel on exactly the tensors where it is accurate."""
    if weights not in WEIGHT_MODES:
        raise ValueError(f"weights must be one of {WEIGHT_MODES} (got {weights!r})")
    packed: Dict[str, tuple] = {}
    for name, t in variables.items():
        t = t.detach().cpu()
        big_float = t.dim() >= 2 and t.numel() >= _PACK_MIN_SIZE and t.is_floating_point()
        if weights == "f32" or not big_float:
            packed[name] = ("raw", t)
        elif weights == "bf16":
            packed[name] = ("bf16", t.float().to(torch.bfloat16))  # to nearest even
        else:
            q, scale = _rtn_numpy(t.float().numpy())
            packed[name] = ("int8", torch.from_numpy(q), torch.from_numpy(scale))
    return packed


class _Eps(nn.Module):
    """``model.conditional_generation_eps`` as a module's forward, for
    ``torch.func.functional_call``."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()
        self.m = model

    def forward(self, y: Tensor, eps_u: Tensor, eps_z: Tensor) -> Tensor:
        return self.m.conditional_generation_eps(y, eps_u, eps_z)


class _Generation(nn.Module):
    """The exported computation: ``(y, eps_u, eps_z, do_norm)`` -> SR batch.

    ``serve.SuperResolver.super_resolve``'s math (float32 input, optional
    per-image min-max normalization, one conditional generation with the
    given noise), the model's tensors held as this module's buffers in their
    packed form and rebuilt in the graph (``torch.func.functional_call``), so
    the compressed tensors, not their float32 expansion, are what the
    artifact stores."""

    def __init__(self, model: nn.Module, packed: Dict[str, tuple]) -> None:
        super().__init__()
        self.__dict__["_eps"] = _Eps(model)  # not a submodule: its weights stay out
        self._entries = []
        for i, (name, entry) in enumerate(packed.items()):
            attrs = []
            for j, t in enumerate(entry[1:]):
                attrs.append(f"t{i}_{j}")
                self.register_buffer(attrs[-1], t.contiguous())
            self._entries.append((name, entry[0], attrs))

    def unpacked(self) -> Dict[str, Tensor]:
        """The model's tensors rebuilt from their packed form: bf16 upcast,
        int8 times its per-output-channel scales."""
        state = {}
        for name, kind, attrs in self._entries:
            t = getattr(self, attrs[0])
            if kind == "bf16":
                t = t.float()
            elif kind == "int8":
                t = t.float() * getattr(self, attrs[1])
            state[name] = t
        return state

    def forward(self, y: Tensor, eps_u: Tensor, eps_z: Tensor, do_norm: Tensor) -> Tensor:
        y = y.float()
        y = torch.where(do_norm, normalize_image(y), y)
        state = {"m." + name: t for name, t in self.unpacked().items()}
        return torch.func.functional_call(self._eps, state, (y, eps_u, eps_z))


def graph_ops(program) -> set:
    """The call targets of an exported program's graph."""
    return {node.target for node in program.graph.nodes if node.op == "call_function"}


def _check_aten(program) -> None:
    """Raise unless every op of the graph is an ``aten`` op: no custom op, no
    Python callback into the kernels' library."""
    bad = sorted(str(t) for t in graph_ops(program)
                 if not (isinstance(t, torch._ops.OpOverload) and t.namespace == "aten"))
    if bad:
        raise RuntimeError(f"the exported graph holds ops that are not aten ops: {bad}")


def _plain_copy(resolver) -> nn.Module:
    """A CPU copy of the resolver's model, in eval mode, every conv on its
    plain version, the chain off, no int8 weights (the float weights of an
    ``int8_weights`` resolver unpacked)."""
    from simple_vae_rs_tpu_torch.ops import quantize as qz
    from simple_vae_rs_tpu_torch.ops.conv_blocks import use_chain, use_plain_path

    with qz.unpack_weights(resolver.model, getattr(resolver, "_packed", None)):
        model = copy.deepcopy(resolver.model)
    model = model.to("cpu").eval()
    qz.attach_quant(model, {})
    use_chain(model, False)
    use_plain_path(model)
    return model


def export_resolver(resolver, path: str, batch: int = 16, weights: str = "f32") -> str:
    """Write ``resolver``'s (``serve.SuperResolver``) SR endpoint to ``path``
    and its sidecar to ``path + ".meta.json"``; returns ``path``.

    The artifact is fixed-shape, ``(batch, ps/2, ps/2, C)`` in and ``(batch,
    ps, ps, C)`` out, with the noise of that batch as inputs;
    :class:`ExportedResolver` re-batches any request size into it.
    ``weights`` compresses the stored tensors (module doc)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1 (got {batch})")
    model = _plain_copy(resolver)
    packed = _pack_variables(dict([*model.named_parameters(), *model.named_buffers()]), weights)
    cfg = model.config
    ps, channels = int(cfg.patch_size), int(cfg.channels)
    shape_u, shape_z = model.generation_noise_shapes(batch, (ps // 2, ps // 2))
    args = (torch.zeros(batch, ps // 2, ps // 2, channels), torch.zeros(shape_u),
            torch.zeros(shape_z), torch.tensor(True))
    with torch.no_grad():
        program = torch.export.export(_Generation(model, packed), args, strict=False)
    program = program.run_decompositions()
    _check_aten(program)
    torch.export.save(program, path)
    meta = {
        "format": FORMAT,
        "model_type": type(model).__name__,
        "cr": float(cfg.cr),
        "patch_size": ps,
        "channels": channels,
        "batch": int(batch),
        "scale": 2,
        "normalize": bool(resolver.normalize),
        "weights": weights,
        # the JAX count: parameters (gammas included) and BatchNorm statistics
        "n_params": int(sum(t.numel() for t in model.state_dict().values())),
    }
    with open(path + ".meta.json", "w") as fh:
        json.dump(meta, fh, indent=1)
    return path


def export_checkpoint(ckpt_path: str, out_path: str, batch: int = 16, weights: str = "f32",
                      **model_kwargs: Any) -> str:
    """Checkpoint -> artifact in one call: the model rebuilt on the CPU from
    the checkpoint's meta as serving does (``SuperResolver.from_checkpoint``)."""
    from simple_vae_rs_tpu_torch.serve import SuperResolver

    resolver = SuperResolver.from_checkpoint(ckpt_path, device="cpu", **model_kwargs)
    return export_resolver(resolver, out_path, batch=batch, weights=weights)


def _check_format(meta: Dict[str, Any]) -> None:
    fmt = meta.get("format")
    if fmt == JAX_FORMAT:
        raise ValueError(f"{JAX_FORMAT} is the JAX package's StableHLO artifact: serve it with "
                         f"simple_vae_rs_tpu.export; this package serves {FORMAT} artifacts")
    if fmt != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact (sidecar says {fmt!r})")


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for one call, as the plain versions run: an exported graph
    does not record the switch, and TF32 would move the float32 output by
    more than 1e-4 from the live path."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _input_shapes(program) -> list:
    """The shapes of the program's user inputs, in order."""
    names = set(program.graph_signature.user_inputs)
    return [tuple(node.meta["val"].shape) for node in program.graph.nodes
            if node.op == "placeholder" and node.name in names]


class ExportedResolver(Endpoints):
    """Serve a loaded artifact with the live resolver's API: ``super_resolve``,
    ``super_resolve_moments``, ``uncertainty``, ``mmse_estimate`` and the
    whole-raster ``TileEndpoints``. The program is moved to ``device`` (the
    card by default) here, in place, the one place where its device is
    decided. Every
    request is re-batched into the artifact's fixed ``batch`` (the ragged
    tail padded by repeating its last row, input and noise, and trimmed on
    the device). Noise is drawn as the live resolver draws it
    (``serve.Endpoints``). Outputs are float32 tensors on ``device``."""

    def __init__(self, program, meta: Dict[str, Any], seed: int = 0, device="cuda") -> None:
        _check_format(meta)
        super().__init__(device, seed, bool(meta["normalize"]))
        from torch.export.passes import move_to_device_pass

        self.meta = dict(meta)
        self.batch = int(meta["batch"])
        self._program = move_to_device_pass(program, str(self.device))
        self._graph = self._program.module()
        _, shape_u, shape_z, _ = _input_shapes(self._program)
        self._shapes = (shape_u[1:], shape_z[1:])

    @property
    def window(self) -> int:
        """LR window size of the tile endpoints: one model patch in LR space."""
        return int(self.meta["patch_size"]) // 2

    def _input(self, y) -> Tensor:
        y = y if isinstance(y, Tensor) else torch.as_tensor(np.asarray(y))
        y = y.to(self.device, torch.float32)
        if y.dim() == 3:
            y = y[None]
        w, c = self.window, int(self.meta["channels"])
        if y.dim() != 4 or tuple(y.shape[1:]) != (w, w, c):
            raise ValueError(f"artifact serves (B, {w}, {w}, {c}) LR batches, got "
                             f"{tuple(y.shape)}")
        return y.contiguous()

    def _noise_shapes(self, batch: int, lr_hw: Tuple[int, int]):
        """The graph's noise shapes (``lr_hw`` is the fixed window)."""
        shape_u, shape_z = self._shapes
        return (batch, *shape_u), (batch, *shape_z)

    def _serving(self):
        return _no_tf32()

    def _flag(self, value: bool) -> Tensor:
        return torch.tensor(bool(value), device=self.device)

    @torch.no_grad()
    def _call(self, y: Tensor, eps_u: Tensor, eps_z: Tensor, flag: Tensor) -> Tensor:
        """One dispatch of the graph on a full batch."""
        out = self._graph(y, eps_u, eps_z, flag)
        if out.device.type != self.device.type:
            raise RuntimeError(f"the artifact ran on {out.device}, not on {self.device}")
        return out

    def _dispatch(self, y: Tensor, eps_u: Tensor, eps_z: Tensor, flag: Tensor) -> Tensor:
        """Up to ``batch`` rows through the graph: a short batch is padded by
        repeating its last row and trimmed after."""
        short = self.batch - int(y.shape[0])
        if short:
            pad = lambda t: torch.cat([t, t[-1:].expand(short, *t.shape[1:])])
            y, eps_u, eps_z = pad(y), pad(eps_u), pad(eps_z)
        out = self._call(y, eps_u, eps_z, flag)
        return out[:self.batch - short] if short else out

    def _generate(self, y: Tensor, eps_u: Tensor, eps_z: Tensor, normalize: bool) -> Tensor:
        """Any number of rows, in ceil(B / batch) dispatches; ``normalize`` is
        the graph's traced flag."""
        flag = self._flag(normalize)
        outs = [self._dispatch(y[i:i + self.batch], eps_u[i:i + self.batch],
                               eps_z[i:i + self.batch], flag)
                for i in range(0, int(y.shape[0]), self.batch)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def uncertainty(self, y, samples: int = 32, chunk: Optional[int] = None,
                    seed: Optional[int] = None) -> Dict[str, Tensor]:
        """Posterior SR statistics of one LR image: mean/std/variance maps
        over ``samples`` draws, in ceil(samples / batch) dispatches of the
        image repeated ``batch`` times (each slot an independent draw, as the
        JAX artifact's). ``chunk`` is taken for the live resolver's signature;
        the artifact's batch is the chunk."""
        del chunk
        if samples < 2:
            raise ValueError(f"samples must be >= 2 (got {samples})")
        y = self._input(y)[:1]
        if self.normalize:
            y = normalize_image(y)
        tile = y.expand(self.batch, *y.shape[1:]).contiguous()
        flag = self._flag(False)
        gen = self._generator(seed)
        s1 = s2 = None
        done = 0
        with self._serving():
            while done < samples:
                take = min(self.batch, samples - done)
                sr = self._call(tile, *self._noise(self.batch, tuple(tile.shape[1:3]), gen),
                                flag)[:take]
                part1, part2 = sr.sum(dim=0), (sr * sr).sum(dim=0)
                s1 = part1 if s1 is None else s1 + part1
                s2 = part2 if s2 is None else s2 + part2
                done += take
        mean = s1 / samples
        var = torch.clamp_min(s2 / samples - mean * mean, 0.0)
        return {"mean": mean, "std": torch.sqrt(var), "variance": var}


def _sidecar(path: str) -> Dict[str, Any]:
    """The sidecar of the artifact at ``path``; raises if it is missing."""
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"{meta_path} missing: artifacts travel as the pair "
                                "(file, file.meta.json)")
    with open(meta_path) as fh:
        return json.load(fh)


def load_exported(path: str, seed: int = 0, device="cuda") -> ExportedResolver:
    """Load ``path`` (and its ``.meta.json``) for serving on ``device``."""
    meta = _sidecar(path)
    _check_format(meta)
    return ExportedResolver(torch.export.load(path), meta, seed=seed, device=device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m simple_vae_rs_tpu_torch.export",
        description="Export a checkpoint's SR endpoint to a torch.export artifact (weights "
        "stored in it; serves with torch alone).")
    p.add_argument("ckpt", help="checkpoint path (as given to --model_ckpt, e.g. ckpt/job)")
    p.add_argument("out", help="artifact output path (writes out + out.meta.json)")
    p.add_argument("--batch", type=int, default=16,
                   help="fixed serving batch of the artifact (default 16: the tile "
                   "endpoints' window batch)")
    p.add_argument("--weights", default="f32", choices=WEIGHT_MODES,
                   help="stored precision of the large tensors: f32 (exact, default), bf16 "
                   "(about half the file) or int8 (about a quarter; per-channel weight-only "
                   "quantization, dequantized by plain ops in the graph)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_normalize", action="store_true",
                   help="make normalize-off the artifact's default (inputs arrive "
                   "normalized)")
    p.add_argument("--verify", action="store_true",
                   help="after writing, load the artifact on --backend's device and run one "
                   "batch")
    p.add_argument("--backend", default="",
                   help="device of --verify: 'cpu', or the CUDA card (the default); the "
                   "export itself runs on the host")
    args = p.parse_args(argv)
    device = backend_device(args.backend)

    from simple_vae_rs_tpu_torch.serve import SuperResolver

    resolver = SuperResolver.from_checkpoint(args.ckpt, seed=args.seed, device="cpu")
    if args.no_normalize:
        resolver.normalize = False
    path = export_resolver(resolver, args.out, batch=args.batch, weights=args.weights)
    print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB, weights={args.weights}) + "
          f"{path}.meta.json")
    if args.verify:
        esr = load_exported(path, seed=args.seed, device=device)
        w, c = esr.window, int(esr.meta["channels"])
        y = np.random.default_rng(0).random((args.batch, w, w, c), np.float32)
        out = esr.super_resolve(y)
        print(f"verify: super_resolve({y.shape}) -> {tuple(out.shape)} on {out.device}, "
              f"range [{float(out.min()):.4f}, {float(out.max()):.4f}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
