"""Int8 weight quantization (port of ``simple_vae_rs_tpu/ops/quantize.py``).

Scheme: symmetric per-output-channel int8. A conv kernel ``(kh, kw, C, O)``
gets ``scale[o] = absmax(w[..., o]) / 127`` (1 for a zero channel) and either

- :func:`quantize_stochastic`: ``q = floor(x) + (u < x - floor(x))`` with
  ``x = w / scale`` (a true division) and ``u`` uniform in [0, 1), clipped to
  +-127: unbiased, ``E[q] * scale == w``, the W8A8 serving mode's quantizer
  (``SuperResolver(int8=True)`` through :func:`quantize_params_tree`); or
- :func:`quantize_rtn`: round to nearest (half to even), the weights-only
  mode's (:func:`pack_int8_weights`).

The uniform numbers come from a counter-based generator, an integer hash of
``(seed, element index)`` (:func:`hash_uniform`): element ``i`` of a tensor
draws ``u_i = mantissa(mix32(mix32(i ^ k0) + k1))`` where ``mix32`` is the
32-bit finalizer ``x ^= x >> 16; x *= 0x7feb352d; x ^= x >> 15;
x *= 0x846ca68b; x ^= x >> 16`` and ``(k0, k1)`` are two mixed words of the
64-bit seed (:func:`seed_words`). The top 23 bits become the mantissa of a
float in [1, 2), minus 1. The CUDA kernel (``csrc/quantize.cu``, the port of
the Pallas kernel ``_quant_kernel``) and the plain version
(:func:`quantize_stochastic_plain`, plain PyTorch integer arithmetic) compute
the same hash, so the same ``(weights, seed)`` give the same bytes on the
CPU and on the card, on every run. The stream is not the TPU's, nor
``jax.random``'s: against the JAX package the contract is distributional
(error below one grid step, unbiased).

A CPU tensor goes through the plain version; a CUDA tensor launches the
kernels or raises. On the card a whole quant tree is one C call
(:func:`quantize_leaves`: a column-absmax pass and a stochastic-round pass,
each one launch over every leaf); :func:`quantize_stochastic` is the tree of
one leaf. :data:`launches` counts the kernels' launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import zlib
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

Tensor = torch.Tensor

SOURCE = "quantize.cu"
QMAX = 127.0
# Decoder submodule prefixes (VAE ``dec_*``, CondSRVAE ``dx_*`` / ``dy_*``),
# matched against every component of a kernel's path.
DECODER_PREFIXES = ("dec_", "dx_", "dy_")
# Leaves smaller than this stay float32 in the weights-only mode: biases,
# BatchNorm leaves and the gamma scalars.
PACK_MIN_SIZE = 4096

launches: Dict[str, int] = {"quantize_stochastic": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def true_div(t: Tensor, value: float) -> Tensor:
    """``t / value`` as one IEEE division per element on every device. With a
    Python scalar PyTorch's CUDA division multiplies by the reciprocal, which
    is an ulp off for some inputs: enough to move a quantized value across a
    rounding boundary, and to make the card's scales differ from the CPU's."""
    return t / torch.full((), value, dtype=t.dtype, device=t.device)


def channel_scales(w: Tensor) -> Tensor:
    """Per-output-channel symmetric scales: absmax over all but the last
    axis, over 127; a zero channel gets 1 so the dequant multiply stays
    defined."""
    amax = w.detach().to(torch.float32).abs().amax(dim=tuple(range(w.dim() - 1)))
    return torch.where(amax > 0, true_div(amax, QMAX), torch.ones_like(amax))


def quantize_rtn(w: Tensor) -> Tuple[Tensor, Tensor]:
    """Round-to-nearest (half to even) int8 values and their scales."""
    scale = channel_scales(w)
    q = torch.clamp(torch.round(w.detach().to(torch.float32) / scale), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize(q: Tensor, scale: Tensor, dtype=torch.float32) -> Tensor:
    """``q * scale`` along the last axis."""
    return (q.to(torch.float32) * scale).to(dtype)


# ------------------------------------------------------ counter-based uniform
_M32 = 0xFFFFFFFF


def _mix32_int(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


def seed_words(seed: int) -> Tuple[int, int]:
    """The two 32-bit key words ``(k0, k1)`` of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0 = _mix32_int((seed & _M32) + 0x9E3779B9)
    k1 = _mix32_int((seed >> 32) ^ k0 ^ 0x85EBCA6B)
    return k0, k1


def _mix32(x: Tensor) -> Tensor:
    # 32-bit words carried in int64: a product wraps modulo 2**64, which
    # keeps its low 32 bits, and the mask drops the rest
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def hash_uniform(numel: int, seed: int, device=None) -> Tensor:
    """``numel`` float32 uniforms in [0, 1): element ``i`` from the hash of
    ``(seed, i)`` described in the module docstring."""
    if numel >= 2**32:
        raise ValueError("hash_uniform indexes elements with 32 bits")
    k0, k1 = seed_words(seed)
    i = torch.arange(numel, dtype=torch.int64, device=device)
    bits = _mix32((_mix32(i ^ k0) + k1) & _M32)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def quantize_stochastic_plain(w: Tensor, seed: int) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`quantize_stochastic` (JAX
    ``quantize_stochastic_ref`` with the hash stream for ``u``)."""
    scale = channel_scales(w)
    x = w.detach().to(torch.float32) / scale
    lo = torch.floor(x)
    u = hash_uniform(x.numel(), seed, x.device).reshape(x.shape)
    q = torch.clamp(lo + (u < (x - lo)).to(torch.float32), -QMAX, QMAX)
    return q.to(torch.int8), scale


# Leaves of one table of ``csrc/quantize.cu`` (its MAX_LEAVES): a C call
# launches its two passes once per this many leaves.
TABLE_LEAVES = 48


class _Leaf(ctypes.Structure):
    """``SvrsQuantLeaf`` of ``csrc/quantize.cu``."""
    _fields_ = [("w", ctypes.c_void_p), ("q", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("numel", ctypes.c_longlong), ("o", ctypes.c_int), ("k0", ctypes.c_uint),
                ("k1", ctypes.c_uint)]


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from simple_vae_rs_tpu_torch.ops import _build

        lib = _build.load(SOURCE)
        fn = lib.svrs_quantize_tree
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(_Leaf), ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def quantize_leaves(leaves: Sequence[Tuple[Tensor, int]]) -> List[Tuple[Tensor, Tensor]]:
    """:func:`quantize_stochastic` of every ``(w, seed)`` of ``leaves``: on
    CPU tensors the plain version leaf by leaf; on one CUDA card one C call
    for all of them (a zeroed absmax scratch, then two launches per
    :data:`TABLE_LEAVES` leaves; an empty leaf launches nothing). On the card
    the results are views of one int8 and one float32 buffer."""
    if not leaves:
        return []
    dev = leaves[0][0].device
    if dev.type == "cpu":
        return [quantize_stochastic_plain(w, seed) for w, seed in leaves]
    if dev.type != "cuda":
        raise ValueError(f"quantize_stochastic: CPU or CUDA tensors only, not {dev}")
    for w, _ in leaves:
        if w.device != dev:
            raise ValueError(f"quantize_stochastic: all leaves must be on {dev}, one is on "
                             f"{w.device}")
        if w.dtype != torch.float32:
            raise TypeError(f"quantize_stochastic: float32 only, got {w.dtype}")
        if w.dim() < 1 or w.numel() >= 2**31:
            raise ValueError(f"quantize_stochastic: bad shape {tuple(w.shape)}")
    out: List[Optional[Tuple[Tensor, Tensor]]] = [None] * len(leaves)
    live = []
    for i, (w, seed) in enumerate(leaves):
        if w.numel() == 0:  # nothing to launch: the plain version's result (or error)
            out[i] = quantize_stochastic_plain(w, seed)
        else:
            live.append(i)
    if live:
        ws = [leaves[i][0].detach().contiguous() for i in live]
        sizes = [w.numel() for w in ws]
        widths = [w.shape[-1] for w in ws]
        q_all = torch.empty(sum(sizes), dtype=torch.int8, device=dev)
        # the scales, then the absmax scratch
        s_all = torch.empty(2 * sum(widths), dtype=torch.float32, device=dev)
        table = (_Leaf * len(ws))()
        qo = so = 0
        for j, (i, w) in enumerate(zip(live, ws)):
            q = q_all[qo:qo + sizes[j]].view(w.shape)
            s = s_all[so:so + widths[j]]
            table[j] = _Leaf(w.data_ptr(), q.data_ptr(), s.data_ptr(), sizes[j], widths[j],
                             *seed_words(leaves[i][1]))
            out[i] = (q, s)
            qo += sizes[j]
            so += widths[j]
        index = ws[0].get_device()
        err = _library().svrs_quantize_tree(index, table, len(ws), s_all[so:].data_ptr(),
                                            torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            raise RuntimeError(f"quantize_stochastic: CUDA launch failed with cudaError {err}")
        launches["quantize_stochastic"] += 2 * -(-len(ws) // TABLE_LEAVES)
    return out


def quantize_stochastic(w: Tensor, seed: int) -> Tuple[Tensor, Tensor]:
    """Stochastic-round ``w`` to ``(int8 values, float32 per-last-axis
    scales)``; the same ``(w, seed)`` give the same bytes on any device. On
    the card, the tree of one leaf (:func:`quantize_leaves`)."""
    return quantize_leaves([(w, seed)])[0]


# ----------------------------------------------------------- the quant tree
def _conv_modules(model: nn.Module) -> Iterator[Tuple[Tuple[str, ...], nn.Module]]:
    """(flax path of the kernel leaf, module) of every conv of ``model``."""
    for name, mod in model.named_modules():
        kernel = getattr(mod, "kernel", None)
        if isinstance(kernel, nn.Parameter) and kernel.dim() == 4 and hasattr(mod, "set_quant"):
            yield tuple(name.split(".")) if name else (), mod


def leaf_seed(seed: int, path: Tuple[str, ...]) -> int:
    """The 64-bit seed of one leaf's stream: ``seed`` in the high word and
    the CRC-32 of the leaf's flax path in the low one."""
    return ((int(seed) & _M32) << 32) | zlib.crc32("/".join(path).encode())


def quantize_params_tree(model: nn.Module, seed: int,
                         prefixes: Tuple[str, ...] = DECODER_PREFIXES) -> Dict[str, Any]:
    """The ``quant`` tree of ``model``: every conv kernel whose flax path
    (``a/b/kernel`` for the module ``a.b``) has a component starting with one
    of ``prefixes`` becomes ``{"kernel_q": int8, "kernel_s": (O,) float32}``
    at the same path; every other leaf is left out. Each leaf has its own
    stream (:func:`leaf_seed`), so the tree is reproducible for a given
    ``(weights, seed)``. On the card the whole tree is one C call
    (:func:`quantize_leaves`). Attach it with :func:`attach_quant`."""
    paths, leaves = [], []
    for path, mod in _conv_modules(model):
        leaf = path + ("kernel",)
        if any(comp.startswith(pref) for comp in leaf for pref in prefixes):
            paths.append(path)
            leaves.append((mod.kernel.detach(), leaf_seed(seed, leaf)))
    tree: Dict[str, Any] = {}
    for path, (q, s) in zip(paths, quantize_leaves(leaves)):
        node = tree
        for comp in path:
            node = node.setdefault(comp, {})
        node["kernel_q"], node["kernel_s"] = q, s
    return tree


def _quant_leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    if "kernel_q" in tree or "kernel_s" in tree:
        if set(tree) != {"kernel_q", "kernel_s"}:
            raise KeyError(f"quant node {'/'.join(prefix)!r} must hold kernel_q and "
                           f"kernel_s alone, got {sorted(tree)}")
        yield prefix, tree["kernel_q"], tree["kernel_s"]
        return
    for key, val in tree.items():
        if not isinstance(val, Mapping):
            raise KeyError(f"unexpected quant leaf {'/'.join(prefix + (key,))!r}")
        yield from _quant_leaves(val, prefix + (key,))


def attach_quant(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Give ``model``'s convs the int8 weights of a ``quant`` tree (nested
    dicts of tensors or arrays, as :func:`quantize_params_tree` and the JAX
    package build it) and clear them on every other conv: their presence on
    a conv is what routes it through the int8 kernels. Raises ``KeyError``
    on a path that is no conv of the model."""
    convs = dict(_conv_modules(model))
    given = {}
    for path, q, s in _quant_leaves(tree):
        if path not in convs:
            raise KeyError(f"quant leaf {'/'.join(path)!r} matches no conv of the model")
        given[path] = (q, s)
    for path, mod in convs.items():
        mod.set_quant(*given.get(path, (None, None)))
    return model


def has_quant(model: nn.Module) -> bool:
    """Whether any conv of ``model`` carries int8 weights."""
    return any(mod.kernel_q is not None for _, mod in _conv_modules(model))


# ------------------------------------------------- weights-only int8 pack
def pack_int8_weights(model: nn.Module) -> Dict[str, Tuple[Tensor, Tensor]]:
    """Weights-only int8: round-to-nearest quantize every floating parameter
    with ``ndim >= 2`` and at least :data:`PACK_MIN_SIZE` elements (the conv
    kernels) to ``(int8 values, per-last-axis float32 scales)`` on the
    parameter's device, and release the parameter's float32 storage: the
    model then holds an empty tensor there and runs only inside
    :func:`unpack_weights`. Returns ``{parameter name: (q, scale)}``."""
    packed = {}
    for name, p in model.named_parameters():
        if p.dim() >= 2 and p.numel() >= PACK_MIN_SIZE and p.is_floating_point():
            packed[name] = quantize_rtn(p.detach())
            p.requires_grad_(False)
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
    return packed


@contextlib.contextmanager
def unpack_weights(model: nn.Module, packed: Optional[Mapping[str, Tuple[Tensor, Tensor]]]):
    """For the length of one request, give every packed parameter of
    ``model`` its dequantized float32 value (``q * scale``); the storage is
    released again on exit. Does nothing when ``packed`` is None."""
    if not packed:
        yield model
        return
    params = dict(model.named_parameters())
    try:
        for name, (q, s) in packed.items():
            params[name].data = dequantize(q, s)
        yield model
    finally:
        for name in packed:
            p = params[name]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
