"""Fused chain of 3x3 convs: one CUDA kernel for n layers, and its plain version.

The port of ``simple_vae_rs_tpu/ops/pallas_conv.py``'s two chain kernels
(``fused_conv3x3_chain`` and ``fused_conv3x3_chain_wl``, which compute the
same function in two TPU layouts): a linear chain of ``n`` 3x3/s1 SAME convs,
each with its bias and no activation between,

    h_0 = x,    h_{l+1} = conv3x3(h_l, kernels[l]) + biases[l],

with ``x`` NHWC float32 ``(B, H, W, C_0)`` and ``kernels[l]`` in the JAX HWIO
layout ``(3, 3, C_l, C_{l+1})``. These are the models' eval-mode tails: the
four convs that end each decoder and each encoder.

:func:`fused_conv3x3_chain` given CPU tensors computes the plain version
(:func:`conv3x3_chain_plain`, the sequential ``F.conv2d`` chain, JAX
``_chain_reference``); given CUDA tensors it launches the hand-written kernel
in ``csrc/conv_chain.cu`` once for the whole chain, on the current stream, or
raises. There is no fallback between the two and no per-layer launch. The
launch is counted in ``fused_conv.launches["fused_conv3x3_chain"]``.

The chain has no backward (the JAX package's has none: training keeps the
per-layer kernels with their gradients), so the wrapper refuses tensors that
require one.

The CUDA source's header says what bounds the kernel and what its design
does about shared memory and halos; :func:`plan_chain` is the launch
geometry (output tile and the two stage buffers) it is given, and
:func:`tile_rects` the rectangles a block stores and computes per stage,
which the kernel derives the same way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from simple_vae_rs_tpu_torch.ops import fused_conv as fc

Tensor = torch.Tensor

NAME = fc.CHAIN
SOURCE = "conv_chain.cu"
MAX_LAYERS = 8  # MAXL of the CUDA source
SMEM_BYTES = 232_448  # shared memory a block can use on sm_90 (227 KB)
BK = 32  # weight rows staged per step
WS_FLOATS = BK * 64  # the staged weight slice of the CUDA source
TILE_SIDES = (4, 8, 16, 32, 64)

Rect = Tuple[int, int, int, int]  # y0, x0, h, w


def chan4(c: int) -> int:
    """Channels rounded up to whole 16-byte words: the depth of the K loop."""
    return (c + 3) & ~3


def pixel_stride(c: int) -> int:
    """Floats between two stored pixels: :func:`chan4` padded to an odd
    number of 16-byte words, so neighbouring pixels fall in different banks."""
    s = chan4(c)
    return s if (s >> 2) & 1 else s + 4


def layer_tile(cout: int, m: int) -> Tuple[int, int]:
    """``(TX, TM)`` of a layer with ``cout`` output channels on ``m`` pixels:
    threads along N (4 channels each) and pixels per thread, as the kernel
    picks them."""
    if cout > 16:
        return (16, 4) if m <= 64 else (16, 8)
    if cout > 4:
        return (4, 4) if m <= 256 else (4, 8)
    return (1, 2)


def tile_rects(ty0: int, tx0: int, th: int, tw: int, n: int, h: int, w: int
               ) -> Tuple[List[Rect], List[Rect]]:
    """``(stored, computed)`` rectangles per stage of the tile at
    ``(ty0, tx0)``: stage ``s`` (the input of layer ``s``) is stored on
    ``stored[s]`` = ``computed[s + 1]`` grown by one pixel per side, and
    computed on the part of it inside the image; ``computed[n]`` is the
    tile. ``stored`` has ``n`` entries, ``computed`` ``n + 1``."""
    computed: List[Optional[Rect]] = [None] * (n + 1)
    stored: List[Optional[Rect]] = [None] * n
    computed[n] = (ty0, tx0, min(th, h - ty0), min(tw, w - tx0))
    for s in range(n - 1, -1, -1):
        cy, cx, ch, cw = computed[s + 1]
        stored[s] = (cy - 1, cx - 1, ch + 2, cw + 2)
        y0, y1 = max(cy - 1, 0), min(cy + ch + 1, h)
        x0, x1 = max(cx - 1, 0), min(cx + cw + 1, w)
        computed[s] = (y0, x0, y1 - y0, x1 - x0)
    return stored, computed


def _extents(size: int, tile: int, n: int) -> List[List[int]]:
    """Computed extent along one axis, per tile and stage 1..n."""
    out = []
    for t0 in range(0, size, tile):
        _, computed = tile_rects(t0, 0, tile, 1, n, size, 1)
        out.append([r[2] for r in computed[1:]])
    return out


def _sides(size: int) -> List[int]:
    """Tile sides worth trying along an axis of ``size``: every side below it
    and the first that covers it."""
    return [s for i, s in enumerate(TILE_SIDES) if i == 0 or TILE_SIDES[i - 1] < size]


def stage_buffers(th: int, tw: int, h: int, w: int, chans: Sequence[int]) -> Tuple[int, int]:
    """Floats of the two stage buffers of a ``th x tw`` tile: stage ``s`` is
    at most ``th + 2 (n - s)`` by ``tw + 2 (n - s)`` pixels (and never more
    than the image with its border), and stages alternate between the two."""
    n = len(chans) - 1
    bufs = [4, 4]
    for s in range(n):
        size = (min(th + 2 * (n - s), h + 2) * min(tw + 2 * (n - s), w + 2)
                * pixel_stride(chans[s]))
        bufs[s & 1] = max(bufs[s & 1], size)
    return bufs[0], bufs[1]


@functools.lru_cache(maxsize=256)
def plan_chain(h: int, w: int, chans: Tuple[int, ...]) -> Tuple[int, int, int, int]:
    """Launch geometry ``(TH, TW, buf0, buf1)`` of a chain over ``h x w``
    images with channel widths ``chans`` (``C_0 .. C_n``): the output tile
    and the two stage buffers in floats. Of the tiles whose buffers fit in a
    block's shared memory beside the weight slice, the one with the fewest
    multiply-adds over the image (halo recompute and ragged last tiles
    counted), then the largest. Raises ``ValueError`` when none fits."""
    n = len(chans) - 1
    best = None
    for th in _sides(h):
        for tw in _sides(w):
            bufs = stage_buffers(th, tw, h, w, chans)
            if 4 * (bufs[0] + bufs[1] + WS_FLOATS) > SMEM_BYTES:
                continue
            rows, cols = _extents(h, th, n), _extents(w, tw, n)
            macs = sum(sum(r[l] for r in rows) * sum(c[l] for c in cols)
                       * chans[l] * chans[l + 1] for l in range(n))
            key = (macs, -th * tw, th)
            if best is None or key < best[0]:
                best = (key, (th, tw, bufs[0], bufs[1]))
    if best is None:
        raise ValueError(f"{NAME}: no tile of a {h}x{w} image with channels {chans} fits in "
                         f"{SMEM_BYTES} bytes of shared memory")
    return best[1]


def _check(x: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor]) -> Tuple[int, ...]:
    """Validates the shapes; returns the channel widths ``C_0 .. C_n``."""
    if x.dim() != 4:
        raise ValueError(f"{NAME}: x must be NHWC (B, H, W, C), got {tuple(x.shape)}")
    n = len(kernels)
    if not 1 <= n <= MAX_LAYERS or len(biases) != n:
        raise ValueError(f"{NAME}: takes 1 to {MAX_LAYERS} kernels and as many biases, got "
                         f"{n} and {len(biases)}")
    chans = [int(x.shape[-1])]
    for i, (k, b) in enumerate(zip(kernels, biases)):
        if k.dim() != 4 or tuple(k.shape[:3]) != (3, 3, chans[-1]):
            raise ValueError(f"{NAME}: kernel {i} must be (3, 3, {chans[-1]}, O), got "
                             f"{tuple(k.shape)}")
        chans.append(int(k.shape[-1]))
        if tuple(b.shape) != (chans[-1],):
            raise ValueError(f"{NAME}: bias {i} must be ({chans[-1]},), got {tuple(b.shape)}")
    return tuple(chans)


def conv3x3_chain_plain(x: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor]
                        ) -> Tensor:
    """Plain version of :func:`fused_conv3x3_chain` (JAX ``_chain_reference``):
    the sequential chain of ``F.conv2d`` + bias."""
    _check(x, kernels, biases)
    h = x.permute(0, 3, 1, 2)
    for k, b in zip(kernels, biases):
        h = F.conv2d(h, k.permute(3, 2, 0, 1), b, padding=1)
    return h.permute(0, 2, 3, 1).contiguous()


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from simple_vae_rs_tpu_torch.ops import _build

        lib = _build.load(SOURCE)
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.svrs_conv3x3_chain.argtypes = (
            [ctypes.c_void_p, ptrs, ptrs, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
             ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.svrs_conv3x3_chain.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(x: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor]) -> Tensor:
    chans = _check(x, kernels, biases)
    dev = x.device
    for t in (x, *kernels, *biases):
        if t.device != dev:
            raise ValueError(f"{NAME}: all tensors must be on {dev}, one is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: tensors must be contiguous")
    b, h, w, _ = x.shape
    if b * h * w * max(chans) >= 2**31:
        raise ValueError(f"{NAME}: tensor too large for 32-bit pixel indices")
    out = torch.empty((b, h, w, chans[-1]), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    if min(chans) < 1:
        raise ValueError(f"{NAME}: every layer needs at least one channel, got {chans}")
    th, tw, buf0, buf1 = plan_chain(h, w, chans)
    n = len(kernels)
    # the pointer arrays are read during the call only; the tensors outlive it
    kernel_ptrs = (ctypes.c_void_p * n)(*[k.data_ptr() for k in kernels])
    bias_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in biases])
    widths = (ctypes.c_int * (n + 1))(*chans)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().svrs_conv3x3_chain(
            x.data_ptr(), kernel_ptrs, bias_ptrs, widths, n, out.data_ptr(), b, h, w, th, tw,
            buf0, buf1, stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: CUDA launch failed with cudaError {err}")
    fc.launches[NAME] += 1
    return out


def fused_conv3x3_chain(x: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor],
                        plain: bool = False) -> Tensor:
    """The chain ``conv3x3(. , kernels[l]) + biases[l]`` for ``l = 0 .. n-1``
    on ``x`` (B, H, W, C_0), ``1 <= n <= 8``: (B, H, W, C_n). One kernel
    launch on CUDA tensors, the plain version on CPU tensors or with
    ``plain``. Forward only."""
    if any(t.requires_grad for t in (x, *kernels, *biases)) and torch.is_grad_enabled():
        raise RuntimeError(f"{NAME} has no backward: call it under torch.no_grad() "
                           f"(training runs the convs one by one)")
    if plain or x.device.type == "cpu":
        return conv3x3_chain_plain(x, kernels, biases)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: tensors must be on the CPU or a CUDA card, not {x.device}")
    return _launch(x, kernels, biases)
