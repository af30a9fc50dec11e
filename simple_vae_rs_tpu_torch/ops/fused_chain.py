"""Fused chain of 3x3 convs: one CUDA kernel for n layers, and its plain version.

The port of ``simple_vae_rs_tpu/ops/pallas_conv.py``'s two chain kernels
(``fused_conv3x3_chain`` and ``fused_conv3x3_chain_wl``, which compute the
same function in two TPU layouts): a linear chain of ``n`` 3x3/s1 SAME convs,
each with its bias and no activation between,

    h_0 = x,    h_{l+1} = conv3x3(h_l, kernels[l]) + biases[l],

with ``x`` NHWC ``(B, H, W, C_0)`` and ``kernels[l]`` in the JAX HWIO layout
``(3, 3, C_l, C_{l+1})``, both float32 or both bfloat16, and the biases
float32. These are the models' eval-mode tails: the four convs that end each
decoder and each encoder. In bfloat16 it is JAX ``fused_conv3x3_chain``'s
function on bfloat16 operands: each layer sums in float32, adds its bias
rounded to bfloat16 (the Pallas kernel casts the biases to ``x.dtype``) and
rounds to bfloat16.

:func:`fused_conv3x3_chain` given CPU tensors computes the plain version
(:func:`conv3x3_chain_plain`: in float32 the sequential ``F.conv2d`` chain,
JAX ``_chain_reference``; in bfloat16 the layers as above); given CUDA
tensors it launches the hand-written kernel in ``csrc/conv_chain.cu`` once
for the whole chain, on the current stream, or raises: its float32 instance
or, for bfloat16 tensors, its bfloat16 instance, which reads and writes
bfloat16 itself. There is no fallback between the two and no per-layer
launch. A launch is counted in ``fused_conv.launches["fused_conv3x3_chain"]``
(float32) or ``fused_conv.bf16_launches["fused_conv3x3_chain"]["forward"]``.

The chain has no backward (the JAX package's has none: training keeps the
per-layer kernels with their gradients), so the wrapper refuses tensors that
require one.

The CUDA source's header says what bounds the kernel and what its design
does about it. This module holds the launch geometry it is given: a block
owns a strip of output rows of one image across a panel of columns (the
whole width wherever the rings fit), and streams down the rows.
:func:`stage_spans` is the span of rows (or columns) a block stores of each
stage, :func:`chain_layout` the rings in shared memory for a strip, a panel
and a number of rows per step, and :func:`plan_chain` the layout a launch
takes. :func:`advance` is the row schedule every block follows; the kernel
computes the same. Sizes and offsets are in elements of the chain's dtype
(``itemsize`` 4 or 2 bytes): the bfloat16 rings hold a pixel in
:func:`pixel_stride` ``(c, 2)`` elements and its weight slots twice the
rows, so the same shared memory holds more rows or wider strips.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from simple_vae_rs_tpu_torch.ops import fused_conv as fc

Tensor = torch.Tensor

NAME = fc.CHAIN
SOURCE = "conv_chain.cu"
MAX_LAYERS = 8  # MAXL of the CUDA source
SMEM_BYTES = 232_448  # shared memory a block can use on sm_90 (227 KB)
NT = 256  # threads a block
STAGES = 2  # slots of the weight ring
SMS = 132  # streaming multiprocessors of the H100 SXM
TARGET_M = 128  # output pixels a layer step aims at: one 128-row tile
STEP_MACS = 200_000  # the plan's price of one layer step (ring fill, barriers) in multiply-adds
# (BM, BN, WM, WN, KS) of a layer's tile by its output width (layer_tile):
# eight warps of WM x WN, each (WM / 16) x (WN / 8) m16n8k8 (m16n8k16 in
# bfloat16) tiles, and KS weight rows a slot of the weight ring (deeper for
# the narrow layers, whose slots hold little work between two barriers); a
# bfloat16 slot holds twice the rows in the same bytes (slot_rows)
LAYER_TILES = ((128, 8, 16, 8, 128), (128, 16, 16, 16, 128), (128, 64, 32, 32, 64),
               (64, 128, 32, 32, 64))


def c8(c: int) -> int:
    """Channels rounded up to whole 8-deep k groups: a tap's share of K."""
    return (c + 7) & ~7


def c16(c: int) -> int:
    """Channels rounded up to whole 16-deep k groups: a tap's share of K in
    bfloat16."""
    return (c + 15) & ~15


def k_per_tap(c: int, itemsize: int = 4) -> int:
    """A tap's share of K: :func:`c8` in float32, :func:`c16` in bfloat16."""
    return c8(c) if itemsize == 4 else c16(c)


def pixel_stride(c: int, itemsize: int = 4) -> int:
    """Elements between two stored pixels: a tap's K (:func:`k_per_tap`)
    plus one 16-byte word, an odd number of 16-byte words in all, so that
    the A fragment of 8 neighbouring pixels x 4 float32 channels falls on
    32 distinct banks, and the 8 pixel rows of one bfloat16 ``ldmatrix``
    phase on 8 distinct 16-byte bank groups."""
    return k_per_tap(c, itemsize) + 16 // itemsize


def layer_tile(cout: int) -> int:
    """Index into :data:`LAYER_TILES` of a layer with ``cout`` outputs."""
    n8 = c8(cout)
    return 0 if n8 <= 8 else 1 if n8 <= 16 else 2 if n8 <= 64 else 3


def b_ld(bn: int) -> int:
    """Elements between two rows of a staged weight slice of width ``bn``:
    the float32 B fragment (4 k rows x 8 columns) then falls on 32 distinct
    banks, and in bfloat16 (an odd number of 16-byte words) the 8 k rows of
    an ``ldmatrix.trans`` phase on 8 distinct 16-byte bank groups."""
    return max(bn, 16) + 8


def slot_rows(cout: int, itemsize: int = 4) -> int:
    """KS: the weight rows a slot of a layer with ``cout`` outputs holds."""
    return LAYER_TILES[layer_tile(cout)][4] * 4 // itemsize


def slot_size(cout: int, itemsize: int = 4) -> int:
    """Elements of a weight slot of a layer with ``cout`` outputs."""
    bn = LAYER_TILES[layer_tile(cout)][1]
    return slot_rows(cout, itemsize) * b_ld(bn)


def stage_spans(o0: int, o1: int, n: int, size: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` per stage ``s = 0 .. n`` along one axis of ``size`` for a
    block whose output is ``[o0, o1)``: stage ``s`` (the input of layer
    ``s``) is stored ``n - s`` further out per side, clipped to the image and
    its one-pixel zero border; stage ``n`` is the output itself. The stored
    positions outside the image stay zero: the SAME padding of every layer."""
    return [(max(-1, o0 - (n - s)), min(size + 1, o1 + (n - s))) for s in range(n)] + [(o0, o1)]


def advance(nxt: Sequence[int], hi: Sequence[int], rs: int) -> List[int]:
    """One step of a block's row schedule: ``nxt[s]`` is the next row of
    stage ``s`` to produce, ``hi[s]`` the end of its span. Stage 0 takes up
    to ``rs`` more rows; then each later stage takes up to ``rs`` rows
    whose three input rows are stored (all of the rest once its input stage
    is complete). Every stage then lags its input by at most one row, so a
    ring of ``rs + 2`` rows per stage holds every row a layer still reads,
    and a step's input rows may be copied in as soon as layer 0 of the step
    before is done (the kernel overlaps them with layers 1 .. n-1)."""
    new = [min(hi[0], nxt[0] + rs)]
    for s in range(1, len(nxt)):
        lim = hi[s] if new[s - 1] == hi[s - 1] else new[s - 1] - 1
        new.append(max(nxt[s], min(hi[s], nxt[s] + rs, lim)))
    return new


class ChainPlan(NamedTuple):
    """The launch geometry of a chain (offsets and sizes in elements of its
    dtype)."""

    strip: int  # output rows a block owns
    panel: int  # output columns a block owns
    rs: int  # rows a stage advances per step
    rows: Tuple[int, ...]  # ring rows per stage 0 .. n-1
    cols: Tuple[int, ...]  # stored pixels per ring row
    offsets: Tuple[int, ...]  # the rings' offsets in shared memory (elements)
    ws_off: int  # the weight ring's offset (elements)
    ws_slot: int  # elements a slot of the weight ring holds
    smem_bytes: int
    strips: int
    panels: int
    clear: int  # bit s: stage s shares its ring with stage s - 2 and is zeroed first


@functools.lru_cache(maxsize=4096)
def _max_span(size: int, extent: int, n: int, s: int, inside: bool = False) -> int:
    """The longest span of stage ``s`` over the blocks of extent ``extent``
    along an axis of ``size``: stored, or with ``inside`` computed (the part
    inside the image)."""
    spans = (stage_spans(o0, min(size, o0 + extent), n, size)[s] for o0 in range(0, size, extent))
    if inside:
        return max(min(hi, size) - max(lo, 0) for lo, hi in spans)
    return max(hi - lo for lo, hi in spans)


def chain_layout(h: int, w: int, chans: Sequence[int], strip: int, panel: int, rs: int,
                 itemsize: int = 4) -> ChainPlan:
    """The shared memory of a chain of elements of ``itemsize`` bytes over
    ``h x w`` images run in strips of ``strip`` rows and panels of ``panel``
    columns, ``rs`` rows per step: stage ``s`` keeps a ring of ``min(rs + 2,
    its longest span)`` rows of its longest span of pixels at
    :func:`pixel_stride`; the weight ring follows.
    When ``rs`` covers every span, a block runs its whole chain in one step
    (each stage complete before the next layer reads it, and never read
    again), so the even stages share one region and the odd stages another,
    and a stage that takes over a region is zeroed before it is written."""
    n = len(chans) - 1
    rows = tuple(min(rs + 2, _max_span(h, strip, n, s)) for s in range(n))
    cols = tuple(_max_span(w, panel, n, s) for s in range(n))
    sizes = [rows[s] * cols[s] * pixel_stride(chans[s], itemsize) for s in range(n)]
    if rs >= _max_span(h, strip, n, 0):  # one step: two regions, in turns
        region = [max(sizes[0::2]), max(sizes[1::2], default=0)]
        offsets = tuple(0 if s % 2 == 0 else region[0] for s in range(n))
        off, clear = sum(region), sum(1 << s for s in range(2, n))
    else:
        offsets = tuple(sum(sizes[:s]) for s in range(n))
        off, clear = sum(sizes), 0
    ws_slot = max(slot_size(c, itemsize) for c in chans[1:])
    smem = itemsize * (off + STAGES * ws_slot)
    return ChainPlan(strip, panel, rs, rows, cols, offsets, off, ws_slot, smem,
                     -(-h // strip), -(-w // panel), clear)


def _extents(size: int) -> List[int]:
    """Every distinct block extent ``ceil(size / k)``, largest first."""
    return sorted({-(-size // k) for k in range(1, size + 1)}, reverse=True)


def _cost(b: int, h: int, w: int, chans: Sequence[int], plan: ChainPlan) -> int:
    """Multiply-adds of the busiest block, its layer steps priced at
    :data:`STEP_MACS`, times the waves of blocks over the SMs."""
    n = len(chans) - 1
    macs = sum(_max_span(h, plan.strip, n, s, True) * _max_span(w, plan.panel, n, s, True)
               * chans[s - 1] * chans[s] for s in range(1, n + 1))
    steps = -(-(_max_span(h, plan.strip, n, 0) + n) // plan.rs)
    blocks = b * plan.strips * plan.panels
    return -(-blocks // SMS) * (9 * macs + STEP_MACS * n * steps)


@functools.lru_cache(maxsize=256)
def plan_chain(b: int, h: int, w: int, chans: Tuple[int, ...], itemsize: int = 4) -> ChainPlan:
    """The launch geometry of a chain over ``b`` images of ``h x w`` with
    channel widths ``chans`` (``C_0 .. C_n``) in elements of ``itemsize``
    bytes (4: float32, 2: bfloat16). Panels are the whole width
    unless no layout of full rows fits in a block's shared memory (then the
    widest panel that does). Strips: of every strip height, the one with the
    least :func:`_cost` (seam recompute against blocks to fill the SMs; the
    larger strip on a tie). Rows per step: up to :data:`TARGET_M` output
    pixels a step, fewer when the rings do not fit. Raises ``ValueError``
    when nothing fits."""
    n = len(chans) - 1
    for panel in _extents(w):
        best = None
        for strip in _extents(h):
            rs = max(1, min(TARGET_M // panel, strip + 2 * n))
            while rs >= 1:
                plan = chain_layout(h, w, chans, strip, panel, rs, itemsize)
                if plan.smem_bytes <= SMEM_BYTES:
                    break
                rs -= 1
            if rs < 1:
                continue
            cost = _cost(b, h, w, chans, plan)
            if best is None or cost < best[0]:
                best = (cost, plan)
        if best is not None:
            return best[1]
    raise ValueError(f"{NAME}: no layout of a {h}x{w} image with channels {chans} fits in "
                     f"{SMEM_BYTES} bytes of shared memory")


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
    """Plain version of :func:`fused_conv3x3_chain`. float32: JAX
    ``_chain_reference``, the sequential chain of ``F.conv2d`` + bias.
    bfloat16: JAX ``fused_conv3x3_chain``'s function (``_kernel3_chain``),
    per layer the bfloat16 input and kernel upcast (exact), the conv in
    float32 with TF32 off, plus the bias rounded to bfloat16, rounded to
    bfloat16."""
    _check(x, kernels, biases)
    h = x.permute(0, 3, 1, 2)
    if x.dtype != torch.bfloat16:
        for k, b in zip(kernels, biases):
            h = F.conv2d(h, k.permute(3, 2, 0, 1), b, padding=1)
        return h.permute(0, 2, 3, 1).contiguous()
    for k, b in zip(kernels, biases):
        with fc._no_tf32():
            acc = F.conv2d(h.float(), k.float().permute(3, 2, 0, 1), padding=1)
        h = (acc + b.to(torch.bfloat16).float().view(1, -1, 1, 1)).to(torch.bfloat16)
    return h.permute(0, 2, 3, 1).contiguous()


def _check_dtypes(x: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor]) -> None:
    """x and the kernels float32, or all bfloat16; the biases float32."""
    if x.dtype not in fc.DTYPES or any(k.dtype != x.dtype for k in kernels):
        raise TypeError(f"{NAME}: x and the kernels must all be float32 or all bfloat16, got "
                        f"{x.dtype} and {[k.dtype for k in kernels]}")
    if any(t.dtype != torch.float32 for t in biases):
        raise TypeError(f"{NAME}: the biases must be float32 (the bfloat16 chain rounds them "
                        f"itself), got {[t.dtype for t in biases]}")


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from simple_vae_rs_tpu_torch.ops import _build

        lib = _build.load(SOURCE)
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        for fn in (lib.svrs_conv3x3_chain, lib.svrs_conv3x3_chain_bf16):
            fn.argtypes = (
                [ctypes.c_int, ctypes.c_void_p, ptrs, ptrs, ints, ctypes.c_int, ctypes.c_void_p]
                + [ctypes.c_int] * 3 + [ints, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(x: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor]) -> Tensor:
    chans = _check(x, kernels, biases)
    dev = x.device
    _check_dtypes(x, kernels, biases)
    for t in (x, *kernels, *biases):
        if t.device != dev:
            raise ValueError(f"{NAME}: all tensors must be on {dev}, one is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: tensors must be contiguous")
    b, h, w, _ = x.shape
    if b * h * w * max(chans) >= 2**31:
        raise ValueError(f"{NAME}: tensor too large for 32-bit pixel indices")
    out = torch.empty((b, h, w, chans[-1]), device=dev, dtype=x.dtype)
    if out.numel() == 0:
        return out
    if min(chans) < 1:
        raise ValueError(f"{NAME}: every layer needs at least one channel, got {chans}")
    bf16 = x.dtype == torch.bfloat16
    plan = plan_chain(b, h, w, chans, x.element_size())
    # the plan as the C entry point reads it
    geo = [plan.strip, plan.panel, plan.rs, plan.ws_off, plan.ws_slot, plan.smem_bytes,
           plan.clear, *plan.rows, *plan.cols, *plan.offsets]
    n = len(kernels)
    # the arrays are read during the call only; the tensors outlive it
    kernel_ptrs = (ctypes.c_void_p * n)(*[k.data_ptr() for k in kernels])
    bias_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in biases])
    widths = (ctypes.c_int * (n + 1))(*chans)
    # one C call that makes the device current itself, on the raw handle of
    # its current stream
    index = x.get_device()
    lib = _library()
    fn = lib.svrs_conv3x3_chain_bf16 if bf16 else lib.svrs_conv3x3_chain
    err = fn(index, x.data_ptr(), kernel_ptrs, bias_ptrs, widths, n, out.data_ptr(), b, h, w,
             (ctypes.c_int * len(geo))(*geo), torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{NAME}: CUDA launch failed with cudaError {err}")
    if bf16:
        fc.bf16_launches[NAME]["forward"] += 1
    else:
        fc.launches[NAME] += 1
    return out


def fused_conv3x3_chain(x: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor],
                        plain: bool = False) -> Tensor:
    """The chain ``conv3x3(. , kernels[l]) + biases[l]`` for ``l = 0 .. n-1``
    on ``x`` (B, H, W, C_0), ``1 <= n <= 8``: (B, H, W, C_n) in ``x``'s
    dtype (each layer rounded to bfloat16 in bfloat16). One kernel launch on
    CUDA tensors, the plain version on CPU tensors or with ``plain``.
    Forward only."""
    if any(t.requires_grad for t in (x, *kernels, *biases)) and torch.is_grad_enabled():
        raise RuntimeError(f"{NAME} has no backward: call it under torch.no_grad() "
                           f"(training runs the convs one by one)")
    if plain or x.device.type == "cpu":
        _check_dtypes(x, kernels, biases)
        return conv3x3_chain_plain(x, kernels, biases)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: tensors must be on the CPU or a CUDA card, not {x.device}")
    return _launch(x, kernels, biases)
