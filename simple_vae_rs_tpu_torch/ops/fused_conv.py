"""Fused conv + per-channel affine + optional ReLU: CUDA kernels and plain versions.

The port of ``simple_vae_rs_tpu/ops/pallas_conv.py``'s three eval-path
kernels. Each computes ``act(conv(x, kernel) * scale + shift)`` with ``x``
NHWC and ``kernel`` in the JAX HWIO layout ``(kh, kw, C, O)``, both float32
or both bfloat16, ``scale`` and ``shift`` float32, the sums in float32 and
the output in ``x``'s dtype (one rounding, as the JAX kernels store
``out.astype(x.dtype)``):

- :func:`fused_conv3x3_bn_relu`: 3x3, stride 1, SAME padding (every 3x3 conv);
- :func:`fused_conv4x4s2_bn_relu`: 4x4, stride 2, pad 1 (DownBlock eval tail
  with BatchNorm folded in by :func:`fold_conv_bn`);
- :func:`fused_convT4x4s2_bn_relu`: transposed 4x4, stride 2, pad 1, with the
  kernel in the input-dilated form the JAX models store (UpBlock eval tail).

A wrapper given CPU tensors computes its plain version (``*_plain``, plain
PyTorch on permuted tensors); given CUDA tensors it launches the hand-written
kernel in ``csrc/fused_conv.cu`` on the current stream or raises. There is no
fallback between the two. :data:`launches` counts the float32 kernels'
launches per wrapper, and :data:`role_launches` splits them into forward
calls and input gradients; :data:`bf16_launches` counts the bfloat16
instances' launches the same way, by role, and :data:`bf16_impl_launches`
splits those by the kernel that ran ("wg" or "tc"). A bfloat16 CUDA tensor
launches a bfloat16 kernel or raises: it never reaches the float32 kernel.
A bfloat16 launch of #1, #5 or #6 that :func:`wg_eligible` admits, in
either role, runs ``conv_wg_bf16`` (``csrc/conv_wg.cu``: wgmma fed by TMA,
launch plan :func:`plan_wg`) or raises; every other bfloat16 launch runs
``conv_tc_bf16``.

:func:`fused_conv` is the differentiable form (port of the JAX ``_make_grad``
VJPs): its backward computes every input gradient with one of the three
kernels on the flipped, in/out-swapped weight (:func:`input_grad`) and the
weight gradient with one library call (:func:`weight_grad`; JAX leaves it to
XLA too).

The CUDA source's header says what bounds the kernels on the card and what
their implicit-GEMM design does about it. All three (:data:`TC_KERNELS`) run
on the tensor cores, at float32 accuracy (3xTF32) for float32 operands and
on the bf16 MMA with float32 accumulation for bfloat16 ones, with the launch
geometry of :func:`plan_tc`; the transposed conv as four output phases of
four live taps each.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

SOURCE = "fused_conv.cu"

# kernel name -> (C entry point, live taps, spatial stride, output phases);
# the bfloat16 instance of each is the entry point + "_bf16"
_KERNELS = {
    "fused_conv3x3_bn_relu": ("svrs_conv3x3", 9, 1, 1),
    "fused_conv4x4s2_bn_relu": ("svrs_conv4x4s2", 16, 2, 1),
    "fused_convT4x4s2_bn_relu": ("svrs_convT4x4s2", 4, 1, 4),
}
ROLES = ("forward", "dx")

# Launches of each kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else, under the role it ran for.
# The chain kernel of ``ops/fused_chain.py`` (forward only) counts here too.
CHAIN = "fused_conv3x3_chain"
launches: Dict[str, int] = {**{name: 0 for name in _KERNELS}, CHAIN: 0}
role_launches: Dict[str, Dict[str, int]] = {name: dict.fromkeys(ROLES, 0) for name in _KERNELS}
# The bfloat16 instances' launches by kernel and role (none of them counts in
# ``launches`` or ``role_launches``); the chain's bfloat16 instance counts
# under its name, in the forward role (it has no other)
bf16_launches: Dict[str, Dict[str, int]] = {
    **{name: dict.fromkeys(ROLES, 0) for name in _KERNELS}, CHAIN: {"forward": 0}}
# The same launches of #1, #5 and #6 by the kernel that ran: "wg"
# (``conv_wg_bf16``) or "tc" (``conv_tc_bf16``); per kernel and role they sum
# to ``bf16_launches``
IMPLS = ("wg", "tc")
bf16_impl_launches: Dict[str, Dict[str, Dict[str, int]]] = {
    name: {role: dict.fromkeys(IMPLS, 0) for role in ROLES} for name in _KERNELS}
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for counts in (role_launches, bf16_launches):
        for roles in counts.values():
            for role in roles:
                roles[role] = 0
    for roles in bf16_impl_launches.values():
        for impls in roles.values():
            for impl in impls:
                impls[impl] = 0


_SMS = 132  # H100 SXM streaming multiprocessors

# The kernels that run on the tensor cores (``conv_tc``, 3xTF32: all three)
# and their tile configurations: (BM, BN, warp tile WM, WN, cp.async stages)
# per index.
TC_KERNELS = ("fused_conv3x3_bn_relu", "fused_conv4x4s2_bn_relu", "fused_convT4x4s2_bn_relu")
TC_TILES = {
    0: (128, 128, 64, 32, 3),  # N > 64
    1: (128, 64, 32, 32, 3),   # 16 < N <= 64
    2: (64, 16, 16, 16, 4),    # N <= 16: the warps along M
    3: (32, 128, 32, 32, 4),   # M <= 64 per phase: the weight-bound prior heads
}
TC_BK = 32
TC_BK_BF16 = 64  # the bfloat16 instances' K step: the same bytes per stage
_TC_MIN_SPLIT_K = 4 * TC_BK


def plan_tc(m: int, n: int, k: int, phases: int = 1,
            tiles: Dict[int, Tuple[int, ...]] = TC_TILES, bk: int = TC_BK
            ) -> Tuple[int, int, int]:
    """Launch geometry ``(tile config, K splits, K per split)`` of a
    tensor-core kernel with tile configurations ``tiles`` (:data:`TC_TILES`;
    the int8 kernel passes its own) and K step ``bk`` (:data:`TC_BK_BF16`
    for the bfloat16 instances) for a GEMM of ``m`` output pixels per
    phase x ``n`` channels x ``k`` reduction, ``phases`` of them (4 for the
    transposed conv, each its own blocks).

    Thin tiles for few pixels (the weight-bound prior heads), narrow tiles
    for few channels (the 64x64 tail), and a K split of whole K steps (at
    least four a split) when the output tiles alone would leave most of the
    card's SMs idle.
    """
    if m <= 64:
        cfg = 3
    elif n <= 16:
        cfg = 2
    elif n <= 64:
        cfg = 1
    else:
        cfg = 0
    bm, bn = tiles[cfg][:2]
    blocks = _cdiv(m, bm) * _cdiv(n, bn) * phases
    splits = 1
    if blocks < _SMS:
        splits = max(1, min(_cdiv(2 * _SMS, blocks), k // (4 * bk)))
    kchunk = _cdiv(_cdiv(k, splits), bk) * bk
    return cfg, _cdiv(k, kchunk), kchunk


def tc_smem_bytes(cfg: int, tiles: Dict[int, Tuple[int, ...]] = TC_TILES,
                  bf16: bool = False) -> int:
    """Dynamic shared memory of tensor-core tile ``cfg`` of ``tiles``: its
    cp.async ring of A ``[BM][BK + 4]`` and B ``[BK][BN + 8]`` 4-byte slots
    (float32, or int32 words of the int8 kernel), or with ``bf16`` of A
    ``[BM][64 + 8]`` and B ``[64][BN + 8]`` bfloat16 slots (the CUDA
    source's ``tc_smem_bytes`` and ``tcb_smem_bytes``, which size the
    launch; here for the plan's checks)."""
    bm, bn, _, _, stages = tiles[cfg]
    if bf16:
        return 2 * stages * (bm * (TC_BK_BF16 + 8) + TC_BK_BF16 * (bn + 8))
    return 4 * stages * (bm * (TC_BK + 4) + TC_BK * (bn + 8))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ------------------------------------------------------------ conv_wg_bf16
# The bfloat16 #1, #5 and #6 on wgmma fed by TMA (``csrc/conv_wg.cu``): a
# tile is WG_BM output pixels (two consumer warpgroups of 64 rows) x BN
# channels, K in k-groups of KC channels of one tap (64, or 16 where C <= 16).
WG_SOURCE = "conv_wg.cu"
WG_KERNELS = {"fused_conv3x3_bn_relu": "svrs_conv3x3_wg_bf16",
              "fused_conv4x4s2_bn_relu": "svrs_conv4x4s2_wg_bf16",
              "fused_convT4x4s2_bn_relu": "svrs_convT4x4s2_wg_bf16"}
WG_BM = 128
# the ring's stages per (KC, BN), one instance each: as deep as one block's
# 227 KB of shared memory allows with 64-channel k-groups (A 16 KB and B
# 128 * BN bytes a stage), 8 with 16-channel ones
WG_STAGES = {(64, 128): 6, (64, 64): 8, (64, 16): 8, (16, 128): 8, (16, 64): 8, (16, 16): 8}
WG_MAX_W = 256  # input pixels of a row: at most two 128-pixel boxes
# The measured cut per kernel, (operations, output tiles, k-group steps on
# the busiest block) of :func:`wg_route` (chip_smoke.py B6 times both
# bfloat16 kernels in turns at every shape of the canonical paths; NVIDIA
# H100 80GB HBM3 at 700 W, PERF.md). #1 and #6: conv_wg_bf16 was slower than
# conv_tc_bf16 at some shapes below 6.7 GFLOP (both near their launch floor
# of 0.02-0.06 ms) and at the prior heads of 7 or 14 tiles (conv_tc_bf16
# splits their K over the card), and it tied at 9.7 GFLOP with 36 k-group
# steps a block (256 tiles of 18):
# there it took 0.029-0.063 ms from run to run against conv_tc_bf16's steady
# 0.060, its device time below the host path of a launch from Python; past
# the three cuts it took 0.30-0.91x conv_tc_bf16's time at every shape.
# #5, measured on its own: below 8 GFLOP conv_wg_bf16 was slower at the
# 16-channel inputs (1.04-1.19x) and within the launch floor (0.03-0.05 ms)
# at the others; [512, 16, 16, 64] -> 128 (8.6 GFLOP, 256 tiles, 32 k-group
# steps) took 0.031 ms against 0.055, and the input-gradient launches past
# 34 GFLOP 0.38-0.49x conv_tc_bf16's time, so its step cut is 32.
WG_CUTS = {"fused_conv3x3_bn_relu": (8e9, 64, 64),
           "fused_conv4x4s2_bn_relu": (8e9, 64, 32),
           "fused_convT4x4s2_bn_relu": (8e9, 64, 64)}


class WgPlan(NamedTuple):
    """Launch plan of ``conv_wg_bf16``: the A box (``wb`` pixels of a row,
    ``th`` rows, ``nb`` images; wb * th * nb <= WG_BM), the channel tile
    ``bn``, the k-group's channels ``kc``, the ring's ``stages``, the output
    ``tiles`` (phases x pixel tiles x channel tiles) and the persistent
    ``grid`` (one block per SM at most)."""
    wb: int
    th: int
    nb: int
    bn: int
    kc: int
    stages: int
    tiles: int
    grid: int


def wg_box(b: int, h: int, w: int) -> Tuple[int, int, int]:
    """The A box ``(wb, th, nb)`` of a (B, H, W) input grid: whole rows when
    W <= WG_BM (64x64 -> two rows, 8x8 -> two images, 4x4 -> eight), else
    128-pixel row segments."""
    if w >= WG_BM:
        return WG_BM, 1, 1
    th = min(h, WG_BM // w)
    nb = max(1, min(b, WG_BM // (w * h))) if th == h else 1
    return w, th, nb


def wg_bn(o: int) -> int:
    """The channel tile: 128 above 64 outputs, 64 above 16, else 16 (the
    canonical O <= 64 are 4, 16 and 64)."""
    return 128 if o > 64 else 64 if o > 16 else 16


def wg_kc(c: int) -> int:
    """The k-group's channels: 16 (32-byte rows) where C <= 16, else 64."""
    return 16 if c <= 16 else 64


def plan_wg(name: str, b: int, h: int, w: int, c: int, o: int) -> WgPlan:
    """:class:`WgPlan` of kernel ``name`` (#1, #5 or #6) on a (B, H, W, C)
    input with O outputs (K is taps x ceil(C / kc) k-groups). The box is in
    output pixels (of one phase for #6): (H/2, W/2) for #5."""
    _, _, stride, phases = _KERNELS[name]
    oh, ow = h // stride, w // stride
    wb, th, nb = wg_box(b, oh, ow)
    bn, kc = wg_bn(o), wg_kc(c)
    tiles = phases * _cdiv(ow, wb) * _cdiv(oh, th) * _cdiv(b, nb) * _cdiv(o, bn)
    return WgPlan(wb, th, nb, bn, kc, WG_STAGES[kc, bn], tiles, min(tiles, _SMS))


def _wg_takes(name: str, x_shape, o: int) -> bool:
    """The shapes ``conv_wg_bf16`` can run at all: #1, #5 or #6, C % 8 == 0
    and O % 8 == 0 (TMA's global strides are whole 16 bytes), W <= 256, and
    for #5 even H and W (as JAX #5 requires)."""
    if name not in WG_KERNELS or x_shape[-1] % 8 or o % 8 or x_shape[2] > WG_MAX_W:
        return False
    return _KERNELS[name][2] == 1 or (x_shape[1] % 2 == 0 and x_shape[2] % 2 == 0)


def wg_route(name: str, x_shape, o: int) -> bool:
    """The shape half of :func:`wg_eligible`: what ``conv_wg_bf16`` takes,
    with at least the operations (2 M N K over the phases), output tiles and
    k-group steps on the busiest block (:func:`plan_wg`) of the kernel's
    :data:`WG_CUTS`, the measured cut: below it ``conv_tc_bf16`` was as fast
    or at some shapes faster."""
    if not _wg_takes(name, x_shape, o):
        return False
    b, h, w, c = x_shape
    _, taps, stride, phases = _KERNELS[name]
    min_flops, min_tiles, min_steps = WG_CUTS[name]
    if 2.0 * phases * b * (h // stride) * (w // stride) * o * taps * c < min_flops:
        return False
    plan = plan_wg(name, b, h, w, c, o)
    steps = _cdiv(plan.tiles, plan.grid) * taps * _cdiv(c, plan.kc)
    return plan.tiles >= min_tiles and steps >= min_steps


def _wg_operands(x: Tensor, kernel: Tensor) -> bool:
    return (x.dtype == torch.bfloat16 and kernel.dtype == torch.bfloat16
            and x.data_ptr() % 16 == 0 and kernel.data_ptr() % 16 == 0)


def wg_supported(name: str, x: Tensor, kernel: Tensor) -> bool:
    """What ``conv_wg_bf16`` can run at all: bfloat16 #1, #5 or #6, C % 8
    == 0 and O % 8 == 0, x and the weight 16-byte aligned, W <= 256, even H
    and W for #5."""
    return _wg_operands(x, kernel) and _wg_takes(name, x.shape, kernel.shape[-1])


def wg_eligible(name: str, x: Tensor, kernel: Tensor) -> bool:
    """Whether a bfloat16 launch of kernel ``name`` runs ``conv_wg_bf16``; a
    static rule of shapes, dtypes and alignment, the same on every run:
    bfloat16 x and weight, both 16-byte aligned, and :func:`wg_route` of the
    shapes (#1, #5 or #6, C % 8 == 0, O % 8 == 0, W <= 256, even H and W for
    #5, and the kernel's measured cut on operations, tiles and k-group
    steps)."""
    return _wg_operands(x, kernel) and wg_route(name, x.shape, kernel.shape[-1])


def geometry(name: str, x: Tensor, kernel: Tensor) -> Tuple[int, int, int, int]:
    """GEMM shape ``(M per phase, N, K, phases)`` of a kernel call."""
    _, taps, stride, phases = _KERNELS[name]
    b, h, w, c = x.shape
    ho, wo = (h // 2, w // 2) if stride == 2 else (h, w)
    return b * ho * wo, kernel.shape[-1], taps * c, phases


def output_shape(name: str, x_shape, o: int) -> Tuple[int, int, int, int]:
    b, h, w, _ = x_shape
    if name == "fused_conv4x4s2_bn_relu":
        return (b, h // 2, w // 2, o)
    if name == "fused_convT4x4s2_bn_relu":
        return (b, 2 * h, 2 * w, o)
    return (b, h, w, o)


def _check(name: str, x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor) -> None:
    kh = 3 if name == "fused_conv3x3_bn_relu" else 4
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (kh, kh, c):
        raise ValueError(
            f"{name}: kernel must be ({kh}, {kh}, {c}, O), got {tuple(kernel.shape)}"
        )
    o = kernel.shape[-1]
    for t, what in ((scale, "scale"), (shift, "shift")):
        if tuple(t.shape) != (o,):
            raise ValueError(f"{name}: {what} must be ({o},), got {tuple(t.shape)}")


def _check_dtypes(name: str, x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor) -> None:
    """x and kernel float32 or bfloat16, of one dtype; scale and shift float32."""
    if x.dtype not in DTYPES or kernel.dtype != x.dtype:
        raise TypeError(f"{name}: x and kernel must both be float32 or both bfloat16, got "
                        f"{x.dtype} and {kernel.dtype}")
    if scale.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError(f"{name}: scale and shift must be float32, got {scale.dtype} and "
                        f"{shift.dtype}")


def _launch(name: str, x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor,
            relu: bool, role: str = "forward", impl: Optional[str] = None) -> Tensor:
    """Launch kernel ``name`` on CUDA tensors. A bfloat16 launch runs
    ``conv_wg_bf16`` when :func:`wg_eligible` admits it, else
    ``conv_tc_bf16``; ``impl`` ("wg" or "tc") names the kernel instead, for a
    measurement that times both at one shape (``chip_smoke.py``), and "wg"
    still needs :func:`wg_supported`."""
    _check(name, x, kernel, scale, shift)
    _check_dtypes(name, x, kernel, scale, shift)
    dev = x.device
    for t in (x, kernel, scale, shift):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, one is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    m, n, k, phases = geometry(name, x, kernel)
    if max(x.numel(), phases * m * n) >= 2**31:
        raise ValueError(f"{name}: tensor too large for 32-bit pixel indices")
    b, h, w, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    if impl is None:
        impl = "wg" if bf16 and wg_eligible(name, x, kernel) else "tc"
    elif impl not in IMPLS or not bf16 or (impl == "wg" and not wg_supported(name, x, kernel)):
        raise ValueError(f"{name}: no {impl} kernel for {x.dtype} x{tuple(x.shape)} -> {n}")
    out = torch.empty(output_shape(name, x.shape, n), device=dev, dtype=x.dtype)
    if m == 0 or n == 0:
        return out
    if impl == "wg":
        _launch_wg(name, x, kernel, scale, shift, out, relu)
        bf16_launches[name][role] += 1
        bf16_impl_launches[name][role]["wg"] += 1
        return out
    cfg, splits, kchunk = plan_tc(m, n, k, phases, bk=TC_BK_BF16 if bf16 else TC_BK)
    ws = (torch.empty((splits * phases * m * n,), device=dev, dtype=torch.float32)
          if splits > 1 else None)
    fn = getattr(_library(), _KERNELS[name][0] + ("_bf16" if bf16 else ""))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cfg, x.data_ptr(), kernel.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 out.data_ptr(), ws.data_ptr() if ws is not None else None,
                 b, h, w, c, n, int(relu), splits, kchunk, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    if bf16:
        bf16_launches[name][role] += 1
        bf16_impl_launches[name][role]["tc"] += 1
    else:
        launches[name] += 1
        role_launches[name][role] += 1
    return out


def _launch_wg(name: str, x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor,
               out: Tensor, relu: bool) -> None:
    b, h, w, c = x.shape
    o = kernel.shape[-1]
    if out.data_ptr() % 16:
        raise ValueError(f"{name}: the output is not 16-byte aligned")
    plan = plan_wg(name, b, h, w, c, o)
    fn = getattr(_wg_library(), WG_KERNELS[name])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), kernel.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 out.data_ptr(), b, h, w, c, o, int(relu), plan.wb, plan.th, plan.nb, plan.bn,
                 plan.kc, plan.stages, plan.grid, stream)
    if err >= 20000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled is not available")
    if err >= 10000:
        raise RuntimeError(f"{name}: a TMA tensor map failed to encode (CUresult {err - 10000})")
    if err != 0:
        raise RuntimeError(f"{name}: conv_wg_bf16 launch failed with cudaError {err}")


_lib: Optional[ctypes.CDLL] = None
_wg_lib: Optional[ctypes.CDLL] = None


def _wg_library() -> ctypes.CDLL:
    global _wg_lib
    if _wg_lib is None:
        from simple_vae_rs_tpu_torch.ops import _build

        lib = _build.load(WG_SOURCE)
        for sym in WG_KERNELS.values():
            fn = getattr(lib, sym)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _wg_lib = lib
    return _wg_lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from simple_vae_rs_tpu_torch.ops import _build

        lib = _build.load(SOURCE)
        for sym, *_ in _KERNELS.values():
            for fn in (getattr(lib, sym), getattr(lib, sym + "_bf16")):
                fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _dispatch(name: str, x, kernel, scale, shift, relu, role: str = "forward",
              impl: Optional[str] = None):
    if x.device.type == "cpu" and impl is None:
        _check_dtypes(name, x, kernel, scale, shift)
        return PLAIN[name](x, kernel, scale, shift, relu)
    if x.device.type != "cuda":
        where = "a CUDA card" if impl else "the CPU or a CUDA card"
        raise ValueError(f"{name}: tensors must be on {where}, not {x.device}")
    return _launch(name, x, kernel, scale, shift, relu, role, impl)


def launch_bf16(name: str, impl: str, x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor,
                relu: bool = True) -> Tensor:
    """Kernel ``name`` on bfloat16 CUDA tensors through ``impl`` ("wg":
    ``conv_wg_bf16``, which needs :func:`wg_supported`; "tc":
    ``conv_tc_bf16``), whatever :func:`wg_eligible` says: for measurements
    that hold and time both kernels at one shape. Counted as a forward
    launch; the model paths never call it."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: launch_bf16 needs CUDA tensors, not {x.device}")
    return _launch(name, x, kernel, scale, shift, relu, "forward", impl)


# ------------------------------------------------------------ plain versions
# The JAX ``_reference3`` contract for both dtypes: the operands upcast to
# float32, the conv in float32 with TF32 off, ``* scale + shift`` and the
# ReLU in float32, then one rounding to ``x``'s dtype.
def _up(t: Tensor) -> Tensor:
    """bfloat16 upcast to float32; float32 (and the int8 plain versions'
    float64) as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _affine(y_nchw: Tensor, scale: Tensor, shift: Tensor, relu: bool, dtype) -> Tensor:
    y = y_nchw.permute(0, 2, 3, 1) * scale + shift
    return (y.clamp_min(0.0) if relu else y).to(dtype).contiguous()


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(kernel: Tensor) -> Tensor:
    return kernel.permute(3, 2, 0, 1)


def conv3x3_plain(x, kernel, scale, shift, relu=True):
    """Plain version of :func:`fused_conv3x3_bn_relu` (JAX ``_reference3``)."""
    with _no_tf32():
        y = F.conv2d(_nchw(_up(x)), _oihw(_up(kernel)), padding=1)
    return _affine(y, scale, shift, relu, x.dtype)


def conv4x4s2_plain(x, kernel, scale, shift, relu=True):
    """Plain version of :func:`fused_conv4x4s2_bn_relu` (JAX ``_reference4``)."""
    with _no_tf32():
        y = F.conv2d(_nchw(_up(x)), _oihw(_up(kernel)), stride=2, padding=1)
    return _affine(y, scale, shift, relu, x.dtype)


def convT4x4s2_plain(x, kernel, scale, shift, relu=True):
    """Plain version of :func:`fused_convT4x4s2_bn_relu` (JAX ``_referenceT``):
    a conv over the zero-dilated input with pad 2 and the stored kernel."""
    b, h, w, c = x.shape
    xd = _up(x).new_zeros((b, c, 2 * h - 1, 2 * w - 1))
    xd[:, :, ::2, ::2] = _nchw(_up(x))
    with _no_tf32():
        y = F.conv2d(xd, _oihw(_up(kernel)), padding=2)
    return _affine(y, scale, shift, relu, x.dtype)


PLAIN = {
    "fused_conv3x3_bn_relu": conv3x3_plain,
    "fused_conv4x4s2_bn_relu": conv4x4s2_plain,
    "fused_convT4x4s2_bn_relu": convT4x4s2_plain,
}


# ------------------------------------------------------------------ wrappers
def fused_conv3x3_bn_relu(x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor,
                          relu: bool = True) -> Tensor:
    """``act(conv3x3/s1 SAME(x, kernel) * scale + shift)``; (B, H, W, O)."""
    return _dispatch("fused_conv3x3_bn_relu", x, kernel, scale, shift, relu)


def fused_conv4x4s2_bn_relu(x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor,
                            relu: bool = True) -> Tensor:
    """``act(conv4x4/s2/p1(x, kernel) * scale + shift)``; (B, H/2, W/2, O)."""
    return _dispatch("fused_conv4x4s2_bn_relu", x, kernel, scale, shift, relu)


def fused_convT4x4s2_bn_relu(x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor,
                             relu: bool = True) -> Tensor:
    """``act(convT4x4/s2/p1(x) * scale + shift)`` with ``kernel`` in the
    input-dilated form (spatially flipped, ``(4, 4, C, O)``); (B, 2H, 2W, O)."""
    return _dispatch("fused_convT4x4s2_bn_relu", x, kernel, scale, shift, relu)


WRAPPERS = {
    "fused_conv3x3_bn_relu": fused_conv3x3_bn_relu,
    "fused_conv4x4s2_bn_relu": fused_conv4x4s2_bn_relu,
    "fused_convT4x4s2_bn_relu": fused_convT4x4s2_bn_relu,
}


# ------------------------------------------------------------------ gradients
# The kernel that computes each conv's input gradient: the 3x3 conv is its
# own adjoint, and the strided conv and the input-dilated convT are each
# other's (JAX ``conv4x4s2_dx`` and ``jax.linear_transpose``).
DX_KERNEL = {
    "fused_conv3x3_bn_relu": "fused_conv3x3_bn_relu",
    "fused_conv4x4s2_bn_relu": "fused_convT4x4s2_bn_relu",
    "fused_convT4x4s2_bn_relu": "fused_conv4x4s2_bn_relu",
}


def flip_swap(kernel: Tensor) -> Tensor:
    """(k, k, C, O) -> the adjoint's weight ``k'[i, j, o, c] = k[k-1-i, k-1-j, c, o]``
    (JAX ``_flip_swap``)."""
    return kernel.flip(0, 1).transpose(2, 3).contiguous()


def input_grad(name: str, g_conv: Tensor, kernel: Tensor, in_shape,
               plain: bool = False, impl: Optional[str] = None) -> Tensor:
    """Gradient of conv ``name`` with respect to its input ``(B, H, W, C)``,
    given the gradient ``g_conv`` of its pre-affine output: the
    :data:`DX_KERNEL` kernel on the flip-swapped weight, scale 1, shift 0,
    no ReLU (the plain version of that kernel with ``plain``), in
    ``g_conv``'s dtype. ``impl`` names the bfloat16 kernel on CUDA tensors
    as :func:`launch_bf16` does, for measurements; the model paths never
    pass it."""
    b, h, w, c = in_shape
    if name == "fused_conv4x4s2_bn_relu" and (h, w) != (2 * g_conv.shape[1], 2 * g_conv.shape[2]):
        raise ValueError(f"{name}: the input gradient needs an even input, got {tuple(in_shape)}")
    dx_name = DX_KERNEL[name]
    ones = torch.ones(c, device=g_conv.device, dtype=torch.float32)
    args = (g_conv, flip_swap(kernel), ones, torch.zeros_like(ones), False)
    if plain:
        return PLAIN[dx_name](*args)
    return _dispatch(dx_name, *args, role="dx", impl=impl)


def weight_grad(name: str, x: Tensor, g_conv: Tensor, kernel: Tensor) -> Tensor:
    """Gradient of conv ``name`` with respect to its HWIO ``kernel``: one
    library call (``aten.convolution_backward``, weight only, TF32 off) in
    ``x``'s dtype, as the JAX package leaves it to XLA's ``linear_transpose``."""
    xn, gn = _nchw(x), _nchw(g_conv)
    mask = [False, True, False]
    with _no_tf32():
        if name == "fused_convT4x4s2_bn_relu":
            # y = conv_transpose2d(x, w_t, stride 2, pad 1), w_t[c, o, i, j] = k[3-i, 3-j, c, o]
            w_t = kernel.flip(0, 1).permute(2, 3, 0, 1)
            dw = torch.ops.aten.convolution_backward(
                gn, xn, w_t, None, [2, 2], [1, 1], [1, 1], True, [0, 0], 1, mask)[1]
            return dw.flip(2, 3).permute(2, 3, 0, 1).contiguous()
        stride = 2 if name == "fused_conv4x4s2_bn_relu" else 1
        dw = torch.ops.aten.convolution_backward(
            gn, xn, _oihw(kernel), None, [stride, stride], [1, 1], [1, 1], False, [0, 0], 1,
            mask)[1]
        return dw.permute(2, 3, 1, 0).contiguous()


class _FusedConv(torch.autograd.Function):
    """``act(conv(x, kernel) * scale + shift)`` with the backward of JAX's
    ``_make_grad``: the ReLU mask and the pre-affine conv result come from
    the saved output, so the forward conv is not run again. The backward
    works in float32 (the ReLU mask, ``dscale`` and ``dshift``) and rounds
    ``g * scale`` once to ``x``'s dtype for the input and weight gradients,
    which come back in that dtype."""

    @staticmethod
    def forward(ctx, x, kernel, scale, shift, name, relu, plain):
        fn = PLAIN[name] if plain else WRAPPERS[name]
        out = fn(x, kernel, scale, shift, relu)
        ctx.save_for_backward(x, kernel, scale, shift, out)
        ctx.name, ctx.relu, ctx.plain = name, relu, plain
        return out

    @staticmethod
    def backward(ctx, g):
        x, kernel, scale, shift, out = ctx.saved_tensors
        need_x, need_k, need_scale, need_shift = ctx.needs_input_grad[:4]
        g, out = g.float(), out.float()  # no-ops in float32
        if ctx.relu:
            g = torch.where(out > 0.0, g, 0.0)
        dx = dk = dscale = dshift = None
        if need_scale:
            inv = torch.where(scale == 0.0, 0.0, 1.0 / scale)
            dscale = torch.sum(g * ((out - shift) * inv), dim=(0, 1, 2))
        if need_shift:
            dshift = torch.sum(g, dim=(0, 1, 2))
        # the kernels take contiguous tensors; autograd may hand back views
        g_conv = (g * scale).to(x.dtype).contiguous()
        if need_x:
            dx = input_grad(ctx.name, g_conv, kernel, x.shape, ctx.plain)
        if need_k:
            dk = weight_grad(ctx.name, x, g_conv, kernel)
        return dx, dk, dscale, dshift, None, None, None


def fused_conv(name: str, x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor,
               relu: bool, plain: bool = False) -> Tensor:
    """Differentiable ``act(conv(x, kernel) * scale + shift)`` through kernel
    ``name`` (its plain version with ``plain``), forward and backward."""
    return _FusedConv.apply(x, kernel, scale, shift, name, relu, plain)


# bfloat16 instances against their plain versions: one rounding of a float32
# sum on each side, the sums in another order. Where the two float32 sums
# straddle a rounding boundary the outputs are one bfloat16 ulp apart; below
# about 1e-4 of the tensor's largest value the float32 sums' own order
# (the float32 kernels' tolerance) can move an element by more ulps of its
# own magnitude, so the bound is one ulp at the element plus that much.
BF16_SUM_TOL = 1e-4  # of max|plain|


def bf16_ulp(t: Tensor) -> Tensor:
    """The spacing of bfloat16 at ``|t|``: ``2^(floor(log2|t|) - 7)`` (8
    significant bits), float32."""
    a = t.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def compare_bf16(got: Tensor, want: Tensor) -> Dict[str, float]:
    """``got`` against ``want`` (both bfloat16): the largest difference, the
    largest of it over the bound (one ulp at the element plus
    :data:`BF16_SUM_TOL` of max|want|; <= 1 passes), the share of elements
    bit-equal and the share within one ulp of their own magnitude."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ulp = bf16_ulp(torch.maximum(g.abs(), w.abs()))
    ref = float(w.abs().max()) if w.numel() else 0.0
    bound = ulp + BF16_SUM_TOL * ref
    n = max(err.numel(), 1)
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0, "max_abs_ref": ref,
            "of_bound": float((err / bound).max()) if err.numel() else 0.0,
            "share_bit_equal": float((got.view(torch.int16) == want.view(torch.int16))
                                     .sum()) / n,
            "share_within_1ulp": float((err <= ulp).sum()) / n}


def fold_conv_bn(kernel: Tensor, bias: Optional[Tensor], bn_scale: Tensor, bn_bias: Tensor,
                 running_mean: Tensor, running_var: Tensor, eps: float = 1e-5):
    """Fold eval-mode BatchNorm into ``(kernel, scale, shift)``:
    ``conv -> BN(eval) == conv * s + t`` with ``s = gamma / sqrt(var + eps)``
    and ``t = beta - mean * s`` (``+ bias * s`` when the conv has a bias)."""
    s = bn_scale / torch.sqrt(running_var + eps)
    t = bn_bias - running_mean * s
    if bias is not None:
        t = t + bias * s
    return kernel, s, t
