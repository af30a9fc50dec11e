"""Fused conv + per-channel affine + optional ReLU: CUDA kernels and plain versions.

The port of ``simple_vae_rs_tpu/ops/pallas_conv.py``'s three eval-path
kernels. Each computes ``act(conv(x, kernel) * scale + shift)`` with ``x``
NHWC float32 and ``kernel`` in the JAX HWIO layout ``(kh, kw, C, O)``:

- :func:`fused_conv3x3_bn_relu`: 3x3, stride 1, SAME padding (every 3x3 conv);
- :func:`fused_conv4x4s2_bn_relu`: 4x4, stride 2, pad 1 (DownBlock eval tail
  with BatchNorm folded in by :func:`fold_conv_bn`);
- :func:`fused_convT4x4s2_bn_relu`: transposed 4x4, stride 2, pad 1, with the
  kernel in the input-dilated form the JAX models store (UpBlock eval tail).

A wrapper given CPU tensors computes its plain version (``*_plain``, plain
PyTorch on permuted tensors); given CUDA tensors it launches the hand-written
kernel in ``csrc/fused_conv.cu`` on the current stream or raises. There is no
fallback between the two. :data:`launches` counts kernel launches per wrapper,
and :data:`role_launches` splits them into forward calls and input gradients.

:func:`fused_conv` is the differentiable form (port of the JAX ``_make_grad``
VJPs): its backward computes every input gradient with one of the three
kernels on the flipped, in/out-swapped weight (:func:`input_grad`) and the
weight gradient with one library call (:func:`weight_grad`; JAX leaves it to
XLA too).

The CUDA source's header says what bounds each kernel on the card and what
its implicit-GEMM design does about it; :func:`plan` is the launch geometry
(tile configuration and K split) it is given.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

SOURCE = "fused_conv.cu"

# kernel name -> (C entry point, live taps, spatial stride, output phases)
_KERNELS = {
    "fused_conv3x3_bn_relu": ("svrs_conv3x3", 9, 1, 1),
    "fused_conv4x4s2_bn_relu": ("svrs_conv4x4s2", 16, 2, 1),
    "fused_convT4x4s2_bn_relu": ("svrs_convT4x4s2", 4, 1, 4),
}
ROLES = ("forward", "dx")

# Launches of each kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else, under the role it ran for.
launches: Dict[str, int] = {name: 0 for name in _KERNELS}
role_launches: Dict[str, Dict[str, int]] = {name: dict.fromkeys(ROLES, 0) for name in _KERNELS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        role_launches[name] = dict.fromkeys(ROLES, 0)


# Tile configurations of the CUDA launcher: (BM, BN) per index.
TILES = {0: (128, 128), 1: (128, 64), 2: (256, 16), 3: (32, 128)}
_BK = 8
_SMS = 132  # H100 SXM streaming multiprocessors
_MIN_SPLIT_K = 32  # keep at least 4 BK steps in every K split


def plan(m: int, n: int, k: int, phases: int = 1) -> Tuple[int, int, int]:
    """Launch geometry ``(tile config, K splits, K per split)`` for a GEMM of
    ``m`` output pixels (per phase) x ``n`` channels x ``k`` reduction.

    Thin tiles for few pixels (the weight-bound prior heads), narrow tiles
    for few channels (the 64x64 tail), and a K split when the output tiles
    alone would leave most of the card's SMs idle.
    """
    if m <= 64:
        cfg = 3
    elif n <= 32:
        cfg = 2
    elif n <= 64:
        cfg = 1
    else:
        cfg = 0
    bm, bn = TILES[cfg]
    blocks = _cdiv(m, bm) * _cdiv(n, bn) * phases
    splits = 1
    if blocks < _SMS:
        splits = max(1, min(_cdiv(2 * _SMS, blocks), k // _MIN_SPLIT_K))
    kchunk = _cdiv(_cdiv(k, splits), _BK) * _BK
    return cfg, _cdiv(k, kchunk), kchunk


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


def _launch(name: str, x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor,
            relu: bool, role: str = "forward") -> Tensor:
    _check(name, x, kernel, scale, shift)
    dev = x.device
    for t in (x, kernel, scale, shift):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, one is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    m, n, k, phases = geometry(name, x, kernel)
    if max(x.numel(), phases * m * n) >= 2**31:
        raise ValueError(f"{name}: tensor too large for 32-bit pixel indices")
    b, h, w, c = x.shape
    out = torch.empty(output_shape(name, x.shape, n), device=dev, dtype=torch.float32)
    if m == 0 or n == 0:
        return out
    cfg, splits, kchunk = plan(m, n, k, phases)
    ws = (torch.empty((splits * phases * m * n,), device=dev, dtype=torch.float32)
          if splits > 1 else None)
    fn = getattr(_library(), _KERNELS[name][0])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cfg, x.data_ptr(), kernel.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 out.data_ptr(), ws.data_ptr() if ws is not None else None,
                 b, h, w, c, n, int(relu), splits, kchunk, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    launches[name] += 1
    role_launches[name][role] += 1
    return out


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from simple_vae_rs_tpu_torch.ops import _build

        lib = _build.load(SOURCE)
        for sym, *_ in _KERNELS.values():
            fn = getattr(lib, sym)
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _dispatch(name: str, x, kernel, scale, shift, relu, role: str = "forward"):
    if x.device.type == "cpu":
        return PLAIN[name](x, kernel, scale, shift, relu)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA card, not {x.device}")
    return _launch(name, x, kernel, scale, shift, relu, role)


# ------------------------------------------------------------ plain versions
def _affine(y_nchw: Tensor, scale: Tensor, shift: Tensor, relu: bool) -> Tensor:
    y = y_nchw.permute(0, 2, 3, 1) * scale + shift
    return (y.clamp_min(0.0) if relu else y).contiguous()


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(kernel: Tensor) -> Tensor:
    return kernel.permute(3, 2, 0, 1)


def conv3x3_plain(x, kernel, scale, shift, relu=True):
    """Plain version of :func:`fused_conv3x3_bn_relu` (JAX ``_reference3``)."""
    return _affine(F.conv2d(_nchw(x), _oihw(kernel), padding=1), scale, shift, relu)


def conv4x4s2_plain(x, kernel, scale, shift, relu=True):
    """Plain version of :func:`fused_conv4x4s2_bn_relu` (JAX ``_reference4``)."""
    y = F.conv2d(_nchw(x), _oihw(kernel), stride=2, padding=1)
    return _affine(y, scale, shift, relu)


def convT4x4s2_plain(x, kernel, scale, shift, relu=True):
    """Plain version of :func:`fused_convT4x4s2_bn_relu` (JAX ``_referenceT``):
    a conv over the zero-dilated input with pad 2 and the stored kernel."""
    b, h, w, c = x.shape
    xd = x.new_zeros((b, c, 2 * h - 1, 2 * w - 1))
    xd[:, :, ::2, ::2] = _nchw(x)
    return _affine(F.conv2d(xd, _oihw(kernel), padding=2), scale, shift, relu)


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
               plain: bool = False) -> Tensor:
    """Gradient of conv ``name`` with respect to its input ``(B, H, W, C)``,
    given the gradient ``g_conv`` of its pre-affine output: the
    :data:`DX_KERNEL` kernel on the flip-swapped weight, scale 1, shift 0,
    no ReLU (the plain version of that kernel with ``plain``)."""
    b, h, w, c = in_shape
    if name == "fused_conv4x4s2_bn_relu" and (h, w) != (2 * g_conv.shape[1], 2 * g_conv.shape[2]):
        raise ValueError(f"{name}: the input gradient needs an even input, got {tuple(in_shape)}")
    dx_name = DX_KERNEL[name]
    args = (g_conv, flip_swap(kernel), g_conv.new_ones(c), g_conv.new_zeros(c), False)
    if plain:
        return PLAIN[dx_name](*args)
    return _dispatch(dx_name, *args, role="dx")


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def weight_grad(name: str, x: Tensor, g_conv: Tensor, kernel: Tensor) -> Tensor:
    """Gradient of conv ``name`` with respect to its HWIO ``kernel``: one
    library call (``aten.convolution_backward``, weight only, TF32 off), as
    the JAX package leaves it to XLA's ``linear_transpose``."""
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
    the saved output, so the forward conv is not run again."""

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
        if ctx.relu:
            g = torch.where(out > 0.0, g, 0.0)
        dx = dk = dscale = dshift = None
        if need_scale:
            inv = torch.where(scale == 0.0, 0.0, 1.0 / scale)
            dscale = torch.sum(g * ((out - shift) * inv), dim=(0, 1, 2))
        if need_shift:
            dshift = torch.sum(g, dim=(0, 1, 2))
        # the kernels take contiguous tensors; autograd may hand back views
        g_conv = (g * scale).contiguous()
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
