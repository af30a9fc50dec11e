"""W8A8 int8 fused convs: CUDA kernels and exact plain versions.

The port of ``simple_vae_rs_tpu/ops/pallas_int8.py``, eval only (no
gradient, as there). Weights arrive quantized (``kernel_q`` int8 in the JAX
HWIO layout, ``kernel_s`` one float32 scale per output channel, from
``ops/quantize.py``); activations are quantized inside the call:

    a   = max(absmax(x over the image's group) / 127, 1e-12)
    qx  = clip(round(x / a), -127, 127)          (half to even)
    acc = conv(qx, kernel_q)                      (int32, exact)
    out = act(float(acc) * ((a * kernel_s) * scale) + shift)

- :func:`int8_conv3x3_bn_relu`: 3x3, stride 1, SAME;
- :func:`int8_conv4x4s2_bn_relu`: 4x4, stride 2, pad 1 (DownBlock tail);
- :func:`int8_convT4x4s2_bn_relu`: transposed 4x4, stride 2, pad 1, kernel in
  the input-dilated form (UpBlock tail).

``x`` is float32 or bfloat16 (a bfloat16 model's convs, as the JAX blocks
hand the kernels ``x.astype(dtype)``); the output has ``x``'s dtype. A
bfloat16 ``x`` is upcast to float32 (exact), so its scales and quantized
values are those of the float32 tensor of the same values; the epilogue is
float32 and rounds once to bfloat16 (the JAX kernels'
``out.astype(x.dtype)``).

``act_group`` is the number of consecutive images that share one activation
scale. The default, the whole batch, is what the JAX package's
``int8_reference*`` and its strip kernel compute, and what it runs
everywhere off a TPU; ``act_group = bt`` reproduces a Pallas launch of
``B / bt`` programs, each with the absmax of its own batch tile. With one
scale per call an image's output depends on the other images of its batch:
that is the reference's behaviour.

A wrapper given CPU tensors computes its plain version; given CUDA tensors
it launches the kernels of ``csrc/int8_conv.cu`` on the current stream (no
host sync between them) or raises: the absmax pass, then, in one C call, the
quantize pass (:func:`act_quant`, each activation quantized once into an
int8 NHWC buffer with 16-channel padding) and the conv on the int8 tensor
cores (all three convs, :data:`TC_KERNELS`). :data:`launches` counts the
launches of each on float32 tensors, :data:`bf16_launches` those of the
bfloat16 instances (``csrc/int8_conv.cu``'s ``*_bf16`` entry points, which
read and write bfloat16 themselves): a bfloat16 CUDA tensor launches them or
raises. The plain versions accumulate exactly (a float64 conv of
integer-valued tensors, every partial sum below 2**53), as the kernels'
int32 does; the reference's float32 conv rounds once sums pass 2**24, which
K = 9 * 424 reaches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops.quantize import QMAX, true_div

Tensor = torch.Tensor

SOURCE = "int8_conv.cu"

# int8 kernel -> the float kernel with the same geometry
_KERNELS = {
    "int8_conv3x3_bn_relu": "fused_conv3x3_bn_relu",
    "int8_conv4x4s2_bn_relu": "fused_conv4x4s2_bn_relu",
    "int8_convT4x4s2_bn_relu": "fused_convT4x4s2_bn_relu",
}
ABSMAX = "act_absmax"
QUANT = "act_quant"

# The kernels on the int8 tensor cores (``int8_tc``, fed by the quantize
# pass): all three, with their mode in the C entry point ``svrs_int8_tc``.
TC_KERNELS = {"int8_conv3x3_bn_relu": 0, "int8_conv4x4s2_bn_relu": 1,
              "int8_convT4x4s2_bn_relu": 2}
TC_PAD = 16  # channel multiple of the quantized activations and the packed weight
# Tile configurations of ``int8_tc``: (BM, BN, warp tile WM, WN, cp.async
# stages) per index; K runs in steps of 32 words (128 channels), the step of
# the float kernels' ``fc.TC_BK`` floats, so the two share their plan.
TC_TILES = {
    0: (128, 128, 64, 32, 3),  # N > 64
    1: (128, 64, 32, 32, 3),   # 16 < N <= 64
    2: (128, 16, 16, 16, 4),   # N <= 16: the 64x64 tail's O = 16 and O = 4
    3: (32, 128, 32, 32, 4),   # M <= 64 per phase
}
TC_BKW = fc.TC_BK

# Launches since the last reset_launches(): a wrapper adds one per kernel it
# launches (the absmax pass, the quantize pass and the conv), and nowhere else;
# on float32 tensors in ``launches``, on bfloat16 ones in ``bf16_launches``.
launches: Dict[str, int] = {**{name: 0 for name in _KERNELS}, ABSMAX: 0, QUANT: 0}
bf16_launches: Dict[str, int] = dict(launches)


def reset_launches() -> None:
    for counts in (launches, bf16_launches):
        for name in counts:
            counts[name] = 0


def _count(x: Tensor, name: str) -> None:
    (bf16_launches if x.dtype == torch.bfloat16 else launches)[name] += 1


def float_name(name: str) -> str:
    """The float32 kernel of ``ops/fused_conv.py`` with the same geometry."""
    return _KERNELS[name]


def output_shape(name: str, x_shape, o: int) -> Tuple[int, int, int, int]:
    return fc.output_shape(float_name(name), x_shape, o)


def padded_channels(c: int) -> int:
    """Channels of a pixel of the quantized activations and of a tap of the
    packed weight: ``round_up(c, 16)``, the pad channels zero."""
    return _cdiv(c, TC_PAD) * TC_PAD


def geometry(name: str, x_shape, o: int) -> Tuple[int, int, int, int]:
    """GEMM shape ``(M per phase, N, K in words, phases)`` of a kernel call,
    a word being four channels of one tap: K = live taps * ``round_up(C, 16)
    / 4``."""
    _, taps, stride, phases = fc._KERNELS[float_name(name)]
    b, h, w, c = x_shape
    ho, wo = (h // 2, w // 2) if stride == 2 else (h, w)
    return b * ho * wo, o, taps * padded_channels(c) // 4, phases


def plan_int8_tc(m: int, n: int, k: int, phases: int = 1) -> Tuple[int, int, int]:
    """Launch geometry ``(tile config, K splits, K words per split)`` of
    ``int8_tc`` for a GEMM of ``m`` output pixels per phase x ``n`` channels
    x ``k`` words, ``phases`` of them: :func:`fused_conv.plan_tc`'s choices
    over :data:`TC_TILES` (thin tiles for few pixels, narrow ones for few
    channels, a K split of whole 32-word steps when the output tiles alone
    would leave most of the card's SMs idle)."""
    return fc.plan_tc(m, n, k, phases, TC_TILES)


def tc_smem_bytes(cfg: int) -> int:
    """Dynamic shared memory of ``int8_tc`` tile ``cfg``: its cp.async ring
    of A ``[BM][32 + 4]`` and B ``[32][BN + 8]`` int32 slots."""
    return fc.tc_smem_bytes(cfg, TC_TILES)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _group(b: int, act_group: Optional[int]) -> int:
    group = b if act_group is None else int(act_group)
    if group < 1:
        raise ValueError(f"act_group must be >= 1, got {act_group}")
    return max(1, min(group, b))


def pack_kernel_q(kernel_q: Tensor) -> Tensor:
    """``(kh, kw, C, O)`` int8 -> ``(kh * kw * round_up(C, 16) / 4, O)``
    int32, the weight as every int8 conv kernel takes it: four consecutive
    input channels of one output channel in one word (channel ``4 j + i`` in
    byte ``i``, zero past ``C``), the s8 tensor-core MMA's B fragment
    layout. The conv modules keep it (``kernel_p``)."""
    kh, kw, c, o = kernel_q.shape
    c4 = padded_channels(c) // 4
    q = F.pad(kernel_q, (0, 0, 0, 4 * c4 - c))
    q = q.reshape(kh * kw, c4, 4, o).permute(0, 1, 3, 2).contiguous()
    return q.view(torch.int32).reshape(kh * kw * c4, o)


def _check(name: str, x: Tensor, kernel_q: Tensor, kernel_s: Tensor, scale: Tensor,
           shift: Tensor) -> None:
    fc._check(float_name(name), x, kernel_q, scale, shift)
    if kernel_q.dtype != torch.int8:
        raise TypeError(f"{name}: kernel_q must be int8, got {kernel_q.dtype}")
    if tuple(kernel_s.shape) != (kernel_q.shape[-1],):
        raise ValueError(f"{name}: kernel_s must be ({kernel_q.shape[-1]},), "
                         f"got {tuple(kernel_s.shape)}")


# ------------------------------------------------------------ plain versions
def act_absmax_plain(x: Tensor, act_group: Optional[int] = None) -> Tensor:
    """``max |x|`` over each group of ``act_group`` consecutive images
    (the last group may be short): ``(ceil(B / act_group),)``, float32."""
    x = fc._up(x)
    b = x.shape[0]
    group = _group(b, act_group)
    per_image = x.abs().amax(dim=(1, 2, 3))
    per_image = F.pad(per_image, (0, (-b) % group))
    return per_image.view(-1, group).amax(dim=1)


def _scale_per_image(amax: Tensor, b: int, act_group: Optional[int]) -> Tensor:
    """The activation scale ``max(amax / 127, 1e-12)`` of each image, ``(B, 1, 1, 1)``."""
    a = torch.clamp_min(true_div(amax, QMAX), 1e-12)
    return a.repeat_interleave(_group(b, act_group))[:b].view(b, 1, 1, 1)


def quantize_act(x: Tensor, act_group: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """The in-kernel activation quantization (JAX ``_quant_act``):
    integer-valued float32 ``qx`` and the per-image scale ``(B, 1, 1, 1)``."""
    x = fc._up(x)
    a = _scale_per_image(act_absmax_plain(x, act_group), x.shape[0], act_group)
    return torch.clamp(torch.round(x / a), -QMAX, QMAX), a


def act_quant_plain(x: Tensor, amax: Tensor, act_group: Optional[int] = None) -> Tensor:
    """Plain version of :func:`act_quant`: :func:`quantize_act` with the
    group absmax ``amax`` given, its channels zero-padded to a multiple of
    16, as int8 ``(B, H, W, round_up(C, 16))``."""
    x = fc._up(x)
    c = x.shape[-1]
    a = _scale_per_image(amax, x.shape[0], act_group)
    q = torch.clamp(torch.round(x / a), -QMAX, QMAX)
    return F.pad(q, (0, padded_channels(c) - c)).to(torch.int8)


def _plain(name: str, x, kernel_q, kernel_s, scale, shift, relu, act_group) -> Tensor:
    _check(name, x, kernel_q, kernel_s, scale, shift)
    o = kernel_q.shape[-1]
    if x.shape[0] == 0:
        return x.new_empty(output_shape(name, x.shape, o))
    qx, a = quantize_act(x, act_group)  # a bfloat16 x upcast: exact
    one = torch.ones(o, dtype=torch.float64, device=x.device)
    acc = fc.PLAIN[float_name(name)](qx.double(), kernel_q.double(), one, torch.zeros_like(one),
                                     False)
    # every partial sum is an integer below 2**53: the round only removes
    # what a transform-based library algorithm might add
    out = torch.round(acc).to(torch.float32) * ((a * kernel_s) * scale) + shift
    return (out.clamp_min(0.0) if relu else out).to(x.dtype)  # one rounding


def int8_conv3x3_plain(x, kernel_q, kernel_s, scale, shift, relu=True, act_group=None):
    """Plain version of :func:`int8_conv3x3_bn_relu` (JAX ``int8_reference3``,
    accumulated exactly)."""
    return _plain("int8_conv3x3_bn_relu", x, kernel_q, kernel_s, scale, shift, relu, act_group)


def int8_conv4x4s2_plain(x, kernel_q, kernel_s, scale, shift, relu=True, act_group=None):
    """Plain version of :func:`int8_conv4x4s2_bn_relu` (JAX ``int8_reference4``)."""
    return _plain("int8_conv4x4s2_bn_relu", x, kernel_q, kernel_s, scale, shift, relu,
                  act_group)


def int8_convT4x4s2_plain(x, kernel_q, kernel_s, scale, shift, relu=True, act_group=None):
    """Plain version of :func:`int8_convT4x4s2_bn_relu` (JAX ``int8_referenceT``)."""
    return _plain("int8_convT4x4s2_bn_relu", x, kernel_q, kernel_s, scale, shift, relu,
                  act_group)


PLAIN = {
    "int8_conv3x3_bn_relu": int8_conv3x3_plain,
    "int8_conv4x4s2_bn_relu": int8_conv4x4s2_plain,
    "int8_convT4x4s2_bn_relu": int8_convT4x4s2_plain,
}


# ------------------------------------------------------------------ launches
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from simple_vae_rs_tpu_torch.ops import _build

        lib = _build.load(SOURCE)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        argtypes = {
            "svrs_int8_tc": [i32] * 3 + [vp] * 9 + [i32] * 9 + [vp],
            "svrs_act_quant": [i32] + [vp] * 3 + [i32] * 5 + [vp],
            "svrs_act_absmax": [i32, vp, vp, ctypes.c_longlong, ctypes.c_longlong, i32, i32, vp],
        }
        for sym, types in argtypes.items():
            for fn in (getattr(lib, sym), getattr(lib, sym + "_bf16")):
                fn.argtypes = types
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _cuda_input(name: str, x: Tensor) -> Tensor:
    if x.dtype not in fc.DTYPES:
        raise TypeError(f"{name}: float32 or bfloat16 activations only, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: tensor too large for 32-bit pixel indices")
    # the kernels read whole 16-byte words (four float32 or eight bfloat16 channels)
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _symbol(fn: str, x: Tensor):
    """C entry point ``fn`` of the library, its bfloat16 instance for a
    bfloat16 ``x``."""
    return getattr(_library(), fn + ("_bf16" if x.dtype == torch.bfloat16 else ""))


# The absmax pass's grid: 256-thread blocks (8 resident on an SM), each
# reading at least 32 KB (``csrc/int8_conv.cu``, ``act_absmax``).
_ABSMAX_BLOCKS_PER_SM = 8
_ABSMAX_MIN_BYTES = 32768


def absmax_plan(per_group: int, groups: int, itemsize: int = 4) -> int:
    """Blocks per group of the absmax pass over elements of ``itemsize``
    bytes: enough that all groups' blocks together fill every SM, and no
    more than gives each block 32 KB to read."""
    return max(1, min(per_group * itemsize // _ABSMAX_MIN_BYTES,
                      _cdiv(_ABSMAX_BLOCKS_PER_SM * fc._SMS, groups)))


def act_absmax(x: Tensor, act_group: Optional[int] = None) -> Tensor:
    """Per-group ``max |x|`` (see :func:`act_absmax_plain`): the absmax pass
    of the int8 convs, on the card one call that zeroes the result and
    launches the kernel, and no host sync."""
    if x.device.type == "cpu":
        return act_absmax_plain(x, act_group)
    if x.device.type != "cuda":
        raise ValueError(f"{ABSMAX}: tensors must be on the CPU or a CUDA card, not {x.device}")
    x = _cuda_input(ABSMAX, x)
    b = x.shape[0]
    group = _group(b, act_group)
    groups = _cdiv(max(b, 1), group)
    numel = x.numel()
    if numel == 0:
        return x.new_zeros((groups,), dtype=torch.float32)
    amax = x.new_empty((groups,), dtype=torch.float32)
    per_group = group * (numel // b)
    # a pass of a few microseconds on the card: the host path stays short
    # (the C entry point makes the device current itself; the raw stream
    # handle of the device's current stream, without a Stream object)
    dev = x.get_device()
    err = _symbol("svrs_act_absmax", x)(
        dev, x.data_ptr(), amax.data_ptr(), per_group, numel, groups,
        absmax_plan(per_group, groups, x.element_size()), torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{ABSMAX}: CUDA launch failed with cudaError {err}")
    _count(x, ABSMAX)
    return amax


def _qx_buffer(x: Tensor) -> Tensor:
    b, h, w, c = x.shape
    if b * h * w * padded_channels(c) >= 2**31:
        raise ValueError(f"{QUANT}: tensor too large for 32-bit indices")
    return torch.empty((b, h, w, padded_channels(c)), device=x.device, dtype=torch.int8)


def act_quant(x: Tensor, amax: Tensor, act_group: Optional[int] = None) -> Tensor:
    """``x`` quantized with its group absmax ``amax`` (from :func:`act_absmax`)
    into int8 ``(B, H, W, round_up(C, 16))``, the pad channels 0 (see
    :func:`act_quant_plain`): the quantize pass of the tensor-core int8
    convs, which :func:`int8_conv` launches inside their own call; here
    alone, for its checks and its time."""
    if x.device.type == "cpu":
        return act_quant_plain(x, amax, act_group)
    if x.device.type != "cuda":
        raise ValueError(f"{QUANT}: tensors must be on the CPU or a CUDA card, not {x.device}")
    x = _cuda_input(QUANT, x)
    b, h, w, c = x.shape
    group = _group(b, act_group)
    if (amax.dtype != torch.float32 or amax.device != x.device or not amax.is_contiguous()
            or tuple(amax.shape) != (_cdiv(max(b, 1), group),)):
        raise ValueError(f"{QUANT}: amax must be contiguous float32 "
                         f"({_cdiv(max(b, 1), group)},) on {x.device}")
    qx = _qx_buffer(x)
    if qx.numel() == 0:
        return qx
    dev = x.get_device()
    err = _symbol("svrs_act_quant", x)(dev, x.data_ptr(), amax.data_ptr(), qx.data_ptr(),
                                       b, h, w, c, group, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{QUANT}: CUDA launch failed with cudaError {err}")
    _count(x, QUANT)
    return qx


def _launch(name: str, x: Tensor, kernel_q: Tensor, kernel_s: Tensor, scale: Tensor,
            shift: Tensor, relu: bool, act_group: Optional[int],
            packed: Optional[Tensor]) -> Tensor:
    _check(name, x, kernel_q, kernel_s, scale, shift)
    dev = x.device
    x = _cuda_input(name, x)
    for t in (kernel_s, scale, shift):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: kernel_s, scale and shift must be contiguous float32")
    b, h, w, c = x.shape
    m, n, k4, phases = geometry(name, x.shape, kernel_q.shape[-1])
    if packed is None:
        packed = pack_kernel_q(kernel_q)
    want = (kernel_q.shape[0] * kernel_q.shape[1] * padded_channels(c) // 4, n)
    if packed.dtype != torch.int32 or tuple(packed.shape) != want or not packed.is_contiguous():
        raise ValueError(f"{name}: packed weight must be contiguous int32 {want}, "
                         f"got {packed.dtype} {tuple(packed.shape)}")
    for t in (kernel_q, kernel_s, scale, shift, packed):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, one is on {t.device}")
    if phases * m * n >= 2**31:
        raise ValueError(f"{name}: tensor too large for 32-bit pixel indices")
    out = torch.empty(output_shape(name, x.shape, n), device=dev, dtype=x.dtype)
    if m == 0 or n == 0:
        return out
    group = _group(b, act_group)
    amax = act_absmax(x, group)
    cfg, splits, kchunk = plan_int8_tc(m, n, k4, phases)
    ws = (torch.empty((splits * phases * m * n,), device=dev, dtype=torch.int32)
          if splits > 1 else None)
    qx = _qx_buffer(x)
    # quantize pass, conv and K-split reduce in one C call that makes the
    # device current itself, on the raw handle of its current stream
    index = x.get_device()
    err = _symbol("svrs_int8_tc", x)(
        index, TC_KERNELS[name], cfg, x.data_ptr(), packed.data_ptr(), kernel_s.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), amax.data_ptr(), qx.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, b, h, w, c, n, group, int(relu), splits,
        kchunk, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    _count(x, QUANT)
    _count(x, name)
    return out


def int8_conv(name: str, x: Tensor, kernel_q: Tensor, kernel_s: Tensor, scale: Tensor,
              shift: Tensor, relu: bool, plain: bool = False,
              act_group: Optional[int] = None, packed: Optional[Tensor] = None) -> Tensor:
    """W8A8 conv ``name``: its plain version with ``plain`` or on CPU
    tensors, else the kernels. ``packed`` is ``pack_kernel_q(kernel_q)`` when
    the caller keeps it (the conv modules do), else it is built per call."""
    if plain or x.device.type == "cpu":
        return PLAIN[name](x, kernel_q, kernel_s, scale, shift, relu, act_group)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA card, not {x.device}")
    return _launch(name, x, kernel_q, kernel_s, scale, shift, relu, act_group, packed)


# ------------------------------------------------------------------ wrappers
def int8_conv3x3_bn_relu(x: Tensor, kernel_q: Tensor, kernel_s: Tensor, scale: Tensor,
                         shift: Tensor, relu: bool = True, act_group: Optional[int] = None,
                         packed: Optional[Tensor] = None) -> Tensor:
    """``act(conv3x3_int8(x) * scale + shift)``; (B, H, W, O) in ``x``'s dtype."""
    return int8_conv("int8_conv3x3_bn_relu", x, kernel_q, kernel_s, scale, shift, relu,
                     act_group=act_group, packed=packed)


def int8_conv4x4s2_bn_relu(x: Tensor, kernel_q: Tensor, kernel_s: Tensor, scale: Tensor,
                           shift: Tensor, relu: bool = True, act_group: Optional[int] = None,
                           packed: Optional[Tensor] = None) -> Tensor:
    """``act(conv4x4/s2/p1_int8(x) * scale + shift)``; (B, H/2, W/2, O)."""
    return int8_conv("int8_conv4x4s2_bn_relu", x, kernel_q, kernel_s, scale, shift, relu,
                     act_group=act_group, packed=packed)


def int8_convT4x4s2_bn_relu(x: Tensor, kernel_q: Tensor, kernel_s: Tensor, scale: Tensor,
                            shift: Tensor, relu: bool = True, act_group: Optional[int] = None,
                            packed: Optional[Tensor] = None) -> Tensor:
    """``act(convT4x4/s2/p1_int8(x) * scale + shift)`` with ``kernel_q`` in
    the input-dilated form; (B, 2H, 2W, O)."""
    return int8_conv("int8_convT4x4s2_bn_relu", x, kernel_q, kernel_s, scale, shift, relu,
                     act_group=act_group, packed=packed)


WRAPPERS = {
    "int8_conv3x3_bn_relu": int8_conv3x3_bn_relu,
    "int8_conv4x4s2_bn_relu": int8_conv4x4s2_bn_relu,
    "int8_convT4x4s2_bn_relu": int8_convT4x4s2_bn_relu,
}
