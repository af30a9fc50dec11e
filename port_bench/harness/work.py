"""The yardstick: the card's peaks, and the operations and bytes of the
convs a step or a request runs, counted from the configuration's shapes.

Frozen here so that no change to the program moves it. The arithmetic is
``chip_smoke.py``'s (``bound_row``, ``tc_bound_ms``, the conv geometry):
operations are the useful multiply-adds times two (a transposed conv's four
live taps per output pixel, never the zeros of its dilated input); bytes
count each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_F32_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3  # float32 accuracy as three TF32 products
PEAK_BYTES_S = 3.35e12  # HBM3

# the port's conv kernels by name in a device trace (the split-K epilogue
# of conv_tc and int8_tc included: it finishes their sums)
CONV_KERNELS = ("conv_tc", "conv_wg", "chain_kernel", "int8_tc", "splitk_reduce")


def peak_flops(dtype: str) -> float:
    """The peak of the units a conv of ``dtype`` runs on in the port: the
    bf16 tensor cores, or 3xTF32 for float32."""
    return PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_3XTF32_FLOPS


def itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def conv_flops(kind: str, shape: Tuple[int, ...], o: int) -> float:
    """Operations of one conv of input ``shape`` (B, H, W, C) to ``o``
    channels."""
    b, h, w, c = shape
    if kind == "conv3x3":
        return 2.0 * b * h * w * 9 * c * o
    if kind == "conv4x4s2":
        return 2.0 * b * (h // 2) * (w // 2) * 16 * c * o
    if kind == "convT4x4s2":
        return 2.0 * b * (2 * h) * (2 * w) * 4 * c * o
    raise ValueError(f"unknown conv {kind}")


def _out_pixels(kind: str, b: int, h: int, w: int) -> int:
    if kind == "conv4x4s2":
        return b * (h // 2) * (w // 2)
    if kind == "convT4x4s2":
        return b * 4 * h * w
    return b * h * w


def conv_bytes(kind: str, shape: Tuple[int, ...], o: int, dtype: str, role: str) -> float:
    """Bytes of one launch: ``forward`` reads x and the weight, writes the
    output, reads a float32 scale and shift a channel; ``dx`` (the input
    gradient) reads the output's gradient and the weight, writes x's."""
    b, h, w, c = shape
    k = 9 if kind == "conv3x3" else 16
    n = itemsize(dtype)
    act_in, act_out = b * h * w * c, _out_pixels(kind, b, h, w) * o
    per_channel = 4.0 * 2 * (o if role == "forward" else c)
    return n * (act_in + act_out + k * c * o) + per_channel


def bound_s(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """The least time the card could take, and which bound it is."""
    t_ops, t_bytes = flops / peak_flops(dtype), nbytes / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def train_step_work(sites: List, dtype: str) -> Dict[str, float]:
    """One training step whose forward runs the convs ``sites`` (a family's
    ``conv_sites``: kind, input shape, O, whether the input gradient is
    computed): the model's operations (forward, input gradient and weight
    gradient of every conv, once each; no input gradient where the input is
    data), and the bound of the conv kernels' work (forward and input
    gradient) with the share of it that operations bound."""
    flops = bound = by_ops = 0.0
    for kind, shape, o, needs_dx in sites:
        f = conv_flops(kind, shape, o)
        roles = ["forward"] + (["dx"] if needs_dx else [])
        flops += f * (len(roles) + 1)  # + the weight gradient
        for role in roles:
            t, which = bound_s(f, conv_bytes(kind, shape, o, dtype, role), dtype)
            bound += t
            by_ops += t if which == "operations" else 0.0
    return {"model_flops": flops, "conv_bound_s": bound, "conv_bound_ops_share": by_ops / bound}


def forward_work(sites: List, dtype: str) -> Dict[str, float]:
    """A pass that runs the convs ``sites`` forward only (an N-draw
    request: its conditioning pass on one LR image, then the decoder over
    every draw)."""
    flops = bound = by_ops = 0.0
    for kind, shape, o, _ in sites:
        f = conv_flops(kind, shape, o)
        flops += f
        t, which = bound_s(f, conv_bytes(kind, shape, o, dtype, "forward"), dtype)
        bound += t
        by_ops += t if which == "operations" else 0.0
    return {"model_flops": flops, "conv_bound_s": bound, "conv_bound_ops_share": by_ops / bound}
