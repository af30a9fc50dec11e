"""u16 quantized wire codec of the HTTP serving protocol (numpy only).

Arrays travel as a per-channel affine quantization to uint16:

    q  = round((x - lo) * 65535 / (hi - lo))   uint16, per channel
    x' = lo + q * (hi - lo) / 65535            float32, both sides

``lo``/``hi`` are float32 per-channel extrema carried in the same ``.npz``
body (``<key>__lo`` / ``<key>__hi`` companions), so both sides rebuild the
same float32 values and a seeded request stays byte-reproducible on this
wire as on float32. The bytes are the JAX package's codec's, so either
package's client talks to either package's server.

Error bound: ``|x' - x| <= (hi_c - lo_c) / 65535 / 2`` per channel ``c``
(half a step; about 7.6e-6 on [0, 1] products). On the moments endpoint the
error of the derived std map is absolute (std comes out of ``s2/n -
(s1/n)^2``), so consumers that need small stds exactly stay on float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

U16_MAX = 65535
_LO = "__lo"
_HI = "__hi"

#: value of the ``wire`` request option that selects this codec
WIRE_U16 = "u16"
#: accepted ``wire`` option values ("" / "f32" keep the float32 wire)
WIRE_VALUES = ("", "f32", WIRE_U16)


def quantize_u16(arr) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-channel (last axis) affine quantization to uint16.

    Returns ``(q, lo, hi)`` — ``q`` uint16 with ``arr``'s shape, ``lo``/
    ``hi`` float32 of shape (C,). A flat channel (hi == lo) quantizes to
    zeros and dequantizes exactly to ``lo``. Non-finite inputs are
    refused: NaN/inf would poison the extrema and silently corrupt every
    value in the channel.
    """
    a = np.ascontiguousarray(np.asarray(arr, np.float32))
    if a.ndim < 1 or a.size == 0:
        raise ValueError(f"cannot quantize shape {a.shape}")
    flat = a.reshape(-1, a.shape[-1])
    lo = flat.min(axis=0).astype(np.float32)
    hi = flat.max(axis=0).astype(np.float32)
    if not (np.isfinite(lo).all() and np.isfinite(hi).all()):
        raise ValueError("non-finite values cannot ride the u16 wire")
    span = hi - lo
    scale = np.zeros_like(span)
    # sub-tiny spans (< ~2e-34) would overflow 65535/span to inf in
    # float32 and the channel-min element would compute 0*inf=NaN, whose
    # uint16 cast is platform-defined — treat them like flat channels
    # (q=0 everywhere, dequantizes to lo; error <= span, i.e. negligible)
    # so the wire stays bit-deterministic for pathological inputs too.
    # a masked np.divide still evaluates the full array (RuntimeWarning on
    # the masked 0-denominators), and sub-tiny spans overflow to inf before
    # the isfinite sweep zeroes them — silence both, the results are
    # identical by the lines below
    pos = span > 0
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        scale = np.where(
            pos, np.float32(U16_MAX) / np.where(pos, span, np.float32(1)), scale
        ).astype(np.float32)
    scale[~np.isfinite(scale)] = 0
    q = np.rint((a - lo) * scale.astype(np.float32))
    return np.clip(q, 0, U16_MAX).astype(np.uint16), lo, hi


def dequantize_u16(q, lo, hi) -> np.ndarray:
    """Inverse of :func:`quantize_u16` — float32, bit-deterministic.

    Uses only the transmitted ``(q, lo, hi)``, in float32 throughout, so
    client and server reconstruct identical bytes from the same body.
    """
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    step = (hi - lo) / np.float32(U16_MAX)
    return (np.asarray(q).astype(np.float32) * step.astype(np.float32)
            + lo).astype(np.float32)


def encode_arrays_u16(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Quantize a reply/request dict for ``np.savez``.

    ``{"sr": x}`` becomes ``{"sr": q, "sr__lo": lo, "sr__hi": hi}``; keys
    must not already carry the companion suffixes.
    """
    out: Dict[str, np.ndarray] = {}
    for k, v in arrays.items():
        if k.endswith(_LO) or k.endswith(_HI):
            raise ValueError(f"reserved key suffix in {k!r}")
        q, lo, hi = quantize_u16(v)
        out[k] = q
        out[k + _LO] = lo
        out[k + _HI] = hi
    return out


def decode_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Dequantize any ``<key>__lo``/``<key>__hi`` companions; pass the
    rest through — one decoder serves both wire formats (a plain f32
    ``.npz`` has no companions and comes back unchanged)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in arrays.items():
        if k.endswith(_LO) or k.endswith(_HI):
            continue
        lo, hi = arrays.get(k + _LO), arrays.get(k + _HI)
        out[k] = v if lo is None or hi is None else dequantize_u16(v, lo, hi)
    return out
