"""ctypes loader for the native TIFF-LZW codec (``lzw.c``; the port's copy of
the JAX package's ``data/lzw_native.py``).

The pure-Python codec in :mod:`tiffio` runs at a few MB/s; on compressed
Sen2Venus tiles strip decode would set the pace of the data pipeline. This
module compiles ``lzw.c`` on first use with the system C compiler (``cc -O3
-shared -fPIC``) into ``build/svrs_lzw/<hash>/`` under the repository root
(beside ``ops/_build.py``'s ``build/svrs_torch_kernels/``; never into the
package), keyed by the source hash, and exposes :func:`lzw_decode_native`
and :func:`lzw_encode_native`.

No compiler, an unwritable build directory, or a stream the C decoder
rejects (-1) make these return ``None``, and :mod:`tiffio` takes the Python
codec, which stays the semantic reference (the tests pin native == Python).
That is the one documented fallback of the port; ``tiffio.CODEC_CALLS``
counts which codec ran, so a caller can assert the native one did.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).with_name("lzw.c")
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "svrs_lzw"
_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()
build_error: Optional[str] = None  # why the last build failed, for doctor


def lib_path() -> Path:
    """Where the shared object of the current ``lzw.c`` is built."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / tag / "liblzw.so"


def _build() -> Optional[ctypes.CDLL]:
    global build_error
    try:
        so = lib_path()
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            # compile to a process- and thread-unique name, then rename, so a
            # concurrent build never loads a half-written object
            tmp = so.with_name(f"liblzw.{os.getpid()}.{threading.get_ident()}.tmp.so")
            cc = os.environ.get("CC", "cc")
            proc = subprocess.run([cc, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                build_error = f"{cc} exited {proc.returncode}: {proc.stderr.strip()}"
                return None
            os.replace(tmp, so)
        return ctypes.CDLL(str(so))
    except OSError as e:
        build_error = repr(e)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Build and load the shared object once; ``None`` if unavailable."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            lib = _build()
            if lib is not None:
                for name in ("svrs_lzw_decode", "svrs_lzw_encode"):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_long
                    fn.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_char), ctypes.c_long]
                _lib = lib
    return _lib


def lzw_decode_native(data: bytes, size_hint: int = 0) -> Optional[bytes]:
    """Decode a TIFF-LZW stream natively; ``None``: the caller falls back.

    ``size_hint`` is the expected decoded size (the strip's sample bytes);
    the buffer starts there and doubles on -2 (too small). A -1 (corrupt
    stream) also returns ``None``, so the Python decoder defines the error.
    """
    lib = get_lib()
    if lib is None:
        return None
    cap = max(int(size_hint), 4 * len(data) + 1024)
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = lib.svrs_lzw_decode(data, len(data), buf, cap)
        if n == -2:
            cap *= 2
            continue
        if n < 0:
            return None
        return buf.raw[:n]


def lzw_encode_native(data: bytes) -> Optional[bytes]:
    """Encode to TIFF-LZW natively; ``None``: the caller falls back. The
    output is byte-identical to ``tiffio._lzw_encode``."""
    lib = get_lib()
    if lib is None:
        return None
    # 12-bit codes expand 8-bit literals at most 1.5x, plus the CLEAR resets
    # and the header and EOI: 2x + slack is safe
    cap = 2 * len(data) + 1024
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = lib.svrs_lzw_encode(data, len(data), buf, cap)
        if n == -2:  # only if the bound above were ever wrong
            cap *= 2
            continue
        if n < 0:  # allocation failure: the Python encoder takes over
            return None
        return buf.raw[:n]
