"""Minimal numpy TIFF reader and writer for satellite tiles (the port's copy of
the JAX package's ``data/tiffio.py``).

It implements the subset real GeoTIFF tiles need: striped baseline TIFF,
single image, uint8/16/32, int16/32 and float32 samples, both planar
configurations (band-interleaved ``(H, W, C)`` and band-sequential
``(C, H, W)``, the legacy single-strip planar layout too), little- and
big-endian, and the compressions GDAL commonly writes: **Deflate/zlib (8 and
legacy 32946) and LZW (5)**, each with or without the horizontal-differencing
predictor (tag 317 = 2).

Besides the whole-array ``read_tiff``/``write_tiff`` pair, ``TiffReader``
and ``TiffStripWriter`` give the same codec as *streaming* row-window access,
so a whole scene is read or written in bounded memory, the strips of one row
band at a time; the writer's ``checkpoint`` resumes an interrupted file.

LZW runs on the native codec (``lzw_native``, built on first use) and falls
back to the pure-Python codec here, the semantic reference, only where the
native one cannot be built; :data:`CODEC_CALLS` counts the strips each
codec handled. Unlike the JAX module, ``read_tiff`` never hands the file to
``tifffile``: this codec reads every file.
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from simple_vae_rs_tpu_torch.data.lzw_native import lzw_decode_native, lzw_encode_native

# tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_SAMPLE_FORMAT = 339

# compression codes
_COMP_NONE = 1
_COMP_LZW = 5
_COMP_DEFLATE = 8
_COMP_DEFLATE_OLD = 32946

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}

# LZW strips handled by each codec since the last reset (decode and encode)
CODEC_CALLS = {"native_decode": 0, "python_decode": 0, "native_encode": 0, "python_encode": 0}


def reset_codec_calls() -> None:
    for key in CODEC_CALLS:
        CODEC_CALLS[key] = 0


def _read_ifd_file(fh, offset: int, bo: str) -> Dict[int, List]:
    """Parse one IFD from an open file, seeking only to out-of-line values."""
    fh.seek(offset)
    (count,) = struct.unpack(bo + "H", fh.read(2))
    block = fh.read(count * 12)
    entries: Dict[int, List] = {}
    deferred = []
    for i in range(count):
        tag, typ, n = struct.unpack_from(bo + "HHI", block, i * 12)
        fmt = _TYPE_FMT.get(typ)
        if fmt is None:
            continue
        size = _TYPE_SIZES.get(typ, 1) * n
        if size <= 4:
            raw = block[i * 12 + 8 : i * 12 + 8 + size]
            entries[tag] = list(struct.unpack(bo + fmt * n, raw))
        else:
            (ptr,) = struct.unpack_from(bo + "I", block, i * 12 + 8)
            deferred.append((tag, n, ptr, fmt, size))
    for tag, n, ptr, fmt, size in deferred:
        fh.seek(ptr)
        entries[tag] = list(struct.unpack(bo + fmt * n, fh.read(size)))
    return entries


# --------------------------------------------------------------- LZW codec
# TIFF-variant LZW (TIFF 6.0 §13): MSB-first bit packing, 9-bit initial
# codes, ClearCode=256, EOI=257, and the "early change" quirk — the code
# width bumps one entry *before* the table fills (at 510/1022/2046).
_LZW_CLEAR = 256
_LZW_EOI = 257


def _lzw_decode(data: bytes) -> bytes:
    out = bytearray()
    table: List[bytes] = []

    def reset():
        nonlocal table, width
        table = [bytes([i]) for i in range(256)] + [b"", b""]
        width = 9

    width = 9
    reset()
    bitbuf = 0
    nbits = 0
    prev: bytes | None = None
    pos = 0
    n = len(data)
    while True:
        while nbits < width:
            if pos >= n:
                return bytes(out)  # missing EOI: tolerate truncated strips
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            nbits += 8
        code = (bitbuf >> (nbits - width)) & ((1 << width) - 1)
        nbits -= width
        if code == _LZW_EOI:
            return bytes(out)
        if code == _LZW_CLEAR:
            reset()
            prev = None
            continue
        if prev is None:
            if code >= len(table):
                raise ValueError(f"corrupt LZW stream: code {code}")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):  # KwKwK case
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"corrupt LZW stream: code {code}")
        out += entry
        prev = entry
        # early change: width grows when the NEXT entry would not fit
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1


def _lzw_encode(data: bytes) -> bytes:
    out = bytearray()
    bitbuf = 0
    nbits = 0

    def emit(code: int, width: int):
        nonlocal bitbuf, nbits
        bitbuf = (bitbuf << width) | code
        nbits += width
        while nbits >= 8:
            out.append((bitbuf >> (nbits - 8)) & 0xFF)
            nbits -= 8

    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    width = 9
    emit(_LZW_CLEAR, width)
    w = b""
    for byte in data:
        wk = w + bytes([byte])
        if wk in table:
            w = wk
            continue
        emit(table[w], width)
        table[wk] = next_code
        next_code += 1
        # width-bump mirror of the decoder: the decoder grows its width
        # once its table reaches 511/1023/2047 entries (= next_code - 1
        # here), verified against libtiff-written streams in the tests
        if next_code >= (1 << width) and width < 12:
            width += 1
        if next_code >= 4094:  # table nearly full: reset
            emit(_LZW_CLEAR, width)
            table = {bytes([i]): i for i in range(256)}
            next_code = 258
            width = 9
        w = bytes([byte])
    if w:
        emit(table[w], width)
        # the decoder appends a table entry for this final code too, and
        # may bump its width before reading EOI — mirror that bump here or
        # the EOI (and the stream end) desync when the final entry lands
        # exactly on a 511/1023/2047 boundary
        if next_code + 1 >= (1 << width) and width < 12:
            width += 1
    emit(_LZW_EOI, width)
    if nbits:
        out.append((bitbuf << (8 - nbits)) & 0xFF)
    return bytes(out)


def _decompress_strip(raw: bytes, comp: int, path: str, size_hint: int = 0) -> bytes:
    if comp == _COMP_NONE:
        return raw
    if comp in (_COMP_DEFLATE, _COMP_DEFLATE_OLD):
        return zlib.decompress(raw)
    if comp == _COMP_LZW:
        # the native decoder (data/lzw.c, about memory speed); the Python
        # loop stays the semantic reference and the fallback
        out = lzw_decode_native(raw, size_hint)
        if out is not None:
            CODEC_CALLS["native_decode"] += 1
            return out
        CODEC_CALLS["python_decode"] += 1
        return _lzw_decode(raw)
    raise ValueError(f"{path}: compression={comp} unsupported")


def _undo_predictor(strip: np.ndarray, rows: int, width: int, chans: int):
    """Invert horizontal differencing (predictor 2) in place-ish.

    ``strip`` is the decoded 1-D sample array of one strip; differencing is
    per row, per channel, with wraparound in the sample dtype.
    """
    arr = strip.reshape(rows, width, chans)
    # cumsum in a wide int then wrap back to the storage dtype
    wide = np.cumsum(arr.astype(np.int64), axis=1)
    info_bits = arr.dtype.itemsize * 8
    wide &= (1 << info_bits) - 1
    return wide.astype(arr.dtype).reshape(-1)


def _apply_predictor(plane: np.ndarray) -> np.ndarray:
    """Horizontal differencing for the writer: (rows, width, chans) ints."""
    diffed = plane.copy()
    diffed[:, 1:, :] = plane[:, 1:, :] - plane[:, :-1, :]
    return diffed


# ---------------------------------------------------------- streaming read
class TiffReader:
    """Streaming row-window access to one striped TIFF image.

    Parses the IFD once, then ``read_rows(r0, r1)`` decodes only the strips
    covering those rows — a row-band sweep over a whole scene touches
    O(band) bytes at a time instead of materializing the raster
    (``read_tiff`` is this class applied to ``[0, height)``). A small strip
    cache keeps overlapping window reads from re-decompressing the strip
    they share.

    Attributes: ``height``, ``width``, ``samples_per_pixel``, ``planar``
    (1 interleaved / 2 band-sequential), ``dtype`` (native byte order),
    ``layout`` ("hw" | "hwc" | "chw" — the shape family ``read_rows``
    returns, mirroring ``read_tiff``).
    """

    _CACHE_STRIPS = 8

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh = open(path, "rb")
        head = self._fh.read(8)
        if head[:2] == b"II":
            bo = "<"
        elif head[:2] == b"MM":
            bo = ">"
        else:
            self._fh.close()
            raise ValueError(f"{path}: not a TIFF file")
        (magic,) = struct.unpack_from(bo + "H", head, 2)
        if magic != 42:
            self._fh.close()
            raise ValueError(f"{path}: unsupported TIFF magic {magic} (bigtiff?)")
        (ifd_off,) = struct.unpack_from(bo + "I", head, 4)
        if ifd_off == 0:
            # TiffStripWriter leaves the pointer zeroed until a clean
            # close — this is an interrupted/unfinalized product
            self._fh.close()
            raise ValueError(
                f"{path}: no IFD — the file was written but never "
                f"finalized (interrupted sweep? resume or re-run it)"
            )
        tags = _read_ifd_file(self._fh, ifd_off, bo)

        self._bo = bo
        self.width = tags[_IMAGE_WIDTH][0]
        self.height = tags[_IMAGE_LENGTH][0]
        self.samples_per_pixel = tags.get(_SAMPLES_PER_PIXEL, [1])[0]
        bits = tags.get(_BITS_PER_SAMPLE, [8])[0]
        self._comp = tags.get(_COMPRESSION, [1])[0]
        self.planar = tags.get(_PLANAR_CONFIG, [1])[0]
        sfmt = tags.get(_SAMPLE_FORMAT, [1])[0]
        self._pred = tags.get(_PREDICTOR, [1])[0]

        kind = {1: "u", 2: "i", 3: "f"}.get(sfmt, "u")
        if self._pred == 2 and kind == "f":
            self._fh.close()
            raise ValueError(f"{path}: predictor 2 on float samples")
        if self._pred not in (1, 2):
            self._fh.close()
            raise ValueError(f"{path}: predictor {self._pred} unsupported")
        self._file_dtype = np.dtype(f"{bo}{kind}{bits // 8}")
        self.dtype = self._file_dtype.newbyteorder("=")

        self._offsets = tags[_STRIP_OFFSETS]
        self._counts = tags[_STRIP_BYTE_COUNTS]
        self._rps = min(tags.get(_ROWS_PER_STRIP, [self.height])[0], self.height)
        self._strips_per_plane = -(-self.height // self._rps)
        planes = self.samples_per_pixel if self.planar == 2 else 1
        # some writers put EVERY plane in one strip (band-sequential data,
        # single offset) — decode it once and slice planes out of it
        self._monolithic = self.planar == 2 and planes > 1 and \
            len(self._offsets) == 1
        if self._monolithic:
            self._rps = self.height
            self._strips_per_plane = 1
        elif len(self._offsets) < planes * self._strips_per_plane:
            # rows-per-strip declared loosely; trust the offset table
            self._strips_per_plane = len(self._offsets) // planes
            if self._strips_per_plane < 1:
                self._fh.close()
                raise ValueError(
                    f"{path}: {len(self._offsets)} strip(s) cannot cover "
                    f"{planes} plane(s)"
                )
            self._rps = -(-self.height // self._strips_per_plane)
        self._cache: OrderedDict = OrderedDict()
        self._mono = None  # decoded (C, H, W) for monolithic-planar files

    # -- context management
    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "TiffReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- geometry
    @property
    def rows_per_strip(self) -> int:
        """Strip height — the natural block size for sequential sweeps."""
        return self._rps

    @property
    def layout(self) -> str:
        if self.samples_per_pixel == 1:
            return "hw"
        return "chw" if self.planar == 2 else "hwc"

    @property
    def to_hwc(self):
        """``read_rows`` block (in ``layout``) -> ``(rows, width, C)`` view.

        The single place the layout->HWC mapping lives: every streaming
        consumer (product scoring) uses it, so a new layout cannot make them
        diverge."""
        return layout_to_hwc(self.layout)

    @property
    def shape(self):
        h, w, c = self.height, self.width, self.samples_per_pixel
        return {"hw": (h, w), "hwc": (h, w, c), "chw": (c, h, w)}[self.layout]

    # -- strip access
    def _strip(self, plane: int, sidx: int) -> np.ndarray:
        """One decoded strip as (strip_rows, width * strip_chans), native order."""
        key = (plane, sidx)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            return hit
        if self._monolithic:
            # One physical strip holds every plane, plane-major: a single
            # compressed stream can only be decoded front-to-back, so
            # bounded-memory access is impossible for this legacy layout.
            # Decode and convert it ONCE and hand out plane views — the
            # old per-plane path re-decompressed the whole payload for
            # every plane and pinned duplicate copies in the strip cache.
            if self._mono is None:
                c = self.samples_per_pixel
                need = self.height * self.width * c
                self._fh.seek(self._offsets[0])
                raw = self._fh.read(self._counts[0])
                data = _decompress_strip(
                    raw, self._comp, self.path,
                    need * self._file_dtype.itemsize,
                )
                arr = np.frombuffer(data, dtype=self._file_dtype)
                if arr.size < need:
                    raise ValueError(
                        f"{self.path}: strip 0 truncated "
                        f"({arr.size} of {need} samples)"
                    )
                arr = arr[:need]
                if self._pred == 2:
                    arr = _undo_predictor(
                        arr, self.height * c, self.width, 1
                    )
                self._mono = arr.astype(self.dtype).reshape(
                    c, self.height, self.width
                )
            return self._mono[plane]
        chans = self.samples_per_pixel if self.planar == 1 else 1
        strip_rows = min(self._rps, self.height - sidx * self._rps)
        need = strip_rows * self.width * chans
        idx = plane * self._strips_per_plane + sidx
        self._fh.seek(self._offsets[idx])
        raw = self._fh.read(self._counts[idx])
        data = _decompress_strip(
            raw, self._comp, self.path, need * self._file_dtype.itemsize
        )
        arr = np.frombuffer(data, dtype=self._file_dtype)
        if arr.size < need:
            raise ValueError(
                f"{self.path}: strip {idx} truncated "
                f"({arr.size} of {need} samples)"
            )
        arr = arr[:need]
        if self._pred == 2:
            arr = _undo_predictor(arr, strip_rows, self.width, chans)
        out = arr.astype(self.dtype).reshape(strip_rows, self.width * chans)
        self._cache[key] = out
        if len(self._cache) > self._CACHE_STRIPS:
            self._cache.popitem(last=False)
        return out

    def read_rows(self, r0: int, r1: int) -> np.ndarray:
        """Rows ``[r0, r1)`` in the file's layout (see ``layout``).

        Returns ``(rows, W)`` single-band, ``(rows, W, C)`` interleaved or
        ``(C, rows, W)`` band-sequential — the same shape family (and byte
        order) ``read_tiff`` returns for the whole image.
        """
        if not 0 <= r0 < r1 <= self.height:
            raise ValueError(
                f"rows [{r0}, {r1}) out of range for height {self.height}"
            )
        planes = self.samples_per_pixel if self.planar == 2 else 1
        chans = self.samples_per_pixel if self.planar == 1 else 1
        rows = r1 - r0
        out = np.empty((planes, rows, self.width * chans), self.dtype)
        s0, s1 = r0 // self._rps, (r1 - 1) // self._rps
        for pl in range(planes):
            for s in range(s0, s1 + 1):
                strip = self._strip(pl, s)
                lo = max(r0, s * self._rps)
                hi = min(r1, s * self._rps + strip.shape[0])
                out[pl, lo - r0 : hi - r0] = strip[lo - s * self._rps : hi - s * self._rps]
        if self.samples_per_pixel == 1:
            return out.reshape(rows, self.width)
        if self.planar == 2:
            return out.reshape(planes, rows, self.width)
        return out.reshape(rows, self.width, self.samples_per_pixel)


def layout_to_hwc(layout: str):
    """Function mapping a ``TiffReader.read_rows`` block in ``layout`` to
    an ``(rows, width, C)`` HWC array (grayscale gains a channel axis)."""
    return {
        "hw": lambda b: b[:, :, None],
        "chw": lambda b: np.moveaxis(b, 0, -1),
        "hwc": lambda b: b,
    }[layout]


def read_tiff(path: str) -> np.ndarray:
    """Read the first image of a TIFF file.

    Returns ``(H, W)`` for single-band, ``(H, W, C)`` for interleaved, or
    ``(C, H, W)`` for band-sequential planar files (tifffile's shapes).
    """
    with TiffReader(path) as reader:
        return reader.read_rows(0, reader.height)


# --------------------------------------------------------- streaming write
_WRITE_COMP = {"none": _COMP_NONE, "deflate": _COMP_DEFLATE, "lzw": _COMP_LZW}


class TiffStripWriter:
    """Incremental striped-TIFF writer: declare the geometry up front,
    append row blocks with ``write_rows``, ``close()`` emits the IFD.

    Only one strip of rows is ever buffered, so whole-scene products
    stream to disk in bounded memory (the layout is header | strips | IFD,
    with the header's IFD pointer patched on close — strip offsets land in
    the offsets tag in plane-major order regardless of physical position,
    which is what lets band-sequential files stream row-wise too).

    ``write_rows`` accepts the same shape family ``read_rows`` produces:
    ``(rows, W)`` single-band, ``(rows, W, C)`` interleaved, or
    ``(C, rows, W)`` when ``planar_channels_first``. Blocks may be any
    height; exactly ``height`` rows must arrive before ``close()``.
    """

    def __init__(
        self,
        path: str,
        height: int,
        width: int,
        channels: int = 1,
        dtype=np.uint8,
        planar_channels_first: bool = False,
        compression: str = "none",
        predictor: bool = False,
        rows_per_strip: Optional[int] = None,
        resume_state: Optional[dict] = None,
    ) -> None:
        """``resume_state`` (a ``checkpoint()`` dict) reopens an
        interrupted file instead of starting one: the file is truncated
        to the checkpointed position and the strip bookkeeping and
        pending row buffer restore, so writing continues exactly where
        the checkpoint was taken (everything after it — e.g. a torn
        half-written strip — is discarded)."""
        if height < 1 or width < 1 or channels < 1:
            raise ValueError(
                f"invalid geometry {height}x{width}x{channels}"
            )
        self.dtype = np.dtype(dtype)
        if self.dtype.kind not in "uif":
            raise ValueError(f"unsupported sample dtype {self.dtype}")
        if predictor and self.dtype.kind == "f":
            raise ValueError("predictor requires integer samples")
        self._comp = _WRITE_COMP[compression]
        self.path = path
        self.height, self.width, self.channels = height, width, channels
        self._planar = 2 if (planar_channels_first and channels > 1) else 1
        self._accept_chw = bool(planar_channels_first)
        self._predictor = predictor
        strip_chans = channels if self._planar == 1 else 1
        row_bytes = width * strip_chans * self.dtype.itemsize
        if rows_per_strip is None:
            # ~1 MiB strips: small enough to stream, big enough to compress
            rows_per_strip = max(1, min(height, (1 << 20) // max(1, row_bytes)))
        if rows_per_strip < 1:
            raise ValueError(f"rows_per_strip must be >= 1 (got {rows_per_strip})")
        self._rps = min(rows_per_strip, height)
        self._strips_per_plane = -(-height // self._rps)
        planes = channels if self._planar == 2 else 1
        n = planes * self._strips_per_plane
        self._offsets = [0] * n
        self._counts = [0] * n
        self._row = 0  # rows fully handed over by the caller
        self._emitted = 0  # rows already encoded into strips
        self._buf: List[np.ndarray] = []  # pending (rows, W, C) blocks
        self._buf_rows = 0
        if resume_state is None:
            self._fh = open(path, "wb")
            # header with a zero IFD pointer, patched in close()
            self._fh.write(struct.pack("<2sHI", b"II", 42, 0))
        else:
            st = resume_state
            if int(st.get("rps", -1)) != self._rps or \
                    len(st.get("offsets", ())) != n:
                raise ValueError(
                    f"{path}: resume state does not match this geometry "
                    f"(rps {st.get('rps')} vs {self._rps}, "
                    f"{len(st.get('offsets', ()))} vs {n} strips)"
                )
            self._fh = open(path, "r+b")
            self._fh.truncate(int(st["pos"]))
            self._fh.seek(int(st["pos"]))
            self._offsets = [int(v) for v in st["offsets"]]
            self._counts = [int(v) for v in st["counts"]]
            self._row = int(st["row"])
            self._emitted = int(st["emitted"])
            if st.get("buf_b64"):
                import base64

                shape = tuple(int(v) for v in st["buf_shape"])
                buf = np.frombuffer(
                    base64.b64decode(st["buf_b64"]), dtype=self.dtype
                ).reshape(shape)
                self._buf = [buf]
                self._buf_rows = shape[0]
        self._closed = False

    # -- context management: emit the IFD only on a clean exit
    def __enter__(self) -> "TiffStripWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        elif not self._closed:
            self._fh.close()
            self._closed = True

    def write_rows(self, block: np.ndarray) -> None:
        block = np.asarray(block)
        if self.channels == 1 and block.ndim == 2:
            block = block[:, :, None]
        elif self._accept_chw:
            if block.ndim != 3 or block.shape[0] != self.channels:
                raise ValueError(
                    f"expected (C={self.channels}, rows, W) block, got {block.shape}"
                )
            block = np.moveaxis(block, 0, -1)
        if block.ndim != 3 or block.shape[1] != self.width or \
                block.shape[2] != self.channels:
            raise ValueError(
                f"expected (rows, {self.width}, {self.channels}) block, "
                f"got {block.shape}"
            )
        if block.dtype != self.dtype:
            raise ValueError(
                f"block dtype {block.dtype} != declared {self.dtype}"
            )
        rows = block.shape[0]
        if self._row + rows > self.height:
            raise ValueError(
                f"write past declared height: {self._row} + {rows} > {self.height}"
            )
        self._row += rows
        self._buf.append(block)
        self._buf_rows += rows
        while self._buf_rows >= self._rps:
            self._emit_strip()

    def checkpoint(self) -> dict:
        """JSON-serializable writer state at this instant (see
        ``resume_state``): file position, strip bookkeeping, and any rows
        still buffered below one strip (base64 of the raw samples — at
        most ``rows_per_strip`` rows, ~1 MiB). Written strip bytes are
        fsynced first so the state on disk is at least as fresh as the
        checkpoint that points into it."""
        import base64

        self._fh.flush()
        os.fsync(self._fh.fileno())
        buf = (
            np.ascontiguousarray(self._take_rows(self._buf_rows))
            if self._buf_rows else None
        )
        if buf is not None:  # _take_rows consumed the buffer: put it back
            self._buf = [buf]
            self._buf_rows = buf.shape[0]
        return {
            "pos": self._fh.tell(),
            "offsets": list(self._offsets),
            "counts": list(self._counts),
            "row": self._row,
            "emitted": self._emitted,
            "rps": self._rps,
            "buf_shape": list(buf.shape) if buf is not None else None,
            "buf_b64": (
                base64.b64encode(buf.astype(self.dtype).tobytes()).decode()
                if buf is not None else None
            ),
        }

    def _take_rows(self, n: int) -> np.ndarray:
        """Pop exactly n rows off the block buffer as one (n, W, C) array."""
        parts, got = [], 0
        while got < n:
            head = self._buf[0]
            take = min(n - got, head.shape[0])
            parts.append(head[:take])
            if take == head.shape[0]:
                self._buf.pop(0)
            else:
                self._buf[0] = head[take:]
            got += take
        self._buf_rows -= n
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _emit_strip(self) -> None:
        sidx = self._emitted // self._rps
        rows = min(self._rps, self.height - self._emitted)
        data = np.ascontiguousarray(self._take_rows(rows))
        le = data.astype(self.dtype.newbyteorder("<"))
        planes = self.channels if self._planar == 2 else 1
        for pl in range(planes):
            plane = le[:, :, pl : pl + 1] if self._planar == 2 else le
            if self._predictor:
                plane = _apply_predictor(plane)
            payload = plane.tobytes()
            if self._comp == _COMP_DEFLATE:
                payload = zlib.compress(payload, 6)
            elif self._comp == _COMP_LZW:
                # the native encoder (data/lzw.c, byte-identical output) at
                # memory speed; the Python loop stays the semantic reference
                # and the fallback
                payload = lzw_encode_native(payload)
                if payload is None:
                    CODEC_CALLS["python_encode"] += 1
                    payload = _lzw_encode(plane.tobytes())
                else:
                    CODEC_CALLS["native_encode"] += 1
            idx = pl * self._strips_per_plane + sidx
            self._offsets[idx] = self._fh.tell()
            self._counts[idx] = len(payload)
            self._fh.write(payload)
            if len(payload) % 2:  # TIFF wants word-aligned value offsets
                self._fh.write(b"\x00")
        self._emitted += rows

    def close(self) -> None:
        if self._closed:
            return
        if self._row != self.height:
            self._fh.close()
            self._closed = True
            raise ValueError(
                f"{self.path}: wrote {self._row} of {self.height} declared rows"
            )
        if self._buf_rows:
            self._emit_strip()
        c = self.channels
        kind_map = {"u": 1, "i": 2, "f": 3}
        bits = self.dtype.itemsize * 8
        n_strips = len(self._offsets)
        tags = [
            (_IMAGE_WIDTH, 3, 1, self.width),
            (_IMAGE_LENGTH, 3, 1, self.height),
            (_BITS_PER_SAMPLE, 3, c, [bits] * c),
            (_COMPRESSION, 3, 1, self._comp),
            (_PHOTOMETRIC, 3, 1, 1),
            (_STRIP_OFFSETS, 4, n_strips, self._offsets),
            (_SAMPLES_PER_PIXEL, 3, 1, c),
            (_ROWS_PER_STRIP, 4, 1, self._rps),
            (_STRIP_BYTE_COUNTS, 4, n_strips, self._counts),
            (_PLANAR_CONFIG, 3, 1, self._planar),
            (_PREDICTOR, 3, 1, 2 if self._predictor else 1),
            (_SAMPLE_FORMAT, 3, c, [kind_map[self.dtype.kind]] * c),
        ]
        if self._fh.tell() % 2:
            self._fh.write(b"\x00")
        ifd_off = self._fh.tell()
        n = len(tags)
        extra_cursor = ifd_off + 2 + n * 12 + 4
        entries = b""
        extra = b""
        for tag, typ, cnt, val in tags:
            fmt = _TYPE_FMT[typ]
            vals = val if isinstance(val, list) else [val]
            size = _TYPE_SIZES[typ] * cnt
            packed = struct.pack("<" + fmt * cnt, *vals)
            if size <= 4:
                entries += struct.pack("<HHI", tag, typ, cnt) + packed + \
                    b"\x00" * (4 - size)
            else:
                entries += struct.pack("<HHII", tag, typ, cnt, extra_cursor)
                extra += packed
                extra_cursor += size
        self._fh.write(struct.pack("<H", n) + entries + struct.pack("<I", 0))
        self._fh.write(extra)
        self._fh.seek(4)
        self._fh.write(struct.pack("<I", ifd_off))
        self._fh.close()
        self._closed = True


def write_tiff(
    path: str,
    array: np.ndarray,
    planar_channels_first: bool = False,
    compression: str = "none",
    predictor: bool = False,
) -> None:
    """Write a striped TIFF in one call (single strip per plane).

    ``array``: (H, W), (H, W, C) interleaved, or (C, H, W) when
    ``planar_channels_first`` — matching what ``read_tiff`` returns.
    ``compression``: "none" | "deflate" | "lzw"; ``predictor`` applies
    horizontal differencing (integer samples only) before compression —
    the combination GDAL typically writes for satellite tiles. For
    incremental output use ``TiffStripWriter`` directly.
    """
    arr = np.ascontiguousarray(array)
    if arr.ndim == 2:
        h, w, c = arr.shape[0], arr.shape[1], 1
        planar_channels_first = False
    elif planar_channels_first:
        c, h, w = arr.shape
    else:
        h, w, c = arr.shape
    writer = TiffStripWriter(
        path, h, w, c, arr.dtype,
        planar_channels_first=planar_channels_first,
        compression=compression, predictor=predictor, rows_per_strip=h,
    )
    writer.write_rows(arr)
    writer.close()
