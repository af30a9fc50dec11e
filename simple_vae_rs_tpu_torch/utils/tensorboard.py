"""TensorBoard event files, written with the standard library and numpy (the
port's copy of the JAX package's ``utils/tensorboard.py``).

It writes the on-disk format directly: TFRecord framing (length and
masked CRC32C) around hand-encoded ``Event``/``Summary`` protobufs, which a
stock TensorBoard reads; no tensorboard package is needed.

- TFRecord: ``uint64 len | uint32 masked_crc(len) | bytes | uint32
  masked_crc(bytes)``, CRC32C (Castagnoli) with TF's rotate+offset mask.
- Event: field 1 ``wall_time`` (double), 2 ``step`` (int64), 3
  ``file_version`` (string), 5 ``summary`` (message).
- Summary.Value: field 1 ``tag`` (string), 2 ``simple_value`` (float), 4
  ``image`` (message: height=1, width=2, colorspace=3,
  encoded_image_string=4).

``read_tfevents`` parses the records back (the tests use it, and so does a
run without TensorBoard installed).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple


# ------------------------------------------------------------------ crc32c
_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- proto encode
def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # protobuf int64 encodes negatives as 10-byte 2^64
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3) + _varint(val)


def _field_bytes(num: int, val: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(val)) + val


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _event(step: Optional[int], summary: bytes = b"",
           file_version: str = "") -> bytes:
    ev = _field_double(1, time.time())
    if step is not None:
        ev += _field_varint(2, int(step))
    if file_version:
        ev += _field_bytes(3, file_version.encode())
    if summary:
        ev += _field_bytes(5, summary)
    return ev


class TensorBoardLogger:
    """Scalar + image panels to ``{run_dir}/events.out.tfevents.*``."""

    def __init__(self, run_dir: str) -> None:
        import socket

        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        # hostname+pid disambiguate concurrent writers / same-second
        # restarts (the standard tfevents convention) — two processes
        # appending 4-part records to one file would corrupt its framing
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.svrs")
        self._fh = open(os.path.join(run_dir, fname), "wb")
        self._write(_event(None, file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(record)
        self._fh.write(struct.pack("<I", _masked_crc(record)))
        self._fh.flush()

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        values = b""
        for tag, v in metrics.items():
            values += _field_bytes(
                1, _field_bytes(1, tag.encode()) + _field_float(2, float(v))
            )
        self._write(_event(step, summary=values))

    def log_images(self, images: Dict[str, Any], step: Optional[int] = None
                   ) -> None:
        values = b""
        from simple_vae_rs_tpu_torch.utils.logging import _numpy

        for tag, batch in images.items():
            arr = _numpy(batch)
            if arr.ndim == 3:
                arr = arr[None]
            for i, img in enumerate(arr):
                png = _encode_png(img)
                if png is None:
                    return  # no PIL: images are best-effort, like JsonlLogger
                image_msg = (
                    _field_varint(1, img.shape[0]) + _field_varint(2, img.shape[1])
                    + _field_varint(3, 3) + _field_bytes(4, png)
                )
                values += _field_bytes(
                    1, _field_bytes(1, f"{tag}/{i}".encode())
                    + _field_bytes(4, image_msg)
                )
        if values:
            self._write(_event(step, summary=values))

    def finish(self) -> None:
        self._fh.close()


def _encode_png(img) -> Optional[bytes]:
    """Shared with the JSONL panels: one band convention."""
    from simple_vae_rs_tpu_torch.utils.logging import to_png_bytes

    return to_png_bytes(img)


class TeeLogger:
    """Fan a log stream out to several loggers (e.g. JSONL + TensorBoard)."""

    def __init__(self, *loggers: Any) -> None:
        self.loggers = loggers

    def log(self, metrics, step=None):
        for lg in self.loggers:
            lg.log(metrics, step=step)

    def log_images(self, images, step=None):
        for lg in self.loggers:
            lg.log_images(images, step=step)

    def finish(self):
        for lg in self.loggers:
            lg.finish()


# ------------------------------------------------------------------ reader
def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = struct.unpack_from("<d", buf, i)[0], i + 8
        elif wire == 5:
            val, i = struct.unpack_from("<f", buf, i)[0], i + 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        else:  # pragma: no cover - groups unused
            raise ValueError(f"unsupported wire type {wire}")
        yield num, wire, val


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        out |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return out, i
        shift += 7


def read_tfevents(path: str) -> List[Dict[str, Any]]:
    """Parse an event file back to ``[{"step": int, tag: value, ...}]``
    (scalars only; image records report ``tag: "<image>"``). Verifies the
    record CRCs — a corrupt file fails loudly."""
    records = []
    with open(path, "rb") as fh:
        data = fh.read()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (ln,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
        if hcrc != _masked_crc(header):
            raise ValueError(f"bad length crc at byte {i}")
        rec = data[i + 12:i + 12 + ln]
        (dcrc,) = struct.unpack("<I", data[i + 12 + ln:i + 16 + ln])
        if dcrc != _masked_crc(rec):
            raise ValueError(f"bad data crc at byte {i}")
        i += 16 + ln
        ev: Dict[str, Any] = {}
        for num, _, val in _iter_fields(rec):
            if num == 2:
                ev["step"] = val
            elif num == 3:
                ev["file_version"] = val.decode()
            elif num == 5:
                for vnum, _, vval in _iter_fields(val):
                    if vnum != 1:
                        continue
                    tag, scalar, image = "", None, False
                    for fnum, _, fval in _iter_fields(vval):
                        if fnum == 1:
                            tag = fval.decode()
                        elif fnum == 2:
                            scalar = fval
                        elif fnum == 4:
                            image = True
                    ev[tag] = "<image>" if image else scalar
        records.append(ev)
    return records
