"""TensorBoard event files of scalar summaries (no TF dependency): this
package's own copy of the scalar part of
``distributed_tensorflow_tpu/utils/summary.py``, with its pure-Python
CRC32C.

Wire formats:
  * TFRecord: ``u64le(len) crc32c_masked(len_bytes) data crc32c_masked(data)``
  * ``Event`` proto: wall_time(1,double) step(2,int64) file_version(3,string)
    summary(5,message)
  * ``Summary`` proto: repeated value(1); ``Summary.Value``: tag(1,string)
    simple_value(2,float)

Histogram summaries are not ported: the LM trainer writes scalars only.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

from distributed_tensorflow_tpu_torch.utils import protowire as _pw


def _build_crc_table() -> list[int]:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _build_crc_table()
_MASK_DELTA = 0xA282EAD8


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def encode_scalar_value(tag: str, value: float) -> bytes:
    return _pw.field_bytes(1, _pw.field_bytes(1, tag.encode()) + _pw.field_float(2, float(value)))


def encode_event(wall_time: float, step: int | None = None,
                 summary_values: bytes | None = None, file_version: str | None = None) -> bytes:
    msg = _pw.field_double(1, wall_time)
    if step is not None:
        msg += _pw.field_varint(2, int(step))
    if file_version is not None:
        msg += _pw.field_bytes(3, file_version.encode())
    if summary_values:
        msg += _pw.field_bytes(5, summary_values)
    return msg


def write_record(fh, data: bytes) -> None:
    header = struct.pack("<Q", len(data))
    fh.write(header)
    fh.write(struct.pack("<I", masked_crc32c(header)))
    fh.write(data)
    fh.write(struct.pack("<I", masked_crc32c(data)))


def read_records(path: str):
    """Yield raw record payloads from a TFRecord event file, verifying CRCs."""
    with open(path, "rb") as fh:
        while True:
            header = fh.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", fh.read(4))
            if masked_crc32c(header) != hcrc:
                raise IOError(f"corrupt record header in {path}")
            data = fh.read(length)
            (dcrc,) = struct.unpack("<I", fh.read(4))
            if masked_crc32c(data) != dcrc:
                raise IOError(f"corrupt record payload in {path}")
            yield data


class SummaryWriter:
    """TensorBoard event writer of scalars (``add_scalars``, then
    ``close``), one file under ``logdir``. Thread-safe."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        fname = "events.out.tfevents.%010d.%s%s" % (int(time.time()), socket.gethostname(),
                                                     filename_suffix)
        self._fh = open(os.path.join(logdir, fname), "wb")
        self._lock = threading.Lock()
        write_record(self._fh, encode_event(time.time(), file_version="brain.Event:2"))

    def add_scalars(self, scalars: dict, step: int) -> None:
        values = b"".join(encode_scalar_value(t, v) for t, v in scalars.items())
        with self._lock:
            write_record(self._fh, encode_event(time.time(), step, values))

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()
