"""Protocol-buffers wire-format encoders (no protobuf dependency): this
package's own copy of the parts of ``distributed_tensorflow_tpu/utils/
protowire.py`` that scalar event files use. Wire types: 0 = varint, 1 =
64-bit, 2 = length-delimited, 5 = 32-bit.
"""

from __future__ import annotations

import struct


def varint(value: int) -> bytes:
    if value < 0:
        value &= 0xFFFFFFFFFFFFFFFF  # two's-complement 64-bit encoding
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def tag(field: int, wire_type: int) -> bytes:
    return varint((field << 3) | wire_type)


def field_varint(field: int, value: int) -> bytes:
    return tag(field, 0) + varint(value & 0xFFFFFFFFFFFFFFFF)


def field_bytes(field: int, value: bytes) -> bytes:
    return tag(field, 2) + varint(len(value)) + value


def field_float(field: int, value: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", value)


def field_double(field: int, value: float) -> bytes:
    return tag(field, 1) + struct.pack("<d", value)
