"""The msgpack state-dict format of ``flax.serialization``, without msgpack.

This package's own codec for what ``flax.serialization.msgpack_serialize``
writes and ``msgpack_restore`` reads: maps with str keys, lists, nil, bool,
int, float (float64), str and bin. An ndarray is ext type 1 whose payload
packs ``(shape, dtype.name, C-order bytes)``; a numpy scalar is ext type 3
with the same payload. An array of more than :data:`MAX_CHUNK_SIZE` bytes is
written as flax's chunked form, ``{"__msgpack_chunked_array__": True,
"shape": {"0": ...}, "chunks": {"0": ...}}``, and read back whole.

Maps are written with their keys in sorted order, as flax writes them (it
rebuilds the tree with ``jax.tree_util.tree_map`` first), so a params tree
gives flax's bytes exactly. :func:`dump` streams to a file: each array's
bytes go from its buffer to the file without a copy. :func:`loads` returns
arrays that are views of the buffer it was given.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax's limit: msgpack caps one object at 2**31 - 1 bytes
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------------------
# Encoding.
# ---------------------------------------------------------------------------


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes((v,))
    if -32 <= v < 0:
        return struct.pack("b", v)
    if v >= 0:
        for marker, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= top:
                return bytes((marker,)) + struct.pack(fmt, v)
    else:
        for marker, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                                 (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if v >= low:
                return bytes((marker,)) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit in 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, markers: tuple[int, int, int]) -> bytes:
    """The header of a str/bin/array/map of ``n`` items: the fix form where
    there is one, else the 8- (str and bin only), 16- or 32-bit form."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    m8, m16, m32 = markers
    if m8 is not None and n <= 0xFF:
        return bytes((m8, n))
    if n <= 0xFFFF:
        return bytes((m16,)) + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return bytes((m32,)) + struct.pack(">I", n)
    raise OverflowError(f"{n} items do not fit in a msgpack header")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6))


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 15, (None, 0xDC, 0xDD))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 15, (None, 0xDE, 0xDF))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes((fixed[n], code))
    return _sized(n, None, 0, (0xC7, 0xC8, 0xC9)) + bytes((code,))


def _ndarray_parts(arr: np.ndarray, code: int) -> tuple[bytes, memoryview]:
    """An ndarray's ext header and inner header (``msgpack.packb((shape,
    dtype.name, bytes))``'s bytes up to the buffer), and its buffer."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization "
                         "of ndarrays.")
    if not arr.flags.c_contiguous:  # (np.ascontiguousarray would make a scalar 1-d)
        arr = arr.copy(order="C")
    data = memoryview(arr.reshape(-1)).cast("B") if arr.size else memoryview(b"")
    inner = (_array_header(3) + _array_header(arr.ndim) + b"".join(_int(d) for d in arr.shape)
             + _str(arr.dtype.name) + _bin_header(len(data)))
    return _ext_header(code, len(inner) + len(data)) + inner, data


def _chunk(arr: np.ndarray) -> dict:
    """flax ``serialization._chunk``: the flat array in pieces of at most
    ``MAX_CHUNK_SIZE`` bytes, with the shape."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = np.ascontiguousarray(arr).reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _walk(obj: Any, write) -> None:
    """Hand ``obj``'s encoding to ``write`` piece by piece."""
    if isinstance(obj, dict):
        chunked = _CHUNKED in obj
        items = list(obj.items()) if chunked else sorted(obj.items())
        write(_map_header(len(items)))
        for k, v in items:
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            write(_str(k))
            _walk(v, write)
    elif isinstance(obj, (list, tuple)):
        write(_array_header(len(obj)))
        for v in obj:
            _walk(v, write)
    elif obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        write(_int(obj))
    elif type(obj) is float:
        write(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        write(_str(obj))
    elif type(obj) in (bytes, bytearray, memoryview):
        data = memoryview(obj).cast("B")
        write(_bin_header(len(data)))
        write(data)
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            _walk(_chunk(obj), write)
            return
        head, data = _ndarray_parts(obj, _EXT_NDARRAY)
        write(head)
        write(data)
    elif isinstance(obj, np.generic):
        head, data = _ndarray_parts(np.asarray(obj), _EXT_NPSCALAR)
        write(head + bytes(data))
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def dumps(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    out = bytearray()
    _walk(tree, out.extend)
    return bytes(out)


def dump(tree: Any, fh: BinaryIO) -> int:
    """Write ``tree``'s encoding to the binary file ``fh``, array buffers
    straight from memory. Returns the bytes written."""
    n = 0

    def write(b):
        nonlocal n
        fh.write(b)
        n += len(b)

    _walk(tree, write)
    return n


# ---------------------------------------------------------------------------
# Decoding.
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in lengths:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        n = self.unpack(lengths[b])
        if b <= 0xC6:  # bin: a view inside an array's payload, else bytes
            return self.take(n) if raw else bytes(self.take(n))
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return self.text(n, raw)
        if b <= 0xDD:
            return [self.obj(raw) for _ in range(n)]
        return self.map(n, raw)

    def text(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def ext(self, n: int):
        code = struct.unpack("b", self.take(1))[0]
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        inner = _Reader(data)
        shape, dtype_name, buf = inner.obj(raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(obj: Any) -> Any:
    if isinstance(obj, dict):
        if _CHUNKED in obj:
            shape = tuple(obj["shape"][str(i)] for i in range(len(obj["shape"])))
            chunks = [obj["chunks"][str(i)] for i in range(len(obj["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in obj.items()}
    return obj


def loads(buf) -> Any:
    """``flax.serialization.msgpack_restore(buf)``: the tree, its arrays
    views of ``buf`` (writable when ``buf`` is), chunked arrays whole."""
    reader = _Reader(buf)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes of trailing data")
    return _unchunk(tree)
