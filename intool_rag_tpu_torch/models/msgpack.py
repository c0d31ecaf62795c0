"""A small msgpack decoder and encoder for flax checkpoints
(``flax.serialization`` bytes), so the port reads and writes the JAX
package's encoder checkpoints without flax or the msgpack package.

:func:`unpackb` handles maps, arrays, str, bin, ints, floats, nil and bool,
and ext type 1, flax's ndarray: a packed ``(shape, dtype name, buffer)``
decoded to a numpy array. :func:`packb` writes what a parameter tree holds:
maps with str keys, numpy arrays, and the ints, strs and bytes inside an
array's record.
"""

from __future__ import annotations

import struct

import numpy as np

_NDARRAY_EXT = 1


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def value(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.sint(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8/16/32/64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8/16/32/64
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            typ = self.sint(1)
            return self.ext(typ, 1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return str(self.take(self.uint(1 << (b - 0xD9))), "utf-8")
        if b in (0xDC, 0xDD):  # array 16/32
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, typ: int, n: int):
        payload = bytes(self.take(n))
        if typ != _NDARRAY_EXT:
            raise ValueError(f"unsupported msgpack ext type {typ}")
        shape, dtype, buf = unpackb(payload)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def unpackb(data: bytes):
    """Decode one msgpack object; raises on trailing bytes."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


# flax splits a leaf above this size into chunks; writing those is not ported
_MAX_LEAF_BYTES = 2**30


def _pack_len(n: int, fix: tuple[int, int] | None, codes: tuple[int, ...]) -> bytes:
    """Header of a sized object: a fix byte where ``n`` fits ``fix = (base,
    limit)``, else the first of ``codes`` (8-, 16-, 32-bit length; 0 where
    the type has no such width) that holds ``n``."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, width in zip(codes, (1, 2, 4)):
        if code and n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"object of length {n} is too long for msgpack")


def _pack_into(obj, out: list[bytes]) -> None:
    if isinstance(obj, dict):
        out.append(_pack_len(len(obj), (0x80, 16), (0, 0xDE, 0xDF)))
        for key, val in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, got {type(key).__name__}")
            _pack_into(key, out)
            _pack_into(val, out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.nbytes > _MAX_LEAF_BYTES:
            raise ValueError(f"cannot pack an array of dtype {obj.dtype} and {obj.nbytes} bytes")
        payload = packb([list(obj.shape), obj.dtype.name, obj.tobytes("C")])
        out.append(_pack_len(len(payload), None, (0xC7, 0xC8, 0xC9)) + bytes([_NDARRAY_EXT]))
        out.append(payload)
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), (0x90, 16), (0, 0xDC, 0xDD)))
        for item in obj:
            _pack_into(item, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_pack_len(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out.append(_pack_len(len(obj), None, (0xC4, 0xC5, 0xC6)))
        out.append(bytes(obj))
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        n = int(obj)
        if 0 <= n <= 0x7F:
            out.append(bytes([n]))
        elif 0 <= n < 1 << 64:
            out.append(b"\xcf" + n.to_bytes(8, "big"))
        elif -(1 << 63) <= n < 0:
            out.append(b"\xd3" + n.to_bytes(8, "big", signed=True))
        else:
            raise ValueError(f"integer {n} does not fit 64 bits")
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode a parameter tree (nested str-keyed dicts of numpy arrays) as
    bytes that ``flax.serialization.from_bytes`` restores."""
    out: list[bytes] = []
    _pack_into(obj, out)
    return b"".join(out)
