"""A small msgpack decoder for flax checkpoints (``flax.serialization``
bytes), so the port reads the JAX package's encoder checkpoints without
flax or the msgpack package.

Handles maps, arrays, str, bin, ints, floats, nil and bool, and ext type 1,
flax's ndarray: a packed ``(shape, dtype name, buffer)`` decoded to a
numpy array.
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
