"""A reader and a writer of flax's msgpack files: the JAX package's
``.jaxckpt`` checkpoints (``utils/checkpoint.py:103-132`` there), written by
``flax.serialization.msgpack_serialize``, and the port's int8 calibration
files (``engine/quantize.py``).

The port depends on neither ``msgpack`` nor ``flax``, so this module reads
the format itself: maps, arrays, str and bin, ints, floats, nil and
booleans (the msgpack specification), flax's extension types (code 1, an
ndarray: a msgpack (shape, dtype name, buffer) triple; code 2, a complex;
code 3, a numpy scalar) and flax's chunked arrays (``MAX_CHUNK_SIZE``
pieces of an array larger than 1 GiB). Arrays come back as numpy arrays;
bfloat16 ones as float32, which holds their values exactly.
``msgpack_serialize`` writes maps with str keys, str, bytes, lists, ints
and numpy arrays (extension code 1), which flax reads.
"""

from __future__ import annotations

import struct

import numpy as np

_CHUNKED = "__msgpack_chunked_array__"


def _bf16_to_f32(buf: bytes) -> np.ndarray:
    bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
    return bits.view(np.float32)


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = Reader(data).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        arr = _bf16_to_f32(buf)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name)).copy()
    return arr.reshape(shape)


def _ext(code: int, data: bytes):
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = Reader(data).value()
        return complex(real, imag)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack extension type {code}")


class Reader:
    """Decodes one msgpack value from ``data`` (``value()``)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode()
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}  # bin 8/16/32
        if b in sized:
            return self._take(self._unpack(sized[b]))
        exts = {0xC7: "B", 0xC8: "H", 0xC9: "I"}  # ext 8/16/32
        if b in exts:
            n = self._unpack(exts[b])
            code = self._unpack("b")
            return _ext(code, self._take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self._unpack("b")
            return _ext(code, self._take(fixext[b]))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self._unpack(numbers[b])
        strs = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in strs:
            return self._take(self._unpack(strs[b])).decode()
        if b in (0xDC, 0xDD):
            return self._array(self._unpack("H" if b == 0xDC else "I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"invalid msgpack byte 0x{b:02x} at {self.pos - 1}")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            return _unchunk(out)
        return out


def _as_tuple(d: dict) -> tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict) -> np.ndarray:
    """flax's chunked form of an oversized array, joined."""
    return np.concatenate(_as_tuple(d["chunks"])).reshape(_as_tuple(d["shape"]))


def msgpack_restore(data: bytes):
    """The tree that ``flax.serialization.msgpack_serialize`` wrote."""
    reader = Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    return out


def _pack(obj, out: list) -> None:
    if isinstance(obj, str):
        raw = obj.encode()
        out.append(struct.pack(">BI", 0xDB, len(raw)) + raw)
    elif isinstance(obj, bytes):
        out.append(struct.pack(">BI", 0xC6, len(obj)) + obj)
    elif isinstance(obj, (list, tuple)):
        out.append(struct.pack(">BI", 0xDD, len(obj)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(struct.pack(">BI", 0xDF, len(obj)))
        for k, v in obj.items():
            _pack(str(k), out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        arr = np.array(obj, order="C")  # 0-d stays 0-d
        data = msgpack_serialize([list(arr.shape), arr.dtype.name,
                                  arr.tobytes()])
        out.append(struct.pack(">BIb", 0xC9, len(data), 1) + data)
    elif isinstance(obj, int):  # a shape's sizes
        out.append(struct.pack(">Bq", 0xD3, obj))
    else:
        raise TypeError(f"msgpack_serialize: cannot write {type(obj)}")


def msgpack_serialize(obj) -> bytes:
    """``obj`` in flax's msgpack format (the inverse of ``msgpack_restore``
    for the types it writes)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)
