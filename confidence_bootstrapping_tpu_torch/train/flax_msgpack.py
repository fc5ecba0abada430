"""Read and write the bytes ``flax.serialization.to_bytes`` writes, with numpy only.

The machine that runs the port has neither flax nor msgpack, and a model
directory's weights are a Flax msgpack bundle (the JAX package's
``train/checkpoints.py``). The format, as ``flax/serialization.py`` writes it:

* a msgpack map of str keys (nested maps for nested dicts) whose values are
  nil, bools, ints, float64s, str, bin or further maps;
* an ndarray as ext type 1, its payload the msgpack array ``[shape, dtype
  name, raw C-order bytes]``; a numpy scalar as ext type 3 with the payload
  of its 0-d array; ext type 2 (a Python complex) is refused here;
* an array above ``MAX_CHUNK_SIZE`` bytes as the map
  ``{"__msgpack_chunked_array__": true, "shape": {"0": ...}, "chunks": {"0":
  <flat array>, ...}}`` of flat chunks of at most that many bytes.

``to_bytes`` gives the same bytes as ``flax.serialization.to_bytes`` of the
same tree of dicts (tests/test_torch_checkpoints.py holds them equal), and
``restore`` returns what ``flax.serialization.msgpack_restore`` returns: the
nested dicts with numpy leaves (read-only views of the bytes), chunked arrays
joined. It needs no template.
"""

from __future__ import annotations

import struct

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE: larger arrays are written in chunks
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ----------------------------------------------------------------------------- writing


def to_bytes(tree: dict) -> bytes:
    """The msgpack bytes of a tree of str-keyed dicts whose leaves are numpy
    arrays and scalars, Python bools, ints, floats, str, bytes and None."""
    out = []
    _pack(_chunk_leaves(tree), out)
    return b"".join(out)


def _chunk_leaves(x):
    if isinstance(x, dict):
        return {str(k): _chunk_leaves(v) for k, v in x.items()}
    if isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
        step = max(1, int(MAX_CHUNK_SIZE / x.dtype.itemsize))
        flat = x.reshape(-1)
        chunks = [flat[i: i + step] for i in range(0, flat.size, step)]
        return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(x.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return x


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        b = x.encode("utf-8")
        out.append(_head(len(b), 0xa0, 0x1f, b"\xd9", b"\xda", b"\xdb") + b)
    elif type(x) is bytes:
        out.append(_head(len(x), None, 0, b"\xc4", b"\xc5", b"\xc6") + x)
    elif type(x) is dict:
        out.append(_head(len(x), 0x80, 0x0f, None, b"\xde", b"\xdf"))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif type(x) in (list, tuple):
        out.append(_head(len(x), 0x90, 0x0f, None, b"\xdc", b"\xdd"))
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(_EXT_NDARRAY, _ndarray_bytes(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(x))))
    else:
        raise TypeError(f"flax_msgpack.to_bytes does not write {type(x).__name__}")


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    out = []
    _pack([list(a.shape), a.dtype.name, a.tobytes("C")], out)
    return b"".join(out)


def _head(n: int, fix, fix_max: int, b8, b16, b32) -> bytes:
    """A msgpack length header: the fix form (type byte ``fix | n``) up to
    ``fix_max``, then 8, 16 and 32-bit lengths (None: no such form)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    if b8 is not None and n <= 0xff:
        return b8 + bytes([n])
    if n <= 0xffff:
        return b16 + struct.pack(">H", n)
    if n <= 0xffffffff:
        return b32 + struct.pack(">I", n)
    raise ValueError(f"a msgpack object of {n} items or bytes is too large")


def _int(x: int) -> bytes:
    if x >= 0:
        if x < 0x80:
            return bytes([x])
        for code, fmt, top in ((b"\xcc", ">B", 0xff), (b"\xcd", ">H", 0xffff), (b"\xce", ">I", 0xffffffff),
                               (b"\xcf", ">Q", 0xffffffffffffffff)):
            if x <= top:
                return code + struct.pack(fmt, x)
    else:
        if x >= -0x20:
            return struct.pack(">b", x)
        for code, fmt, low in ((b"\xd0", ">b", -0x80), (b"\xd1", ">h", -0x8000), (b"\xd2", ">i", -0x80000000),
                               (b"\xd3", ">q", -0x8000000000000000)):
            if x >= low:
                return code + struct.pack(fmt, x)
    raise OverflowError(f"msgpack has no integer of {x}")


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
    if n in fixed:
        return fixed[n] + bytes([code]) + data
    return _head(n, None, 0, b"\xc7", b"\xc8", b"\xc9") + bytes([code]) + data


# ----------------------------------------------------------------------------- reading


def restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``."""
    r = _Reader(memoryview(data))
    tree = r.read()
    if r.k != len(data):
        raise ValueError(f"flax_msgpack.restore: {len(data) - r.k} bytes after the end of the object")
    return _unchunk_leaves(tree)


def _unchunk_leaves(x):
    if isinstance(x, dict):
        if _CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            return np.concatenate([x["chunks"][str(i)] for i in range(len(x["chunks"]))]).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in x.items()}
    return x


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf, self.k = buf, 0

    def take(self, n: int) -> memoryview:
        if self.k + n > len(self.buf):
            raise ValueError("flax_msgpack.restore: the data ends inside an object")
        out = self.buf[self.k: self.k + n]
        self.k += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.read() for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return str(self.take(t & 0x1f), "utf-8")
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if t in fixed:
            return fixed[t]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                0xca: ">f", 0xcb: ">d"}
        if t in ints:
            return self.unpack(ints[t])
        lengths = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H", 0xdd: ">I",
                   0xde: ">H", 0xdf: ">I", 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if t in lengths:
            n = self.unpack(lengths[t])
            if t <= 0xc6:
                return bytes(self.take(n))
            if t <= 0xc9:
                return self.ext(self.unpack(">b"), n)
            if t <= 0xdb:
                return str(self.take(n), "utf-8")
            if t <= 0xdd:
                return [self.read() for _ in range(n)]
            return self.map(n)
        if 0xd4 <= t <= 0xd8:
            return self.ext(self.unpack(">b"), 1 << (t - 0xd4))
        raise ValueError(f"flax_msgpack.restore: byte 0x{t:02x} at {self.k - 1} starts no msgpack object")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"flax_msgpack.restore: a map key of type {type(k).__name__}")
            out[k] = self.read()
        return out

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == _EXT_COMPLEX:
            raise ValueError("flax_msgpack.restore: complex numbers (ext type 2) are not read")
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"flax_msgpack.restore: unknown ext type {code}")
        r = _Reader(data)
        shape, name, raw = r.read()
        if r.k != n:
            raise ValueError("flax_msgpack.restore: bytes after an array's payload")
        try:
            dtype = np.dtype(name)
        except TypeError:
            raise ValueError(f"flax_msgpack.restore: dtype {name!r} is not a numpy dtype") from None
        a = np.frombuffer(raw, dtype=dtype).reshape(shape)
        return a[()] if code == _EXT_NPSCALAR else a
