"""A pure-Python msgpack codec limited to what ``flax.serialization`` writes
and reads, so the port reads and writes ``dtt``'s ``state.msgpack`` files
without the ``msgpack`` package.

Values: maps with ``str`` keys (dicts, in their order), ``None``, bool,
int, float (a float64), str, bytes and numpy arrays. An array is flax's
ndarray extension (type 1): a msgpack array of (shape, dtype name, raw C
bytes), as ``flax.serialization._ndarray_to_bytes`` packs it. Every
header takes msgpack's shortest form, as the reference packer does, so
`packb` of flax's state dict (keys in its sorted order) equals
``flax.serialization.to_bytes`` byte for byte. Anything else raises:
lists, other extension types, non-str keys, arrays of more than 2^30
bytes (which flax would split into chunks) or of a dtype numpy does not
know.

Array bytes are never touched element by element: `dump` writes each
array's memory as it is, and `unpackb` returns arrays that view the
buffer it was given (read-only when it is ``bytes``).
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

_NDARRAY_EXT = 1
_MAX_ARRAY_BYTES = 2 ** 30      # flax's MAX_CHUNK_SIZE


def _uint_header(n: int, fix_base: int, fix_max: int, codes) -> bytes:
    """Header of a length-prefixed type: the fix form up to `fix_max`, else
    the 8/16/32-bit forms `codes` (None where the type has no such form)."""
    if n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _str_header(n: int) -> bytes:
    return _uint_header(n, 0xa0, 31, (0xd9, 0xda, 0xdb))


def _bin_header(n: int) -> bytes:
    return _uint_header(n, 0, -1, (0xc4, 0xc5, 0xc6))


def _map_header(n: int) -> bytes:
    return _uint_header(n, 0x80, 15, (None, 0xde, 0xdf))


def _array_header(n: int) -> bytes:
    return _uint_header(n, 0x90, 15, (None, 0xdc, 0xdd))


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v > 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _str(v: str) -> bytes:
    raw = v.encode("utf-8")
    return _str_header(len(raw)) + raw


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _uint_header(n, 0, -1, (0xc7, 0xc8, 0xc9))
    return head + struct.pack(">b", code)


def _ndarray(a: np.ndarray) -> list:
    """The pieces of flax's ndarray extension for `a`: headers as bytes,
    the data as a memoryview of `a`."""
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    if a.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f"array of {a.nbytes} bytes: flax would chunk it")
    dims = b"".join(_int(int(d)) for d in a.shape)
    meta = (_array_header(3) + _array_header(a.ndim) + dims
            + _str(a.dtype.name) + _bin_header(a.nbytes))
    return [_ext_header(len(meta) + a.nbytes, _NDARRAY_EXT), meta,
            memoryview(a.reshape(-1)).cast("B")]


def _pack(obj) -> Iterator:
    if obj is None:
        yield b"\xc0"
    elif obj is True:
        yield b"\xc3"
    elif obj is False:
        yield b"\xc2"
    elif type(obj) is int:
        yield _int(obj)
    elif type(obj) is float:
        yield b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        yield _str(obj)
    elif type(obj) is bytes:
        yield _bin_header(len(obj)) + obj
    elif type(obj) is np.ndarray:
        yield from _ndarray(obj)
    elif type(obj) is dict:
        yield _map_header(len(obj))
        for k, v in obj.items():
            if type(k) is not str:
                raise TypeError(f"msgpack map key {k!r} is not a str")
            yield _str(k)
            yield from _pack(v)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} as flax does")


def dump(obj, f) -> int:
    """Write `obj` packed to the binary file `f`; returns the bytes
    written."""
    n = 0
    for piece in _pack(obj):
        f.write(piece)
        n += len(piece) if isinstance(piece, bytes) else piece.nbytes
    return n


def packb(obj) -> bytes:
    """`obj` packed as flax packs its state dict."""
    return b"".join(bytes(p) if isinstance(p, memoryview) else p
                    for p in _pack(obj))


class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("msgpack data ends early")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self, code: int, codes) -> int:
        return self.unpack({codes[0]: ">B", codes[1]: ">H",
                            codes[2]: ">I"}[code])

    def obj(self):
        c = self.unpack(">B")
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.obj() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return str(self.take(c & 0x1f), "utf-8")
        if c == 0xc0:
            return None
        if c in (0xc2, 0xc3):
            return c == 0xc3
        if c in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.length(c, (0xc4, 0xc5, 0xc6))))
        if c in (0xc7, 0xc8, 0xc9):
            return self.ext(self.length(c, (0xc7, 0xc8, 0xc9)))
        if c == 0xca:
            return self.unpack(">f")
        if c == 0xcb:
            return self.unpack(">d")
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if c in ints:
            return self.unpack(ints[c])
        if 0xd4 <= c <= 0xd8:
            return self.ext(1 << (c - 0xd4))
        if c in (0xd9, 0xda, 0xdb):
            return str(self.take(self.length(c, (0xd9, 0xda, 0xdb))),
                       "utf-8")
        if c in (0xdc, 0xdd):
            n = self.unpack(">H" if c == 0xdc else ">I")
            return [self.obj() for _ in range(n)]
        if c in (0xde, 0xdf):
            return self.map(self.unpack(">H" if c == 0xde else ">I"))
        raise ValueError(f"msgpack type byte {c:#x} is not used by flax")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if type(k) is not str:
                raise ValueError(f"msgpack map key {k!r} is not a str")
            out[k] = self.obj()
        if out.get("__msgpack_chunked_array__") is True:
            raise ValueError("chunked arrays (over 2^30 bytes) are not read")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        end = self.pos + n
        if code != _NDARRAY_EXT:
            raise ValueError(f"msgpack extension type {code} is not flax's "
                             "ndarray")
        head = self.unpack(">B")
        shape, name = self.obj(), self.obj()
        c = self.unpack(">B")
        if (head != 0x93 or not isinstance(shape, list)
                or not isinstance(name, str) or c not in (0xc4, 0xc5, 0xc6)):
            raise ValueError("malformed flax ndarray extension")
        data = self.take(self.length(c, (0xc4, 0xc5, 0xc6)))
        if self.pos != end:
            raise ValueError("malformed flax ndarray extension")
        try:
            dtype = np.dtype(name)
        except TypeError:
            raise ValueError(f"array dtype {name!r} is not a numpy dtype")
        return np.frombuffer(data, dtype=dtype).reshape(shape)


def unpackb(buf):
    """The value packed in `buf` (bytes or any buffer); arrays view it."""
    r = _Reader(buf)
    out = r.obj()
    if r.pos != len(r.mv):
        raise ValueError("trailing bytes after the msgpack value")
    return out
