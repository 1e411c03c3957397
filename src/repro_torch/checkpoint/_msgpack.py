"""A msgpack codec for the subset the checkpoint layout uses: map, array,
str, bin, bool, int and nil.

``packb`` picks the smallest encoding of each value, as
``msgpack.packb(obj, use_bin_type=True)`` does (fixmap / map16 / map32,
fixarray / array16 / array32, fixstr / str8 / str16 / str32, bin8 / bin16 /
bin32, positive and negative fixint, then the narrowest of uint8..uint64 or
int8..int64), so a checkpoint written here is byte for byte the file the
``msgpack`` package writes. Every length and int is big-endian. ``unpackb``
reads the same subset back (str as ``str``, bin as ``bytes``); anything
else raises ``ValueError``. The port needs no ``msgpack`` package.
"""

from __future__ import annotations

import struct


def _head(out: bytearray, n: int, fix: int, fix_max: int,
          codes: tuple) -> None:
    """A length header: the fix form up to ``fix_max``, else the first of
    the 8/16/32-bit ``codes`` (None where a width is not defined) that
    holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit a msgpack header")


def _pack_int(out: bytearray, v: int) -> None:
    if -32 <= v < 128:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} does not fit 64 bits")
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)),
                              (0xD3, ">q", -(1 << 63))):
            if v >= lo:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} does not fit 64 bits")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _head(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` (dicts, lists, tuples, str, bytes, bool, int, None) as
    msgpack bytes."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.mv):
            raise ValueError("msgpack data ends early")
        b = self.mv[self.at:self.at + n]
        self.at += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",       # str
         0xC4: ">B", 0xC5: ">H", 0xC6: ">I",       # bin
         0xDC: ">H", 0xDD: ">I",                   # array
         0xDE: ">H", 0xDF: ">I"}                   # map


def _unpack(r: _Reader):
    c = r.take(1)[0]
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if c == 0xC0:
        return None
    if c in (0xC2, 0xC3):
        return c == 0xC3
    if c in _INTS:
        return r.unpack(_INTS[c])
    if 0xA0 <= c <= 0xBF or c in (0xD9, 0xDA, 0xDB):
        n = c & 0x1F if c <= 0xBF else r.unpack(_LENS[c])
        return str(r.take(n), "utf-8")
    if c in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.unpack(_LENS[c])))
    if 0x90 <= c <= 0x9F or c in (0xDC, 0xDD):
        n = c & 0x0F if c <= 0x9F else r.unpack(_LENS[c])
        return [_unpack(r) for _ in range(n)]
    if 0x80 <= c <= 0x8F or c in (0xDE, 0xDF):
        n = c & 0x0F if c <= 0x8F else r.unpack(_LENS[c])
        out = {}
        for _ in range(n):
            k = _unpack(r)
            out[k] = _unpack(r)
        return out
    raise ValueError(f"msgpack subset: type byte 0x{c:02x} is not supported")


def unpackb(data) -> object:
    """The object one msgpack value in ``data`` encodes (the whole of it)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.at != len(r.mv):
        raise ValueError(f"msgpack data has {len(r.mv) - r.at} extra bytes")
    return obj
