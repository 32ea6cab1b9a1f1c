"""Wire framing: length-prefixed MessagePack messages over asyncio streams.

Port of `dynamo_tpu/runtime/codec.py`. The reference packs its bodies with
the `msgpack` package (`packb(use_bin_type=True)`, `unpackb(raw=False)`);
the port writes MessagePack itself on the standard library, because the
machine it serves on has no `msgpack`. It covers exactly the types the
store and transport frames carry, and its bytes equal msgpack's for them:

  nil, bool, int (fixint, uint 8..64, int 8..64; the smallest format that
  holds the value, as msgpack picks it), float (always float64, 0xcb),
  str (fixstr, str 8/16/32), bin (bytes, bytearray, memoryview: bin
  8/16/32), array (list, tuple), map (dict, in its iteration order).

Anything else raises TypeError, and an int outside [-2^63, 2^64) raises
OverflowError, as msgpack does; numpy scalars must be turned into Python
numbers first (the callers do). Decoding accepts every MessagePack format
but the ext types, gives arrays back as lists and str as str (`raw=False`),
and, like `unpackb`'s default, refuses map keys that are not str or bytes.

Frame = 4-byte big-endian length + MessagePack body, at most MAX_FRAME.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any

MAX_FRAME = 256 * 1024 * 1024  # hard cap against corrupt length prefixes

_LEN = struct.Struct(">I")
_B, _H, _I, _Q = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_b, _h, _i, _q = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80 or -32 <= n < 0:
        out += _b.pack(n) if n < 0 else _B.pack(n)
    elif n > 0:
        if n <= 0xFF:
            out += b"\xcc" + _B.pack(n)
        elif n <= 0xFFFF:
            out += b"\xcd" + _H.pack(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xce" + _I.pack(n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _Q.pack(n)
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -0x80:
        out += b"\xd0" + _b.pack(n)
    elif n >= -0x8000:
        out += b"\xd1" + _h.pack(n)
    elif n >= -0x80000000:
        out += b"\xd2" + _i.pack(n)
    elif n >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(n)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: bytes,
              out: bytearray) -> None:
    """Header of a str/bin/array/map of length n: a fix form below
    `fix_max` (fix = its base byte; 0 = none), else the 8/16/32-bit form
    from `codes` (8-bit form absent when codes has two bytes)."""
    if n < fix_max:
        out.append(fix | n)
    elif len(codes) == 3 and n <= 0xFF:
        out += codes[0:1] + _B.pack(n)
    elif n <= 0xFFFF:
        out += codes[-2:-1] + _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out += codes[-1:] + _I.pack(n)
    else:
        raise ValueError(f"object too large to pack: length {n}")


def _pack(obj: Any, out: bytearray) -> None:
    # the order of msgpack's own checks: subclasses of int, float, str,
    # bytes, dict and list pack as their base type
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + _F64.pack(obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), 0, 0, b"\xc4\xc5\xc6", out)
        out += obj
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, b"\xd9\xda\xdb", out)
        out += data
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, b"\xde\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, b"\xdc\xdd", out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, memoryview):
        data = obj.tobytes()
        _pack_len(len(data), 0, 0, b"\xc4\xc5\xc6", out)
        out += data
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """MessagePack body of `obj`: `msgpack.packb(obj, use_bin_type=True)`."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def num(self, fmt: struct.Struct):
        return fmt.unpack(self.take(fmt.size))[0]


_LEN_FMT = {0: _B, 1: _H, 2: _I}


def _unpack(r: _Reader) -> Any:
    c = r.num(_B)
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0xA0 <= c <= 0xBF:
        return str(r.take(c & 0x1F), "utf-8")
    if 0x90 <= c <= 0x9F:
        return [_unpack(r) for _ in range(c & 0x0F)]
    if 0x80 <= c <= 0x8F:
        return _unpack_map(r, c & 0x0F)
    if c == 0xC0:
        return None
    if c == 0xC2:
        return False
    if c == 0xC3:
        return True
    if 0xC4 <= c <= 0xC6:                       # bin 8/16/32
        return bytes(r.take(r.num(_LEN_FMT[c - 0xC4])))
    if c == 0xCA:
        return r.num(_F32)
    if c == 0xCB:
        return r.num(_F64)
    if 0xCC <= c <= 0xCF:                       # uint 8..64
        return r.num((_B, _H, _I, _Q)[c - 0xCC])
    if 0xD0 <= c <= 0xD3:                       # int 8..64
        return r.num((_b, _h, _i, _q)[c - 0xD0])
    if 0xD9 <= c <= 0xDB:                       # str 8/16/32
        return str(r.take(r.num(_LEN_FMT[c - 0xD9])), "utf-8")
    if c in (0xDC, 0xDD):                       # array 16/32
        return [_unpack(r) for _ in range(r.num(_H if c == 0xDC else _I))]
    if c in (0xDE, 0xDF):                       # map 16/32
        return _unpack_map(r, r.num(_H if c == 0xDE else _I))
    raise ValueError(f"Unpack failed: unsupported MessagePack type "
                     f"0x{c:02x}")


def _unpack_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             f"key when strict_map_key=True")
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes) -> Any:
    """Decode one MessagePack object: `msgpack.unpackb(data, raw=False)`."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("Unpack failed: extra data after the object")
    return obj


def pack(obj: Any) -> bytes:
    body = packb(obj)
    return _LEN.pack(len(body)) + body


async def read_frame(reader: asyncio.StreamReader) -> Any:
    """Read one frame; raises ConnectionError on EOF/oversize."""
    try:
        header = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionResetError) as e:
        raise ConnectionError("stream closed") from e
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ConnectionError(f"frame too large: {length}")
    try:
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError) as e:
        raise ConnectionError("stream closed mid-frame") from e
    return unpackb(body)


def write_frame(writer: asyncio.StreamWriter, obj: Any) -> None:
    writer.write(pack(obj))
