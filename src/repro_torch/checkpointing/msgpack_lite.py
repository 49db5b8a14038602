"""The subset of MessagePack a checkpoint manifest uses: maps, arrays,
strings, integers, booleans and nil.  :func:`packb` writes the bytes
``msgpack.packb`` writes for these (its defaults: the smallest encoding of
each integer, str8 for strings of 32-255 bytes); :func:`unpackb` reads
them back, arrays as lists, as ``msgpack.unpackb`` does.  A manifest's
maps have a few keys, its strings are leaf paths and file names, and its
one long array is the entries: fixmap, str8 and array16 are the widest
headers, and anything else (floats, bytes, wider headers) is refused.  The
machine that runs the port may lack the ``msgpack`` package, so the port
carries this one.
"""
from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        if len(b) < 32:
            out.append(0xA0 | len(b))
        elif len(b) <= 0xFF:
            out += bytes((0xD9, len(b)))
        else:
            raise ValueError(f"a string of {len(b)} bytes is not in the manifest's subset")
        out += b
    elif isinstance(obj, (list, tuple)):
        if len(obj) < 16:
            out.append(0x90 | len(obj))
        elif len(obj) <= 0xFFFF:
            out.append(0xDC)
            out += struct.pack(">H", len(obj))
        else:
            raise ValueError(f"an array of {len(obj)} items is not in the manifest's subset")
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        if len(obj) >= 16:
            raise ValueError(f"a map of {len(obj)} keys is not in the manifest's subset")
        out.append(0x80 | len(obj))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError("Integer value out of range")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError("Integer value out of range")


# the integers' codes -> their struct formats
_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def unpackb(data: bytes):
    obj, at = _unpack(memoryview(bytes(data)), 0)
    if at != len(data):
        raise ValueError(f"{len(data) - at} extra bytes after the msgpack object")
    return obj


def _unpack(buf: memoryview, at: int):
    code = buf[at]
    at += 1
    if code < 0x80:
        return code, at
    if code >= 0xE0:
        return code - 0x100, at
    if code < 0x90:
        return _items(buf, at, code & 0x0F, "map")
    if code < 0xA0:
        return _items(buf, at, code & 0x0F, "array")
    if code < 0xC0:
        return _str(buf, at, code & 0x1F)
    if code == 0xC0:
        return None, at
    if code in (0xC2, 0xC3):
        return code == 0xC3, at
    if code in _INTS:
        fmt = _INTS[code]
        return struct.unpack_from(fmt, buf, at)[0], at + struct.calcsize(fmt)
    if code == 0xD9:
        return _str(buf, at + 1, buf[at])
    if code == 0xDC:
        return _items(buf, at + 2, struct.unpack_from(">H", buf, at)[0], "array")
    raise ValueError(f"msgpack code 0x{code:02x} is not in the manifest's subset")


def _str(buf: memoryview, at: int, n: int):
    return str(buf[at:at + n], "utf-8"), at + n


def _items(buf: memoryview, at: int, n: int, kind: str):
    if kind == "array":
        out = []
        for _ in range(n):
            v, at = _unpack(buf, at)
            out.append(v)
        return out, at
    out = {}
    for _ in range(n):
        k, at = _unpack(buf, at)
        v, at = _unpack(buf, at)
        out[k] = v
    return out, at
