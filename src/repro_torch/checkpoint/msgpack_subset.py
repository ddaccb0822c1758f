"""The msgpack subset the checkpoint layout uses: map, str, bin, array
and int, encoded as ``msgpack.packb(obj, use_bin_type=True)`` encodes
them (always the shortest form), so a file written here is byte for
byte the one the msgpack package would write. Needs no msgpack package.
"""
from __future__ import annotations

import struct


def _head(out: list, n: int, fix: int, fix_max: int, codes) -> None:
    """Type byte plus length: the fix form below ``fix_max``, else the
    first of ``codes`` ((code, struct format, max)) that fits."""
    if n <= fix_max:
        out.append(bytes((fix | n,)))
        return
    for code, fmt, top in codes:
        if n <= top:
            out.append(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} is too large for msgpack")


_MAP = ((0xde, ">H", 0xFFFF), (0xdf, ">I", 0xFFFFFFFF))
_ARR = ((0xdc, ">H", 0xFFFF), (0xdd, ">I", 0xFFFFFFFF))
_STR = ((0xd9, ">B", 0xFF), (0xda, ">H", 0xFFFF), (0xdb, ">I", 0xFFFFFFFF))
_BIN = ((0xc4, ">B", 0xFF), (0xc5, ">H", 0xFFFF), (0xc6, ">I", 0xFFFFFFFF))
_UINT = ((0xcc, ">B", 0xFF), (0xcd, ">H", 0xFFFF),
         (0xce, ">I", 0xFFFFFFFF), (0xcf, ">Q", 0xFFFFFFFFFFFFFFFF))
_INT = ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15), (0xd2, ">i", 1 << 31),
        (0xd3, ">q", 1 << 63))


def pack(obj, out: list) -> None:
    """Append the encoding of ``obj`` to ``out`` as a list of bytes."""
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"cannot pack {obj!r}: not in the checkpoint subset")
    if isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, _MAP)
        for k, v in obj.items():
            pack(k, out)
            pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, _ARR)
        for v in obj:
            pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, len(b), 0xa0, 31, _STR)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj) if not isinstance(obj, bytes) else obj
        _head(out, len(b), 0, -1, _BIN)
        out.append(b)
    elif isinstance(obj, int):
        if 0 <= obj:
            _head(out, obj, 0x00, 0x7F, _UINT)
        elif obj >= -32:
            out.append(struct.pack(">b", obj))
        else:
            for code, fmt, top in _INT:
                if obj >= -top:
                    out.append(bytes((code,)) + struct.pack(fmt, obj))
                    return
            raise ValueError(f"integer {obj} is too large for msgpack")
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}: not in the "
                        "checkpoint subset")


def packb(obj) -> bytes:
    out: list = []
    pack(obj, out)
    return b"".join(out)


_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
        0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}
_NUM = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
        0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def unpackb(data: bytes):
    """Decode one object of the subset; raises ValueError on anything
    else or on trailing bytes."""
    mv = memoryview(data)
    obj, pos = _unpack(mv, 0)
    if pos != len(mv):
        raise ValueError(f"{len(mv) - pos} trailing bytes after the object")
    return obj


def _unpack(mv: memoryview, pos: int):
    code = mv[pos]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code in _NUM:
        fmt = _NUM[code]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, mv, pos)[0], pos + n
    if 0x80 <= code <= 0x8F or code in (0xde, 0xdf):
        n, pos = _length(mv, pos, code, code & 0x0F)
        out = {}
        for _ in range(n):
            k, pos = _unpack(mv, pos)
            out[k], pos = _unpack(mv, pos)
        return out, pos
    if 0x90 <= code <= 0x9F or code in (0xdc, 0xdd):
        n, pos = _length(mv, pos, code, code & 0x0F)
        out = []
        for _ in range(n):
            v, pos = _unpack(mv, pos)
            out.append(v)
        return out, pos
    if 0xA0 <= code <= 0xBF or code in (0xd9, 0xda, 0xdb):
        n, pos = _length(mv, pos, code, code & 0x1F)
        return bytes(mv[pos:pos + n]).decode("utf-8"), pos + n
    if code in (0xc4, 0xc5, 0xc6):
        n, pos = _length(mv, pos, code, 0)
        return bytes(mv[pos:pos + n]), pos + n
    raise ValueError(f"msgpack type byte 0x{code:02x} is not in the "
                     "checkpoint subset")


def _length(mv: memoryview, pos: int, code: int, fix: int):
    fmt = _LEN.get(code)
    if fmt is None:
        return fix, pos
    return struct.unpack_from(fmt, mv, pos)[0], pos + struct.calcsize(fmt)
