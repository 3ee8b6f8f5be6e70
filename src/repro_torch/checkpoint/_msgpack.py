"""A pure-Python msgpack reader and writer for the checkpoint trees.

It covers the subset that ``msgpack.packb(tree, use_bin_type=True)``
emits for the trees ``msgpack_ckpt`` writes, and emits the same bytes:

- nil, false, true;
- int as positive or negative fixint, then the smallest of uint 8-64
  (non-negative) or int 8-64 (negative);
- float as float64 (float32 is read too);
- str (fixstr, str 8/16/32, UTF-8) and bytes (bin 8/16/32);
- list and tuple as array, dict as map (fix, 16, 32), in order.

Anything else raises ``TypeError`` on write and ``ValueError`` on read
(ext types, a truncated input, bytes past the end, a non-str map key),
which ``msgpack_ckpt.load`` turns into ``CheckpointError``.  With it the
port reads and writes the reference's checkpoint files on a machine
without the ``msgpack`` package.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

_U64 = 0xFFFFFFFFFFFFFFFF
_I64 = -0x8000000000000000


def _header(n: int, fix_tag: int, fix_max: int, tags: Tuple[int, ...],
            what: str) -> bytes:
    """The length header of a str/bin/array/map of ``n`` items:
    ``fix_tag | n`` below ``fix_max`` (0 for none), else the first of
    ``tags`` (8, 16 and 32-bit lengths; 0 for an absent width) that holds
    ``n``."""
    if n < fix_max:
        return bytes((fix_tag | n,))
    for tag, fmt, top in zip(tags, (">BB", ">BH", ">BI"),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag and n <= top:
            return struct.pack(fmt, tag, n)
    raise ValueError(f"{what} of {n} items is too long for msgpack")


def _pack_int(obj: int) -> bytes:
    if 0 <= obj < 0x80:
        return struct.pack("B", obj)
    if -0x20 <= obj < 0:
        return struct.pack("b", obj)
    if obj >= 0:
        for tag, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                              (0xCE, ">BI", 0xFFFFFFFF),
                              (0xCF, ">BQ", _U64)):
            if obj <= top:
                return struct.pack(fmt, tag, obj)
    else:
        for tag, fmt, low in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                              (0xD2, ">Bi", -0x80000000),
                              (0xD3, ">Bq", _I64)):
            if obj >= low:
                return struct.pack(fmt, tag, obj)
    raise OverflowError(f"integer {obj} does not fit in 64 bits")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_header(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), "str"))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        # a buffer goes out as it is (no copy): a leaf's raw bytes
        raw = obj if isinstance(obj, bytes) else memoryview(obj).cast("B")
        out.append(_header(len(raw), 0, 0, (0xC4, 0xC5, 0xC6), "bin"))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, (0, 0xDC, 0xDD), "array"))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, (0, 0xDE, 0xDF), "map"))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes, as ``msgpack.packb(obj,
    use_bin_type=True)`` writes them."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Sink:
    """``_pack``'s output list as a stream: each piece goes to ``write``."""

    def __init__(self, write):
        self.append = write


def pack_to(obj: Any, write) -> None:
    """Write ``packb(obj)``'s bytes through ``write``, piece by piece,
    without joining them: a checkpoint's leaves go to the file from the
    arrays' own buffers."""
    _pack(obj, _Sink(write))


class _Reader:
    """A cursor over the input; every read past its end raises."""

    def __init__(self, data):
        self.buf = memoryview(data).toreadonly()
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated input: {n} bytes wanted at offset "
                             f"{self.pos} of {len(self.buf)}")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# tag -> struct format of a fixed-width scalar
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# tag -> (kind, struct format of its length)
_SIZED = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(r: _Reader) -> Any:
    tag = r.unpack(">B")
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if tag == 0xC0:
        return None
    if tag in (0xC2, 0xC3):
        return tag == 0xC3
    if tag in _SCALARS:
        return r.unpack(_SCALARS[tag])
    if 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif tag in _SIZED:
        kind, fmt = _SIZED[tag]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{tag:02x} at "
                         f"offset {r.pos - 1}")
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return r.take(n)
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        key = _unpack(r)
        if not isinstance(key, (str, bytes)):
            raise ValueError(f"map key of type {type(key).__name__} is not "
                             f"str or bytes")
        out[key] = _unpack(r)
    return out


def unpackb(data) -> Any:
    """The object in ``data``, as ``msgpack.unpackb(data, raw=False)``
    reads it (arrays as lists), except that a bin is a read-only
    ``memoryview`` into ``data`` (equal to its ``bytes``), so a large
    file's leaves are not copied.  ``ValueError`` on a truncated input,
    trailing bytes or a type outside the subset."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError(f"extra data: {len(r.buf) - r.pos} bytes after the "
                         f"object")
    return obj
