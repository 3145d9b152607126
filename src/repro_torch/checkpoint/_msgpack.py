"""The subset of msgpack the checkpoint format uses, without the msgpack
package.

``packb(obj)`` is byte-identical to ``msgpack.packb(obj, use_bin_type=True)``
for dict, str, bytes-like (bin), int, float (float64), bool, None and
list/tuple, including the smallest-int, fixmap/fixstr/fixarray choices.
``pack_parts`` returns the same bytes as a list of buffers without copying
large bins (the saver writes a multi-GB object straight from its pinned
staging buffer); ``Blob`` wraps such a list so it can sit inside another
object as one bin.  ``unpackb`` decodes the same subset (plus float32),
optionally returning bins as zero-copy memoryviews.
"""
from __future__ import annotations

import struct
from typing import Any, List, Sequence

# Bins at least this long are passed through as buffers, not copied into
# the header stream.
_PASSTHROUGH = 1 << 16


class Blob:
    """A bin value made of several buffers (written back to back)."""

    def __init__(self, parts: Sequence):
        self.parts = [memoryview(p).cast("B") for p in parts]
        self.nbytes = sum(p.nbytes for p in self.parts)


def _int(out: bytearray, v: int) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + struct.pack(">B", v)
        elif v <= 0xFFFF:
            out += b"\xcd" + struct.pack(">H", v)
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + struct.pack(">I", v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            raise OverflowError("int too big for msgpack")
    else:
        if v >= -32:
            out += struct.pack(">b", v)
        elif v >= -0x80:
            out += b"\xd0" + struct.pack(">b", v)
        elif v >= -0x8000:
            out += b"\xd1" + struct.pack(">h", v)
        elif v >= -0x80000000:
            out += b"\xd2" + struct.pack(">i", v)
        elif v >= -0x8000000000000000:
            out += b"\xd3" + struct.pack(">q", v)
        else:
            raise OverflowError("int too small for msgpack")


def _len_header(out: bytearray, n: int, fix_base: int, fix_max: int,
                c16: bytes, c32: bytes, c8: bytes = b"") -> None:
    if n <= fix_max and fix_base >= 0:
        out.append(fix_base | n)
    elif c8 and n <= 0xFF:
        out += c8 + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += c16 + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += c32 + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack length {n} exceeds 2**32 - 1")


class _Packer:
    def __init__(self) -> None:
        self.parts: List = []
        self.buf = bytearray()

    def _bin(self, mvs, n: int) -> None:
        _len_header(self.buf, n, -1, -1, b"\xc5", b"\xc6", b"\xc4")
        for mv in mvs:
            if mv.nbytes >= _PASSTHROUGH:
                if self.buf:
                    self.parts.append(bytes(self.buf))
                    self.buf = bytearray()
                self.parts.append(mv)
            else:
                self.buf += mv

    def pack(self, obj: Any) -> None:
        out = self.buf
        if obj is None:
            out.append(0xC0)
        elif obj is True:
            out.append(0xC3)
        elif obj is False:
            out.append(0xC2)
        elif isinstance(obj, int):
            _int(out, int(obj))
        elif isinstance(obj, float):
            out += b"\xcb" + struct.pack(">d", obj)
        elif isinstance(obj, str):
            raw = obj.encode("utf-8")
            _len_header(out, len(raw), 0xA0, 31, b"\xda", b"\xdb", b"\xd9")
            out += raw
        elif isinstance(obj, Blob):
            self._bin(obj.parts, obj.nbytes)
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            mv = memoryview(obj).cast("B")
            self._bin([mv], mv.nbytes)
        elif isinstance(obj, (list, tuple)):
            _len_header(out, len(obj), 0x90, 15, b"\xdc", b"\xdd")
            for v in obj:
                self.pack(v)
        elif isinstance(obj, dict):
            _len_header(out, len(obj), 0x80, 15, b"\xde", b"\xdf")
            for k, v in obj.items():
                self.pack(k)
                self.pack(v)
        else:
            raise TypeError(f"cannot msgpack {type(obj).__name__}")

    def finish(self) -> List:
        if self.buf:
            self.parts.append(bytes(self.buf))
            self.buf = bytearray()
        return self.parts


def pack_parts(obj: Any) -> List:
    """msgpack of ``obj`` as a list of buffers (concatenate to get the
    bytes); large bins are not copied."""
    p = _Packer()
    p.pack(obj)
    return p.finish()


def packb(obj: Any) -> bytes:
    return b"".join(pack_parts(obj))


class _Unpacker:
    def __init__(self, data, zero_copy: bool):
        self.mv = memoryview(data).cast("B")
        self.pos = 0
        self.zero_copy = zero_copy

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > self.mv.nbytes:
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def _u(self, fmt: str, n: int) -> int:
        return struct.unpack(fmt, self.take(n))[0]

    def _bin(self, n: int):
        mv = self.take(n)
        return mv if self.zero_copy else bytes(mv)

    def _str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.unpack() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out

    def unpack(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b == 0xC4:
            return self._bin(self._u(">B", 1))
        if b == 0xC5:
            return self._bin(self._u(">H", 2))
        if b == 0xC6:
            return self._bin(self._u(">I", 4))
        if b == 0xCA:
            return self._u(">f", 4)
        if b == 0xCB:
            return self._u(">d", 8)
        ints = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4),
                0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
                0xD2: (">i", 4), 0xD3: (">q", 8)}
        if b in ints:
            return self._u(*ints[b])
        if b == 0xD9:
            return self._str(self._u(">B", 1))
        if b == 0xDA:
            return self._str(self._u(">H", 2))
        if b == 0xDB:
            return self._str(self._u(">I", 4))
        if b == 0xDC:
            return self._array(self._u(">H", 2))
        if b == 0xDD:
            return self._array(self._u(">I", 4))
        if b == 0xDE:
            return self._map(self._u(">H", 2))
        if b == 0xDF:
            return self._map(self._u(">I", 4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def unpackb(data, *, zero_copy: bool = False) -> Any:
    """Decode one msgpack object that spans all of ``data``.  Raises
    ValueError on malformed or trailing data.  ``zero_copy`` returns bins
    as memoryviews into ``data``."""
    u = _Unpacker(data, zero_copy)
    try:
        obj = u.unpack()
    except (struct.error, UnicodeDecodeError, IndexError) as e:
        raise ValueError(f"malformed msgpack data: {e!r}") from e
    if u.pos != u.mv.nbytes:
        raise ValueError("extra data after msgpack object")
    return obj
