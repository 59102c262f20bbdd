"""The msgpack subset of the canonical codec, in pure Python.

The codec's bytes are consensus-critical (transaction ids are Merkle roots
over their SHA-256), so this module reproduces the JAX package's msgpack
calls exactly:

- :func:`packb` gives the bytes of ``msgpack.packb(w, use_bin_type=True,
  strict_types=True)`` for the wire values the codec builds: ``None``,
  ``bool``, ``int`` (-2^63 .. 2^64-1, smallest encoding), ``str``,
  ``bytes``/``bytearray`` (bin), ``list`` and :class:`ExtType`. Types are
  checked exactly (``strict_types``): a subclass, a tuple or any other
  value raises ``TypeError``; nesting deeper than 511 raises
  ``ValueError`` as msgpack's recursion limit does.
- :func:`unpackb` reads what ``msgpack.unpackb(b, raw=False,
  strict_map_key=False, ext_hook=ExtType)`` reads — every msgpack format,
  maps and floats included, ext type -1 as a :class:`Timestamp` — and
  raises where it raises: truncated input, trailing bytes, the unused
  0xc1 byte, invalid UTF-8, negative ext codes other than -1, malformed
  timestamps, unhashable map keys and more than 1024 nested containers.
  The exception types may differ; the codec turns every one of them into a
  ``SerializationError``.
"""
from __future__ import annotations

import struct
from collections import namedtuple

#: msgpack's packing recursion limit (``DEFAULT_RECURSE_LIMIT``).
_RECURSE_LIMIT = 511
#: msgpack's unpacking container stack (``STACK_SIZE`` of its C unpacker).
_STACK_LIMIT = 1024


class UnpackError(ValueError):
    """Malformed msgpack bytes."""


class ExtraData(UnpackError):
    """A complete object followed by more bytes."""


class ExtType(namedtuple("ExtType", "code data")):
    """An application-defined msgpack extension value (codes 0..127)."""

    def __new__(cls, code, data):
        if not isinstance(code, int):
            raise TypeError("code must be int")
        if not isinstance(data, bytes):
            raise TypeError("data must be bytes")
        if not 0 <= code <= 127:
            raise ValueError("code must be 0~127")
        return super().__new__(cls, code, data)


class Timestamp:
    """msgpack's timestamp extension (type -1), as msgpack decodes it."""

    __slots__ = ("seconds", "nanoseconds")

    def __init__(self, seconds: int, nanoseconds: int = 0):
        if not 0 <= nanoseconds < 10**9:
            raise ValueError("nanoseconds must be a non-negative integer "
                             "less than 999999999.")
        self.seconds = seconds
        self.nanoseconds = nanoseconds

    @staticmethod
    def from_bytes(b: bytes) -> "Timestamp":
        if len(b) == 4:
            return Timestamp(struct.unpack("!L", b)[0], 0)
        if len(b) == 8:
            data64 = struct.unpack("!Q", b)[0]
            return Timestamp(data64 & 0x00000003FFFFFFFF, data64 >> 34)
        if len(b) == 12:
            nanoseconds, seconds = struct.unpack("!Iq", b)
            return Timestamp(seconds, nanoseconds)
        raise UnpackError("Timestamp type can only be created from 32, 64, "
                          "or 96-bit byte objects")

    def __eq__(self, other):
        return (type(other) is Timestamp and self.seconds == other.seconds
                and self.nanoseconds == other.nanoseconds)

    def __hash__(self):
        return hash((self.seconds, self.nanoseconds))

    def __repr__(self):
        return (f"Timestamp(seconds={self.seconds}, "
                f"nanoseconds={self.nanoseconds})")


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + v.to_bytes(1, "big")
        elif v <= 0xFFFF:
            out += b"\xcd" + v.to_bytes(2, "big")
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + v.to_bytes(4, "big")
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + v.to_bytes(8, "big")
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -(1 << 7):
        out += b"\xd0" + v.to_bytes(1, "big", signed=True)
    elif v >= -(1 << 15):
        out += b"\xd1" + v.to_bytes(2, "big", signed=True)
    elif v >= -(1 << 31):
        out += b"\xd2" + v.to_bytes(4, "big", signed=True)
    elif v >= -(1 << 63):
        out += b"\xd3" + v.to_bytes(8, "big", signed=True)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(out: bytearray, n: int, codes: tuple, what: str) -> None:
    """Header of an 8/16/32-bit length (``codes`` the three type bytes;
    None where the width does not exist)."""
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"{what} is too large")


def packb(obj) -> bytes:
    out = bytearray()
    stack = [(obj, _RECURSE_LIMIT)]
    while stack:
        o, limit = stack.pop()
        if limit < 0:
            raise ValueError("recursion limit exceeded.")
        t = type(o)
        if o is None:
            out.append(0xC0)
        elif t is bool:
            out.append(0xC3 if o else 0xC2)
        elif t is int:
            _pack_int(out, o)
        elif t is str:
            b = o.encode("utf-8")
            n = len(b)
            if n < 32:
                out.append(0xA0 | n)
            else:
                _pack_len(out, n, (0xD9, 0xDA, 0xDB), "String")
            out += b
        elif t is bytes or t is bytearray:
            _pack_len(out, len(o), (0xC4, 0xC5, 0xC6), "Bytes object")
            out += o
        elif t is list:
            n = len(o)
            if n < 16:
                out.append(0x90 | n)
            else:
                _pack_len(out, n, (None, 0xDC, 0xDD), "list")
            stack.extend((x, limit - 1) for x in reversed(o))
        elif t is ExtType:
            n = len(o.data)
            fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
            if fix is not None:
                out.append(fix)
            else:
                _pack_len(out, n, (0xC7, 0xC8, 0xC9), "EXT data")
            out.append(o.code)
            out += o.data
        else:
            raise TypeError(f"can not serialize {t.__name__!r} object")
    return bytes(out)


# ---------------------------------------------------------------------------
# Unpacking
# ---------------------------------------------------------------------------

# fixed-width numbers: header byte -> struct format; the other tables map a
# header byte to the byte width of its length field
_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN_FMT = {1: ">B", 2: ">H", 4: ">I"}
_STR_LEN = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN_LEN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_EXT_LEN = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_ARRAY_LEN = {0xDC: 2, 0xDD: 4}
_MAP_LEN = {0xDE: 2, 0xDF: 4}


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise UnpackError("Unpack failed: incomplete input")
        b = self.buf[self.pos:end]
        self.pos = end
        return b

    def length(self, width: int) -> int:
        return struct.unpack(_LEN_FMT[width], self.take(width))[0]


def _ext(code: int, data: bytes):
    if code == -1:
        return Timestamp.from_bytes(data)
    return ExtType(code, data)


def _scalar_or_header(r: _Reader):
    """Read one header: returns ("value", v), ("array", n) or ("map", n)."""
    b = r.take(1)[0]
    if b < 0x80:
        return "value", b
    if b >= 0xE0:
        return "value", b - 0x100
    if b < 0x90:
        return "map", b & 0x0F
    if b < 0xA0:
        return "array", b & 0x0F
    if b < 0xC0:
        return "value", r.take(b & 0x1F).decode("utf-8")
    if b == 0xC0:
        return "value", None
    if b == 0xC2:
        return "value", False
    if b == 0xC3:
        return "value", True
    fmt = _FIXED.get(b)
    if fmt is not None:
        return "value", struct.unpack(fmt, r.take(struct.calcsize(fmt)))[0]
    if b in _STR_LEN:
        return "value", r.take(r.length(_STR_LEN[b])).decode("utf-8")
    if b in _BIN_LEN:
        return "value", r.take(r.length(_BIN_LEN[b]))
    if b in _EXT_LEN:
        n = r.length(_EXT_LEN[b])
        code = struct.unpack(">b", r.take(1))[0]
        return "value", _ext(code, r.take(n))
    if b in _FIXEXT:
        code = struct.unpack(">b", r.take(1))[0]
        return "value", _ext(code, r.take(_FIXEXT[b]))
    if b in _ARRAY_LEN:
        return "array", r.length(_ARRAY_LEN[b])
    if b in _MAP_LEN:
        return "map", r.length(_MAP_LEN[b])
    raise UnpackError(f"Unknown header: 0x{b:x}")  # 0xc1


def unpackb(data):
    # bytes-like only, as msgpack (bytes(5) or bytes([1]) would succeed)
    r = _Reader(bytes(memoryview(data)))
    # open containers: [kind, items left, container, map key, key read]
    stack: list[list] = []
    while True:
        kind, v = _scalar_or_header(r)
        if kind != "value":
            if len(stack) >= _STACK_LIMIT:
                raise UnpackError("Unpack failed: nesting too deep")
            if v:
                stack.append([kind, v, [] if kind == "array" else {}, None,
                              False])
                continue
            v = [] if kind == "array" else {}
        # attach the finished value v, closing every container it completes
        while stack:
            top = stack[-1]
            if top[0] == "array":
                top[2].append(v)
            elif not top[4]:          # v is a map key
                top[3], top[4] = v, True
                break
            else:
                top[2][top[3]] = v
                top[3], top[4] = None, False
            top[1] -= 1
            if top[1]:
                break
            stack.pop()
            v = top[2]
        else:
            if r.pos != len(r.buf):
                raise ExtraData("unpack(b) received extra data.")
            return v
