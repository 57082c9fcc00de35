"""The proto3 wire format in plain Python, for the messages of
``corev1.proto`` and ``extender.proto``.

The port runs where neither the ``protobuf`` runtime nor ``grpcio`` is
installed, so it keeps its own codec instead of generated ``_pb2``
modules. A message class lists its fields once (``FIELDS``: number, name,
kind); :class:`Message` builds the keyword constructor, the type checks,
``SerializeToString``, ``FromString`` / ``ParseFromString`` and ``==``
from that list.

The bytes are the ones the protobuf runtime writes with
``SerializeToString(deterministic=True)``:

- fields in field-number order;
- a scalar field is written when it differs from its default (a double
  by bit pattern, so ``-0.0`` is written and ``0.0`` is not; a negative
  int32 or int64 as a sign-extended 10-byte varint);
- a singular submessage when it was set, even if empty;
- every element of a repeated field, an empty string or submessage with
  length 0;
- map entries in the runtime's deterministic key order, each entry with
  its key and its value even when they are empty or zero. That order
  (upb's) is bytewise on the UTF-8 key, except that a key comes AFTER
  every key it is a prefix of (``"ab"``, ``"a"``, ``"b"``, ``""``): as if
  each key ended in a byte above all others. 0xFF never occurs in UTF-8,
  so :func:`map_order` appends it.

The reader skips fields it does not know, of wire types 0, 1, 2 and 5,
and merges a submessage that appears twice, as the runtime does.
"""

from __future__ import annotations

import operator
import struct
from typing import Dict, Tuple

#: wire types (encoding.md): varint, fixed64, length-delimited, fixed32
VARINT, FIXED64, LEN, FIXED32 = 0, 1, 2, 5

_U64 = (1 << 64) - 1
_DOUBLE = struct.Struct("<d")
_ZERO8 = b"\x00" * 8

#: scalar kinds -> (wire type, default)
SCALARS = {
    "string": (LEN, ""),
    "bytes": (LEN, b""),
    "bool": (VARINT, False),
    "int32": (VARINT, 0),
    "int64": (VARINT, 0),
    "uint64": (VARINT, 0),
    "enum": (VARINT, 0),
    "double": (FIXED64, 0.0),
}

_RANGES = {
    "int32": (-(1 << 31), 1 << 31),
    "enum": (-(1 << 31), 1 << 31),
    "int64": (-(1 << 63), 1 << 63),
    "uint64": (0, 1 << 64),
}


class DecodeError(ValueError):
    """The bytes are not a valid encoding of the message."""


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def varint(n: int) -> bytes:
    """An unsigned varint; a negative ``n`` is taken modulo 2**64 (the
    sign-extended 10-byte form int32 and int64 use)."""
    n &= _U64
    if n < 0x80:
        return bytes((n,))
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def tag(number: int, wire_type: int) -> bytes:
    return varint((number << 3) | wire_type)


def read_varint(data, pos: int) -> Tuple[int, int]:
    """-> (value, next position); at most 10 bytes."""
    result = shift = 0
    end = len(data)
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _U64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def skip_field(data, pos: int, wire_type: int) -> int:
    """The position after a field's value of ``wire_type``."""
    if wire_type == VARINT:
        return read_varint(data, pos)[1]
    if wire_type == FIXED64:
        pos += 8
    elif wire_type == LEN:
        n, pos = read_varint(data, pos)
        pos += n
    elif wire_type == FIXED32:
        pos += 4
    else:
        raise DecodeError(f"unsupported wire type {wire_type}")
    if pos > len(data):
        raise DecodeError("truncated field")
    return pos


def map_order(key: str) -> bytes:
    """The sort key of a string map key in deterministic serialization."""
    return key.encode("utf-8") + b"\xff"


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


# ---------------------------------------------------------------------------
# values: checks, encoders, decoders by kind
# ---------------------------------------------------------------------------


def check(kind: str, v, where: str):
    """``v`` as the field's Python type; TypeError / ValueError where the
    protobuf runtime refuses it."""
    if kind == "string":
        if not isinstance(v, str):
            raise TypeError(f"{where}: {v!r} has type {type(v).__name__}, "
                            "but expected one of: str")
        return v
    if kind == "bytes":
        if not isinstance(v, (bytes, bytearray)):
            raise TypeError(f"{where}: {v!r} has type {type(v).__name__}, "
                            "but expected one of: bytes")
        return bytes(v)
    if kind == "double":
        if isinstance(v, (str, bytes)) or not hasattr(v, "__float__"):
            raise TypeError(f"{where}: {v!r} has type {type(v).__name__}, "
                            "but expected one of: int, float")
        return float(v)
    if kind == "bool":
        return v if isinstance(v, bool) else bool(operator.index(v))
    try:
        n = operator.index(v)
    except TypeError:
        raise TypeError(f"{where}: {v!r} has type {type(v).__name__}, "
                        "but expected one of: int") from None
    lo, hi = _RANGES[kind]
    if not lo <= n < hi:
        raise ValueError(f"{where}: value out of range: {n}")
    return n


def _enc_value(kind: str, v) -> bytes:
    """A map entry's key or value, written whatever it holds."""
    if kind == "string":
        b = v.encode("utf-8")
        return varint(len(b)) + b
    if kind == "bytes":
        return varint(len(v)) + v
    if kind == "double":
        return _DOUBLE.pack(v)
    return varint(int(v))


def _dec_value(kind: str, data, pos: int, wire_type: int):
    """-> (value, next position) of one scalar of ``kind``; None for the
    value when the wire type does not fit the kind (an unknown field)."""
    want = SCALARS[kind][0]
    if wire_type != want:
        return None, skip_field(data, pos, wire_type)
    if want == LEN:
        n, pos = read_varint(data, pos)
        end = pos + n
        if end > len(data):
            raise DecodeError("truncated length-delimited field")
        raw = bytes(data[pos:end])
        if kind == "string":
            try:
                return raw.decode("utf-8"), end
            except UnicodeDecodeError as e:
                raise DecodeError(f"invalid UTF-8 in a string: {e}") from None
        return raw, end
    if want == FIXED64:
        if pos + 8 > len(data):
            raise DecodeError("truncated fixed64")
        return _DOUBLE.unpack_from(data, pos)[0], pos + 8
    v, pos = read_varint(data, pos)
    if kind == "bool":
        return v != 0, pos
    if kind == "uint64":
        return v, pos
    if kind == "int64":
        return _signed(v, 64), pos
    return _signed(v, 32), pos  # int32, enum


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


class RepeatedScalar(list):
    """A repeated scalar field: a list whose additions are type checked."""

    def __init__(self, kind: str, where: str) -> None:
        super().__init__()
        self._kind, self._where = kind, where

    def append(self, v) -> None:
        super().append(check(self._kind, v, self._where))

    def extend(self, items) -> None:
        if isinstance(items, (str, bytes)):
            raise TypeError(f"{self._where}: expected an iterable of "
                            f"{self._kind}, got {type(items).__name__}")
        kind, where = self._kind, self._where
        super().extend([check(kind, v, where) for v in items])


class RepeatedMessage(list):
    """A repeated submessage field: a list with ``add(**kw)``."""

    def __init__(self, cls, where: str) -> None:
        super().__init__()
        self._cls, self._where = cls, where

    def add(self, **kw):
        m = self._cls(**kw)
        super().append(m)
        return m

    def append(self, m) -> None:
        if not isinstance(m, self._cls):
            raise TypeError(f"{self._where}: expected {self._cls.__name__}, "
                            f"got {type(m).__name__}")
        super().append(m)

    def extend(self, items) -> None:
        for m in items:
            self.append(m)


class ScalarMap(dict):
    """A map field: a dict whose entries are type checked."""

    def __init__(self, kinds: Tuple[str, str], where: str) -> None:
        super().__init__()
        self._kinds, self._where = kinds, where

    def __setitem__(self, k, v) -> None:
        kk, vk = self._kinds
        super().__setitem__(check(kk, k, self._where),
                            check(vk, v, self._where))

    def update(self, items=(), **kw) -> None:
        if hasattr(items, "keys"):
            items = [(k, items[k]) for k in items.keys()]
        elif isinstance(items, (str, bytes)) or not hasattr(items,
                                                            "__iter__"):
            raise TypeError(f"{self._where}: expected a mapping, got "
                            f"{type(items).__name__}")
        for k, v in items:
            self[k] = v
        for k, v in kw.items():
            self[k] = v


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------


class _Sub:
    """A singular submessage field: reads an empty message while unset
    (without setting it, as the runtime does); set means written."""

    def __init__(self, name: str, cls) -> None:
        self.name, self.cls = name, cls

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        v = obj.__dict__.get(self.name)
        return self.cls() if v is None else v

    def __set__(self, obj, v) -> None:
        if v is not None and not isinstance(v, self.cls):
            raise TypeError(f"{type(obj).__name__}.{self.name}: expected "
                            f"{self.cls.__name__}, got {type(v).__name__}")
        obj.__dict__[self.name] = v


class Message:
    """Base of every message class. A subclass sets ``FIELDS``, a tuple of
    ``(number, name, kind)`` where ``kind`` is a scalar kind (see
    ``SCALARS``), ``("message", cls)``, ``("repeated", kind)``,
    ``("repeated", cls)`` or ``("map", key kind, value kind)``."""

    FIELDS: tuple = ()
    _SPECS: Dict[str, tuple] = {}
    _BY_NUMBER: Dict[int, tuple] = {}

    def __init_subclass__(cls, **kw) -> None:
        super().__init_subclass__(**kw)
        specs = []
        for number, name, kind in sorted(cls.FIELDS, key=lambda f: f[0]):
            if isinstance(kind, str):
                role, arg = "scalar", kind
            elif kind[0] == "message":
                role, arg = "message", kind[1]
                setattr(cls, name, _Sub(name, kind[1]))
            elif kind[0] == "repeated":
                if kind[1] not in ("string", "bytes") and not isinstance(
                        kind[1], type):
                    # proto3 packs repeated numbers; no message here has one
                    raise TypeError(f"{cls.__name__}.{name}: repeated "
                                    f"{kind[1]} (packed) is not supported")
                role = ("rmessage" if isinstance(kind[1], type)
                        else "rscalar")
                arg = kind[1]
            else:
                role, arg = "map", (kind[1], kind[2])
            wire = (SCALARS[arg][0] if role in ("scalar", "rscalar")
                    else LEN)
            specs.append((number, name, role, arg, tag(number, wire),
                          f"{cls.__name__}.{name}"))
        cls._SPECS = {s[1]: s for s in specs}
        cls._BY_NUMBER = {s[0]: s for s in specs}
        cls._ORDER = tuple(specs)

    def __init__(self, **kw) -> None:
        d = self.__dict__
        for _n, name, role, arg, _t, where in self._ORDER:
            if role == "scalar":
                d[name] = SCALARS[arg][1]
            elif role == "rscalar":
                d[name] = RepeatedScalar(arg, where)
            elif role == "rmessage":
                d[name] = RepeatedMessage(arg, where)
            elif role == "map":
                d[name] = ScalarMap(arg, where)
            else:
                d[name] = None
        for name, v in kw.items():
            spec = self._SPECS.get(name)
            if spec is None:
                raise ValueError(f'Protocol message {type(self).__name__} '
                                 f'has no "{name}" field.')
            if v is None:
                continue
            role = spec[2]
            if role in ("rscalar", "rmessage"):
                d[name].extend(v)
            elif role == "map":
                d[name].update(v)
            else:
                setattr(self, name, v)

    def __setattr__(self, name, v) -> None:
        spec = self._SPECS.get(name)
        if spec is None:
            raise AttributeError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
        role = spec[2]
        if role == "scalar":
            self.__dict__[name] = check(spec[3], v, spec[5])
        elif role == "message":
            object.__setattr__(self, name, v)
        else:
            raise AttributeError(f"assignment not allowed to repeated or "
                                 f"map field {spec[5]}")

    # -- encoding ----------------------------------------------------------

    def SerializeToString(self, deterministic: bool = True) -> bytes:
        """The message's bytes; always deterministic (map keys sorted)."""
        out = bytearray()
        d = self.__dict__
        for _n, name, role, arg, t, _w in self._ORDER:
            v = d[name]
            if role == "scalar":
                if arg == "double":
                    b = _DOUBLE.pack(v)
                    if b != _ZERO8:
                        out += t
                        out += b
                elif v:
                    out += t
                    if arg == "string":
                        b = v.encode("utf-8")
                        out += varint(len(b))
                        out += b
                    elif arg == "bytes":
                        out += varint(len(v))
                        out += v
                    else:
                        out += varint(int(v))
            elif role == "rscalar":
                for x in v:
                    out += t
                    out += _enc_value(arg, x)
            elif role == "rmessage":
                for m in v:
                    b = m.SerializeToString()
                    out += t
                    out += varint(len(b))
                    out += b
            elif role == "map":
                kk, vk = arg
                vt = tag(2, SCALARS[vk][0])
                for k in sorted(v, key=map_order):
                    b = b"\x0a" + _enc_value(kk, k) + vt + _enc_value(vk,
                                                                     v[k])
                    out += t
                    out += varint(len(b))
                    out += b
            elif v is not None:
                b = v.SerializeToString()
                out += t
                out += varint(len(b))
                out += b
        return bytes(out)

    # -- decoding ----------------------------------------------------------

    @classmethod
    def FromString(cls, data: bytes):
        m = cls()
        m._merge(data, 0, len(data))
        return m

    def ParseFromString(self, data: bytes) -> int:
        """Clear, then read ``data``; returns its length."""
        self.__init__()
        self._merge(data, 0, len(data))
        return len(data)

    def _merge(self, data, pos: int, end: int) -> None:
        d = self.__dict__
        by_number = self._BY_NUMBER
        view = memoryview(data)[:end]
        while pos < end:
            key, pos = read_varint(view, pos)
            number, wire = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            spec = by_number.get(number)
            if spec is None:
                pos = skip_field(view, pos, wire)
                continue
            _n, name, role, arg, _t, _w = spec
            if role in ("scalar", "rscalar"):
                v, pos = _dec_value(arg, view, pos, wire)
                if v is not None:
                    if role == "scalar":
                        d[name] = v
                    else:
                        list.append(d[name], v)
                continue
            if wire != LEN:
                pos = skip_field(view, pos, wire)
                continue
            n, pos = read_varint(view, pos)
            sub_end = pos + n
            if sub_end > end:
                raise DecodeError("truncated submessage")
            if role == "rmessage":
                m = arg()
                m._merge(view, pos, sub_end)
                list.append(d[name], m)
            elif role == "message":
                m = d[name]
                if m is None:
                    m = d[name] = arg()
                m._merge(view, pos, sub_end)
            else:
                kk, vk = arg
                k, v = SCALARS[kk][1], SCALARS[vk][1]
                p = pos
                while p < sub_end:
                    ekey, p = read_varint(view, p)
                    enum_, ewire = ekey >> 3, ekey & 7
                    if enum_ == 1:
                        got, p = _dec_value(kk, view, p, ewire)
                        k = k if got is None else got
                    elif enum_ == 2:
                        got, p = _dec_value(vk, view, p, ewire)
                        v = v if got is None else got
                    else:
                        p = skip_field(view, p, ewire)
                if p != sub_end:
                    raise DecodeError("map entry overruns its length")
                dict.__setitem__(d[name], k, v)
            pos = sub_end
        if pos != end:
            raise DecodeError("field overruns the message")

    # -- comparison --------------------------------------------------------

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        a, b = self.__dict__, other.__dict__
        for _n, name, role, _a, _t, _w in self._ORDER:
            x, y = a[name], b[name]
            if role == "message":
                x = x if x is not None else type(self)._SPECS[name][3]()
                y = y if y is not None else type(self)._SPECS[name][3]()
            if x != y:
                return False
        return True

    __hash__ = None

    def __repr__(self) -> str:
        parts = []
        for _n, name, role, arg, _t, _w in self._ORDER:
            v = self.__dict__[name]
            if role == "scalar" and v == SCALARS[arg][1] and not (
                    arg == "double" and _DOUBLE.pack(v) != _ZERO8):
                continue
            if role != "scalar" and not v:
                continue
            parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"
