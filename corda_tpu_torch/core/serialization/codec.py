"""The canonical binary codec.

Port of corda_tpu/core/serialization/codec.py, byte-identical to it. The
msgpack layer is the port's own pure-Python subset (``_msgpack``): the
card's machine has no ``msgpack`` package.

Wire model: every value is transformed into a *wire tree* of msgpack-safe primitives
(None, bool, int64, bytes, str, list) plus tagged ExtType wrappers for everything
else, then packed with msgpack in one pass:

- ``ExtType(1, …)``  OBJ     — registered type: packb([type_name, [field wires…]])
- ``ExtType(2, …)``  MAP     — dict: packb([[k, v]…]) sorted by packed key bytes
- ``ExtType(3, …)``  SET     — set/frozenset: packb([…]) sorted by packed bytes
- ``ExtType(4, …)``  BIGINT  — arbitrary-precision int: sign byte + magnitude
- ``ExtType(5, …)``  ENUM    — packb([enum_type_name, member_name])

Registered types declare their wire fields; deserialization only ever constructs
registered types (whitelist enforcement).
"""
from __future__ import annotations

import dataclasses
import datetime
import enum
from typing import Any, Callable

from ..crypto.secure_hash import SecureHash
from . import _msgpack
from ._msgpack import ExtType

FORMAT_VERSION = 1
_MAGIC = b"\xc0\x9d\xa1" + bytes([FORMAT_VERSION])  # leads every top-level message

_EXT_OBJ = 1
_EXT_MAP = 2
_EXT_SET = 3
_EXT_BIGINT = 4
_EXT_ENUM = 5
_EXT_INSTANT = 6  # UTC datetime as epoch-microseconds (big-endian i64)
_EXT_OBJ_SCHEMA = 7  # [name, [field names], fields] — carpentable object

_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1


class SerializationError(Exception):
    pass


_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def exact_epoch_micros(t: datetime.datetime) -> int:
    """Exact integer epoch-microseconds (no float path — ``timestamp()`` truncation
    corrupts ~1% of microsecond values, which would fork consensus hashes)."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=datetime.timezone.utc)
    return (t - _EPOCH) // datetime.timedelta(microseconds=1)


# ---------------------------------------------------------------------------
# Type registry (the whitelist)
# ---------------------------------------------------------------------------

# name -> (cls, to_fields, from_fields)
_REGISTRY: dict[str, tuple[type, Callable, Callable]] = {}
_BY_CLASS: dict[type, str] = {}
_ENUM_REGISTRY: dict[str, type] = {}
# schema-carrying types (name -> field names); their wire form embeds the
# field names so receivers WITHOUT the class can still materialize them
_SCHEMA_NAMES: dict[str, list[str]] = {}
# receiver-side synthesized classes for unknown schema'd names
# (ClassCarpenter.kt:30-447 analog) — deliberately NOT in _REGISTRY: the
# trusted whitelist stays authoritative, and a later real registration of
# the same name simply wins for subsequent decodes
_CARPENTED: dict[str, tuple[type, list[str]]] = {}
_CARPENTED_BY_CLASS: dict[type, str] = {}


def register_type(name: str, cls: type,
                  to_fields: Callable[[Any], list] | None = None,
                  from_fields: Callable[[list], Any] | None = None,
                  carry_schema: bool = False) -> None:
    """Register a type for serialization. Defaults handle dataclasses (fields in
    declaration order — deterministic).

    ``carry_schema=True`` writes the field NAMES onto the wire so a receiver
    that does not know the class can carpent a property-bag stand-in
    (see :func:`carpented_class`) — use it for types expected to travel to
    nodes without the defining CorDapp module."""
    if name in _REGISTRY and _REGISTRY[name][0] is not cls:
        raise SerializationError(f"Serialization name collision: {name!r}")
    if carry_schema and (to_fields is not None or from_fields is not None):
        # the carried names are the dataclass's declared fields; a custom
        # codec could reorder/transform values, silently binding receivers'
        # carpented attributes to the wrong values
        raise SerializationError(
            "carry_schema requires the default dataclass field codec")
    if to_fields is None or from_fields is None or carry_schema:
        if not dataclasses.is_dataclass(cls):
            raise SerializationError(
                f"{cls!r} is not a dataclass; provide to_fields/from_fields"
                + (" (carry_schema needs dataclass field names)"
                   if carry_schema else ""))
        field_names = [f.name for f in dataclasses.fields(cls)]
        to_fields = to_fields or (lambda obj, _fn=field_names:
                                  [getattr(obj, n) for n in _fn])
        # Sequences decode as lists; dataclass wire types are immutable, so coerce
        # top-level list fields back to tuples for equality/hashability.
        from_fields = from_fields or (
            lambda fields, _c=cls: _c(*[tuple(f) if isinstance(f, list) else f
                                        for f in fields]))
        if carry_schema:
            _SCHEMA_NAMES[name] = field_names
    _REGISTRY[name] = (cls, to_fields, from_fields)
    _BY_CLASS[cls] = name


#: Cap on distinct carpented names: classes are heavyweight and live
#: instances pin them, so eviction would fork a name across two classes —
#: refuse instead (no legitimate peer set ships thousands of state types).
_CARPENTED_MAX = 4096
#: Cap on fields per carpented schema: make_dataclass execs a class body
#: sized by the field count, and carpented classes are pinned for the
#: process lifetime — an unbounded count is a wire-reachable memory/CPU
#: sink. No legitimate state type approaches this.
_CARPENTED_MAX_FIELDS = 256


def carpented_class(name: str, field_names: list[str]) -> type:
    """Synthesize (once per name+schema) a frozen-dataclass property bag for
    a schema'd wire object whose real class is absent — the runtime class
    synthesis of the reference's ClassCarpenter, minus bytecode: the bag is
    inert data (no methods), so the deserialization whitelist's gadget
    protection is preserved.

    SCHEMA EVOLUTION: a second schema under the same name carpents the
    UNION of all fields seen so far (stable order: first-seen first) and
    becomes the name's class for subsequent decodes — every field defaults
    to None, so a wire form carrying any subset still materializes
    (reference evolution direction: ClassCarpenter.kt:30-447 +
    amqp/SerializerFactory.kt).  Each carpented CLASS remembers its own
    schema (``__corda_carpented_fields__``): instances re-serialize under
    the schema they were built with — a bag decoded before an evolution
    stays bit-exact on re-serialization; a union bag re-serializes under
    the union schema.  Unions grow monotonically and the per-schema field
    cap bounds them, so a hostile peer cannot mint unbounded classes for
    one name.  Every hostile-input failure mode is a SerializationError."""
    entry = _CARPENTED.get(name)
    if entry is not None:
        cls, known = entry
        if known == list(field_names):
            return cls
        union = list(known) + [fn for fn in field_names if fn not in known]
        if union == known:        # subset of what we already know
            return cls
        return _carpent(name, union)
    return _carpent(name, list(field_names))


#: Total class syntheses (first carpents AND union evolutions): every
#: synthesized class is pinned for the process lifetime, so the budget
#: must count evolutions too — otherwise a hostile peer could stream
#: one-field-at-a-time schema changes and mint ~256 classes per name
#: beyond the name cap.
_carpent_count = 0


def _carpent(name: str, field_names: list[str]) -> type:
    import keyword

    global _carpent_count
    if _carpent_count >= _CARPENTED_MAX:
        raise SerializationError(
            f"Carpented-class budget ({_CARPENTED_MAX}) exhausted; "
            f"refusing to synthesize {name!r}")
    if not isinstance(name, str) or not name:
        raise SerializationError(f"Bad carpented type name {name!r}")
    if len(field_names) > _CARPENTED_MAX_FIELDS:
        raise SerializationError(
            f"Carpented schema for {name!r} has {len(field_names)} fields "
            f"(limit {_CARPENTED_MAX_FIELDS})")
    seen = set()
    for fn in field_names:
        if (not isinstance(fn, str) or not fn.isidentifier()
                or fn.startswith("__") or keyword.iskeyword(fn)
                or fn in seen):
            raise SerializationError(f"Bad carpented field name {fn!r}")
        seen.add(fn)
    try:
        cls = dataclasses.make_dataclass(
            name.rsplit(".", 1)[-1] or "Carpented",
            [(fn, Any, dataclasses.field(default=None))
             for fn in field_names],
            frozen=True, eq=True)
    except (TypeError, ValueError) as e:
        raise SerializationError(
            f"Cannot carpent {name!r}: {e}") from e
    cls.__corda_carpented__ = name
    cls.__corda_carpented_fields__ = list(field_names)
    _CARPENTED[name] = (cls, list(field_names))
    _CARPENTED_BY_CLASS[cls] = name
    _carpent_count += 1
    return cls


def serializable(name: str | None = None,
                 to_fields: Callable | None = None,
                 from_fields: Callable | None = None):
    """Class decorator: ``@serializable()`` registers the class under its qualname."""
    def wrap(cls):
        reg_name = name or cls.__name__
        if issubclass(cls, enum.Enum):
            _ENUM_REGISTRY[reg_name] = cls
            cls.__corda_enum_name__ = reg_name
        else:
            register_type(reg_name, cls, to_fields, from_fields)
        return cls
    return wrap


def registered_name(cls: type) -> str | None:
    return _BY_CLASS.get(cls)


# ---------------------------------------------------------------------------
# Wire-tree transform
# ---------------------------------------------------------------------------

def _packb(wire) -> bytes:
    return _msgpack.packb(wire)


def to_wire(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    if isinstance(obj, int) and not isinstance(obj, bool):
        if _I64_MIN <= obj <= _I64_MAX:
            return obj
        sign = 1 if obj >= 0 else 0
        mag = abs(obj)
        return ExtType(_EXT_BIGINT, bytes([sign]) +
                               mag.to_bytes((mag.bit_length() + 7) // 8 or 1, "big"))
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return bytes(obj)
    if isinstance(obj, float):
        raise SerializationError(
            "Floats are not permitted in consensus data (non-deterministic); "
            "use integer quantities (Amount semantics)")
    if isinstance(obj, (list, tuple)):
        return [to_wire(x) for x in obj]
    if isinstance(obj, dict):
        pairs = sorted(([_packb(to_wire(k)), to_wire(v)] for k, v in obj.items()),
                       key=lambda kv: kv[0])
        return ExtType(_EXT_MAP, _packb(pairs))
    if isinstance(obj, (set, frozenset)):
        elems = sorted(_packb(to_wire(x)) for x in obj)
        return ExtType(_EXT_SET, _packb(elems))
    if isinstance(obj, datetime.datetime):
        return ExtType(_EXT_INSTANT,
                               exact_epoch_micros(obj).to_bytes(8, "big", signed=True))
    if isinstance(obj, enum.Enum):
        ename = getattr(type(obj), "__corda_enum_name__", None)
        if ename is None:
            raise SerializationError(f"Enum {type(obj)!r} is not @serializable")
        return ExtType(_EXT_ENUM, _packb([ename, obj.name]))
    name = _BY_CLASS.get(type(obj))
    if name is None:
        cname = _CARPENTED_BY_CLASS.get(type(obj))
        if cname is not None:
            # carpented bag: re-serializes under ITS OWN schema (the one
            # its class was built with), so pre-evolution instances stay
            # bit-exact and union bags emit the union schema
            field_names = type(obj).__corda_carpented_fields__
            fields = [to_wire(getattr(obj, fn)) for fn in field_names]
            return ExtType(_EXT_OBJ_SCHEMA,
                                   _packb([cname, field_names, fields]))
        raise SerializationError(
            f"Type {type(obj).__module__}.{type(obj).__qualname__} is not registered "
            f"for serialization (whitelist violation)")
    _, to_fields, _ = _REGISTRY[name]
    fields = [to_wire(f) for f in to_fields(obj)]
    schema = _SCHEMA_NAMES.get(name)
    if schema is not None:
        return ExtType(_EXT_OBJ_SCHEMA, _packb([name, schema, fields]))
    return ExtType(_EXT_OBJ, _packb([name, fields]))


def _unpackb(data: bytes):
    return _msgpack.unpackb(data)


def from_wire(wire: Any) -> Any:
    if wire is None or isinstance(wire, (bool, int, str, bytes)):
        return wire
    # NB: ExtType subclasses tuple, so it must be checked before the sequence case.
    if isinstance(wire, ExtType):
        code, data = wire.code, wire.data
        if code == _EXT_BIGINT:
            if len(data) < 2:
                raise SerializationError("Truncated bigint")
            val = int.from_bytes(data[1:], "big")
            return val if data[0] else -val
        if code == _EXT_MAP:
            return {_freeze(from_wire(_unpackb(k))): from_wire(v)
                    for k, v in _unpackb(data)}
        if code == _EXT_SET:
            return frozenset(_freeze(from_wire(_unpackb(e))) for e in _unpackb(data))
        if code == _EXT_INSTANT:
            micros = int.from_bytes(data, "big", signed=True)
            return datetime.datetime.fromtimestamp(micros / 1_000_000,
                                                   tz=datetime.timezone.utc)
        if code == _EXT_ENUM:
            ename, member = _unpackb(data)
            cls = _ENUM_REGISTRY.get(ename)
            if cls is None:
                raise SerializationError(f"Enum {ename!r} is not whitelisted")
            return cls[member]
        if code == _EXT_OBJ:
            name, fields = _unpackb(data)
            entry = _REGISTRY.get(name)
            if entry is None:
                raise SerializationError(f"Type {name!r} is not whitelisted")
            _, _, from_fields = entry
            return from_fields([from_wire(f) for f in fields])
        if code == _EXT_OBJ_SCHEMA:
            name, field_names, fields = _unpackb(data)
            if len(field_names) != len(fields):
                raise SerializationError(
                    f"Schema'd object {name!r}: {len(field_names)} names "
                    f"vs {len(fields)} fields")
            if len(set(field_names)) != len(field_names):
                # a duplicated name is always hostile/corrupt wire: binding
                # would silently keep only the last value (dict semantics in
                # both the by-name rebind and the carpenter kwargs)
                seen: set = set()
                dupes = sorted({fn for fn in field_names
                                if fn in seen or seen.add(fn)})
                raise SerializationError(
                    f"Schema'd object {name!r}: duplicate field names "
                    f"{dupes}")
            entry = _REGISTRY.get(name)
            if entry is not None:       # the real class is known: it wins
                cls, _, from_fields = entry
                # Bind by NAME against the local declaration, never by wire
                # position: a peer whose version declares fields in a
                # different order (schema skew) must not silently bind
                # values to the wrong attributes.
                local = _SCHEMA_NAMES.get(name)
                if local is None and dataclasses.is_dataclass(cls):
                    local = [f.name for f in dataclasses.fields(cls)]
                if local is not None and list(field_names) != local:
                    if sorted(field_names) == sorted(local):
                        by_name = dict(zip(field_names, fields))
                        fields = [by_name[n] for n in local]
                    elif name in _SCHEMA_NAMES:
                        # SCHEMA EVOLUTION (reference ClassCarpenter.kt +
                        # amqp/SerializerFactory.kt evolution direction):
                        # a peer on another VERSION of the type — fields
                        # it doesn't carry fill from local dataclass
                        # defaults; fields the local version dropped are
                        # ignored. Only carry_schema types qualify (their
                        # codec is the default dataclass one, so binding
                        # by declaration order is sound); no default for
                        # a missing field ⇒ genuinely incompatible.
                        return _evolved_decode(name, cls, local,
                                               field_names, fields)
                    else:
                        raise SerializationError(
                            f"Schema'd object {name!r}: carried fields "
                            f"{sorted(field_names)} do not match local "
                            f"declaration {sorted(local)}")
                try:
                    return from_fields([from_wire(f) for f in fields])
                except TypeError as e:
                    raise SerializationError(
                        f"Schema'd object {name!r} does not fit local "
                        f"class: {e}") from e
            cls = carpented_class(name, field_names)
            return cls(**{fn: _freeze(from_wire(f))
                          for fn, f in zip(field_names, fields)})
        raise SerializationError(f"Unknown ext code {code}")
    if isinstance(wire, (list, tuple)):
        return [from_wire(x) for x in wire]
    raise SerializationError(f"Unexpected wire value of type {type(wire)!r}")


def _freeze(v):
    return tuple(v) if isinstance(v, list) else v


def _evolved_decode(name: str, cls, local: list[str], field_names, fields):
    """Decode a schema'd object whose carried field set differs from the
    local version of the class: carried-and-local fields bind by name,
    locally-ADDED fields take the dataclass default (the v1→v2 direction),
    carried-but-REMOVED fields are dropped (v2→v1).  A locally-added field
    WITHOUT a default is a genuine incompatibility and fails typed."""
    by_name = {fn: from_wire(v) for fn, v in zip(field_names, fields)}
    spec = {f.name: f for f in dataclasses.fields(cls)}
    vals = []
    for n in local:
        if n in by_name:
            vals.append(_freeze(by_name[n]))
            continue
        f = spec[n]
        # defaults freeze like carried values do (a list default becomes a
        # tuple): evolved instances must hash/compare like native ones
        if f.default is not dataclasses.MISSING:
            vals.append(_freeze(f.default))
        elif f.default_factory is not dataclasses.MISSING:
            vals.append(_freeze(f.default_factory()))
        else:
            raise SerializationError(
                f"Schema'd object {name!r}: peer version lacks field "
                f"{n!r} and the local class declares no default for it")
    try:
        return cls(*vals)
    except TypeError as e:
        raise SerializationError(
            f"Schema'd object {name!r} does not fit local class: {e}"
        ) from e


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def serialize(obj: Any) -> bytes:
    return _MAGIC + _packb(to_wire(obj))


def deserialize(data: bytes) -> Any:
    if len(data) < 4 or data[:3] != _MAGIC[:3]:
        raise SerializationError("Bad magic: not corda_tpu canonical bytes")
    if data[3] != FORMAT_VERSION:
        raise SerializationError(f"Unsupported format version {data[3]}")
    try:
        return from_wire(_unpackb(data[4:]))
    except SerializationError:
        raise
    except Exception as e:
        # Untrusted wire bytes must always fail typed, never leak raw decode errors.
        raise SerializationError(f"Malformed canonical bytes: {type(e).__name__}: {e}") from e


def serialized_hash(obj: Any) -> SecureHash:
    """Merkle component leaf hash: SHA-256 of the canonical bytes (magic included,
    so leaves are domain-separated from raw user bytes)."""
    return SecureHash.sha256(serialize(obj))
