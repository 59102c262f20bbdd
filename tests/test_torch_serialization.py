"""The port's canonical codec (its own msgpack subset, no ``msgpack``
package) against the JAX package's: byte-identical ``serialize`` output,
``deserialize`` that reads the JAX bytes into the port's classes and writes
them back unchanged, and the same refusals — every hostile or truncated
input raises ``SerializationError`` in both packages.

Every comparison is exact (bytes equal). Test-only types are registered in
both packages under names of their own.
"""
import dataclasses
import datetime
import enum
import random

import msgpack
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

import corda_tpu.core.serialization as jser
import corda_tpu_torch.core.serialization as tser
from corda_tpu.core.serialization import codec as jcodec
from corda_tpu_torch.core.serialization import _msgpack
from corda_tpu_torch.core.serialization import codec as tcodec
from test_torch_transactions import (cash_wtx, oracle_wtx, pkgs,
                                     reveals_fix)


@jser.serializable("test_torch_serialization.Color")
class JaxColor(enum.Enum):
    RED = 1
    GREEN = 2


@tser.serializable("test_torch_serialization.Color")
class PortColor(enum.Enum):
    RED = 1
    GREEN = 2


def _same(value_jax, value_port=None):
    """serialize in both packages: the bytes are equal; the port reads the
    JAX bytes and writes what the JAX package writes after reading them
    (or refuses them as it does: the JAX package cannot read back an
    instant whose float conversion leaves datetime's range)."""
    value_port = value_jax if value_port is None else value_port
    raw = jser.serialize(value_jax)
    assert tser.serialize(value_port) == raw
    assert _outcome(tser, tcodec, raw) == _outcome(jser, jcodec, raw)
    return raw


# ---------------------------------------------------------------------------
# Wire values: every msgpack width boundary
# ---------------------------------------------------------------------------

_INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
              2**63 - 1, 2**63, 2**64 - 1, 2**64, 2**200, -1, -32, -33,
              -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
              -2**63 - 1, -2**64, -2**300]
_LEN_EDGES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]

_scalars = st.one_of(
    st.none(), st.booleans(),
    st.integers(), st.sampled_from(_INT_EDGES),
    st.text(max_size=40), st.binary(max_size=40))
_hashable = st.one_of(st.none(), st.booleans(), st.integers(),
                      st.text(max_size=12), st.binary(max_size=12))
_values = st.recursive(
    st.one_of(
        _scalars,
        st.frozensets(_hashable, max_size=20),
        st.datetimes(timezones=st.just(datetime.timezone.utc)),
        st.datetimes(),
        st.sampled_from(list(JaxColor))),
    lambda inner: st.one_of(
        st.lists(inner, max_size=18),
        st.tuples(inner, inner),
        st.dictionaries(_hashable, inner, max_size=6)),
    max_leaves=40)


def _to_port(v):
    """A wire value of JaxColor members, as the port's PortColor."""
    if isinstance(v, JaxColor):
        return PortColor[v.name]
    if isinstance(v, list):
        return [_to_port(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_to_port(x) for x in v)
    if isinstance(v, dict):
        return {k: _to_port(x) for k, x in v.items()}
    return v


@settings(max_examples=400, deadline=None)
@given(_values)
@example(_INT_EDGES)
@example(["x" * n for n in _LEN_EDGES])
@example([b"y" * n for n in _LEN_EDGES])
@example([[0] * n for n in _LEN_EDGES])
@example([frozenset(range(n)) for n in range(20)])   # fixext 1/4/16, ext8
@example([frozenset([b"z" * n]) for n in (250, 251, 252, 65530, 65533)])
@example({k: k for k in range(20)})
@example([datetime.datetime(1, 1, 1), datetime.datetime(9999, 12, 31,
                                                        23, 59, 59, 999999)])
@example(list(JaxColor) + [set(), frozenset(), {}, (), []])
def test_wire_values_serialize_identically(value):
    _same(value, _to_port(value))


def test_ext_widths_reach_every_msgpack_ext_form():
    """The boundary examples above really produce every ext form the codec
    can emit — fixext 1, 4, 8 (an instant), 16 and ext 8/16/32 (fixext 2
    is unreachable: no codec ext payload is two bytes long; the msgpack
    layer is held to msgpack on it below) — and str8/16/32, bin8/16/32,
    array16/32."""
    seen = {tser.serialize(datetime.datetime(2026, 1, 1))[4]}
    for n in range(20):
        seen.add(tser.serialize(frozenset(range(n)))[4])
    for n in (300, 70000):
        seen.add(tser.serialize(frozenset([b"z" * n]))[4])
    assert {0xD4, 0xD6, 0xD7, 0xD8, 0xC7, 0xC8, 0xC9} <= seen
    heads = {tser.serialize(v)[4] for v in (
        "a" * 32, "a" * 256, "a" * 65536, b"b", b"b" * 256, b"b" * 65536,
        [0] * 16, [0] * 65536)}
    assert heads == {0xD9, 0xDA, 0xDB, 0xC4, 0xC5, 0xC6, 0xDC, 0xDD}


def test_msgpack_subset_equals_msgpack_on_wire_trees():
    rng = random.Random(11)

    def tree(depth):
        k = rng.randrange(8 if depth < 4 else 6)
        if k == 0:
            return None
        if k == 1:
            return rng.random() < 0.5
        if k == 2:
            return rng.choice(_INT_EDGES[:-4]) + rng.randrange(-3, 4) * (
                rng.random() < 0.3)
        if k == 3:
            return "é" * rng.choice(_LEN_EDGES[:8])
        if k == 4:
            return bytes(rng.choice(_LEN_EDGES))
        if k == 5:
            return _msgpack.ExtType(rng.randrange(128),
                                    bytes(rng.choice(range(20))))
        return [tree(depth + 1) for _ in range(rng.choice((0, 1, 3, 15, 16)))]

    def as_msgpack(w):
        if isinstance(w, _msgpack.ExtType):
            return msgpack.ExtType(w.code, w.data)
        if isinstance(w, list):
            return [as_msgpack(x) for x in w]
        return w
    for _ in range(300):
        w = tree(0)
        try:
            want = msgpack.packb(as_msgpack(w), use_bin_type=True,
                                 strict_types=True)
        except OverflowError:
            with pytest.raises(OverflowError):
                _msgpack.packb(w)
            continue
        assert _msgpack.packb(w) == want
        back = msgpack.unpackb(want, raw=False, strict_map_key=False,
                               ext_hook=lambda c, d: msgpack.ExtType(c, d))
        assert as_msgpack(_msgpack.unpackb(want)) == back


def test_packing_refusals_match_msgpack():
    class IntLike(int):
        pass

    deep = 1
    for _ in range(600):
        deep = [deep]
    for v in (IntLike(3), (1, 2), 2**64, -2**63 - 1, "a\ud800", deep):
        try:
            msgpack.packb(v, use_bin_type=True, strict_types=True)
            want = None
        except Exception as exc:   # the refusal under comparison
            want = type(exc)
        with pytest.raises(want):
            _msgpack.packb(v)
    for ser in (jser, tser):
        with pytest.raises(ValueError, match="recursion limit"):
            ser.serialize(deep)
        with pytest.raises(jcodec.SerializationError if ser is jser
                           else tcodec.SerializationError):
            ser.serialize(1.5)


# ---------------------------------------------------------------------------
# Component types, carpented and evolved objects
# ---------------------------------------------------------------------------

def _components(P):
    """One of every type on the slice's path, built in package ``P``."""
    C, crypto = P.contracts, P.crypto
    wtx = oracle_wtx(P, 1, time_window=True)
    cash = cash_wtx(P, 2)
    ftx = wtx.build_filtered_transaction(reveals_fix(P))
    sig = crypto.Crypto.sign_with_key(P.kp["alice"], wtx.id.bytes)
    composite = crypto.CompositeKey.Builder().add_key(
        P.key["alice"], 2).add_keys(P.key["bob"], P.key["carol"]).build(3)
    nested = crypto.CompositeKey.Builder().add_keys(
        composite, P.key["notary"]).build(1)
    party = P.identity.Party(P.identity.CordaX500Name(
        "Rates Oracle", "London", "GB", common_name="cn",
        organisation_unit="ou", state="st"), P.key["oracle"])
    state = C.TransactionState(P.dummy.DummyState(9, (P.key["bob"],)),
                               P.notary, encumbrance=None)
    ref = C.StateRef(crypto.SecureHash.sha256(b"ref"), 3)
    fix_of = P.oracle.FixOf("ICE LIBOR", "2016-03-16", "3M")
    return {
        "SecureHash": crypto.SecureHash.sha256(b"x"),
        "PublicKeys": [P.key[n] for n in P.key],
        "CompositeKey": [composite, nested],
        "DigitalSignature": sig.without_key(),
        "DigitalSignature.WithKey": sig,
        "CordaX500Name": party.name,
        "Party": party,
        "AnonymousParty": party.anonymise(),
        "PartyAndReference": party.ref(1, 2, 3),
        "Issued": C.Issued(party.ref(4), "GBP"),
        "UniqueIdentifier": C.UniqueIdentifier("ext", "fixed-id"),
        "TransactionState": state,
        "StateRef": ref,
        "StateAndRef": C.StateAndRef(state, ref),
        "Command": C.Command(P.dummy.DummyContract.Move(),
                             (P.key["alice"], P.key["bob"])),
        "Fix": P.oracle.Fix(fix_of, 525),
        "FixOf": fix_of,
        "TimeWindow": [C.TimeWindow(None, 5), C.TimeWindow(-7, None),
                       wtx.time_window],
        "TransactionType": [C.TransactionType.General,
                            C.TransactionType.NotaryChange],
        "Attachment": C.Attachment.of(b"attachment bytes"),
        "DummyContract": P.dummy.DummyContract(),
        "ScheduledActivity": C.ScheduledActivity(
            "flow-ref", datetime.datetime(2026, 1, 2, 3, 4, 5, 6,
                                          tzinfo=datetime.timezone.utc)),
        "WireTransaction": [wtx, cash],
        "FilteredTransaction": ftx,
        "PartialMerkleTree": ftx.partial_merkle_tree,
        "FilteredLeaves": ftx.filtered_leaves,
        "SignedTransaction": P.tx.SignedTransaction.of(wtx, [sig]),
    }


def test_every_component_type_serializes_identically():
    J, T = pkgs()
    jc, tc = _components(J), _components(T)
    assert list(jc) == list(tc)
    for name in jc:
        raw = jser.serialize(jc[name])
        assert tser.serialize(tc[name]) == raw, name
        back = tser.deserialize(raw)
        assert tser.serialize(back) == raw, name
        assert jser.serialize(jser.deserialize(tser.serialize(back))) == raw
    # the port's registered names (this module's test types aside) are
    # the JAX package's, for classes of the same names
    for name, (cls, _, _) in tcodec._REGISTRY.items():
        if name.startswith("test_torch_serialization."):
            continue
        assert name in jcodec._REGISTRY, name
        assert jcodec._REGISTRY[name][0].__name__ == cls.__name__, name


@dataclasses.dataclass(frozen=True)
class _Note:
    text: str
    count: int
    tags: tuple = ()


@dataclasses.dataclass(frozen=True)
class _NoteV1:
    text: str
    count: int


@dataclasses.dataclass(frozen=True)
class _NoteV2:
    text: str
    count: int
    extra: str = "default"


jcodec.register_type("test_torch_serialization.OnlyInJax", _Note,
                     carry_schema=True)
jcodec.register_type("test_torch_serialization.Evolving", _NoteV1,
                     carry_schema=True)
tcodec.register_type("test_torch_serialization.Evolving", _NoteV2,
                     carry_schema=True)


def test_carpented_objects_round_trip_byte_identically():
    """A schema'd object whose class only the JAX package knows becomes a
    carpented property bag in the port and re-serializes to the same
    bytes."""
    raw = jser.serialize([_Note("hello", 3, ("a", "b")), _Note("x", -1)])
    bags = tser.deserialize(raw)
    assert [type(b).__corda_carpented__ for b in bags] == [
        "test_torch_serialization.OnlyInJax"] * 2
    assert (bags[0].text, bags[0].count, bags[0].tags) == ("hello", 3,
                                                           ("a", "b"))
    assert tser.serialize(bags) == raw
    assert jser.deserialize(tser.serialize(bags)) == [
        _Note("hello", 3, ("a", "b")), _Note("x", -1)]


def test_evolved_objects_decode_as_in_jax():
    """Schema evolution across the packages: the port (v2, one more field
    with a default) reads the JAX package's v1 bytes with the default
    filled in, and the JAX package (v1) reads the port's v2 bytes with the
    extra field dropped."""
    v2 = tser.deserialize(jser.serialize(_NoteV1("a", 1)))
    assert v2 == _NoteV2("a", 1, "default")
    v1 = jser.deserialize(tser.serialize(_NoteV2("b", 2, "dropped")))
    assert v1 == _NoteV1("b", 2)


# ---------------------------------------------------------------------------
# Refusals: hostile and truncated bytes, unregistered types
# ---------------------------------------------------------------------------

def _obj(name: str, fields: list) -> bytes:
    inner = msgpack.packb([name, fields], use_bin_type=True)
    return jcodec._MAGIC + msgpack.packb(msgpack.ExtType(1, inner))


_HOSTILE = {
    "empty": b"",
    "short": jcodec._MAGIC[:3],
    "bad magic": b"\x00\x9d\xa1\x01\xc0",
    "bad version": b"\xc0\x9d\xa1\x02\xc0",
    "no body": jcodec._MAGIC,
    "trailing bytes": jcodec._MAGIC + b"\xc0\xc0",
    "unused 0xc1": jcodec._MAGIC + b"\xc1",
    "invalid utf-8": jcodec._MAGIC + b"\xa2\xff\xfe",
    "float": jcodec._MAGIC + b"\xcb" + b"\x00" * 8,
    "map": jcodec._MAGIC + b"\x81\x01\x02",
    "unhashable map key": jcodec._MAGIC + b"\x81\x91\x01\x02",
    "timestamp ext -1": jcodec._MAGIC + b"\xd6\xff\x00\x00\x00\x01",
    "bad timestamp": jcodec._MAGIC + b"\xd4\xff\x00",
    "negative ext code": jcodec._MAGIC + b"\xd4\x80\x00",
    "unknown ext code": jcodec._MAGIC + b"\xd4\x09\x00",
    "truncated bigint": jcodec._MAGIC + b"\xd4\x04\x01",
    "truncated str": jcodec._MAGIC + b"\xd9\x05abc",
    "truncated array": jcodec._MAGIC + b"\x93\x01",
    "huge array header": jcodec._MAGIC + b"\xdd\xff\xff\xff\xff",
    "unregistered type": _obj("no.such.Type", []),
    "registered, wrong arity": _obj("StateRef", [1]),
    "enum not whitelisted": jcodec._MAGIC + msgpack.packb(msgpack.ExtType(
        5, msgpack.packb(["no.such.Enum", "A"]))),
    "too deep": jcodec._MAGIC + b"\x91" * 1100 + b"\x01",
}


@pytest.mark.parametrize("case", list(_HOSTILE))
def test_hostile_bytes_raise_in_both(case):
    raw = _HOSTILE[case]
    with pytest.raises(jcodec.SerializationError):
        jser.deserialize(raw)
    with pytest.raises(tcodec.SerializationError):
        tser.deserialize(raw)


def _outcome(ser, codec, raw: bytes):
    try:
        value = ser.deserialize(raw)
    except codec.SerializationError:
        return "SerializationError"
    try:
        return ser.serialize(value)
    except Exception as exc:   # decoded but not re-encodable
        return type(exc).__name__


def test_mutated_transaction_bytes_fail_or_decode_alike():
    """Seeded byte flips, truncations and insertions of real serialized
    transactions: the port refuses exactly what the JAX package refuses
    (always with SerializationError), and what both accept re-serializes
    to the same bytes."""
    J, _ = pkgs()
    seeds = [oracle_wtx(J, 0).serialized, cash_wtx(J, 1, True).serialized,
             jser.serialize(oracle_wtx(J, 2).build_filtered_transaction(
                 reveals_fix(J)))]
    rng = random.Random(2026)
    refused = 0
    for k in range(1500):
        buf = bytearray(seeds[k % len(seeds)])
        for _ in range(rng.randint(1, 3)):
            op = rng.random()
            pos = rng.randrange(len(buf))
            if op < 0.5:
                buf[pos] = rng.randrange(256)
            elif op < 0.7:
                del buf[pos:]
                if not buf:
                    buf.append(0)
            else:
                buf.insert(pos, rng.randrange(256))
        raw = bytes(buf)
        want = _outcome(jser, jcodec, raw)
        assert _outcome(tser, tcodec, raw) == want, raw
        refused += want == "SerializationError"
    assert 500 < refused < 1500


def test_unregistered_types_are_refused_in_both():
    class Unregistered:
        pass

    @dataclasses.dataclass(frozen=True)
    class Plain:
        a: int

    class Shade(enum.Enum):
        DARK = 1

    for ser, codec in ((jser, jcodec), (tser, tcodec)):
        for value in (Unregistered(), Plain(1), Shade.DARK, 2.5, [1, 2.5],
                      {"k": object()}):
            with pytest.raises(codec.SerializationError):
                ser.serialize(value)
        with pytest.raises(codec.SerializationError):
            codec.register_type("test_torch_serialization.NotADataclass",
                                Unregistered)
        with pytest.raises(codec.SerializationError):
            codec.register_type("SecureHash", Plain)
