"""The port's Amount arithmetic against the JAX package's
(tests/test_amount.py): the same operations give the same quantities and
the same refusals, and an Amount serialises to the same bytes and crosses
between the packages."""
import pytest

from corda_tpu.core.contracts import amount as jam
from corda_tpu.core.serialization import deserialize as j_deserialize
from corda_tpu.core.serialization import serialize as j_serialize
from corda_tpu_torch.core.contracts import amount as tam
from corda_tpu_torch.core.serialization import deserialize as t_deserialize
from corda_tpu_torch.core.serialization import serialize as t_serialize

PKGS = {"corda_tpu": jam, "corda_tpu_torch": tam}


def _try(fn):
    try:
        out = fn()
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc))
    if isinstance(out, list):
        return [(a.quantity, a.token.code) for a in out]
    if hasattr(out, "quantity"):
        return (out.quantity, out.token.code)
    return out


def _arithmetic(m):
    a, b = m.Amount(100, m.USD), m.Amount(250, m.USD)
    return [_try(f) for f in (
        lambda: a + b, lambda: b - a, lambda: a * 3, lambda: a < b,
        lambda: b >= a, lambda: a + m.Amount(1, m.GBP),
        lambda: m.Amount(-1, m.USD), lambda: a - b, lambda: a * 1.5)]


def test_amount_arithmetic():
    got = {pkg: _arithmetic(m) for pkg, m in PKGS.items()}
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu_torch"][:5] == [(350, "USD"), (150, "USD"),
                                          (300, "USD"), True, True]
    assert [o[0] for o in got["corda_tpu_torch"][5:]] == ["ValueError"] * 4


def _splits(m):
    a = m.Amount(10, m.USD)
    parts = a.splits(3)
    return [_try(lambda: parts), _try(lambda: m.sum_or_throw(parts)),
            _try(lambda: m.sum_or_none([])),
            _try(lambda: m.sum_or_zero([], m.USD)),
            _try(lambda: m.sum_or_throw([]))]


def test_amount_splits_and_sums():
    got = {pkg: _splits(m) for pkg, m in PKGS.items()}
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu_torch"][:4] == [
        [(4, "USD"), (3, "USD"), (3, "USD")], (10, "USD"), None, (0, "USD")]
    assert got["corda_tpu_torch"][4][0] == "ValueError"


@pytest.mark.parametrize("qty,code", [(12345, "USD"), (0, "GBP"),
                                      (10**15, "CHF"), (7, "XAU")])
def test_amount_roundtrip_and_wire_bytes(qty, code):
    t = tam.Amount(qty, tam.currency(code))
    j = jam.Amount(qty, jam.currency(code))
    assert t_deserialize(t_serialize(t)) == t
    assert t_serialize(t) == j_serialize(j)
    assert t_deserialize(j_serialize(j)) == t
    assert j_deserialize(t_serialize(t)) == j
