"""Integer token-quantity arithmetic.

Reference parity: core/.../contracts/Amount.kt:1-442 — quantities are integer counts
of the smallest token unit (pennies, cents); mixing tokens throws; negative amounts
throw. Floats never appear (consensus determinism).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

from ..serialization import serializable


@serializable("Currency")
@dataclass(frozen=True, order=True)
class Currency:
    """ISO-4217-style currency token (the reference uses java.util.Currency)."""

    code: str
    default_fraction_digits: int = 2

    def __str__(self):
        return self.code


USD = Currency("USD")
GBP = Currency("GBP")
EUR = Currency("EUR")
CHF = Currency("CHF")
_WELL_KNOWN = {c.code: c for c in (USD, GBP, EUR, CHF)}


def currency(code: str) -> Currency:
    return _WELL_KNOWN.get(code, Currency(code))


@serializable("Amount")
@dataclass(frozen=True)
class Amount:
    """``quantity`` of the smallest unit of ``token`` (token may be a Currency or an
    ``Issued`` wrapper — Amount[Issued[Currency]] is issued cash)."""

    quantity: int
    token: Any

    def __post_init__(self):
        if not isinstance(self.quantity, int) or isinstance(self.quantity, bool):
            raise ValueError("Amount quantity must be an int")
        if self.quantity < 0:
            raise ValueError("Negative amounts are not allowed")

    @staticmethod
    def from_decimal(value, token) -> "Amount":
        digits = _fraction_digits(token)
        q = round(value * (10 ** digits))
        return Amount(int(q), token)

    def to_decimal(self) -> float:
        return self.quantity / (10 ** _fraction_digits(self.token))

    def _check_token(self, other: "Amount"):
        if self.token != other.token:
            raise ValueError(f"Token mismatch: {self.token} vs {other.token}")

    def __add__(self, other: "Amount") -> "Amount":
        self._check_token(other)
        return Amount(self.quantity + other.quantity, self.token)

    def __sub__(self, other: "Amount") -> "Amount":
        self._check_token(other)
        return Amount(self.quantity - other.quantity, self.token)

    def __mul__(self, factor: int) -> "Amount":
        if not isinstance(factor, int):
            raise ValueError("Amounts may only be multiplied by ints")
        return Amount(self.quantity * factor, self.token)

    __rmul__ = __mul__

    def __lt__(self, other: "Amount") -> bool:
        self._check_token(other)
        return self.quantity < other.quantity

    def __le__(self, other: "Amount") -> bool:
        self._check_token(other)
        return self.quantity <= other.quantity

    def __gt__(self, other):
        return not self.__le__(other)

    def __ge__(self, other):
        return not self.__lt__(other)

    def splits(self, partitions: int) -> list["Amount"]:
        """Split as evenly as possible into ``partitions`` amounts that sum exactly."""
        base, rem = divmod(self.quantity, partitions)
        return [Amount(base + (1 if i < rem else 0), self.token)
                for i in range(partitions)]

    def __str__(self):
        return f"{self.to_decimal():.2f} {_token_str(self.token)}"


def _fraction_digits(token) -> int:
    if isinstance(token, Currency):
        return token.default_fraction_digits
    inner = getattr(token, "product", None)
    if isinstance(inner, Currency):
        return inner.default_fraction_digits
    return 0


def _token_str(token) -> str:
    return str(token)


def sum_or_none(amounts: Iterable[Amount]) -> Amount | None:
    total = None
    for a in amounts:
        total = a if total is None else total + a
    return total


def sum_or_throw(amounts: Iterable[Amount]) -> Amount:
    total = sum_or_none(amounts)
    if total is None:
        raise ValueError("Cannot sum an empty list of amounts")
    return total


def sum_or_zero(amounts: Iterable[Amount], token) -> Amount:
    return sum_or_none(amounts) or Amount(0, token)
