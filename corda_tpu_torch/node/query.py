"""Vault query criteria: the composable query API over vault state.

Reference parity: core/node/services/vault/QueryCriteria.kt:1-131
(VaultQueryCriteria, LinearStateQueryCriteria, FungibleAssetQueryCriteria,
VaultCustomQueryCriteria, And/Or composition), QueryCriteriaUtils.kt:1-297
(ColumnPredicate, PageSpecification, Sort), and the role of
HibernateQueryCriteriaParser (vault/HibernateQueryCriteriaParser.kt:1-437 —
criteria → JPA). Here criteria evaluate directly as predicates over the
in-memory vault index: the SQL engine is a JVM storage concern; the
port's vault is a host-side index whose query cost is negligible next to
the device verification path, so predicate evaluation replaces query
compilation by design.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Callable

DEFAULT_PAGE_SIZE = 200
MAX_PAGE_SIZE = 10_000


class VaultQueryError(Exception):
    pass


# ---------------------------------------------------------------------------
# Column predicates (QueryCriteriaUtils.kt ColumnPredicate)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ColumnPredicate:
    """A comparison over one extracted value. ``op`` ∈ {==, !=, >, >=, <, <=,
    between, in, not_in, like, is_null, not_null}."""

    op: str
    value: Any = None
    to_value: Any = None    # upper bound for "between"

    def test(self, v: Any) -> bool:
        if self.op == "is_null":
            return v is None
        if self.op == "not_null":
            return v is not None
        if v is None:
            return False
        if self.op == "==":
            return v == self.value
        if self.op == "!=":
            return v != self.value
        if self.op == ">":
            return v > self.value
        if self.op == ">=":
            return v >= self.value
        if self.op == "<":
            return v < self.value
        if self.op == "<=":
            return v <= self.value
        if self.op == "between":
            return self.value <= v <= self.to_value
        if self.op == "in":
            return v in self.value
        if self.op == "not_in":
            return v not in self.value
        if self.op == "like":  # SQL LIKE with % wildcards, over str(v)
            import fnmatch
            return fnmatch.fnmatch(str(v), str(self.value).replace("%", "*"))
        raise VaultQueryError(f"unknown predicate op {self.op!r}")


def equal(v) -> ColumnPredicate: return ColumnPredicate("==", v)
def not_equal(v) -> ColumnPredicate: return ColumnPredicate("!=", v)
def greater_than(v) -> ColumnPredicate: return ColumnPredicate(">", v)
def greater_than_or_equal(v) -> ColumnPredicate: return ColumnPredicate(">=", v)
def less_than(v) -> ColumnPredicate: return ColumnPredicate("<", v)
def less_than_or_equal(v) -> ColumnPredicate: return ColumnPredicate("<=", v)
def between(lo, hi) -> ColumnPredicate: return ColumnPredicate("between", lo, hi)
def in_collection(vs) -> ColumnPredicate: return ColumnPredicate("in", tuple(vs))
def like(pattern: str) -> ColumnPredicate: return ColumnPredicate("like", pattern)


@dataclass(frozen=True)
class TimeCondition:
    """Filter on when the vault recorded/consumed the state
    (QueryCriteria.TimeCondition; type ∈ {recorded, consumed})."""

    type: str
    predicate: ColumnPredicate


# ---------------------------------------------------------------------------
# Paging and sorting (QueryCriteriaUtils.kt PageSpecification / Sort)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PageSpecification:
    page_number: int = 1       # 1-based, as in the reference
    page_size: int = DEFAULT_PAGE_SIZE

    def __post_init__(self):
        if self.page_number < 1 or not (0 < self.page_size <= MAX_PAGE_SIZE):
            raise VaultQueryError(
                f"invalid page specification {self.page_number}/{self.page_size}")


@dataclass(frozen=True)
class Sort:
    """Ordered sort columns: (attribute, direction) pairs, direction ∈
    {ASC, DESC}. Attributes: state_ref, recorded_time, consumed_time,
    quantity, or a dotted path into the state data (e.g. "amount.quantity")."""

    columns: tuple = (("state_ref", "ASC"),)

    def __post_init__(self):
        for attr, direction in self.columns:
            if direction not in ("ASC", "DESC"):
                raise VaultQueryError(f"bad sort direction {direction!r}")


@dataclass(frozen=True)
class Page:
    """One page of results plus the total matching count
    (Vault.Page: states + totalStatesAvailable)."""

    states: tuple
    total_states_available: int


# ---------------------------------------------------------------------------
# Vault records (what criteria evaluate against)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VaultRecord:
    """One vault entry with its query-relevant metadata."""

    sar: Any                       # StateAndRef
    status: str                    # "unconsumed" | "consumed"
    recorded_time: datetime | None = None
    consumed_time: datetime | None = None
    locked_by: str | None = None   # soft-lock holder (flow id)


def _participant_keys(state_data) -> set:
    keys = set()
    for p in getattr(state_data, "participants", []):
        k = getattr(p, "owning_key", p)
        keys.update(getattr(k, "keys", (k,)))
    return keys


def _keys_of(parties_or_keys) -> set:
    out = set()
    for p in parties_or_keys:
        k = getattr(p, "owning_key", p)
        out.update(getattr(k, "keys", (k,)))
    return out


def _attr_path(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


# ---------------------------------------------------------------------------
# Criteria (QueryCriteria.kt)
# ---------------------------------------------------------------------------

class QueryCriteria:
    def matches(self, rec: VaultRecord) -> bool:
        raise NotImplementedError

    def __and__(self, other: "QueryCriteria") -> "QueryCriteria":
        return AndComposition(self, other)

    def __or__(self, other: "QueryCriteria") -> "QueryCriteria":
        return OrComposition(self, other)


@dataclass(frozen=True)
class AndComposition(QueryCriteria):
    left: QueryCriteria
    right: QueryCriteria

    def matches(self, rec):
        return self.left.matches(rec) and self.right.matches(rec)


@dataclass(frozen=True)
class OrComposition(QueryCriteria):
    left: QueryCriteria
    right: QueryCriteria

    def matches(self, rec):
        return self.left.matches(rec) or self.right.matches(rec)


def _status_ok(rec_status: str, wanted: str) -> bool:
    return wanted == "all" or rec_status == wanted


class _CommonCriteria(QueryCriteria):
    """Shared axes: status, participants (QueryCriteria.CommonQueryCriteria)."""

    def _common_ok(self, rec: VaultRecord) -> bool:
        if not _status_ok(rec.status, self.status):
            return False
        if self.participants is not None:
            wanted = _keys_of(self.participants)
            if wanted.isdisjoint(_participant_keys(rec.sar.state.data)):
                return False
        return True


@dataclass(frozen=True)
class VaultQueryCriteria(_CommonCriteria):
    """The general axes (QueryCriteria.VaultQueryCriteria): status, state
    types, state refs, notary, soft-locking, time conditions, participants."""

    status: str = "unconsumed"
    contract_state_types: tuple | None = None
    state_refs: tuple | None = None
    notary: tuple | None = None
    soft_locking: str | None = None       # "locked_only" | "unlocked_only"
    time_condition: TimeCondition | None = None
    participants: tuple | None = None

    def matches(self, rec):
        if not self._common_ok(rec):
            return False
        if (self.contract_state_types is not None
                and not isinstance(rec.sar.state.data,
                                   tuple(self.contract_state_types))):
            return False
        if self.state_refs is not None and rec.sar.ref not in self.state_refs:
            return False
        if self.notary is not None and rec.sar.state.notary not in self.notary:
            return False
        if self.soft_locking == "locked_only" and rec.locked_by is None:
            return False
        if self.soft_locking == "unlocked_only" and rec.locked_by is not None:
            return False
        if self.time_condition is not None:
            t = (rec.recorded_time if self.time_condition.type == "recorded"
                 else rec.consumed_time)
            if not self.time_condition.predicate.test(t):
                return False
        return True


@dataclass(frozen=True)
class LinearStateQueryCriteria(_CommonCriteria):
    """LinearState axes: linear ids / external ids
    (QueryCriteria.LinearStateQueryCriteria)."""

    uuids: tuple | None = None
    external_ids: tuple | None = None
    status: str = "unconsumed"
    participants: tuple | None = None

    def matches(self, rec):
        if not self._common_ok(rec):
            return False
        lid = getattr(rec.sar.state.data, "linear_id", None)
        if lid is None:
            return False
        if self.uuids is not None and lid.id not in self.uuids:
            return False
        if (self.external_ids is not None
                and lid.external_id not in self.external_ids):
            return False
        return True


@dataclass(frozen=True)
class FungibleAssetQueryCriteria(_CommonCriteria):
    """FungibleAsset axes: owner, quantity, issuer party/reference
    (QueryCriteria.FungibleAssetQueryCriteria)."""

    owner: tuple | None = None
    quantity: ColumnPredicate | None = None
    issuer: tuple | None = None
    issuer_ref: tuple | None = None
    status: str = "unconsumed"
    participants: tuple | None = None

    def matches(self, rec):
        if not self._common_ok(rec):
            return False
        data = rec.sar.state.data
        amount = getattr(data, "amount", None)
        if amount is None:
            return False
        if self.owner is not None:
            owner_key = getattr(data, "owner", None)
            k = getattr(owner_key, "owning_key", owner_key)
            leaves = set(getattr(k, "keys", (k,)))
            if leaves.isdisjoint(_keys_of(self.owner)):
                return False
        if self.quantity is not None and not self.quantity.test(amount.quantity):
            return False
        issued = getattr(amount, "token", None)
        issuer_pr = getattr(issued, "issuer", None)
        if self.issuer is not None:
            if issuer_pr is None or issuer_pr.party not in self.issuer:
                return False
        if self.issuer_ref is not None:
            if issuer_pr is None or issuer_pr.reference not in self.issuer_ref:
                return False
        return True


@dataclass(frozen=True)
class CustomQueryCriteria(_CommonCriteria):
    """Attribute-expression axis (QueryCriteria.VaultCustomQueryCriteria):
    a dotted attribute path into the state data + a column predicate."""

    attribute: str = ""
    predicate: ColumnPredicate = field(default_factory=lambda: ColumnPredicate("not_null"))
    status: str = "unconsumed"
    participants: tuple | None = None

    def matches(self, rec):
        if not self._common_ok(rec):
            return False
        return self.predicate.test(_attr_path(rec.sar.state.data, self.attribute))


# ---------------------------------------------------------------------------
# Execution (sorting + paging over filtered records)
# ---------------------------------------------------------------------------

_SORT_EXTRACTORS: dict[str, Callable[[VaultRecord], Any]] = {
    "state_ref": lambda r: (r.sar.ref.txhash.bytes, r.sar.ref.index),
    "recorded_time": lambda r: r.recorded_time,
    "consumed_time": lambda r: r.consumed_time,
    "quantity": lambda r: getattr(getattr(r.sar.state.data, "amount", None),
                                  "quantity", None),
}


def _sort_key(rec: VaultRecord, attr: str):
    ex = _SORT_EXTRACTORS.get(attr)
    v = ex(rec) if ex is not None else _attr_path(rec.sar.state.data, attr)
    # None sorts first, deterministically; wrap to keep mixed types orderable
    return (v is not None, v)


def run_query(records, criteria: QueryCriteria | None,
              paging: PageSpecification | None, sorting: Sort | None) -> Page:
    """Filter → sort → page. Mirrors the reference's guard: result sets larger
    than DEFAULT_PAGE_SIZE require an explicit PageSpecification."""
    if criteria is None:
        criteria = VaultQueryCriteria()
    hits = [r for r in records if criteria.matches(r)]
    sorting = sorting or Sort()
    for attr, direction in reversed(sorting.columns):   # stable multi-key
        hits.sort(key=lambda r: _sort_key(r, attr), reverse=direction == "DESC")
    total = len(hits)
    if paging is None:
        if total > DEFAULT_PAGE_SIZE:
            raise VaultQueryError(
                f"{total} results: specify a PageSpecification when the "
                f"result set may exceed {DEFAULT_PAGE_SIZE}")
        return Page(tuple(r.sar for r in hits), total)
    lo = (paging.page_number - 1) * paging.page_size
    return Page(tuple(r.sar for r in hits[lo:lo + paging.page_size]), total)
