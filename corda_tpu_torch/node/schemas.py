"""Custom state persistence schemas: typed projections of vault states.

Reference parity (VERDICT r2 #6):
- ``core/schemas/PersistentTypes.kt``: MappedSchema (a named, versioned set
  of mapped types), PersistentState (a row keyed by StateRef), and the
  QueryableState contract-state interface (supportedSchemas /
  generateMappedObject).
- ``node/services/schema/HibernateObserver.kt``: on every vault update,
  states that support a schema are projected into that schema's table —
  rows appear when a state is produced and disappear when it is consumed.
- ``NodeSchemaService``: the registry of installed schemas.

The host-native form: a schema's "table" is an in-memory column store keyed
by StateRef (the same seam the reference fills with Hibernate entities),
exportable as (header, rows) for external consumers, and queryable through
the vault's criteria engine via ``SchemaColumnCriteria``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.contracts.structures import StateRef
from .query import ColumnPredicate, _CommonCriteria


@dataclass(frozen=True)
class MappedSchema:
    """A named, versioned projection (PersistentTypes.kt:40-45)."""

    name: str
    version: int
    columns: tuple

    @property
    def table_name(self) -> str:
        return f"{self.name}_v{self.version}"


class QueryableState:
    """Mixin for states exportable to custom schemas (QueryableState in
    PersistentTypes.kt): declare the schemas you support and project
    yourself into a row per schema."""

    def supported_schemas(self) -> tuple:
        raise NotImplementedError

    def generate_mapped_object(self, schema: MappedSchema) -> dict:
        """Return {column: value} for ``schema`` (column set must match
        schema.columns)."""
        raise NotImplementedError


@dataclass(frozen=True)
class PersistentRow:
    """One projected row: the StateRef key + values aligned with the
    schema's columns (PersistentState + PersistentStateRef)."""

    ref: StateRef
    values: tuple


def _queryable(state) -> bool:
    """QueryableState by inheritance OR by shape (dataclass states often
    can't take extra bases; the two methods are the contract)."""
    return isinstance(state, QueryableState) or (
        hasattr(state, "supported_schemas")
        and hasattr(state, "generate_mapped_object"))


class SchemaService:
    """NodeSchemaService + HibernateObserver in one: observes the vault and
    maintains one table per schema. Attach via ``start()`` (the node wires
    this automatically)."""

    def __init__(self, hub):
        self.hub = hub
        self._tables: dict[str, dict[StateRef, PersistentRow]] = {}
        self._schemas: dict[str, MappedSchema] = {}

    def start(self) -> "SchemaService":
        self.hub.vault.add_update_observer(self._on_vault_update)
        return self

    # -- the observer (HibernateObserver.persist) ---------------------------
    def _on_vault_update(self, update) -> None:
        for sar in update.consumed:
            for table in self._tables.values():
                table.pop(sar.ref, None)
        for sar in update.produced:
            state = sar.state.data
            if not _queryable(state):
                continue
            for schema in state.supported_schemas():
                self._schemas.setdefault(schema.table_name, schema)
                row = state.generate_mapped_object(schema)
                values = tuple(row.get(col) for col in schema.columns)
                self._tables.setdefault(schema.table_name, {})[sar.ref] = \
                    PersistentRow(sar.ref, values)

    # -- consumption (the node-schemas export analog) ------------------------
    @property
    def schemas(self) -> list[MappedSchema]:
        return list(self._schemas.values())

    def rows(self, schema: MappedSchema) -> list[PersistentRow]:
        return list(self._tables.get(schema.table_name, {}).values())

    def export_table(self, schema: MappedSchema):
        """(header, rows) for external consumers: header = ("transaction_id",
        "output_index", *columns) — the PersistentStateRef embedded-id shape."""
        header = ("transaction_id", "output_index") + tuple(schema.columns)
        rows = [(r.ref.txhash.bytes.hex(), r.ref.index) + r.values
                for r in self.rows(schema)]
        return header, sorted(rows)


@dataclass(frozen=True)
class SchemaColumnCriteria(_CommonCriteria):
    """Vault query criteria over a custom schema column
    (VaultCustomQueryCriteria's typed-column form): matches states that
    support ``schema`` and whose projected ``column`` satisfies the
    predicate. Composes with And/Or like every other criteria."""

    schema: MappedSchema = None
    column: str = ""
    predicate: ColumnPredicate = field(
        default_factory=lambda: ColumnPredicate("not_null"))
    status: str = "unconsumed"
    participants: tuple | None = None

    def matches(self, rec) -> bool:
        if not self._common_ok(rec):
            return False
        state = rec.sar.state.data
        if not _queryable(state):
            return False
        if self.schema.table_name not in {
                s.table_name for s in state.supported_schemas()}:
            return False
        row = state.generate_mapped_object(self.schema)
        return self.predicate.test(row.get(self.column))
