"""Core ledger structures: states, commands, time-windows, attachments.

Reference parity: core/.../contracts/Structures.kt:1-491.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Any, Protocol, runtime_checkable

from ..crypto.keys import PublicKey
from ..crypto.secure_hash import SecureHash
from ..identity import AbstractParty, Party
from ..serialization import serializable, serialize


# ---------------------------------------------------------------------------
# Contracts and states
# ---------------------------------------------------------------------------

class Contract:
    """Code that verifies state transitions. Subclass and override ``verify``.

    Contract singletons are serialized by registered type name; ``verify`` bodies
    always run on the HOST (the GPU handles signatures + hashing — SURVEY.md §3.3).
    """

    #: Hash of the legal prose this code implements (Structures.kt legalContractReference).
    legal_contract_reference: SecureHash = SecureHash.sha256(b"corda_tpu.contract")

    def verify(self, tx: "TransactionForContract") -> None:
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return type(self).__name__


class ContractState:
    """A fact on the ledger. Subclasses must expose ``contract`` and ``participants``."""

    @property
    def contract(self) -> Contract:
        raise NotImplementedError

    @property
    def participants(self) -> list[PublicKey]:
        raise NotImplementedError


class OwnableState(ContractState):
    """A state with a single owner key, supporting ownership transfer.

    Interface contract (duck-typed so dataclass subclasses can declare the
    attributes as fields): `owner: PublicKey`, and
    `with_new_owner(new_owner) -> (CommandData, OwnableState)`.
    """

    def with_new_owner(self, new_owner: PublicKey) -> tuple["CommandData", "OwnableState"]:
        raise NotImplementedError


class LinearState(ContractState):
    """A state evolving through a chain of transactions, tracked by a
    `linear_id: UniqueIdentifier` attribute (duck-typed, see OwnableState)."""

    def is_relevant(self, our_keys: set[PublicKey]) -> bool:
        return any(k in our_keys for p in self.participants for k in p.keys)


class FungibleAsset(OwnableState):
    """An ownable, splittable/mergeable amount of an issued product (Cash etc.).

    Interface contract: `amount: Amount[Issued[T]]`, `exit_keys: set[PublicKey]`
    (duck-typed, see OwnableState).
    """


@serializable("ScheduledActivity")
@dataclass(frozen=True)
class ScheduledActivity:
    """What to do when a scheduled state fires: start this flow at this time."""

    flow_ref: Any  # FlowLogicRef wire form
    scheduled_at: datetime


class SchedulableState(ContractState):
    def next_scheduled_activity(self, this_state_ref: "StateRef",
                                flow_logic_ref_factory) -> ScheduledActivity | None:
        raise NotImplementedError


@serializable("UniqueIdentifier")
@dataclass(frozen=True, order=True)
class UniqueIdentifier:
    external_id: str | None = None
    id: str = field(default_factory=lambda: str(uuid.uuid4()))

    def __str__(self):
        return f"{self.external_id}_{self.id}" if self.external_id else self.id


@serializable("TransactionState")
@dataclass(frozen=True)
class TransactionState:
    """A ContractState plus ledger-level metadata: the notary in charge of it and an
    optional encumbrance link to another output of the same transaction."""

    data: ContractState
    notary: Party
    encumbrance: int | None = None

    def __post_init__(self):
        if self.encumbrance is not None and self.encumbrance < 0:
            raise ValueError("Encumbrance index must be non-negative")


@serializable("StateRef")
@dataclass(frozen=True, order=True)
class StateRef:
    """Pointer to an output state: (transaction id, output index)."""

    txhash: SecureHash
    index: int

    def __str__(self):
        return f"{self.txhash}({self.index})"


@serializable("StateAndRef")
@dataclass(frozen=True)
class StateAndRef:
    state: TransactionState
    ref: StateRef


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------

class CommandData:
    """Marker base for command payloads."""


class TypeOnlyCommandData(CommandData):
    """A command whose meaning is entirely its type (Move, Issue, …)."""

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return type(self).__name__


class MoveCommand(CommandData):
    """Marker: commands that move ownership (contract upgrades inspect these)."""


class IssueCommand(CommandData):
    """Marker: commands that issue new value; carries an anti-replay nonce."""

    nonce: int


class ExitCommand(CommandData):
    """Marker: commands that remove value from the ledger."""


@serializable("Command")
@dataclass(frozen=True)
class Command:
    """A command payload plus the keys required to sign for it."""

    value: CommandData
    signers: tuple[PublicKey, ...]

    def __post_init__(self):
        signers = self.signers
        if isinstance(signers, PublicKey):
            signers = (signers,)
        object.__setattr__(self, "signers", tuple(signers))
        if not self.signers:
            raise ValueError("Command must have at least one signer")


@dataclass(frozen=True)
class AuthenticatedObject:
    """A command as seen during verification: payload + signer keys + resolved
    well-known signer identities."""

    signers: tuple[PublicKey, ...]
    signing_parties: tuple[Party, ...]
    value: CommandData


# ---------------------------------------------------------------------------
# Time windows
# ---------------------------------------------------------------------------

@serializable("TimeWindow", to_fields=lambda tw: [tw.from_time, tw.until_time],
              from_fields=lambda f: TimeWindow(f[0], f[1]))
class TimeWindow:
    """An interval the notary attests the transaction fell within.

    Instants serialize as epoch-microsecond ints (determinism: no float seconds).
    """

    __slots__ = ("from_time", "until_time")

    def __init__(self, from_time: datetime | int | None,
                 until_time: datetime | int | None):
        if from_time is None and until_time is None:
            raise ValueError("TimeWindow must have at least one bound")
        self.from_time = _to_micros(from_time)
        self.until_time = _to_micros(until_time)

    @staticmethod
    def between(from_time: datetime, until_time: datetime) -> "TimeWindow":
        return TimeWindow(from_time, until_time)

    @staticmethod
    def from_only(from_time: datetime) -> "TimeWindow":
        return TimeWindow(from_time, None)

    @staticmethod
    def until_only(until_time: datetime) -> "TimeWindow":
        return TimeWindow(None, until_time)

    @staticmethod
    def with_tolerance(instant: datetime, tolerance: timedelta) -> "TimeWindow":
        return TimeWindow(instant - tolerance, instant + tolerance)

    @property
    def midpoint(self) -> datetime | None:
        if self.from_time is None or self.until_time is None:
            return None
        return _from_micros((self.from_time + self.until_time) // 2)

    def contains(self, instant: datetime) -> bool:
        micros = _to_micros(instant)
        if self.from_time is not None and micros < self.from_time:
            return False
        if self.until_time is not None and micros >= self.until_time:
            return False
        return True

    def __eq__(self, other):
        return (isinstance(other, TimeWindow) and self.from_time == other.from_time
                and self.until_time == other.until_time)

    def __hash__(self):
        return hash((self.from_time, self.until_time))

    def __repr__(self):
        return f"TimeWindow({_from_micros(self.from_time)} .. {_from_micros(self.until_time)})"


def _to_micros(t) -> int | None:
    if t is None or isinstance(t, int):
        return t
    from ..serialization.codec import exact_epoch_micros
    return exact_epoch_micros(t)


def _from_micros(m: int | None) -> datetime | None:
    return None if m is None else datetime.fromtimestamp(m / 1_000_000, tz=timezone.utc)


# ---------------------------------------------------------------------------
# Issuance
# ---------------------------------------------------------------------------

@serializable("PartyAndReference")
@dataclass(frozen=True)
class PartyAndReference:
    """An issuer party plus an opaque reference (e.g. an internal account id)."""

    party: AbstractParty
    reference: bytes

    def __str__(self):
        return f"{self.party}{self.reference.hex()}"


@serializable("Issued")
@dataclass(frozen=True)
class Issued:
    """A product (currency, commodity, …) tagged with who issued it."""

    issuer: PartyAndReference
    product: Any

    def __str__(self):
        return f"{self.product} issued by {self.issuer}"


# ---------------------------------------------------------------------------
# Attachments
# ---------------------------------------------------------------------------

@serializable("Attachment", to_fields=lambda a: [a.id, a.data],
              from_fields=lambda f: Attachment(f[0], f[1]))
class Attachment:
    """An immutable blob identified by its hash (reference: jar files; here any
    content-addressed bytes)."""

    __slots__ = ("id", "data")

    def __init__(self, id: SecureHash, data: bytes):
        self.id = id
        self.data = data

    @staticmethod
    def of(data: bytes) -> "Attachment":
        return Attachment(SecureHash.sha256(data), data)

    def verify(self) -> bool:
        return SecureHash.sha256(self.data) == self.id

    def __eq__(self, other):
        return isinstance(other, Attachment) and self.id == other.id

    def __hash__(self):
        return hash(self.id)


# ---------------------------------------------------------------------------
# The `requireThat` contract-DSL helper
# ---------------------------------------------------------------------------

class _Requirements:
    def using(self, message: str, expr: bool):
        if not expr:
            raise ValueError(f"Failed requirement: {message}")

    # pythonic alias
    def that(self, message: str, expr: bool):
        self.using(message, expr)


def requireThat(fn=None):
    """``requireThat(lambda r: r.using("msg", cond))`` or used as a context manager:

    >>> with requireThat() as r:
    ...     r.using("must be positive", x > 0)
    """
    if fn is not None:
        fn(_Requirements())
        return None
    import contextlib

    @contextlib.contextmanager
    def ctx():
        yield _Requirements()

    return ctx()


def tx_time_micros(tx) -> int | None:
    """A transaction's attested instant: the time-window midpoint (or single
    bound) in epoch micros — what time-sensitive contract rules (maturity,
    default) check against. TimeWindow bounds are integer micros."""
    tw = getattr(tx, "time_window", None)
    if tw is None:
        return None
    if tw.from_time is not None and tw.until_time is not None:
        return (tw.from_time + tw.until_time) // 2
    return tw.from_time if tw.from_time is not None else tw.until_time
