"""Identity: well-known and anonymous parties.

Reference parity: core/.../identity/ (Party.kt, AnonymousParty.kt,
AbstractParty.kt) — an ``AbstractParty`` is identified by an owning key (which may
be a CompositeKey for clustered services); a ``Party`` adds a legal X.500-style name.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .crypto.keys import PublicKey
from .serialization import serializable


@serializable("CordaX500Name")
@dataclass(frozen=True, order=True)
class CordaX500Name:
    """Structured legal name (simplified X.500 DN: O, L, C mandatory — the same
    fields the reference validates in its X500 handling)."""

    organisation: str
    locality: str
    country: str
    common_name: str | None = None
    organisation_unit: str | None = None
    state: str | None = None

    def __post_init__(self):
        if not self.organisation or not self.locality or len(self.country) != 2:
            raise ValueError(
                "CordaX500Name requires organisation, locality and a 2-letter country")

    def __str__(self) -> str:
        parts = [f"O={self.organisation}", f"L={self.locality}", f"C={self.country}"]
        if self.common_name:
            parts.insert(0, f"CN={self.common_name}")
        if self.organisation_unit:
            parts.insert(-2, f"OU={self.organisation_unit}")
        if self.state:
            parts.insert(-1, f"ST={self.state}")
        return ", ".join(parts)

    @staticmethod
    def parse(s: str) -> "CordaX500Name":
        kv = {}
        for part in s.split(","):
            k, _, v = part.strip().partition("=")
            kv[k.strip().upper()] = v.strip()
        return CordaX500Name(
            organisation=kv.get("O", ""), locality=kv.get("L", ""),
            country=kv.get("C", ""), common_name=kv.get("CN"),
            organisation_unit=kv.get("OU"), state=kv.get("ST"))


class AbstractParty:
    """Anything that can own states: identified by its owning key."""

    __slots__ = ("owning_key",)

    def __init__(self, owning_key: PublicKey):
        self.owning_key = owning_key

    # Equality is defined per concrete subclass (strictly same-type) so that
    # AnonymousParty/Party comparisons are symmetric and hash-consistent.
    def __eq__(self, other):
        return type(self) is type(other) and self.owning_key == other.owning_key

    def __hash__(self):
        return hash(self.owning_key)


@serializable("AnonymousParty", to_fields=lambda p: [p.owning_key],
              from_fields=lambda f: AnonymousParty(f[0]))
class AnonymousParty(AbstractParty):
    """A party identified only by key — confidential identities."""

    def __repr__(self):
        return f"AnonymousParty({self.owning_key.to_string_short()[:14]}…)"


@serializable("Party", to_fields=lambda p: [p.name, p.owning_key],
              from_fields=lambda f: Party(f[0], f[1]))
class Party(AbstractParty):
    """A well-known party: legal name + owning key."""

    __slots__ = ("name",)

    def __init__(self, name: CordaX500Name | str, owning_key: PublicKey):
        super().__init__(owning_key)
        if isinstance(name, str):
            name = CordaX500Name.parse(name)
        self.name = name

    def anonymise(self) -> AnonymousParty:
        return AnonymousParty(self.owning_key)

    def ref(self, *reference: int) -> "PartyAndReference":
        from .contracts.structures import PartyAndReference
        return PartyAndReference(self, bytes(reference))

    def __eq__(self, other):
        # Party equality is by key AND name (two services can share a cluster key).
        return (type(other) is Party and self.owning_key == other.owning_key
                and self.name == other.name)

    def __hash__(self):
        return hash((self.owning_key, self.name))

    def __repr__(self):
        return f"Party({self.name})"
