"""Dummy contract/state fixtures (reference: test-utils DummyContract/DummyState)."""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.contracts import (Contract, ContractState, TypeOnlyCommandData)
from ..core.crypto.keys import PublicKey
from ..core.crypto.secure_hash import SecureHash
from ..core.serialization import serializable

DUMMY_NOTARY_NAME = "O=Notary Service, L=Zurich, C=CH"


@serializable("DummyContract.Create")
@dataclass(frozen=True)
class Create(TypeOnlyCommandData):
    pass


@serializable("DummyContract.Move")
@dataclass(frozen=True)
class Move(TypeOnlyCommandData):
    pass


class DummyContract(Contract):
    legal_contract_reference = SecureHash.sha256(b"corda_tpu.testing.DummyContract")

    Create = Create
    Move = Move

    def verify(self, tx) -> None:
        pass  # always accepts


_DUMMY_CONTRACT = DummyContract()

from ..core.serialization import register_type as _register_type  # noqa: E402

_register_type("DummyContract", DummyContract,
               to_fields=lambda c: [], from_fields=lambda f: _DUMMY_CONTRACT)


@serializable("DummyState")
@dataclass(frozen=True)
class DummyState(ContractState):
    magic_number: int = 0
    owners: tuple[PublicKey, ...] = ()

    @property
    def contract(self) -> Contract:
        return _DUMMY_CONTRACT

    @property
    def participants(self) -> list[PublicKey]:
        return list(self.owners)
