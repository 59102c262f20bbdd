"""Attachment-delivered contract code, executed in the deterministic sandbox.

Reference parity (VERDICT r2 #5):
- ``AttachmentsClassLoader.kt``: during verification, contract classes load
  from the transaction's attachment jars — a peer can verify a contract it
  never installed, because the code travels WITH the transaction.
- ``experimental/sandbox WhitelistClassLoader.java:1-356``: that loaded code
  runs gated — whitelisted constructs only, runtime cost accounting.

This package's form: contract verify logic ships as PYTHON SOURCE in a
content-addressed attachment. ``SandboxedState`` carries (attachment id,
contract class name, plain-data fields); its contract resolves the source
from the transaction's own resolved attachments, validates it against the
deterministic whitelist, and runs ``verify`` under the instruction budget
(core.contracts.sandbox). A hostile attachment — banned constructs, budget
exhaustion, or a verify that rejects — fails verification like any contract
violation; it can never run unconfined.

The state's FIELDS are codec-plain (tuples of (name, value) pairs), so a
peer deserializes the state without any contract-specific Python types
installed — the wire-format half of the classloader story.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..crypto.secure_hash import SecureHash
from ..serialization import register_type
from .exceptions import TransactionVerificationException
from .sandbox import (DeterministicSandbox, SandboxBudgetError,
                      SandboxViolation)
from .structures import CommandData, Contract, ContractState


@dataclass(frozen=True)
class SandboxedCommand(CommandData):
    """A command for attachment-delivered contracts: a verb name + plain
    arguments (the sandboxed code dispatches on the name)."""

    name: str
    args: tuple = ()


@dataclass(frozen=True)
class SandboxedState(ContractState):
    """A state whose contract logic lives in ``attachment_id``.

    ``fields`` is a tuple of (name, value) pairs of codec-plain values —
    deserializable by ANY peer, no contract module required."""

    attachment_id: SecureHash
    contract_class: str
    fields: tuple                 # ((name, value), ...)
    owners: tuple                 # participant PublicKeys

    @property
    def contract(self) -> "AttachmentContract":
        return AttachmentContract(self.attachment_id, self.contract_class)

    @property
    def participants(self):
        return list(self.owners)

    def field(self, name: str):
        for key, value in self.fields:
            if key == name:
                return value
        raise KeyError(name)


register_type("sandbox.SandboxedCommand", SandboxedCommand)
register_type("sandbox.SandboxedState", SandboxedState)

#: Budget for one sandboxed contract verification (statements + iterations).
VERIFY_BUDGET = 200_000


@dataclass(frozen=True)
class AttachmentContract(Contract):
    """The classloader seam: verify() finds the source in the transaction's
    resolved attachments and runs it sandboxed. Equality by (attachment,
    class) so the platform's one-verify-per-contract dispatch dedupes."""

    attachment_id: SecureHash
    contract_class: str

    def verify(self, tx) -> None:
        attachment = next(
            (a for a in tx.attachments if a.id == self.attachment_id), None)
        if attachment is None:
            raise TransactionVerificationException(
                tx.id, f"contract attachment {self.attachment_id} is not "
                       f"attached to the transaction")
        try:
            source = attachment.data.decode("utf-8")
        except UnicodeDecodeError as e:
            raise TransactionVerificationException(
                tx.id, f"contract attachment is not source text: {e}")
        sandbox = DeterministicSandbox(instruction_budget=VERIFY_BUDGET)
        try:
            namespace = sandbox.load(source)
        except SandboxViolation as e:
            raise TransactionVerificationException(
                tx.id, f"contract attachment rejected by the sandbox: {e}")
        except SandboxBudgetError as e:
            raise TransactionVerificationException(
                tx.id, f"contract attachment exhausted its budget at "
                       f"load: {e}")
        contract_cls = namespace.get(self.contract_class)
        if contract_cls is None:
            raise TransactionVerificationException(
                tx.id, f"attachment does not define contract class "
                       f"{self.contract_class!r}")
        view = _transaction_view(self, tx)
        try:
            sandbox.run(contract_cls().verify, view)
        except SandboxBudgetError as e:
            raise TransactionVerificationException(
                tx.id, f"sandboxed contract exhausted its budget: {e}")
        except TransactionVerificationException:
            raise
        except Exception as e:
            raise TransactionVerificationException(
                tx.id, f"sandboxed contract rejected: {e}")


def _transaction_view(contract: AttachmentContract, tx) -> dict:
    """Reduce the transaction to plain data for the sandboxed verify: only
    the states/commands belonging to THIS contract, as dicts of primitives
    (the sandbox whitelist has no framework types)."""

    def state_view(state):
        return {"class": state.contract_class,
                "fields": dict(state.fields),
                "owners": [k.encoded for k in state.owners]}

    inputs = [state_view(s) for s in tx.inputs
              if isinstance(s, SandboxedState)
              and s.contract == contract]
    outputs = [state_view(s) for s in tx.outputs
               if isinstance(s, SandboxedState)
               and s.contract == contract]
    commands = [{"name": c.value.name, "args": list(c.value.args),
                 "signers": [k.encoded for k in c.signers]}
                for c in tx.commands
                if isinstance(c.value, SandboxedCommand)]
    return {"inputs": inputs, "outputs": outputs, "commands": commands}
