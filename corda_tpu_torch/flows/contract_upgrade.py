"""Contract upgrade: migrate a state to a new contract version with every
participant's prior authorisation.

Reference parity: ContractUpgradeFlow.kt (+ UpgradedContract in core): each
participant AUTHORISES the upgrade out-of-band first (recorded against the
state ref); the instigator then proposes an upgrade transaction whose
outputs are exactly `upgraded_contract.upgrade(input_state)`; acceptors
refuse anything they have not authorised or that rewrites state beyond the
upgrade function; everyone signs, the old notary notarises, finality
broadcasts. The transaction carries an UpgradeCommand naming the new
contract, which the upgraded contract's verify must accept.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.contracts.structures import (Command, CommandData, StateAndRef,
                                         StateRef, TransactionState)
from ..core.crypto.signatures import DigitalSignatureWithKey
from ..core.serialization import register_type, serializable
from ..core.transactions.signed import SignedTransaction
from ..core.transactions.wire import WireTransaction
from .api import (FlowException, FlowLogic, Receive, Send, SendAndReceive,
                  initiating_flow)
from .library import FinalityFlow, _party_by_key


class UpgradedContract:
    """Interface for the new contract version (core UpgradedContract):
    `legacy_contract_name` names what it upgrades FROM, `upgrade(old_state)`
    maps old state data to new."""

    legacy_contract_name: str = ""

    def upgrade(self, old_state):
        raise NotImplementedError


@serializable("UpgradeCommand", to_fields=lambda c: [c.upgraded_contract_name],
              from_fields=lambda f: UpgradeCommand(f[0]))
@dataclass(frozen=True)
class UpgradeCommand(CommandData):
    upgraded_contract_name: str


@dataclass(frozen=True)
class UpgradeProposal:
    stx: object
    ref: object
    upgraded_contract_name: str


register_type("flows.UpgradeProposal", UpgradeProposal)


def contract_name(contract) -> str:
    cls = contract if isinstance(contract, type) else type(contract)
    return f"{cls.__module__}.{cls.__qualname__}"


def authorise_contract_upgrade(hub, state_and_ref: StateAndRef,
                               upgraded_contract) -> None:
    """Record consent to upgrade `state_and_ref` to `upgraded_contract`
    (CordaRPCOps.authoriseContractUpgrade)."""
    if not hasattr(hub, "contract_upgrade_authorisations"):
        hub.contract_upgrade_authorisations = {}
    hub.contract_upgrade_authorisations[state_and_ref.ref] = \
        contract_name(upgraded_contract)


def deauthorise_contract_upgrade(hub, state_and_ref: StateAndRef) -> None:
    getattr(hub, "contract_upgrade_authorisations", {}).pop(
        state_and_ref.ref, None)


class ContractUpgradeException(FlowException):
    pass


@initiating_flow
class ContractUpgradeFlow(FlowLogic):
    """Instigator: build the upgrade tx, collect acceptances, finalise."""

    def __init__(self, state_and_ref: StateAndRef, upgraded_contract):
        self.state_and_ref = state_and_ref
        self.upgraded_contract = upgraded_contract

    def call(self):
        hub = self.service_hub
        old = self.state_and_ref.state
        new_data = self.upgraded_contract.upgrade(old.data)
        name = contract_name(self.upgraded_contract)
        participants = {getattr(p, "owning_key", p)
                        for p in old.data.participants}
        wtx = WireTransaction(
            inputs=(self.state_and_ref.ref,),
            outputs=(TransactionState(new_data, old.notary, old.encumbrance),),
            commands=(Command(UpgradeCommand(name), tuple(sorted(participants))),),
            notary=old.notary,
            must_sign=tuple(sorted(participants | {old.notary.owning_key})))
        stx = hub.sign_initial_transaction(wtx)
        our_keys = hub.key_management.keys
        for key in participants:
            if any(leaf in our_keys for leaf in key.keys):
                continue
            party = _party_by_key(hub, key)
            if party is None:
                raise ContractUpgradeException(
                    f"No well-known party for {key.to_string_short()}")
            resp = yield SendAndReceive(
                party, UpgradeProposal(stx, self.state_and_ref.ref, name),
                DigitalSignatureWithKey)

            def validate(sig, _key=key):
                sig.verify(stx.id.bytes)
                if not _key.is_fulfilled_by({sig.by}):
                    raise ContractUpgradeException(
                        "Acceptance signed by an unexpected key")
                return sig

            stx = stx.plus(resp.unwrap(validate))
        final = yield from self.sub_flow(FinalityFlow(
            stx, [p for p in (_party_by_key(hub, k) for k in participants)
                  if p is not None]))
        return StateAndRef(final.tx.outputs[0], StateRef(final.id, 0))


class ContractUpgradeAcceptor(FlowLogic):
    """Acceptor: sign only upgrades we authorised, exactly as proposed."""

    def __init__(self, peer):
        self.peer = peer

    def call(self):
        req = yield Receive(self.peer, UpgradeProposal)
        proposal = req.unwrap(
            lambda r: r if isinstance(r, UpgradeProposal) else _refuse())
        hub = self.service_hub
        authorised = getattr(hub, "contract_upgrade_authorisations", {}).get(
            proposal.ref)
        if authorised != proposal.upgraded_contract_name:
            raise ContractUpgradeException(
                f"Upgrade of {proposal.ref} to "
                f"{proposal.upgraded_contract_name} is not authorised")
        stx: SignedTransaction = proposal.stx
        wtx = stx.tx
        if len(wtx.inputs) != 1 or wtx.inputs[0] != proposal.ref \
                or len(wtx.outputs) != 1:
            raise ContractUpgradeException("Malformed upgrade transaction")
        known = hub.load_state(proposal.ref)
        if known is None:
            raise ContractUpgradeException("Unknown state being upgraded")
        # rebuild the expected output with OUR copy of the upgrade function
        upgraded = _resolve_contract(proposal.upgraded_contract_name)
        if contract_name(known.data.contract) != upgraded.legacy_contract_name:
            raise ContractUpgradeException(
                "Upgrade does not apply to the state's current contract")
        expected = upgraded.upgrade(known.data)
        if wtx.outputs[0].data != expected or wtx.outputs[0].notary != known.notary:
            raise ContractUpgradeException(
                "Proposed output is not the authorised upgrade of the input")
        stx.check_signatures_are_valid()
        our_key = next((leaf for k in wtx.must_sign for leaf in k.keys
                        if leaf in hub.key_management.keys), None)
        if our_key is None:
            raise ContractUpgradeException("Our signature is not required")
        yield Send(self.peer, hub.key_management.sign(stx.id.bytes, our_key))
        return None


def _resolve_contract(name: str):
    from ..node.statemachine import _import_flow_class
    cls = _import_flow_class(name)
    return cls() if isinstance(cls, type) else cls


def _refuse():
    raise ContractUpgradeException("Malformed upgrade proposal")


def install_contract_upgrade_acceptor(smm) -> None:
    from .api import flow_name
    smm.register_flow_factory(flow_name(ContractUpgradeFlow),
                              ContractUpgradeAcceptor)
