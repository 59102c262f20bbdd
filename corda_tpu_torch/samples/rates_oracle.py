"""Interest-rates oracle: query + tear-off attestation.

Reference parity: samples/irs-demo NodeInterestRates.Oracle
(NodeInterestRates.kt:88-180) and RatesFixFlow — the oracle pattern: a flow
queries the oracle for a fix, embeds it as a command, then sends a FILTERED
transaction revealing only the oracle's command; the oracle checks every
revealed component with `check_with_fun` (it cannot be tricked into signing
extras it can't see aren't there — the tear-off privacy/integrity model) and
signs the Merkle root.

A copy of the reference's module, with the same registered wire names
(``oracle.FixOf``, ``oracle.Fix``, ``oracle.QueryRequest``,
``oracle.SignRequest``) and field orders, so a ``Fix`` command hashes to the
same Merkle leaf in both packages. One difference: ``RatesOracle.sign_batch``
checks the tear-offs' proofs on the oracle node's device
(``hub.device``, kernel B6 for rounds at or above the crossover).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.contracts.structures import CommandData
from ..core.crypto.signatures import DigitalSignatureWithKey
from ..core.serialization import register_type
from ..core.transactions.filtered import FilteredTransaction
from ..flows.api import (FlowException, FlowLogic, Receive, Send,
                         SendAndReceive, initiating_flow)


@dataclass(frozen=True)
class FixOf:
    """Identifies a fix: name + day + tenor (NodeInterestRates FixOf)."""

    name: str
    for_day: str          # ISO date string (deterministic wire form)
    tenor: str            # e.g. "3M"


@dataclass(frozen=True)
class Fix(CommandData):
    """An observed rate embedded as a command (reference Fix)."""

    of: FixOf
    value_bp: int         # basis points — integer, consensus-safe


@dataclass(frozen=True)
class QueryRequest:
    queries: tuple        # FixOf...


@dataclass(frozen=True)
class SignRequest:
    ftx: FilteredTransaction


for _cls in (FixOf, Fix, QueryRequest, SignRequest):
    register_type(f"oracle.{_cls.__name__}", _cls)


class RatesOracle:
    """The @CordaService half, installed on the oracle node. Holds a fix
    table; answers queries; signs tear-offs it fully agrees with."""

    def __init__(self, hub, fixes: dict[FixOf, int]):
        self.hub = hub
        self.fixes = dict(fixes)

    def install(self, smm) -> None:
        from ..flows.api import flow_name
        oracle = self
        smm.register_flow_factory(
            flow_name(RatesFixQueryFlow),
            lambda peer: _QueryHandler(peer, oracle))
        smm.register_flow_factory(
            flow_name(RatesFixSignFlow),
            lambda peer: _SignHandler(peer, oracle))

    # -- service logic (NodeInterestRates.kt:110-160) ------------------------
    def query(self, queries) -> list[Fix]:
        out = []
        for q in queries:
            if q not in self.fixes:
                raise FlowException(f"Unknown fix {q}")
            out.append(Fix(q, self.fixes[q]))
        return out

    def sign(self, ftx: FilteredTransaction) -> DigitalSignatureWithKey:
        if not ftx.verify():
            raise FlowException("Tear-off failed Merkle verification")
        me = self.hub.my_info.legal_identity

        def acceptable(component) -> bool:
            # Only commands carrying a Fix we agree with, addressed to us
            from ..core.contracts.structures import Command
            if isinstance(component, Command):
                return (isinstance(component.value, Fix)
                        and me.owning_key in component.signers
                        and self.fixes.get(component.value.of)
                        == component.value.value_bp)
            return False

        if not ftx.filtered_leaves.check_with_fun(acceptable):
            raise FlowException(
                "Oracle refuses: revealed components are not exactly "
                "agreeable Fix commands")
        return self.hub.sign(ftx.root_hash.bytes, me.owning_key)

    def sign_batch(self, ftxs) -> list:
        """Bulk attestation: verify EVERY tear-off's Merkle proof in one
        device-batched pass on the oracle node's device
        (core.transactions.batch_merkle — the
        NodeInterestRates.kt:149-180 hot path at load, BASELINE config 3),
        then apply the same per-item acceptance policy as :meth:`sign`.
        Returns one DigitalSignatureWithKey or FlowException per ftx —
        per-item isolation: a bad proof never blocks the rest of the
        batch."""
        from ..core.transactions.batch_merkle import verify_filtered_batch
        proofs_ok = verify_filtered_batch(ftxs, device=self.hub.device)
        me = self.hub.my_info.legal_identity

        def acceptable(component) -> bool:
            from ..core.contracts.structures import Command
            if isinstance(component, Command):
                return (isinstance(component.value, Fix)
                        and me.owning_key in component.signers
                        and self.fixes.get(component.value.of)
                        == component.value.value_bp)
            return False

        out = []
        for ftx, ok in zip(ftxs, proofs_ok):
            if not ok:
                out.append(FlowException("Tear-off failed Merkle verification"))
            elif not ftx.filtered_leaves.check_with_fun(acceptable):
                out.append(FlowException(
                    "Oracle refuses: revealed components are not exactly "
                    "agreeable Fix commands"))
            else:
                out.append(self.hub.sign(ftx.root_hash.bytes, me.owning_key))
        return out


# ---------------------------------------------------------------------------
# Client flows (RatesFixFlow split into its query/sign sub-flows)
# ---------------------------------------------------------------------------

@initiating_flow
class RatesFixQueryFlow(FlowLogic):
    def __init__(self, oracle_party, fix_of: FixOf):
        self.oracle_party = oracle_party
        self.fix_of = fix_of

    def call(self):
        resp = yield SendAndReceive(self.oracle_party,
                                    QueryRequest((self.fix_of,)), list)
        fixes = resp.unwrap(
            lambda r: r if r and isinstance(r[0], Fix) else _bad())
        return fixes[0]


@initiating_flow
class RatesFixSignFlow(FlowLogic):
    def __init__(self, oracle_party, ftx: FilteredTransaction):
        self.oracle_party = oracle_party
        self.ftx = ftx

    def call(self):
        resp = yield SendAndReceive(self.oracle_party, SignRequest(self.ftx),
                                    DigitalSignatureWithKey)

        def validate(sig):
            if not isinstance(sig, DigitalSignatureWithKey):
                raise FlowException("Oracle returned a non-signature")
            sig.verify(self.ftx.root_hash.bytes)
            return sig

        return resp.unwrap(validate)


class _QueryHandler(FlowLogic):
    def __init__(self, peer, oracle: RatesOracle):
        self.peer = peer
        self.oracle = oracle

    def call(self):
        req = yield Receive(self.peer, QueryRequest)
        fixes = self.oracle.query(req.unwrap(lambda r: r.queries))
        yield Send(self.peer, list(fixes))
        return None


class _SignHandler(FlowLogic):
    def __init__(self, peer, oracle: RatesOracle):
        self.peer = peer
        self.oracle = oracle

    def call(self):
        req = yield Receive(self.peer, SignRequest)
        sig = self.oracle.sign(req.unwrap(lambda r: r.ftx))
        yield Send(self.peer, sig)
        return None


def _bad():
    raise FlowException("Oracle returned malformed fixes")
