"""Interest-rate-swap demo — scheduler + oracle + tear-offs, end to end.

Reference parity: samples/irs-demo —
- ``InterestRateSwap.kt``: the swap state (fixed leg vs floating leg over a
  payment schedule) re-scoped to the lifecycle essentials: notional, the two
  legs, the fixing calendar, and the applied fixes. The reference's full
  day-count/payment-event machinery is out of scope; what this demo keeps is
  the part that exercises the PLATFORM: a SchedulableState whose
  `nextScheduledActivity` drives FixingFlow through the node scheduler
  (InterestRateSwap.kt `nextFixingOf`/`nextScheduledActivity`).
- ``FixingFlow.kt:26``: the scheduler-started agent that queries the rates
  oracle, embeds the Fix as a command, has the oracle sign a FILTERED
  transaction (tear-off: the oracle sees only its command —
  NodeInterestRates.kt:149-180), collects the counterparty signature, and
  finalises.
- The oracle itself is ``samples/rates_oracle.py``.

The fixing agent runs on BOTH parties' schedulers; the floating-leg payer
drives (the FixingRoleDecider analog) and the fixed-leg payer's run
no-ops, so exactly one fixing transaction is built per calendar date.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass, replace

from ..core.contracts.exceptions import TransactionVerificationException
from ..core.contracts.structures import (Command, CommandData, Contract,
                                         SchedulableState, ScheduledActivity,
                                         StateAndRef)
from ..core.identity import Party
from ..core.serialization import register_type
from ..core.transactions.builder import TransactionBuilder
from ..core.transactions.filtered import FilteredTransaction
from ..flows.api import FlowLogic, initiating_flow, startable_by_rpc
from ..flows.library import (CollectSignaturesFlow, FinalityFlow,
                             SignTransactionFlow)
from .rates_oracle import (Fix, FixOf, RatesFixQueryFlow, RatesFixSignFlow)


@dataclass(frozen=True)
class FixedLeg:
    """The party paying a fixed rate (InterestRateSwap.FixedLeg, scoped)."""

    payer: Party
    rate_bp: int                  # fixed rate in basis points


@dataclass(frozen=True)
class FloatingLeg:
    """The party paying the floating index (InterestRateSwap.FloatingLeg)."""

    payer: Party
    index_name: str               # e.g. "LIBOR"
    tenor: str                    # e.g. "3M"


@dataclass(frozen=True)
class AgreeCommand(CommandData):
    """Both parties enter the swap (the reference's Agree)."""


@dataclass(frozen=True)
class FixCommand(CommandData):
    """Participants approve applying the oracle's fix (alongside the oracle's
    own Fix command)."""


@dataclass(frozen=True)
class InterestRateSwapState(SchedulableState):
    """The live swap. ``fixing_dates`` is the fixing calendar (ISO dates);
    ``applied_fixes`` grows by one Fix per completed fixing — the reference's
    mutated Calculation (InterestRateSwap.kt evolves floatingLeg rates)."""

    fixed_leg: FixedLeg
    floating_leg: FloatingLeg
    notional: int
    oracle: Party
    fixing_dates: tuple = ()      # ISO "YYYY-MM-DD" strings, in order
    applied_fixes: tuple = ()     # Fix...

    @property
    def contract(self):
        return InterestRateSwap()

    @property
    def participants(self):
        return [self.fixed_leg.payer.owning_key,
                self.floating_leg.payer.owning_key]

    # -- fixing calendar -----------------------------------------------------
    def next_fix_of(self) -> FixOf | None:
        if len(self.applied_fixes) >= len(self.fixing_dates):
            return None
        return FixOf(self.floating_leg.index_name,
                     self.fixing_dates[len(self.applied_fixes)],
                     self.floating_leg.tenor)

    def with_fix(self, fix: Fix) -> "InterestRateSwapState":
        return replace(self, applied_fixes=self.applied_fixes + (fix,))

    def next_scheduled_activity(self, this_state_ref, flow_logic_ref_factory
                                ) -> ScheduledActivity | None:
        fix_of = self.next_fix_of()
        if fix_of is None:
            return None
        at = datetime.datetime.fromisoformat(fix_of.for_day).replace(
            tzinfo=datetime.timezone.utc)
        return ScheduledActivity(
            flow_logic_ref_factory.create(FixingFlow, this_state_ref), at)


for _cls in (FixedLeg, FloatingLeg, AgreeCommand, FixCommand,
             InterestRateSwapState):
    register_type(f"irs.{_cls.__name__}", _cls)


class InterestRateSwap(Contract):
    """The swap contract: agreement shape + fix application integrity
    (InterestRateSwap.kt verify clauses, re-scoped)."""

    def verify(self, tx) -> None:
        irs_inputs = [s for s in tx.inputs
                      if isinstance(s, InterestRateSwapState)]
        irs_outputs = [s.data if hasattr(s, "data") else s
                       for s in tx.outputs]
        irs_outputs = [s for s in irs_outputs
                       if isinstance(s, InterestRateSwapState)]
        agrees = [c for c in tx.commands if isinstance(c.value, AgreeCommand)]
        fixes = [c for c in tx.commands if isinstance(c.value, Fix)]
        if agrees:
            self._verify_agree(irs_inputs, irs_outputs, agrees[0])
        elif fixes:
            self._verify_fix(irs_inputs, irs_outputs, fixes[0], tx)
        else:
            raise TransactionVerificationException(
                None, "IRS transaction needs an Agree or Fix command")

    @staticmethod
    def _verify_agree(inputs, outputs, agree) -> None:
        _req(not inputs, "an agreement consumes no swap")
        _req(len(outputs) == 1, "an agreement produces exactly one swap")
        swap = outputs[0]
        _req(swap.notional > 0, "notional must be positive")
        _req(swap.fixing_dates, "the fixing calendar must not be empty")
        _req(not swap.applied_fixes, "a new swap has no applied fixes")
        _req(swap.fixed_leg.payer != swap.floating_leg.payer,
             "the legs must have distinct payers")
        for key in swap.participants:
            _req(any(key in c.signers for c in [agree]),
                 "both payers must sign the agreement")

    @staticmethod
    def _verify_fix(inputs, outputs, fix_cmd, tx) -> None:
        _req(len(inputs) == 1 and len(outputs) == 1,
             "a fixing consumes one swap and produces one swap")
        before, after = inputs[0], outputs[0]
        fix: Fix = fix_cmd.value
        _req(before.next_fix_of() == fix.of,
             "the fix must be the swap's next expected fixing")
        _req(after == before.with_fix(fix),
             "the output must be the input with exactly this fix applied")
        _req(before.oracle.owning_key in fix_cmd.signers,
             "the oracle must sign the fix")
        approvals = [c for c in tx.commands
                     if isinstance(c.value, FixCommand)]
        _req(bool(approvals), "participants must approve the fix")
        for key in before.participants:
            _req(any(key in c.signers for c in approvals),
                 "both payers must approve the fix")


def _req(cond, message: str) -> None:
    if not cond:
        raise TransactionVerificationException(None, f"IRS: {message}")


# ---------------------------------------------------------------------------
# Flows
# ---------------------------------------------------------------------------

@startable_by_rpc
@initiating_flow
class AgreeSwapFlow(FlowLogic):
    """Enter the swap: build, sign, collect the counterparty's signature,
    finalise (the demo's deal-entry step)."""

    def __init__(self, swap: InterestRateSwapState, notary: Party):
        self.swap = swap
        self.notary = notary

    def call(self):
        hub = self.service_hub
        me = hub.my_info.legal_identity
        builder = TransactionBuilder(notary=self.notary)
        builder.add_output_state(self.swap, self.notary)
        builder.add_command(Command(AgreeCommand(),
                                    tuple(self.swap.participants)))
        builder.sign_with(hub.key_management.key_pair(me.owning_key))
        stx = builder.to_signed_transaction(check_sufficient_signatures=False)
        stx = yield from self.sub_flow(CollectSignaturesFlow(stx))
        return (yield from self.sub_flow(FinalityFlow(stx)))


@initiating_flow
class FixingFlow(FlowLogic):
    """The scheduler-started fixing agent (FixingFlow.kt:26): query the
    oracle, apply the fix, tear off everything but the Fix command for the
    oracle's signature, collect the counterparty's approval, finalise.
    Started by NodeSchedulerService from the swap's next_scheduled_activity
    on BOTH parties; only the floating-leg payer proceeds."""

    def __init__(self, ref):
        self.ref = ref

    def call(self):
        hub = self.service_hub
        ts = hub.load_state(self.ref)
        if ts is None:
            return None                     # already consumed elsewhere
        swap: InterestRateSwapState = ts.data
        me = hub.my_info.legal_identity
        if me != swap.floating_leg.payer:
            return None                     # fixer role: floating payer drives
        fix_of = swap.next_fix_of()
        if fix_of is None:
            return None
        fix = yield from self.sub_flow(
            RatesFixQueryFlow(swap.oracle, fix_of))

        builder = TransactionBuilder(notary=ts.notary)
        builder.add_input_state(StateAndRef(ts, self.ref))
        builder.add_output_state(swap.with_fix(fix), ts.notary)
        builder.add_command(Command(fix, (swap.oracle.owning_key,)))
        builder.add_command(Command(FixCommand(),
                                    tuple(swap.participants)))
        builder.sign_with(hub.key_management.key_pair(me.owning_key))
        stx = builder.to_signed_transaction(check_sufficient_signatures=False)

        # the oracle signs a tear-off revealing ONLY its Fix command
        ftx = FilteredTransaction.build_filtered_transaction(
            stx.tx, lambda component: isinstance(component, Command)
            and isinstance(component.value, Fix))
        oracle_sig = yield from self.sub_flow(
            RatesFixSignFlow(swap.oracle, ftx))
        stx = stx.with_additional_signature(oracle_sig)

        stx = yield from self.sub_flow(CollectSignaturesFlow(stx))
        return (yield from self.sub_flow(FinalityFlow(stx)))


class IrsSignHandler(SignTransactionFlow):
    """Counterparty responder for the demo: accepts well-formed IRS
    transactions (the contract + oracle checks carry the integrity)."""

    def check_transaction(self, stx) -> None:
        wtx = stx.tx
        if not any(isinstance(s.data, InterestRateSwapState)
                   for s in wtx.outputs):
            from ..flows.api import FlowException
            raise FlowException("not an IRS transaction")


def install_irs_demo(node) -> None:
    """Register the demo's responder on a MockNetwork node (the cordapp
    install step)."""
    from ..flows.api import flow_name
    node.smm.register_flow_factory(flow_name(CollectSignaturesFlow),
                                   IrsSignHandler)
