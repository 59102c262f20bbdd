"""Cash flows: issue, pay, exit.

Reference parity: finance/.../flows/CashIssueFlow.kt, CashPaymentFlow.kt,
CashExitFlow.kt (thin flows over the Cash contract's builder helpers +
FinalityFlow, with vault coin selection and soft locking for payments).
"""
from __future__ import annotations

from ..core.contracts.amount import Amount
from ..core.contracts.structures import PartyAndReference
from ..core.transactions.builder import TransactionBuilder
from ..flows.api import FlowException, FlowLogic, initiating_flow, startable_by_rpc
from ..flows.library import FinalityFlow
from .cash import Cash, CashState, InsufficientBalanceException


@startable_by_rpc
@initiating_flow
class CashIssueFlow(FlowLogic):
    """Issue `amount` of our own currency to `recipient`, notarised by
    `notary` (CashIssueFlow.kt)."""

    def __init__(self, amount: Amount, issuer_ref: bytes, recipient, notary):
        self.amount = amount
        self.issuer_ref = issuer_ref
        self.recipient = recipient
        self.notary = notary

    def call(self):
        me = self.service_hub.my_info.legal_identity
        builder = TransactionBuilder(notary=self.notary)
        Cash.generate_issue(builder, self.amount,
                            PartyAndReference(me, self.issuer_ref),
                            self.recipient.owning_key, self.notary)
        builder.sign_with(self.service_hub.key_management.key_pair(me.owning_key))
        stx = builder.to_signed_transaction(check_sufficient_signatures=False)
        final = yield from self.sub_flow(FinalityFlow(stx, [self.recipient]))
        return final


@startable_by_rpc
@initiating_flow
class CashPaymentFlow(FlowLogic):
    """Pay `amount` to `recipient` from our vault (CashPaymentFlow.kt):
    coin-select + soft-lock, build the move, sign, finalise."""

    def __init__(self, amount: Amount, recipient):
        self.amount = amount
        self.recipient = recipient

    def call(self):
        # Coin selection reads mutable vault state → must execute exactly once
        # and be checkpointed, or a restart would rebuild a DIFFERENT spend
        # than the one already sent for notarisation (flows.api.ExecuteOnce).
        stx = yield from self.record(self._build_spend)
        final = yield from self.sub_flow(FinalityFlow(stx, [self.recipient]))
        return final

    def _build_spend(self):
        hub = self.service_hub
        me = hub.my_info.legal_identity
        lock_id = self.run_id or "payment"
        coins = hub.vault.try_lock_states_for_spending(
            lock_id, self.amount.quantity, CashState,
            quantity_of=lambda s: s.amount.quantity,
            state_filter=lambda s: s.amount.token.product == self.amount.token)
        if not coins:
            raise FlowException(f"Insufficient cash to pay {self.amount}")
        try:
            builder = TransactionBuilder()
            Cash.generate_spend(builder, self.amount,
                                self.recipient.owning_key, coins,
                                change_owner=me.owning_key)
            builder.sign_with(hub.key_management.key_pair(me.owning_key))
            return builder.to_signed_transaction(check_sufficient_signatures=False)
        except InsufficientBalanceException as e:
            hub.vault.soft_lock_release(lock_id)
            raise FlowException(str(e)) from e
        except Exception:
            hub.vault.soft_lock_release(lock_id)
            raise


@startable_by_rpc
@initiating_flow
class CashExitFlow(FlowLogic):
    """Remove `amount` of our issued cash from the ledger (CashExitFlow.kt)."""

    def __init__(self, amount: Amount, issuer_ref: bytes):
        self.amount = amount
        self.issuer_ref = issuer_ref

    def call(self):
        stx = yield from self.record(self._build_exit)  # vault read: see above
        final = yield from self.sub_flow(FinalityFlow(stx))
        return final

    def _build_exit(self):
        from ..core.contracts.structures import Issued
        from .cash import Exit, Move
        hub = self.service_hub
        me = hub.my_info.legal_identity
        issued_token = Issued(PartyAndReference(me, self.issuer_ref),
                              self.amount.token)
        coins = [sar for sar in hub.vault.unconsumed_states(CashState)
                 if sar.state.data.amount.token == issued_token]
        gathered, used = 0, []
        for sar in coins:
            used.append(sar)
            gathered += sar.state.data.amount.quantity
            if gathered >= self.amount.quantity:
                break
        if gathered < self.amount.quantity:
            raise FlowException(f"Insufficient cash to exit {self.amount}")
        builder = TransactionBuilder()
        for sar in used:
            builder.add_input_state(sar)
        if gathered > self.amount.quantity:
            builder.add_output_state(CashState(
                Amount(gathered - self.amount.quantity, issued_token),
                me.owning_key), used[0].state.notary)
        exit_amount = Amount(self.amount.quantity, issued_token)
        builder.add_command(Exit(exit_amount), me.owning_key)
        # conservation is enforced by the Move clause (inputs = outputs + exit)
        builder.add_command(Move(), me.owning_key)
        builder.sign_with(hub.key_management.key_pair(me.owning_key))
        return builder.to_signed_transaction(check_sufficient_signatures=False)
