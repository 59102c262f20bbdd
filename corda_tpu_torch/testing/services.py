"""MockServices — an in-memory ServiceHub stand-in for unit tests.

Reference parity: node/MockServices.kt:1-199 (state/attachment/identity/key
stubs backing `toLedgerTransaction` resolution and signing in tests). The
attachment/identity implementations are the node's in-memory services
(node.services) re-exported under their Mock names.
"""
from __future__ import annotations

from ..core.contracts.structures import StateRef, TransactionState
from ..core.crypto.keys import KeyPair, PublicKey
from ..core.crypto.signatures import Crypto, DigitalSignatureWithKey
from ..core.identity import Party
from ..node.services import (InMemoryAttachmentStorage as MockAttachmentStorage,
                             InMemoryIdentityService as MockIdentityService)

__all__ = ["MockAttachmentStorage", "MockIdentityService", "MockServices"]


class MockServices:
    """Minimal ServiceHub: state resolution, attachments, identity, signing."""

    def __init__(self, key_pairs: list[KeyPair] = (), parties: list[Party] = ()):
        self.key_pairs = {kp.public: kp for kp in key_pairs}
        self.attachments = MockAttachmentStorage()
        self.identity_service = MockIdentityService(parties)
        self._states: dict[StateRef, TransactionState] = {}
        self.recorded: list = []

    # -- state resolution (WireTransaction.toLedgerTransaction seam) --------
    def load_state(self, ref: StateRef) -> TransactionState | None:
        return self._states.get(ref)

    def record_transactions(self, *stxs) -> None:
        """Make each transaction's outputs resolvable as future inputs."""
        for stx in stxs:
            self.recorded.append(stx)
            wtx = stx.tx if hasattr(stx, "tx") else stx
            for i, out in enumerate(wtx.outputs):
                self._states[StateRef(wtx.id, i)] = out

    def add_state(self, ref: StateRef, state: TransactionState) -> None:
        self._states[ref] = state

    # -- signing ------------------------------------------------------------
    def sign(self, content: bytes, key: PublicKey) -> DigitalSignatureWithKey:
        kp = self.key_pairs[key]
        return Crypto.sign_with_key(kp, content)

    def sign_transaction(self, wtx_or_stx, *keys: PublicKey):
        """WireTransaction → SignedTransaction (or add sigs to an existing one)."""
        from ..core.transactions.signed import SignedTransaction

        if isinstance(wtx_or_stx, SignedTransaction):
            sigs = [self.sign(wtx_or_stx.id.bytes, k) for k in keys]
            return wtx_or_stx.plus(*sigs)
        wtx = wtx_or_stx
        sigs = [self.sign(wtx.id.bytes, k) for k in keys]
        return SignedTransaction.of(wtx, sigs)
