"""GeneratedLedger — property-based generation of always-valid ledgers.

Reference parity: verifier/src/integration-test/.../GeneratedLedger.kt:25-190
— the key fixture for bulk verification benchmarking and the device-kernel
parity harness: arbitrarily long chains of issuance/move/exit transitions
over a pool of identities, every transaction correctly signed and
platform-rule-valid, with a notary attached so the chains notarise. A copy
of corda_tpu.testing.generated_ledger: the same seed gives the same keys,
transaction ids and signatures.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..core.contracts.structures import (Command, StateAndRef, StateRef,
                                         TransactionState)
from ..core.crypto.keys import KeyPair, generate_keypair
from ..core.crypto.schemes import (ECDSA_SECP256K1_SHA256,
                                   EDDSA_ED25519_SHA512)
from ..core.identity import Party
from ..core.transactions.signed import SignedTransaction
from ..core.transactions.wire import WireTransaction
from ..testing.dummy import DummyContract, DummyState
from .generator import Generator


@dataclass
class LedgerState:
    """Generation-time model of the unspent set."""

    parties: list[tuple[Party, KeyPair]]
    notary: Party
    notary_kp: KeyPair
    unspent: list[StateAndRef] = field(default_factory=list)
    transactions: list[SignedTransaction] = field(default_factory=list)
    owners: dict = field(default_factory=dict)   # StateRef -> KeyPair


def make_generated_ledger(n_transactions: int, seed: int = 0,
                          n_parties: int = 4,
                          scheme_mix: bool = True) -> LedgerState:
    """Generate `n_transactions` valid signed transactions: ~30% issuances,
    ~55% moves, ~15% exits (shifting to issuance when the unspent set runs
    dry). `scheme_mix` spreads party keys across Ed25519 and secp256k1
    (the mixed-scheme batch of BASELINE config 2)."""
    rng = random.Random(seed)
    schemes = ([EDDSA_ED25519_SHA512, ECDSA_SECP256K1_SHA256] if scheme_mix
               else [EDDSA_ED25519_SHA512])
    parties = []
    for i in range(n_parties):
        kp = generate_keypair(schemes[i % len(schemes)],
                              entropy=rng.randbytes(32))
        parties.append((Party(f"O=Gen Party {i}, L=City, C=GB", kp.public), kp))
    notary_kp = generate_keypair(entropy=rng.randbytes(32))
    notary = Party("O=Gen Notary, L=Zurich, C=CH", notary_kp.public)
    ledger = LedgerState(parties, notary, notary_kp)

    party_gen = Generator.choice(range(n_parties))
    magic_gen = Generator.int_range(1, 1 << 30)
    kind_gen = Generator.frequency(
        (0.30, Generator.pure("issue")),
        (0.55, Generator.pure("move")),
        (0.15, Generator.pure("exit")))

    def sign(wtx: WireTransaction, *kps: KeyPair) -> SignedTransaction:
        from ..core.crypto.signatures import Crypto
        sigs = [Crypto.sign_with_key(kp, wtx.id.bytes) for kp in kps]
        return SignedTransaction.of(wtx, sigs)

    def record(stx: SignedTransaction, owner_kps) -> None:
        ledger.transactions.append(stx)
        for i, out in enumerate(stx.tx.outputs):
            ref = StateRef(stx.id, i)
            ledger.unspent.append(StateAndRef(out, ref))
            ledger.owners[ref] = owner_kps[i]

    for _ in range(n_transactions):
        kind = kind_gen.generate(rng)
        if kind != "issue" and not ledger.unspent:
            kind = "issue"
        if kind == "issue":
            who = party_gen.generate(rng)
            party, kp = parties[who]
            n_out = max(1, Generator.poisson_size(1.5, 4).generate(rng))
            outputs = tuple(
                TransactionState(DummyState(magic_gen.generate(rng),
                                            (party.owning_key,)), notary)
                for _ in range(n_out))
            wtx = WireTransaction(
                outputs=outputs,
                commands=(Command(DummyContract.Create(), (party.owning_key,)),),
                notary=notary, must_sign=(party.owning_key,))
            record(sign(wtx, kp), [kp] * n_out)
        else:
            idx = rng.randrange(len(ledger.unspent))
            sar = ledger.unspent.pop(idx)
            owner_kp = ledger.owners[sar.ref]
            if kind == "move":
                who = party_gen.generate(rng)
                new_party, new_kp = parties[who]
                outputs = (TransactionState(
                    DummyState(sar.state.data.magic_number,
                               (new_party.owning_key,)), notary),)
                owner_kps = [new_kp]
            else:  # exit: consume with no outputs
                outputs = ()
                owner_kps = []
            wtx = WireTransaction(
                inputs=(sar.ref,), outputs=outputs,
                commands=(Command(DummyContract.Move(),
                                  (owner_kp.public,)),),
                notary=notary,
                must_sign=(owner_kp.public, notary.owning_key))
            record(sign(wtx, owner_kp, notary_kp), owner_kps)
    return ledger


def signature_triples(ledger: LedgerState):
    """Flatten the ledger into (key, signature, content) checks — the raw feed
    for the device signature batcher (the bulk-verification benchmark input)."""
    triples = []
    for stx in ledger.transactions:
        for sig in stx.sigs:
            triples.append((sig.by, sig.bytes, stx.id.bytes))
    return triples
