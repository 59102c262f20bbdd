"""Signed transactions through the node's verifier service:
``TransactionVerifierService.verify_signed(stx, services)``.

The inputs are cash payments as the reference's CrossCash load test makes
them (``finance/cash.py`` Move: one issued input, a payment output and a
change output), payment i from party i mod ``parties`` to the next, each
signed by the input's owner and by the notary over the transaction's id.
Every ``bad_signature_every``-th carries one bad signature (the owner's and
the notary's in turn, ``bad_signature_kinds`` kinds), every
``unconserved_every``-th destroys one cent. The transactions are built in
the pool with the program's own classes (they are its input format) and
come back pickled beside a plain description that the reference judges.
The reference takes the signed id from the program's ``WireTransaction``:
it does not work the id out again.
"""
from __future__ import annotations

from harness import inputs as gen
from harness import reference as ref

from . import Prepared

CONTROL = "cash_conservation"

NOTARY_NAME = "O=Notary Service, L=Zurich, C=CH"
ISSUER_NAME = "O=Bank of Corda, L=London, C=GB"


def payment_plan(seed: int, i: int, mix: dict, config: dict) -> dict:
    """The plain description of payment ``i``: who owns the input, who is
    paid, the amounts, and what is broken in it."""
    parties = config["parties"]
    owner, payee = ((gen.owner_scheme(config, p), p)
                    for p in (i % parties, (i + 1) % parties))
    r = int.from_bytes(gen.digest(seed, "amount", i), "big")
    lo, hi = mix["input_cents"]
    qty = lo + r % (hi - lo + 1)
    pay = 1 + (r >> 64) % (qty - 2)
    plan = {"owner": owner, "payee": payee, "qty": qty, "pay": pay,
            "change": qty - pay, "bad_sig": None}
    if i % mix["unconserved_every"] == mix["unconserved_offset"]:
        plan["change"] -= 1                    # one cent destroyed
    if i % mix["bad_signature_every"] == mix["bad_signature_offset"]:
        b = i // mix["bad_signature_every"]
        plan["bad_sig"] = ("owner" if b % 2 == 0 else "notary",
                           (b // 2) % mix["bad_signature_kinds"])
    return plan


def payment_label(plan: dict) -> str:
    """What the payment was built to be: "signature" (one bad signature),
    "contract" (cash not conserved) or "accept"."""
    if plan["bad_sig"] is not None:
        return "signature"
    if plan["qty"] != plan["pay"] + plan["change"]:
        return "contract"
    return "accept"


def chunk(job):
    """Payments ``job['indices']`` as (i, SignedTransaction, input StateRef,
    input TransactionState, plain description)."""
    from corda_tpu_torch.core.contracts import Command, TransactionState
    from corda_tpu_torch.core.contracts.amount import Amount, USD
    from corda_tpu_torch.core.contracts.structures import (
        Issued, PartyAndReference, StateRef)
    from corda_tpu_torch.core.crypto import PublicKey
    from corda_tpu_torch.core.crypto import schemes as port_schemes
    from corda_tpu_torch.core.crypto.secure_hash import SecureHash
    from corda_tpu_torch.core.crypto.signatures import DigitalSignatureWithKey
    from corda_tpu_torch.core.identity import Party
    from corda_tpu_torch.core.transactions import (SignedTransaction,
                                                   WireTransaction)
    from corda_tpu_torch.finance.cash import CashState, Move

    seed, mix, config = job["seed"], job["mix"], job["config"]

    def key(scheme, role, j):
        return PublicKey(getattr(port_schemes, scheme),
                         gen.signer(seed, scheme, role, j)[1])

    notary_scheme = config["notary_scheme"]
    notary = Party(NOTARY_NAME, key(notary_scheme, "notary", 0))
    issuer = Party(ISSUER_NAME, key(gen.ED25519, "issuer", 0))
    token = Issued(PartyAndReference(issuer, b"\x01"), USD)
    out = []
    for i in job["indices"]:
        plan = payment_plan(seed, i, mix, config)
        o_scheme, o_j = plan["owner"]
        owner = key(o_scheme, "owner", o_j)
        payee = key(plan["payee"][0], "owner", plan["payee"][1])
        ref = StateRef(SecureHash(gen.digest(seed, "issuance", i)), 0)
        state = TransactionState(CashState(Amount(plan["qty"], token), owner),
                                 notary)
        wtx = WireTransaction(
            inputs=(ref,),
            outputs=(TransactionState(
                CashState(Amount(plan["pay"], token), payee), notary),
                TransactionState(CashState(Amount(plan["change"], token),
                                           owner), notary)),
            commands=(Command(Move(), (owner,)),),
            notary=notary, must_sign=(owner, notary.owning_key))
        msg = wtx.id.bytes
        sigs, plain_sigs = [], []
        for role, scheme, j, pk in (("owner", o_scheme, o_j, owner),
                                    ("notary", notary_scheme, 0,
                                     notary.owning_key)):
            priv, pub = gen.signer(seed, scheme, role, j)
            label = (i, role)
            if plan["bad_sig"] is not None and plan["bad_sig"][0] == role:
                other = gen.signer(seed, scheme, "other", i % 7)[1]
                enc, sig = gen.bad_signature(seed, scheme, priv, pub, msg,
                                             plan["bad_sig"][1], other, label)
            else:
                enc, sig = pub, gen.sign(seed, scheme, priv, pub, msg, label)
            by = pk if enc == pub else PublicKey(pk.scheme, enc)
            sigs.append(DigitalSignatureWithKey(sig, by))
            plain_sigs.append((scheme, enc, sig))
        stx = SignedTransaction.of(wtx, sigs)
        spec = {"id": msg, "sigs": plain_sigs,
                "required": [(o_scheme, owner.encoded),
                             (notary_scheme, notary.owning_key.encoded)],
                "move_signers": [(o_scheme, owner.encoded)],
                "notary": (notary_scheme, notary.owning_key.encoded),
                "input_owner": (o_scheme, owner.encoded),
                "input_qty": plan["qty"],
                "output_qtys": [plan["pay"], plan["change"]]}
        out.append((i, stx, ref, state, spec))
    return out


def jobs(seed: int, mix: dict, config: dict, workers: int) -> list:
    gen.check_config(config)
    return [{"seed": seed, "mix": mix, "config": config,
             "indices": list(range(w, mix["distinct"], workers))}
            for w in range(workers)]


def prepare(rows, seed: int, mix: dict, config: dict) -> Prepared:
    plain = [r[4] for r in rows]
    labels = [payment_label(payment_plan(seed, r[0], mix, config))
              for r in rows]
    services = StateMap({r[2]: r[3] for r in rows})
    return Prepared(([r[1] for r in rows], services), plain, labels,
                    len(plain), 1)


class StateMap:
    """The services a SignedTransaction resolves against: the input states
    by reference, and no attachments."""

    def __init__(self, states: dict):
        self.states = states
        self.attachments = self

    def load_state(self, ref):
        return self.states.get(ref)

    def open_attachment(self, att_id):
        return None


def build_target(config: dict, mix: dict, device: str):
    """The configuration's verifier service, as ``python -m
    corda_tpu_torch.node`` sets it up: the program's defaults, but a host
    crossover that the configuration sets."""
    from corda_tpu_torch.verifier.service import make_verifier_service
    service = make_verifier_service(config["verifier_type"], device=device)
    if config.get("host_crossover") is not None:
        service.batcher.host_crossover = config["host_crossover"]
    return service


def batcher_of(target):
    return target.batcher


def close_target(target) -> None:
    target.shutdown()             # closes its batcher too


def submitter(target, mix: dict, inputs):
    stxs, services = inputs
    return lambda k: target.verify_signed(stxs[k], services)


def outcome_reader(mix: dict):
    """outcome(future) -> "accept", "signature", "missing" or "contract";
    ("error", type name) for any other failure."""
    from corda_tpu_torch.core.contracts.exceptions import (
        TransactionVerificationException)
    from corda_tpu_torch.core.crypto.signatures import SignatureException
    from corda_tpu_torch.core.transactions.signed import (
        SignaturesMissingException)

    def outcome(fut):
        try:
            fut.result(timeout=0)
            return "accept"
        except SignaturesMissingException:
            return "missing"
        except SignatureException:
            return "signature"
        except TransactionVerificationException:
            return "contract"
        except Exception as exc:       # a failure, not a verdict
            return ("error", type(exc).__name__)
    return outcome


def reference(pool, plain, mix: dict, control=None) -> list:
    return ref.payment_verdicts(pool, plain, control)


def mismatches(got, want) -> int:
    return int(got != want)


def judge(answers, expected):
    wrong = sum(got != expected[k] for k, got in answers)
    failed = sum(isinstance(got, tuple) for _, got in answers)
    return wrong, failed
