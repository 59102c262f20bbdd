"""The plain reference: the verdicts the program has to give, worked out
again from the plain description of each input.

It imports nothing of the program and nothing of JAX: only ``plaincrypto``
and the standard library. Signatures are checked in chunks grouped by key on
a process pool (each chunk builds its key's comb table once).

A payment's verdict follows the order of ``SignedTransaction.verify`` that
the service reproduces: every signature valid ("signature" otherwise),
every required key among the signers ("missing"), then the platform and
contract rules ("contract"): the Move command's signers and the input's
notary among the required keys, the Move command signed by the input's
owner, and the cash conserved.

``control`` breaks one guarantee, for the control runs only:
``"ed25519_s_range"`` accepts Ed25519 signatures with s >= L,
``"cash_conservation"`` skips the conservation rule.
"""
from __future__ import annotations

from . import plaincrypto as pc

ED25519 = "EDDSA_ED25519_SHA512"
CURVE_OF = {"ECDSA_SECP256K1_SHA256": pc.SECP256K1,
            "ECDSA_SECP256R1_SHA256": pc.SECP256R1}
CONTROLS = ("ed25519_s_range", "cash_conservation")

#: Items a pool task checks under one key.
CHUNK = 256


def check_chunk(job):
    """[(idx, verdict)] for one key's items [(idx, sig, msg)]."""
    scheme, pub, items, control = job
    if scheme == ED25519:
        key = pc.EdKey(pub)
        check_s = control != "ed25519_s_range"
        return [(idx, key.verify(sig, msg, check_s=check_s))
                for idx, sig, msg in items]
    key = pc.EcKey(CURVE_OF[scheme], pub)
    return [(idx, key.verify(sig, msg)) for idx, sig, msg in items]


def signature_verdicts(pool, items, control=None) -> dict:
    """{idx: verdict} of (idx, scheme, pub, sig, msg) items."""
    by_key: dict = {}
    for idx, scheme, pub, sig, msg in items:
        by_key.setdefault((scheme, pub), []).append((idx, sig, msg))
    jobs = []
    for (scheme, pub), its in by_key.items():
        for k in range(0, len(its), CHUNK):
            jobs.append((scheme, pub, its[k:k + CHUNK], control))
    jobs.sort(key=lambda j: -len(j[2]))
    out = {}
    for part in pool.map(check_chunk, jobs):
        out.update(part)
    return out


def group_verdicts(pool, items, control=None) -> list:
    """Verdicts of signature items (scheme, pub, sig, msg), in order."""
    got = signature_verdicts(
        pool, [(i,) + tuple(item) for i, item in enumerate(items)], control)
    return [got[i] for i in range(len(items))]


def payment_verdicts(pool, specs, control=None) -> list:
    """The verdict of each payment's plain description: "accept",
    "signature", "missing" or "contract"."""
    items = []
    for t, spec in enumerate(specs):
        for k, (scheme, pub, sig) in enumerate(spec["sigs"]):
            items.append(((t, k), scheme, pub, sig, spec["id"]))
    ok = signature_verdicts(pool, items, control)
    out = []
    for t, spec in enumerate(specs):
        if not all(ok[(t, k)] for k in range(len(spec["sigs"]))):
            out.append("signature")
            continue
        signed = {(scheme, pub) for scheme, pub, _ in spec["sigs"]}
        if any(tuple(req) not in signed for req in spec["required"]):
            out.append("missing")
            continue
        movers = {tuple(k) for k in spec["move_signers"]}
        platform = movers | {tuple(spec["notary"])}
        conserved = spec["input_qty"] == sum(spec["output_qtys"])
        if not platform <= {tuple(k) for k in spec["required"]} or \
                tuple(spec["input_owner"]) not in movers or (
                control != "cash_conservation" and not conserved):
            out.append("contract")
            continue
        out.append("accept")
    return out
