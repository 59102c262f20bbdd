"""Signature groups through the verifier worker's batcher:
``SignatureBatcher.submit_group(checks, latency_class=...)``.

The inputs are the signatures of a back-chain's transactions: transaction
t carries one signature by each role of the mix's ``tx_signers`` over its
32-byte id, in that order ("owner": party t mod ``parties`` of the
configuration, on its owner scheme; "notary": the notary, on the notary
scheme). Signature i is the (i mod n)-th of transaction i // n, n the roles
a transaction; every ``tamper_every``-th signature (offset
``tamper_offset``) is tampered, the seven kinds of its scheme in turn. A
submission is a group of ``group_size`` consecutive signatures.
"""
from __future__ import annotations

from harness import inputs as gen
from harness import reference as ref

from . import Prepared

CONTROL = "ed25519_s_range"


def _signer_of(config: dict, mix: dict, i: int):
    """(role, scheme, index) of the key that makes signature ``i``."""
    roles = mix["tx_signers"]
    t, role = divmod(i, len(roles))
    if roles[role] == "owner":
        party = t % config["parties"]
        return "owner", gen.owner_scheme(config, party), party
    if roles[role] == "notary":
        return "notary", config["notary_scheme"], 0
    raise ValueError(f"no signer role {roles[role]!r}")


def chunk(job):
    """Signatures ``job['indices']`` as (i, scheme, pub, sig, msg, kind),
    kind -1 for a valid one."""
    seed, mix, config = job["seed"], job["mix"], job["config"]
    n_roles = len(mix["tx_signers"])
    every, offset = mix["tamper_every"], mix["tamper_offset"]
    out = []
    for i in job["indices"]:
        role, scheme, j = _signer_of(config, mix, i)
        priv, pub = gen.signer(seed, scheme, role, j)
        msg = gen.digest(seed, "id", i // n_roles)
        kind = -1
        if i % every == offset:
            kind = (i // every) % gen.TAMPER_KINDS
            other = gen.signer(seed, scheme, "other", i % 7)[1]
            pub, sig = gen.bad_signature(seed, scheme, priv, pub, msg, kind,
                                         other, i)
        else:
            sig = gen.sign(seed, scheme, priv, pub, msg, i)
        out.append((i, scheme, pub, sig, msg, kind))
    return out


def jobs(seed: int, mix: dict, config: dict, workers: int) -> list:
    gen.check_config(config)
    if mix["distinct"] % len(mix["tx_signers"]):
        raise ValueError("distinct is no whole number of transactions")
    return [{"seed": seed, "mix": mix, "config": config,
             "indices": list(range(w, mix["distinct"], workers))}
            for w in range(workers)]


def prepare(rows, seed: int, mix: dict, config: dict) -> Prepared:
    size = mix["group_size"]
    plain = [(scheme, pub, sig, msg) for _, scheme, pub, sig, msg, _ in rows]
    labels = [kind < 0 for *_, kind in rows]
    groups = _group_checks(plain, size)
    return Prepared(groups, plain,
                    [labels[k:k + size] for k in range(0, len(labels), size)],
                    len(groups), size)


def _group_checks(items, group_size: int):
    """The batcher's (PublicKey, signature, content) checks of plain
    (scheme, pub, sig, msg) items, cut into groups."""
    from corda_tpu_torch.core.crypto import PublicKey
    from corda_tpu_torch.core.crypto import schemes as port_schemes
    keys: dict = {}
    checks = []
    for scheme, pub, sig, msg in items:
        key = keys.get((scheme, pub))
        if key is None:
            key = keys[(scheme, pub)] = PublicKey(
                getattr(port_schemes, scheme), pub)
        checks.append((key, sig, msg))
    return [checks[k:k + group_size]
            for k in range(0, len(checks), group_size)]


def build_target(config: dict, mix: dict, device: str):
    """The worker's ``SignatureBatcher``, as ``python -m
    corda_tpu_torch.verifier`` builds it: the program's defaults, but a
    host crossover that the configuration sets."""
    import torch
    from corda_tpu_torch.verifier.batcher import SignatureBatcher
    kw = {}
    if config.get("host_crossover") is not None:
        kw["host_crossover"] = config["host_crossover"]
    return SignatureBatcher(use_device=True, device=torch.device(device),
                            **kw)


def batcher_of(target):
    return target


def close_target(target) -> None:
    target.close()


def submitter(target, mix: dict, groups):
    cls = mix["latency_class"]
    return lambda k: target.submit_group(groups[k], latency_class=cls)


def outcome_reader(mix: dict):
    """outcome(future) -> the group's list of verdicts, or ("error", type
    name) where the future failed."""
    def outcome(fut):
        try:
            return fut.result(timeout=0)
        except Exception as exc:   # a failure, not a verdict
            return ("error", type(exc).__name__)
    return outcome


def reference(pool, plain, mix: dict, control=None) -> list:
    size = mix["group_size"]
    flat = ref.group_verdicts(pool, plain, control)
    return [flat[k:k + size] for k in range(0, len(flat), size)]


def mismatches(got, want) -> int:
    """Items of a group on which ``got`` (verdicts, or a failure) differs
    from ``want`` (verdicts)."""
    if isinstance(got, tuple):
        return len(want)
    return sum(x != y for x, y in zip(got, want)) + abs(len(got) - len(want))


def judge(answers, expected):
    wrong = failed = 0
    for k, got in answers:
        if isinstance(got, tuple):
            failed += len(expected[k])
        wrong += mismatches(got, expected[k])
    return wrong, failed
