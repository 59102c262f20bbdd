"""The port's generated ledgers against the JAX package's: the cases of
tests/test_loadtest_generated.py that need no MockNetwork.

The same seeds give the same transactions (ids) and the same signature
triples as bytes; every generated transaction's signatures check and its
platform rules hold when resolved against the generated chain in both
packages; and the port's batcher (``device="cpu"``, the plain PyTorch
kernels) gives the JAX batcher's verdicts on the ledger's signatures (the
JAX batcher on its host route, so no JAX kernel is traced)."""
import pytest
import torch

from corda_tpu.core.crypto.signatures import Crypto as JCrypto
from corda_tpu.testing.generated_ledger import \
    make_generated_ledger as j_make_ledger
from corda_tpu.testing.generated_ledger import \
    signature_triples as j_triples
from corda_tpu.verifier.batcher import SignatureBatcher as JBatcher
from corda_tpu_torch.core.contracts.structures import StateRef as TStateRef
from corda_tpu_torch.core.crypto.signatures import Crypto as TCrypto
from corda_tpu_torch.testing import generator as t_generator
from corda_tpu_torch.testing.generated_ledger import \
    make_generated_ledger as t_make_ledger
from corda_tpu_torch.testing.generated_ledger import \
    signature_triples as t_triples
from corda_tpu_torch.verifier.batcher import SignatureBatcher as TBatcher


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _raw(triples):
    return [(k.scheme.scheme_number_id, k.encoded, s, c)
            for k, s, c in triples]


class ChainServices:
    """Resolves a generated chain's input states (duck-typed for either
    package): MockServices.record_transactions without the node."""

    def __init__(self, state_ref):
        self.states = {}
        self.attachments = self
        self._state_ref = state_ref

    def record_transactions(self, stx):
        for i, out in enumerate(stx.tx.outputs):
            self.states[self._state_ref(stx.id, i)] = out

    def load_state(self, ref):
        return self.states.get(ref)

    def open_attachment(self, att_id):
        return None


@pytest.mark.parametrize("n, seed, mix", [(60, 7, True), (30, 11, True),
                                          (25, 3, False)])
def test_same_seed_same_ledger(n, seed, mix):
    jl = j_make_ledger(n, seed=seed, scheme_mix=mix)
    tl = t_make_ledger(n, seed=seed, scheme_mix=mix)
    assert [str(s.id) for s in tl.transactions] == \
        [str(s.id) for s in jl.transactions]
    assert _raw(t_triples(tl)) == _raw(j_triples(jl))
    assert len(tl.unspent) == len(jl.unspent)
    assert [str(sar.ref) for sar in tl.unspent] == \
        [str(sar.ref) for sar in jl.unspent]


def test_generated_ledger_is_valid_and_verifiable():
    """tests/test_loadtest_generated.py's first case on the port, with a
    dict-backed resolver in place of MockServices."""
    ledger = t_make_ledger(60, seed=7)
    assert len(ledger.transactions) == 60
    services = ChainServices(TStateRef)
    for stx in ledger.transactions:
        stx.check_signatures_are_valid()
        services.record_transactions(stx)
    for stx in ledger.transactions:
        stx.to_ledger_transaction(services).verify()
    triples = t_triples(ledger)
    assert len(triples) >= 60
    for key, sig, content in triples[:20]:
        assert TCrypto.is_valid(key, sig, content)
    # the host oracles of both packages agree on every triple
    jtriples = j_triples(j_make_ledger(60, seed=7))
    assert [TCrypto.is_valid(*t) for t in triples] == \
        [JCrypto.is_valid(*t) for t in jtriples]


def test_generator_draws_match_reference():
    from corda_tpu.testing import generator as j_generator
    import random

    def draws(gen_mod):
        G = gen_mod.Generator
        rng = random.Random(5)
        g = G.combine(G.int_range(1, 9), G.bytes_of(4),
                      G.choice("abc").list_of(G.poisson_size(2.0)),
                      G.frequency((0.3, G.pure("x")), (0.7, G.pure("y"))),
                      G.shuffled(range(6)))
        return [g.generate(rng) for _ in range(20)]

    assert draws(t_generator) == draws(j_generator)


def test_generated_ledger_batch_verifies_like_the_reference():
    """tests/test_loadtest_generated.py's batcher case: the generated
    ledger's signatures (Ed25519 and secp256k1) through the port's batcher
    on the plain kernels give the JAX batcher's verdicts, all valid, each
    scheme on its device bucket."""
    jl, tl = j_make_ledger(30, seed=11), t_make_ledger(30, seed=11)
    jb = JBatcher(use_device=False, max_latency_s=0.01)
    tb = TBatcher(device="cpu", host_crossover=0, max_latency_s=0.05)
    try:
        want = jb.submit_group(j_triples(jl)).result(timeout=240)
        got = tb.submit_group(t_triples(tl)).result(timeout=240)
    finally:
        jb.close()
        tb.close()
    assert got == want
    assert all(got) and len(got) >= 30
    snap = tb.metrics.snapshot()
    assert snap["SigBatcher.DeviceChecked"]["count"] == len(got)
    assert snap.get("SigBatcher.BatchFailure", {}).get("count", 0) == 0
