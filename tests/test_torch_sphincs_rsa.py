"""SPHINCS-256 and RSA keys in the port against the JAX package: the same
SPHINCS-256 keys from the same entropy, signatures byte for byte equal and
verifying across the packages, tampering refused in both; RSA keys and
signatures (through the ``cryptography`` package, imported only when an RSA
key is used) verifying across the packages where the package is present,
and the same exception from both where it is absent; and SignedTransactions
signed with either scheme through both packages' verifier services.

Keys and transactions cross between the packages as raw encodings and
``serialize`` bytes."""
import sys

import pytest
import torch

from corda_tpu.core.contracts import Command, TransactionState
from corda_tpu.core.crypto import RSA_SHA256 as J_RSA
from corda_tpu.core.crypto import SPHINCS256_SHA256 as J_SPHINCS
from corda_tpu.core.crypto import generate_keypair as j_generate_keypair
from corda_tpu.core.crypto import sphincs as j_sphincs
from corda_tpu.core.crypto.keys import PrivateKey as JPrivateKey
from corda_tpu.core.crypto.keys import PublicKey as JPublicKey
from corda_tpu.core.crypto.signatures import Crypto as JCrypto
from corda_tpu.core.identity import Party
from corda_tpu.core.serialization import serialize as j_serialize
from corda_tpu.core.transactions import SignedTransaction, WireTransaction
from corda_tpu.testing import DUMMY_NOTARY_NAME, DummyContract, DummyState
from corda_tpu.verifier import TpuTransactionVerifierService as JService
from corda_tpu_torch.core.crypto import RSA_SHA256 as T_RSA
from corda_tpu_torch.core.crypto import SPHINCS256_SHA256 as T_SPHINCS
from corda_tpu_torch.core.crypto import generate_keypair as t_generate_keypair
from corda_tpu_torch.core.crypto import sphincs as t_sphincs
from corda_tpu_torch.core.crypto.keys import PrivateKey as TPrivateKey
from corda_tpu_torch.core.crypto.keys import PublicKey as TPublicKey
from corda_tpu_torch.core.crypto.signatures import Crypto as TCrypto
from corda_tpu_torch.core.serialization import deserialize as t_deserialize
from corda_tpu_torch.testing import dummy as _t_dummy  # noqa: F401 (codec)
from corda_tpu_torch.verifier import SignatureBatcher as TBatcher
from corda_tpu_torch.verifier import TpuTransactionVerifierService as TService

MSG = b"hello"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_keys(kp):
    """A JAX key pair's encodings as the port's keys."""
    return (TPublicKey(T_SPHINCS if kp.public.scheme is J_SPHINCS else T_RSA,
                       kp.public.encoded),
            TPrivateKey(T_SPHINCS if kp.private.scheme is J_SPHINCS else T_RSA,
                        kp.private.encoded))


def _jax_keys(kp):
    return (JPublicKey(J_SPHINCS if kp.public.scheme is T_SPHINCS else J_RSA,
                       kp.public.encoded),
            JPrivateKey(J_SPHINCS if kp.private.scheme is T_SPHINCS else J_RSA,
                        kp.private.encoded))


@pytest.fixture(scope="module")
def sphincs_pair():
    entropy = b"\x01" * 32
    return (j_generate_keypair(J_SPHINCS, entropy=entropy),
            t_generate_keypair(T_SPHINCS, entropy=entropy))


@pytest.fixture(scope="module")
def sphincs_sigs(sphincs_pair):
    jkp, tkp = sphincs_pair
    return (JCrypto.do_sign(jkp.private, MSG), TCrypto.do_sign(tkp.private, MSG))


# -- SPHINCS-256 -------------------------------------------------------------

@pytest.mark.parametrize("seed", [b"\x01" * 32, b"\x2a" * 32, bytes(range(32))])
def test_sphincs_same_keys_from_the_same_entropy(seed):
    jkp = j_generate_keypair(J_SPHINCS, entropy=seed)
    tkp = t_generate_keypair(T_SPHINCS, entropy=seed)
    assert tkp.public.encoded == jkp.public.encoded
    assert tkp.private.encoded == jkp.private.encoded
    assert t_sphincs.keygen(seed) == j_sphincs.keygen(seed)
    assert tkp.public.scheme.scheme_number_id == \
        jkp.public.scheme.scheme_number_id


def test_sphincs_signatures_equal_and_verify_across_packages(sphincs_pair,
                                                            sphincs_sigs):
    jkp, tkp = sphincs_pair
    jsig, tsig = sphincs_sigs
    assert tsig == jsig
    assert len(tsig) == t_sphincs.SIG_LEN == j_sphincs.SIG_LEN == 45088
    # each package's signature verifies under the other's facade
    assert TCrypto.is_valid(tkp.public, jsig, MSG)
    assert JCrypto.is_valid(jkp.public, tsig, MSG)
    assert TCrypto.is_valid(_port_keys(jkp)[0], tsig, MSG)
    assert JCrypto.is_valid(_jax_keys(tkp)[0], jsig, MSG)


def test_sphincs_tampering_refused_in_both(sphincs_pair, sphincs_sigs):
    jkp, tkp = sphincs_pair
    sig = sphincs_sigs[1]
    bad_sigs = []
    for off in (0, 40, len(sig) - 40, len(sig) // 2):
        bad = bytearray(sig)
        bad[off] ^= 1
        bad_sigs.append(bytes(bad))
    bad_sigs.append(sig[:-1])
    for bad in bad_sigs:
        assert not TCrypto.is_valid(tkp.public, bad, MSG)
        assert not JCrypto.is_valid(jkp.public, bad, MSG)
    assert not TCrypto.is_valid(tkp.public, sig, MSG + b"!")
    assert not JCrypto.is_valid(jkp.public, sig, MSG + b"!")
    other = t_generate_keypair(T_SPHINCS, entropy=b"\x2b" * 32)
    assert not TCrypto.is_valid(other.public, sig, MSG)
    assert not t_sphincs.verify(other.public.encoded, MSG, sig)


def test_sphincs_through_the_port_facade():
    """tests/test_sphincs.py's facade case on the port."""
    kp = t_generate_keypair(T_SPHINCS, entropy=b"\x11" * 32)
    content = b"scheme dispatch through the Crypto facade"
    sig = TCrypto.sign_with_key(kp, content)
    assert sig.verify(content)
    assert sig.is_valid(content)
    assert not sig.is_valid(content + b"x")
    assert kp.public.scheme is T_SPHINCS


# -- RSA ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def rsa_pairs():
    pytest.importorskip("cryptography")
    return j_generate_keypair(J_RSA), t_generate_keypair(T_RSA)


def test_rsa_keys_and_signatures_verify_across_packages(rsa_pairs):
    jkp, tkp = rsa_pairs
    for kp in (jkp, tkp):
        # DER SubjectPublicKeyInfo / PKCS#8, 3072-bit
        assert kp.public.encoded[:1] == b"\x30"
        assert kp.private.encoded[:1] == b"\x30"
    for signer in (jkp, tkp):
        jpub, jpriv = _jax_keys(signer) if signer is tkp else (
            signer.public, signer.private)
        tpub, tpriv = _port_keys(signer) if signer is jkp else (
            signer.public, signer.private)
        jsig = JCrypto.do_sign(jpriv, MSG)
        tsig = TCrypto.do_sign(tpriv, MSG)
        # PKCS#1 v1.5 is deterministic: the same key signs the same bytes
        assert tsig == jsig and len(tsig) == 384
        for sig in (jsig, tsig):
            assert JCrypto.is_valid(jpub, sig, MSG)
            assert TCrypto.is_valid(tpub, sig, MSG)
            assert not JCrypto.is_valid(jpub, sig, b"hellO")
            assert not TCrypto.is_valid(tpub, sig, b"hellO")
        bad = bytes([tsig[0] ^ 1]) + tsig[1:]
        assert not JCrypto.is_valid(jpub, bad, MSG)
        assert not TCrypto.is_valid(tpub, bad, MSG)


def test_rsa_deterministic_generation_refused_alike():
    pytest.importorskip("cryptography")
    with pytest.raises(ValueError) as jerr:
        j_generate_keypair(J_RSA, entropy=b"\x01" * 32)
    with pytest.raises(ValueError) as terr:
        t_generate_keypair(T_RSA, entropy=b"\x01" * 32)
    assert str(terr.value) == str(jerr.value)


def _raised(fn):
    try:
        fn()
    except Exception as exc:   # the failure under comparison
        return type(exc)
    return None


def test_rsa_without_cryptography_fails_alike(monkeypatch, rsa_pairs):
    """Without the ``cryptography`` package both packages raise the same
    exception type from key generation, signing and verifying."""
    jkp, tkp = rsa_pairs
    for name in [m for m in sys.modules
                 if m == "cryptography" or m.startswith("cryptography.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "cryptography", None)
    cases = [
        (lambda: j_generate_keypair(J_RSA),
         lambda: t_generate_keypair(T_RSA)),
        (lambda: JCrypto.do_sign(jkp.private, MSG),
         lambda: TCrypto.do_sign(tkp.private, MSG)),
        (lambda: JCrypto.is_valid(jkp.public, b"\x00" * 384, MSG),
         lambda: TCrypto.is_valid(tkp.public, b"\x00" * 384, MSG)),
    ]
    for j_fn, t_fn in cases:
        want = _raised(j_fn)
        assert want is not None and issubclass(want, ImportError)
        assert _raised(t_fn) is want


# -- the service path --------------------------------------------------------

class DictServices:
    """What an issuance resolves against: no states, no attachments."""

    def __init__(self):
        self.attachments = self

    def load_state(self, ref):
        return None

    def open_attachment(self, att_id):
        return None


def _issuance(kp, magic):
    notary = Party(DUMMY_NOTARY_NAME,
                   j_generate_keypair(entropy=b"\x30" * 32).public)
    wtx = WireTransaction(
        outputs=(TransactionState(DummyState(magic, (kp.public,)), notary),),
        commands=(Command(DummyContract.Create(), (kp.public,)),),
        notary=notary, must_sign=(kp.public,))
    good = SignedTransaction.of(wtx, [JCrypto.sign_with_key(kp, wtx.id.bytes)])
    sig = good.sigs[0]
    bad = SignedTransaction(good.tx_bits, (sig.__class__(
        sig.bytes[:-1] + bytes([sig.bytes[-1] ^ 1]), sig.by),))
    return [good, bad]


def _outcome(fut):
    try:
        return ("ok", fut.result(timeout=120))
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc))


def test_sphincs_and_rsa_transactions_through_verify_signed(sphincs_pair,
                                                            rsa_pairs):
    """One SPHINCS-signed and one RSA-signed SignedTransaction (and each
    with a tampered signature) through both packages' verify_signed: both
    take the host route and give the same outcomes."""
    stxs = (_issuance(sphincs_pair[0], 51) + _issuance(rsa_pairs[0], 52))
    services = DictServices()
    jsvc = JService()
    tsvc = TService(batcher=TBatcher(device="cpu", max_latency_s=0.01))
    try:
        want = [_outcome(jsvc.verify_signed(s, services)) for s in stxs]
        got = [_outcome(tsvc.verify_signed(t_deserialize(j_serialize(s)),
                                           services)) for s in stxs]
    finally:
        jsvc.shutdown()
        tsvc.shutdown()
    assert got == want
    assert [o[0] for o in got] == ["ok", "SignatureException"] * 2
    snap = tsvc.batcher.metrics.snapshot()
    assert snap.get("SigBatcher.DeviceChecked", {}).get("count", 0) == 0
    assert snap["SigBatcher.Checked"]["count"] == 4
