"""The plain signers and verifiers: RFC 8032 test vectors, round trips on
each curve, every tamper kind refused, and agreement with the port's host
ecmath as a second witness."""
import random

import pytest

from harness import plaincrypto as pc
from harness.yardsticks import tamper_ecdsa, tamper_ed25519

#: RFC 8032 section 7.1, TEST 1 to 3: secret key, public key, message,
#: signature.
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8"
     "821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085a"
     "c1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff"
     "9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("sk,pk,msg,sig", RFC8032)
def test_rfc8032_vectors(sk, pk, msg, sig):
    sk, pk, msg, sig = map(bytes.fromhex, (sk, pk, msg, sig))
    assert pc.ed_public_key(sk) == pk
    assert pc.ed_sign(sk, msg) == sig
    assert pc.ed_verify(pk, sig, msg)
    assert not pc.ed_verify(pk, sig, msg + b"\x00")


def test_ed25519_round_trip_and_tamper_kinds():
    rng = random.Random(5)
    for _ in range(4):
        sk = rng.randbytes(32)
        other = pc.ed_public_key(rng.randbytes(32))
        pub = pc.ed_public_key(sk)
        msg = rng.randbytes(32)
        item = (pub, pc.ed_sign(sk, msg), msg)
        key = pc.EdKey(pub)
        assert key.verify(item[1], msg)
        for kind in range(7):
            p, s, m = tamper_ed25519(item, kind, other, pc.ED_L)
            assert not pc.ed_verify(p, s, m), kind
        # the control's broken guarantee: s + L passes without the range
        _, s, _ = tamper_ed25519(item, 3, other, pc.ED_L)
        assert key.verify(s, msg, check_s=False)


@pytest.mark.parametrize("curve", [pc.SECP256K1, pc.SECP256R1],
                         ids=lambda c: c.name)
def test_ecdsa_round_trip_and_tamper_kinds(curve):
    rng = random.Random(curve.name)
    for _ in range(4):
        priv = rng.randrange(1, curve.n)
        pub = pc.ecdsa_public_key(curve, priv)
        other = pc.ecdsa_public_key(curve, rng.randrange(1, curve.n))
        msg = rng.randbytes(32)
        r, s = pc.ecdsa_sign(curve, priv, msg, rng.randrange(1, curve.n))
        assert s <= curve.n // 2
        assert pc.der_decode(pc.der_encode(r, s)) == (r, s)
        assert pc.ecdsa_verify(curve, pub, pc.der_encode(r, s), msg)
        for kind in range(7):
            p, m, r2, s2 = tamper_ecdsa(curve.n, (pub, msg, r, s), kind,
                                        other)
            assert not pc.ecdsa_verify(curve, p, pc.der_encode(r2, s2), m)


def test_plain_signatures_verify_in_the_port_and_back():
    from corda_tpu_torch.core.crypto import ecmath
    rng = random.Random(9)
    sk = rng.randbytes(32)
    msg = rng.randbytes(32)
    pub = pc.ed_public_key(sk)
    assert ecmath.ed25519_public_key(sk) == pub
    assert ecmath.ed25519_sign(sk, msg, public=pub) == pc.ed_sign(sk, msg)
    for curve, port in ((pc.SECP256K1, ecmath.SECP256K1),
                        (pc.SECP256R1, ecmath.SECP256R1)):
        priv = rng.randrange(1, curve.n)
        r, s = pc.ecdsa_sign(curve, priv, msg, rng.randrange(1, curve.n))
        Q = port.mul(priv, port.g)
        assert ecmath.ecdsa_verify(port, Q, msg, r, s)
        r2, s2 = ecmath.ecdsa_sign(port, priv, msg)
        assert pc.ecdsa_verify(curve, pc.ecdsa_public_key(curve, priv),
                               pc.der_encode(r2, s2), msg)
