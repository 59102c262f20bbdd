"""Host-side cryptography: hashing, signature schemes, keys, the ``Crypto``
facade, composite keys and Merkle trees (copies of corda_tpu.core.crypto's
modules of the same names; SPHINCS-256 in ``sphincs``, RSA through the
``cryptography`` package, imported only when an RSA key is used)."""
from .secure_hash import SecureHash, sha256, sha256_twice, hash_concat
from .schemes import (
    SignatureScheme,
    EDDSA_ED25519_SHA512,
    ECDSA_SECP256K1_SHA256,
    ECDSA_SECP256R1_SHA256,
    RSA_SHA256,
    SPHINCS256_SHA256,
    COMPOSITE_KEY,
    ALL_SCHEMES,
    DEFAULT_SIGNATURE_SCHEME,
    scheme_by_id,
)
from .keys import PublicKey, PrivateKey, KeyPair, generate_keypair
from .signatures import DigitalSignature, TransactionSignature, Crypto
from .composite import CompositeKey, CompositeSignature, CompositeSignaturesWithKeys
from .merkle import MerkleTree, PartialMerkleTree, MerkleTreeException
from .base58 import b58encode, b58decode

__all__ = [
    "SecureHash", "sha256", "sha256_twice", "hash_concat",
    "SignatureScheme", "EDDSA_ED25519_SHA512", "ECDSA_SECP256K1_SHA256",
    "ECDSA_SECP256R1_SHA256", "RSA_SHA256", "SPHINCS256_SHA256", "COMPOSITE_KEY",
    "ALL_SCHEMES", "DEFAULT_SIGNATURE_SCHEME", "scheme_by_id",
    "PublicKey", "PrivateKey", "KeyPair", "generate_keypair",
    "DigitalSignature", "TransactionSignature", "Crypto",
    "CompositeKey", "CompositeSignature", "CompositeSignaturesWithKeys",
    "MerkleTree", "PartialMerkleTree", "MerkleTreeException",
    "b58encode", "b58decode",
]
