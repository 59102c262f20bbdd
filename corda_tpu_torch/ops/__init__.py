"""Device kernels of the port and the host code around them.

- field.py      — host limb helpers, the plain PyTorch field engine over
  p25519, secp256k1's and P-256's primes, and the per-device table cache
  (CUDA counterparts: ``csrc/field25519.cuh``, ``field_k1.cuh``,
  ``field_p256.cuh``)
- scalarprep.py — ctypes binding of ``native/scalarmath.cpp``, built at
  first use into ``corda_tpu_torch/_build/``
- staging.py    — pinned host staging buffers, released on CUDA events
- ed25519.py    — the Ed25519 split-k verifier: host prep, the plain
  PyTorch version and the CUDA kernel wrapper (``csrc/ed25519_split.cu``)
- weierstrass.py — ECDSA over secp256k1 and secp256r1 in every verify
  mode: hybrid GLV (``csrc/secp256k1_hybrid.cu``), half-gcd split
  (``csrc/secp256r1_split.cu``), windowed (``csrc/weierstrass_windowed.cu``),
  Shamir (``csrc/weierstrass_shamir.cu``) and GLV
  (``csrc/secp256k1_glv.cu``), over the shared point formulas of
  ``csrc/curve_k1_pair.cuh`` and ``curve_p256_pair.cuh`` (GLV calls
  ``curve_k1_pair.cuh`` directly): host preps, G tables, plain versions,
  CUDA kernel wrappers and the batch entry points
- sha256.py     — batched SHA-256, Merkle levels and roots: the plain
  PyTorch version and the CUDA kernel wrapper (``csrc/sha256.cu``);
  imported with the package, as in the reference

Importing this package builds nothing and touches no device.
"""
from . import sha256  # noqa: F401

__all__ = ["sha256"]
