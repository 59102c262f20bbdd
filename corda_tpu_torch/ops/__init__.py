"""Device kernels of the port and the host code around them.

- field.py      — host limb helpers, the plain PyTorch p25519 engine and the
  per-device table cache (CUDA counterpart: ``csrc/field25519.cuh``)
- scalarprep.py — ctypes binding of ``native/scalarmath.cpp``, built at
  first use into ``corda_tpu_torch/_build/``
- staging.py    — pinned host staging buffers, released on CUDA events
- ed25519.py    — the Ed25519 split-k verifier: host prep, the plain
  PyTorch version and the CUDA kernel wrapper (``csrc/ed25519_split.cu``)
- weierstrass.py — helpers shared with the (not yet ported) ECDSA kernels

Importing this package builds nothing and touches no device.
"""
