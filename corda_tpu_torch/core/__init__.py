"""Host-side ledger primitives the verification path needs (own copies of
the corda_tpu.core modules of the same names)."""
