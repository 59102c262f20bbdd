"""Sample applications (own copies of corda_tpu.samples' modules; only the
rates oracle's data classes so far)."""
