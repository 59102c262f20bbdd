"""Sample applications (own copies of corda_tpu.samples' modules: the rates
oracle's service and flows, and the SIMM valuation with its flows, so
far)."""
