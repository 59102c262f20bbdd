"""Sample applications (own copies of corda_tpu.samples' modules: the rates
oracle's data classes and the SIMM margin so far)."""
