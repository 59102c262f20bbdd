"""corda_tpu_torch — the PyTorch/CUDA port of corda_tpu for NVIDIA Hopper.

The JAX package ``corda_tpu`` is the reference; this package re-implements
its signature-verification service path for one H100:

- ``corda_tpu_torch.core``       — own copies of the host crypto the path needs
- ``corda_tpu_torch.ops``        — field engine, host prep, staging and the
  hand-written CUDA kernels (sources in ``csrc/``, built at first use by
  ``_build`` into ``_build/``)
- ``corda_tpu_torch.verifier``   — SignatureBatcher and the verifier services
- ``corda_tpu_torch.parallel``   — meshes of devices and sharded verification
- ``corda_tpu_torch.flows`` / ``node`` / ``storage`` — the flow framework,
  the node's services, state machine and notary, and the key-value store
- ``corda_tpu_torch.network``    — the messaging SPI and the in-memory bus
- ``corda_tpu_torch.testing``    — MockNetwork, mock services and fixtures
- ``corda_tpu_torch.samples``    — the rates oracle and the SIMM valuation
- ``corda_tpu_torch.observability`` / ``utils`` — tracer, flight recorder,
  resource accounting, metrics and the fault-injection seam

It imports neither ``jax`` nor anything of ``corda_tpu``. Entry points take a
``device`` (default ``"cuda"``); pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels on the CPU.
"""

__version__ = "0.1.0"
