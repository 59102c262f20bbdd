"""Transaction verification services — the north-star seam, on the GPU.

Port of corda_tpu.verifier: per-signature verification is batched across
many transactions into the port's CUDA kernels; contract ``verify()`` bodies
and coverage checks stay on the host.
"""
from .batcher import SignatureBatcher  # noqa: F401
from .service import (  # noqa: F401
    DeviceTransactionVerifierService,
    InMemoryTransactionVerifierService,
    TpuTransactionVerifierService,
    TransactionVerifierService,
    make_verifier_service,
)
