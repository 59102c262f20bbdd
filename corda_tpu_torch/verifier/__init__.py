"""Transaction verification services — the north-star seam, on the GPU.

Port of corda_tpu.verifier: per-signature verification is batched across
many transactions into the port's CUDA kernels; contract ``verify()`` bodies
and coverage checks stay on the host. The out-of-process verifier fans
requests out over a messaging service to workers, each with its own batcher.
"""
from .batcher import SignatureBatcher  # noqa: F401
from .out_of_process import (  # noqa: F401
    OutOfProcessTransactionVerifierService,
    VerifierRequestQueue,
    VerifierWorker,
)
from .service import (  # noqa: F401
    DeviceTransactionVerifierService,
    InMemoryTransactionVerifierService,
    TpuTransactionVerifierService,
    TransactionVerifierService,
    make_verifier_service,
)
