"""Public face of the fault-injection harness.

The implementation lives in ``corda_tpu_torch.utils.faults`` so that
production modules (the batcher, the in-memory bus, the out-of-process
verifier) can import ``fault_point`` without pulling in the
``corda_tpu_torch.testing`` package. Tests import from here, as the JAX
package's tests import ``corda_tpu.testing.faults``:

    from corda_tpu_torch.testing.faults import FaultRule, inject

    with inject(FaultRule("net.send", "drop", count=3), seed=7) as inj:
        ...
        assert inj.fired("net.send") == 3
"""
from ..utils.faults import (DROP, DUPLICATE, FaultError, FaultInjector,
                            FaultRule, active, arm, disarm, fault_point,
                            inject)

__all__ = ["DROP", "DUPLICATE", "FaultError", "FaultInjector", "FaultRule",
           "active", "arm", "disarm", "fault_point", "inject"]
