"""Test fixtures (own copies of corda_tpu.testing's modules of the same
names): the dummy contract and state, the fault-injection harness
(``testing.faults``, imported as a module), and the random-data generator
and generated ledgers (``testing.generator``, ``testing.generated_ledger``).
The mock network, mock services, ledger DSL and the in-process node
runners are not ported yet."""
from .dummy import DummyContract, DummyState, DUMMY_NOTARY_NAME

__all__ = ["DummyContract", "DummyState", "DUMMY_NOTARY_NAME"]
