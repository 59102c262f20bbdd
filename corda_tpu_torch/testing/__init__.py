"""Test fixtures (own copies of corda_tpu.testing's modules of the same
names): the dummy contract and state, and the fault-injection harness
(``testing.faults``, imported as a module). The mock network, mock
services, ledger DSL and driver are not ported yet."""
from .dummy import DummyContract, DummyState, DUMMY_NOTARY_NAME

__all__ = ["DummyContract", "DummyState", "DUMMY_NOTARY_NAME"]
