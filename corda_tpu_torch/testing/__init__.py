"""Test fixtures (own copies of the reference package's testing modules of
the same names): the dummy contract and state, the expectation DSL
(``expect``), mock services, the in-memory MockNetwork (``MockNetwork(
device=...)``, default "cuda"), the fault-injection harness
(``testing.faults``, imported as a module), and the random-data generator
and generated ledgers (``testing.generator``, ``testing.generated_ledger``),
the ledger DSL (``testing.ledger_dsl``, imported as a module), and the
process driver and its runners (``testing.driver``, ``testing.runner``,
imported as modules: ``DriverDSL(device=...)``, default "cuda")."""
from .dummy import DummyContract, DummyState, DUMMY_NOTARY_NAME
from .expect import expect, parallel, repeat, run_expectations, sequence
from .mocknetwork import MockNetwork, MockNode, TestClock
from .services import MockAttachmentStorage, MockIdentityService, MockServices

__all__ = ["DummyContract", "DummyState", "DUMMY_NOTARY_NAME",
           "expect", "parallel", "repeat", "run_expectations", "sequence",
           "MockAttachmentStorage", "MockIdentityService", "MockServices",
           "MockNetwork", "MockNode", "TestClock"]
