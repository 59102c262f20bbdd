"""The control (the reference with one guarantee broken) comes out wrong,
at a size a test run holds; on the card's machine the same function runs
at the cells' own sizes (``python3 portbench/control.py``)."""
import pytest
from conftest import PAYMENTS, bench_copy

from harness import control

#: The payments entry has no cell yet: its cells are added as files.
PAYMENT_CELLS = [("mixed.payments", "mixed-scheme-node", "payments", []),
                 ("ed25519.payments", "ed25519-node", "payments", [])]
SMALL = {"ed25519.bulk": {"distinct": 256},
         "mixed.payments": {"distinct": 96},
         "ed25519.payments": {"distinct": 96}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_copy(tmp_path_factory.mktemp("bench"), PAYMENT_CELLS,
                      {"payments": PAYMENTS})


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_gives_wrong_verdicts(root, cell):
    for seed in (2 ** 33 + 11, 2 ** 33 + 12, 2 ** 33 + 13):
        reading = control.control_reading(cell, seed, SMALL[cell], root)
        assert reading["wrong_verdicts"] > 0, (cell, seed, reading)
