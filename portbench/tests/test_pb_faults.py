"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the plain path on the CPU) and the
rest of the run is driven as on the card."""
import pytest
from conftest import PAYMENTS, bench_copy

from harness import runner

#: Small sizes with a tampered item in every few, so that a short window
#: on the CPU judges some of each kind.
BULK = {"distinct": 128, "group_size": 8, "outstanding": 4,
        "warmup_submissions": 2, "tamper_every": 3, "tamper_offset": 1}
#: The payments entry has no cell yet: its cells are added as files.
PAYMENT_CELLS = [("mixed.payments", "mixed-scheme-node", "payments", []),
                 ("ed25519.payments", "ed25519-node", "payments", [])]
CELLS = ["ed25519.bulk"] + [c[0] for c in PAYMENT_CELLS]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_copy(tmp_path_factory.mktemp("bench"), PAYMENT_CELLS,
                      {"payments": PAYMENTS})


def _flip_one(verdicts):
    v = list(verdicts)
    v[0] = not v[0]
    return v


def _half_left_out(verdicts):
    v = list(verdicts)
    half = len(v) // 2
    return v[:half] + [True] * (len(v) - half)


def _none_checked(verdicts):
    return [True] * len(verdicts)


def _broken_batcher(monkeypatch, alter):
    from corda_tpu_torch.verifier.batcher import SignatureBatcher
    resolve = SignatureBatcher._resolve

    def broken(self, bucket, items, verdicts, bctx=None):
        return resolve(self, bucket, items, alter(verdicts), bctx)
    monkeypatch.setattr(SignatureBatcher, "_resolve", broken)


def _run(root, cell):
    return runner.run_cell(cell, 2 ** 33 + 21, 1.0, False, device="cpu",
                           root=root,
                           overrides=BULK if cell == "ed25519.bulk" else {})


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("alter", [_flip_one, _half_left_out, _none_checked],
                         ids=["answer_altered", "half_the_batch_left_out",
                              "verification_skipped"])
def test_a_broken_batcher_is_not_correct(monkeypatch, root, cell, alter):
    _broken_batcher(monkeypatch, alter)
    result = _run(root, cell)
    assert result["correct"] is False
    assert result["checks"]["wrong_verdicts"]["value"] > 0


@pytest.mark.parametrize("cell", ["mixed.payments", "ed25519.payments"])
def test_contract_checks_left_out_is_not_correct(monkeypatch, root, cell):
    from corda_tpu_torch.core.transactions.ledger import LedgerTransaction
    monkeypatch.setattr(LedgerTransaction, "verify", lambda self: None)
    result = _run(root, cell)
    assert result["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_plain_path_is_correct(root, cell):
    assert _run(root, cell)["correct"] is True
