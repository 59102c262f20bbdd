"""The input makers are deterministic by seed, and the reference agrees
with what each input was built to be."""
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import pytest
from conftest import PAYMENTS

from entries import submit_group, verify_signed
from harness import runner

BULK = {"distinct": 96, "group_size": 8, "tamper_every": 16,
        "tamper_offset": 5, "tx_signers": ["owner", "notary"]}


@pytest.fixture(scope="module")
def pool():
    with ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as p:
        yield p


def _rows(entry, pool, seed, mix, config, workers):
    rows = [r for job in entry.jobs(seed, mix, config, workers)
            for r in pool.submit(entry.chunk, job).result()]
    return sorted(rows, key=lambda r: r[0])


@pytest.mark.parametrize("config", ["ed25519-node", "mixed-scheme-node"])
def test_signature_groups_are_deterministic_and_judged_as_built(pool,
                                                                 config):
    cfg = runner.load("configs", config)
    seed = 2 ** 34 + 1
    a = _rows(submit_group, pool, seed, BULK, cfg, 2)
    assert a == _rows(submit_group, pool, seed, BULK, cfg, 3)
    assert a != _rows(submit_group, pool, seed + 1, BULK, cfg, 2)
    assert sum(r[-1] >= 0 for r in a) == 6
    prepared = submit_group.prepare(a, seed, BULK, cfg)
    assert submit_group.reference(pool, prepared.plain,
                                  BULK) == prepared.labels


@pytest.mark.parametrize("config", ["ed25519-node", "mixed-scheme-node"])
def test_payments_are_deterministic_and_judged_as_built(pool, config):
    cfg = runner.load("configs", config)
    mix = dict(PAYMENTS, distinct=40, bad_signature_every=16,
               bad_signature_offset=5, unconserved_every=8,
               unconserved_offset=3)
    seed = 2 ** 35 + 3
    a = _rows(verify_signed, pool, seed, mix, cfg, 2)
    b = _rows(verify_signed, pool, seed, mix, cfg, 3)
    assert [(r[1].id, r[4]) for r in a] == [(r[1].id, r[4]) for r in b]
    assert [r[1].id for r in a] != [
        r[1].id for r in _rows(verify_signed, pool, seed + 1, mix, cfg, 2)]
    prepared = verify_signed.prepare(a, seed, mix, cfg)
    assert set(prepared.labels) == {"accept", "signature", "contract"}
    assert verify_signed.reference(pool, prepared.plain,
                                   mix) == prepared.labels
