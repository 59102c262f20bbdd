"""The port's clause library, deterministic sandbox, attachment contract,
universal contract, contract-upgrade and notary-change flows against the
JAX package's: every case of tests/test_{sandbox,attachment_contract,
universal,contract_upgrade,notary_change}.py run on both packages
(tests/test_torch_finance.py's harness), and the sandbox's verdicts and
charged budget compared on a seeded set of contract sources.

A contract upgrade names the upgraded contract by its module path
(``contract_upgrade.contract_name``), and the port's paths are
``corda_tpu_torch.*`` where the reference's are ``corda_tpu.*``; the test
contract's twin lives in a module of the port's own name. So the upgrade
transaction's id differs between the packages by design: those cases
compare the ledgers' shape (transactions and states a node), and the
names map by prefix."""
import random

import pytest

from test_torch_finance import (PKGS, mod, reference_cases, run_case,
                                run_on_both, twin_pair)

CASES = (reference_cases("test_sandbox")
         + reference_cases("test_attachment_contract")
         + reference_cases("test_universal")
         + reference_cases("test_notary_change"))
UPGRADE_CASES = reference_cases("test_contract_upgrade")


def test_the_cases_cover_the_reference_files():
    by_file = {}
    for case in CASES + UPGRADE_CASES:
        by_file[case.values[0]] = by_file.get(case.values[0], 0) + 1
    assert by_file == {"test_sandbox": 33, "test_attachment_contract": 8,
                       "test_universal": 5, "test_notary_change": 2,
                       "test_contract_upgrade": 2}


@pytest.mark.parametrize("name,attr,params", CASES)
def test_reference_case(name, attr, params, monkeypatch):
    run_on_both(name, attr, params, monkeypatch)


def _shape(ledgers):
    return [[(n["name"], len(n["transactions"]), len(n["unconsumed"]),
              len(n["consumed"])) for n in ledger] for ledger in ledgers]


@pytest.mark.parametrize("name,attr,params", UPGRADE_CASES)
def test_contract_upgrade_case(name, attr, params, monkeypatch):
    modules = twin_pair(name)
    records = {pkg: run_case(pkg, modules[pkg], attr, params, monkeypatch)
               for pkg in PKGS}
    ref, port = records["corda_tpu"], records["corda_tpu_torch"]
    assert ref["outcome"] == ("ok",)
    assert port["outcome"] == ref["outcome"]
    assert _shape(port["ledgers"]) == _shape(ref["ledgers"])
    # the shared issuance before the upgrade names no module: same id
    first = {pkg: records[pkg]["ledgers"][0][1]["transactions"]
             for pkg in PKGS}
    ref_ids = {tx for tx, _ in first["corda_tpu"]}
    port_ids = {tx for tx, _ in first["corda_tpu_torch"]}
    assert ref_ids & port_ids


def test_upgraded_contract_names_map_by_prefix():
    modules = twin_pair("test_contract_upgrade")
    names = {pkg: (mod(pkg, "flows.contract_upgrade").contract_name(
        modules[pkg].DummyContractV2), modules[pkg].DummyContractV2
        .legacy_contract_name) for pkg in PKGS}
    ref_mod = modules["corda_tpu"].__name__
    port_mod = modules["corda_tpu_torch"].__name__
    assert names["corda_tpu_torch"][0] == names["corda_tpu"][0].replace(
        ref_mod + ".", port_mod + ".", 1)
    assert names["corda_tpu_torch"][1] == names["corda_tpu"][1].replace(
        "corda_tpu.", "corda_tpu_torch.", 1)


def test_sandbox_deny_list_is_the_references():
    ref, port = (mod(pkg, "core.contracts.sandbox") for pkg in PKGS)
    assert {k.__name__: v for k, v in port._BANNED_NODES.items()} == \
        {k.__name__: v for k, v in ref._BANNED_NODES.items()}
    assert port._SAFE_BUILTIN_NAMES == ref._SAFE_BUILTIN_NAMES
    assert port._WIDTH_METHODS == ref._WIDTH_METHODS
    assert port._MAX_FORMAT_WIDTH == ref._MAX_FORMAT_WIDTH
    assert port.DeterministicSandbox.instruction_budget == \
        ref.DeterministicSandbox.instruction_budget
    ref_ac, port_ac = (mod(pkg, "core.contracts.attachment_contract")
                       for pkg in PKGS)
    assert port_ac.VERIFY_BUDGET == ref_ac.VERIFY_BUDGET


def _sandbox_sources(seed: int, n: int) -> list:
    """Seeded contract sources: loops of random lengths, some within the
    budget and some past it, formatting widths around the cap, banned
    constructs, and exceptions raised by the contract."""
    rng = random.Random(seed)
    banned = ("import os", "x = {1, 2}", "def f():\n    global y",
              "with open('x') as f:\n    pass", "x = 'a'.ljust(5)",
              "x = f'{1:>20}'", "x = obj.__class__",
              "match 1:\n    case _:\n        pass")
    out = []
    for i in range(n):
        kind = rng.randrange(5)
        if kind == 0:
            reps = rng.choice((10, 1000, 300_000, 2_000_000))
            out.append(f"def f(a, b):\n    t = 0\n    for i in range({reps}):"
                       f"\n        t += i\n    return t + a - b\n")
        elif kind == 1:
            width = rng.choice((5, 9_999, 10_000, 10_001, 10 ** 9))
            out.append(f"def f(a, b):\n    return format(a, '>{width}')"
                       "[:8] + str(b)\n")
        elif kind == 2:
            out.append(banned[rng.randrange(len(banned))])
        elif kind == 3:
            exp = rng.choice((3, 64, 10 ** 5, 10 ** 8))
            out.append(f"def f(a, b):\n    return (a + 2) ** {exp} % 97 + b\n")
        else:
            out.append("def f(a, b):\n    if a > b:\n        raise "
                       "ValueError('a above b: ' + str(a - b))\n"
                       "    return [x * 2 for x in range(b)][-1]\n")
    return out


def _sandbox_outcome(pkg: str, source: str, a: int, b: int):
    sb = mod(pkg, "core.contracts.sandbox")
    sandbox = sb.DeterministicSandbox()
    try:
        ns = sandbox.load(source)
        if "f" not in ns:
            return ("loaded", sandbox.spent)
        return ("ok", sandbox.run(ns["f"], a, b), sandbox.spent)
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc), sandbox.spent)


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_sandbox_verdicts_and_budget_equal(seed):
    rng = random.Random(seed * 7919)
    outcomes = []
    for source in _sandbox_sources(seed, 24):
        a, b = rng.randrange(100), rng.randrange(1, 100)
        ref = _sandbox_outcome("corda_tpu", source, a, b)
        port = _sandbox_outcome("corda_tpu_torch", source, a, b)
        assert port == ref, source
        outcomes.append(ref[0])
    # the seeded set reaches several outcomes, not one
    assert len(set(outcomes)) >= 3
