"""The port's finance CorDapp against the JAX package's: every case of the
reference's finance tests run on both packages, outcomes and ledgers
compared.

Each reference test file (tests/test_cash.py, ...) runs twice: as the
reference's own module, and as a twin of the port, its source executed
with every ``corda_tpu.`` module naming ``corda_tpu_torch.`` and every
MockNetwork on the CPU (``twin_module``). A case passes when it passes on
the reference, ends the same way on the port (the same exception type and
message, or none), and leaves every MockNetwork it built with the same
ledger on both packages: each node's recorded transactions (their ids and
``serialize`` bytes) and its vault's unconsumed and consumed states (refs
and bytes). MockNetwork keys come from fixed seeds, so the ids agree.

Nodes keep ``verifier_service = None`` here, as in the reference tests:
flows verify in-flow on the host. tests/test_torch_trade.py drives the
port's batcher.

The helpers (``reference_cases``, ``run_on_both``) serve
tests/test_torch_contracts.py too."""
import hashlib
import importlib
import inspect
import itertools
import pathlib
import tempfile

import pytest
import torch

from test_torch_flow_framework import PKGS, mod, twin_module

TESTS = pathlib.Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def port_twin(name: str, drop: tuple = ()):
    """The port's twin of tests/<name>.py: its source without the lines in
    ``drop`` (imports of modules the port does not have yet), every
    MockNetwork on the CPU."""
    src = (TESTS / f"{name}.py").read_text()
    for line in drop:
        assert line in src, line
        src = src.replace(line, "")
    src = src.replace("MockNetwork()", 'MockNetwork(device="cpu")')
    return twin_module("corda_tpu_torch", name, src)


def twin_pair(name: str, drop: tuple = ()) -> dict:
    """{pkg: the module} of tests/<name>.py: the reference's own module
    (shared with its own run, so its wire names register once) and the
    port's twin."""
    return {"corda_tpu": importlib.import_module(name),
            "corda_tpu_torch": port_twin(name, drop)}


def reference_cases(name: str, only=None, skip=()) -> list:
    """pytest params, one a case of tests/<name>.py: (file, test function
    name, parametrize values); ``only`` / ``skip`` select by function
    name."""
    module = importlib.import_module(name)
    out = []
    for attr, fn in vars(module).items():
        if not attr.startswith("test_") or not callable(fn):
            continue
        if (only is not None and attr not in only) or attr in skip:
            continue
        grids = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not grids:
            out.append(pytest.param(name, attr, {}, id=f"{name}::{attr}"))
            continue
        axes = []
        for mark in grids:
            names = [n.strip() for n in mark.args[0].split(",")]
            axes.append([dict(zip(names, v if len(names) > 1 else (v,)))
                         for v in mark.args[1]])
        for i, combo in enumerate(itertools.product(*axes)):
            params = {k: v for part in combo for k, v in part.items()}
            out.append(pytest.param(name, attr, params,
                                    id=f"{name}::{attr}[{i}]"))
    return out


def _digest(pkg: str, obj) -> str:
    ser = mod(pkg, "core.serialization")
    return hashlib.sha256(ser.serialize(obj)).hexdigest()


def ledger_of(pkg: str, network) -> list:
    """Every node's recorded transactions and vault, as ids and digests of
    their ``serialize`` bytes."""
    nodes = []
    for node in network.nodes:
        vault = node.services.vault

        def states(status):
            return sorted((sar.ref.txhash.bytes.hex(), sar.ref.index,
                           _digest(pkg, sar.state))
                          for sar in vault.query(status=status))
        nodes.append({
            "name": str(node.party.name),
            "transactions": sorted((stx.id.bytes.hex(), _digest(pkg, stx))
                                   for stx in node.services.storage.transactions),
            "unconsumed": states("unconsumed"),
            "consumed": states("consumed")})
    return nodes


def run_case(pkg: str, module, attr: str, params: dict, monkeypatch) -> dict:
    """One case of ``module`` on ``pkg``: its outcome and the ledgers of
    the MockNetworks it built."""
    networks = []
    base = mod(pkg, "testing").MockNetwork

    class RecordingNetwork(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            networks.append(self)

    if hasattr(module, "MockNetwork"):
        monkeypatch.setattr(module, "MockNetwork", RecordingNetwork)
    teardown = []

    def resolve(fn, given):
        kwargs = {}
        for p in inspect.signature(fn).parameters:
            if p in given:
                kwargs[p] = given[p]
            elif p == "tmp_path":
                tmp = tempfile.TemporaryDirectory()
                teardown.append(tmp.cleanup)
                kwargs[p] = pathlib.Path(tmp.name)
            else:
                fixture = getattr(module, p)
                value = resolve(fixture._get_wrapped_function(), {})
                if inspect.isgenerator(value):
                    gen, value = value, next(value)
                    teardown.append(lambda gen=gen: next(gen, None))
                kwargs[p] = value
        return fn(**kwargs)

    try:
        resolve(getattr(module, attr), params)
        result = ("ok",)
    except Exception as exc:   # the outcome under comparison
        result = (type(exc).__name__, str(exc))
    finally:
        for fn in reversed(teardown):
            fn()
    return {"outcome": result,
            "ledgers": [ledger_of(pkg, n) for n in networks]}


def run_on_both(name: str, attr: str, params: dict, monkeypatch,
                drop: tuple = ()) -> dict:
    """The case on each package; fails unless it passes on the reference
    and the port's record equals the reference's."""
    modules = twin_pair(name, drop)
    records = {pkg: run_case(pkg, modules[pkg], attr, params, monkeypatch)
               for pkg in PKGS}
    ref, port = records["corda_tpu"], records["corda_tpu_torch"]
    assert ref["outcome"] == ("ok",)
    assert port["outcome"] == ref["outcome"]
    assert port["ledgers"] == ref["ledgers"]
    return records


#: tests/test_finance_tail.py's finance and flow cases; its registration
#: cases need network/registration.py, which the port does not have yet.
FINANCE_TAIL = ("test_commodity_issue_and_move",
                "test_commodity_conservation_enforced",
                "test_commodity_issue_requires_issuer_signature",
                "test_mixed_cash_and_commodity_transaction",
                "test_two_party_deal_flow",
                "test_manual_finality_broadcasts_only_named_recipients",
                "test_fresh_keys_survive_restart",
                "test_broadcast_reaches_later_recipients_past_a_dead_one")
#: tests/test_audit.py's cases that need no node/rpc.py.
AUDIT = ("test_flow_error_event", "test_capacity_bound")
AUDIT_DROP = ("from corda_tpu.node.rpc import CordaRPCOps, "
              "FlowPermissionException\n",)

CASES = (reference_cases("test_cash")
         + reference_cases("test_commercial_paper")
         + reference_cases("test_obligation")
         + reference_cases("test_ledger_dsl")
         + reference_cases("test_finance_tail", only=FINANCE_TAIL)
         + reference_cases("test_vault_query")
         + reference_cases("test_schemas")
         + reference_cases("test_expect"))


def test_the_cases_cover_the_reference_files():
    by_file = {}
    for case in CASES:
        by_file[case.values[0]] = by_file.get(case.values[0], 0) + 1
    assert by_file == {"test_cash": 3, "test_commercial_paper": 3,
                       "test_obligation": 10, "test_ledger_dsl": 3,
                       "test_finance_tail": 8, "test_vault_query": 5,
                       "test_schemas": 4, "test_expect": 2}


@pytest.mark.parametrize("name,attr,params", CASES)
def test_reference_case(name, attr, params, monkeypatch):
    run_on_both(name, attr, params, monkeypatch)


@pytest.mark.parametrize("attr", AUDIT)
def test_audit_case(attr, monkeypatch):
    run_on_both("test_audit", attr, {}, monkeypatch, drop=AUDIT_DROP)


def test_a_case_that_differs_is_caught(monkeypatch):
    """The comparison sees a port that ends otherwise: the port's Cash
    issuance made to refuse every issue fails the case."""
    port_cash = mod("corda_tpu_torch", "finance.cash")

    def refuse(self, tx, inputs, outputs, commands, token):
        raise port_cash.TransactionVerificationException(tx.id, "refused")

    monkeypatch.setattr(port_cash.IssueClause, "verify", refuse)
    with pytest.raises(AssertionError):
        run_on_both("test_cash", "test_cash_contract_conservation", {},
                    monkeypatch)


def test_legal_prose_is_the_references():
    """legal_contract_reference hashes the same bytes in both packages."""
    for path, cls in (("finance.cash", "Cash"),
                      ("finance.commercial_paper", "CommercialPaper"),
                      ("finance.commodity", "CommodityContract"),
                      ("finance.obligation", "Obligation")):
        ref, port = (getattr(mod(pkg, path), cls) for pkg in PKGS)
        assert port.legal_contract_reference.bytes == \
            ref.legal_contract_reference.bytes


def test_cash_schema_registers_with_the_ports_registry():
    port_cash = mod("corda_tpu_torch", "finance.cash")
    ref_cash = mod("corda_tpu", "finance.cash")
    schema = port_cash.CASH_SCHEMA_V1
    assert isinstance(schema, mod("corda_tpu_torch", "node.schemas").MappedSchema)
    ref = ref_cash.CASH_SCHEMA_V1
    assert (schema.name, schema.version, schema.columns, schema.table_name) \
        == (ref.name, ref.version, ref.columns, ref.table_name)


SLICE = ("core.contracts.clauses", "core.contracts.sandbox",
         "core.contracts.attachment_contract", "finance.cash",
         "finance.commercial_paper", "finance.commodity", "finance.obligation",
         "finance.flows", "finance.deal", "finance.trade",
         "flows.state_replacement", "flows.contract_upgrade",
         "experimental.universal", "testing.ledger_dsl")


def test_wire_names_and_public_names_are_the_references():
    """Every wire name the reference's slice modules register, the port's
    register, for the class of the same name; and each module has the
    reference's public names."""
    wire = {}
    for pkg in PKGS:
        for path in SLICE:
            mod(pkg, path)
        registry = mod(pkg, "core.serialization.codec")._REGISTRY
        home = {f"{pkg}.{path}": path for path in SLICE}
        wire[pkg] = {name: (home[cls.__module__], cls.__qualname__)
                     for name, (cls, _, _) in registry.items()
                     if cls.__module__ in home}
    assert wire["corda_tpu_torch"] == wire["corda_tpu"]
    assert {"sandbox.SandboxedCommand", "sandbox.SandboxedState",
            "universal.UniversalContract", "Cash",
            "trade.SellerTradeInfo"} <= set(wire["corda_tpu"])
    for path in SLICE:
        ref, port = (mod(pkg, path) for pkg in PKGS)
        public = {n for n in vars(ref) if not n.startswith("_")}
        assert public <= set(vars(port)), path
