"""The port's clients against the JAX package's: the RPC client, the JSON and
YAML bindings with the string-to-call parser, the monitor model, the shell
and the explorer.

Every case of tests/test_{rpc_streaming,shell_jackson,monitor,oracle_shell,
explorer}.py runs on the port's twin of the file with the reference's marks
(``run_twin_case``): the source with every ``corda_tpu.`` module naming
``corda_tpu_torch.`` and every constructor of the port that defaults to the
card given ``device="cpu"`` (``cpu_twin``). A case's fixtures are the twin's
own, autouse ones included, and this run's pytest fixtures.

Then the same inputs through both packages, compared exactly:
``to_jsonable`` / ``to_json`` / ``render_yaml`` of seeded values (parties,
keys, hashes, amounts, bytes, times, states and signed transactions made
from the same seeds); ``StringToMethodCallParser`` on the same command
lines, bound to each package's flows (the arguments' ``serialize`` bytes and
each refusal's message); a shell session over each package's MockNetwork
(its output with each package's module prefix and run ids masked); and a
web server over each package's RPC client to a live node, where the port
serves the float-bearing routes the reference answers with 500.

The helpers at the top (``cpu_twin``, ``twin_cases``, ``run_twin_case``)
serve tests/test_torch_tools.py and tests/test_torch_driver.py too."""
import ast
import datetime
import importlib
import inspect
import io
import json
import random
import re
import urllib.error
import urllib.request

import pytest

from test_torch_finance import reference_cases
from test_torch_flow_framework import PKGS, mock_network, mod, twin_module
from test_torch_raft import TESTS

#: The port's constructors that default to the card ("cuda", raising
#: without CUDA): a twin builds each one on the CPU.
CPU_CALLS = frozenset({"MockNetwork", "SignatureBatcher",
                       "TpuTransactionVerifierService", "VerifierWorker",
                       "NodeConfiguration", "Simulation", "DriverDSL",
                       "driver"})


class _OnTheCPU(ast.NodeTransformer):
    """Add ``device="cpu"`` to each call of a ``CPU_CALLS`` name that names
    no device and passes no ``**kwargs``."""

    def visit_Call(self, node):
        self.generic_visit(node)
        func = node.func
        name = (func.id if isinstance(func, ast.Name)
                else func.attr if isinstance(func, ast.Attribute) else None)
        if name in CPU_CALLS and not any(k.arg in ("device", None)
                                         for k in node.keywords):
            node.keywords.append(ast.keyword("device", ast.Constant("cpu")))
        return node


def cpu_twin(name: str, subs: tuple = ()):
    """The port's twin of tests/<name>.py: its source with each ``(old,
    new)`` of ``subs`` applied, every ``CPU_CALLS`` constructor on the CPU,
    every ``corda_tpu.`` module then naming ``corda_tpu_torch.``; its
    ``__file__`` is the reference file's."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    for old, new in subs:
        assert old in src, old
        src = src.replace(old, new)
    tree = ast.fix_missing_locations(_OnTheCPU().visit(ast.parse(src)))
    return twin_module("corda_tpu_torch", name,
                       f"__file__ = {str(path)!r}\n" + ast.unparse(tree))


def twin_cases(*names: str) -> list:
    """pytest params, one a case of each tests/<name>.py, each carrying the
    reference case's marks (``slow``, ``medium``, ...)."""
    out = []
    for name in names:
        module = importlib.import_module(name)
        for case in reference_cases(name):
            attr = case.values[1]
            marks = [m for m in getattr(getattr(module, attr), "pytestmark",
                                        []) if m.name != "parametrize"]
            out.append(pytest.param(*case.values, marks=marks, id=case.id))
    return out


def run_twin_case(name: str, attr: str, params: dict, request,
                  subs: tuple = ()) -> None:
    """Case ``attr`` of tests/<name>.py on the port's twin: parameters from
    ``params``; the twin's fixtures (its autouse ones first) run as pytest
    runs them, generator teardowns included; any other argument is this
    run's pytest fixture of that name."""
    module = cpu_twin(name, subs)
    fixtures = {n: f for n, f in vars(module).items()
                if hasattr(f, "_fixture_function_marker")}
    values, teardown = dict(params), []

    def value(arg):
        if arg not in values:
            fixture = fixtures.get(arg)
            if fixture is None:
                values[arg] = request.getfixturevalue(arg)
            else:
                got = call(fixture._get_wrapped_function())
                if inspect.isgenerator(got):
                    teardown.append(got)
                    got = next(got)
                values[arg] = got
        return values[arg]

    def call(fn):
        return fn(**{p: value(p) for p in inspect.signature(fn).parameters})

    try:
        for fname, fixture in fixtures.items():
            if fixture._fixture_function_marker.autouse:
                value(fname)
        call(getattr(module, attr))
    finally:
        for gen in reversed(teardown):
            next(gen, None)


FILES = ("test_rpc_streaming", "test_shell_jackson", "test_monitor",
         "test_oracle_shell", "test_explorer")


def test_the_cases_cover_the_reference_files():
    by_file = {}
    for case in twin_cases(*FILES):
        by_file[case.values[0]] = by_file.get(case.values[0], 0) + 1
    assert by_file == {"test_rpc_streaming": 11, "test_shell_jackson": 8,
                       "test_monitor": 2, "test_oracle_shell": 3,
                       "test_explorer": 2}


@pytest.mark.parametrize("name,attr,params", twin_cases(*FILES))
def test_reference_case_on_the_port(name, attr, params, request):
    run_twin_case(name, attr, params, request)


def test_a_twin_builds_the_cards_constructors_on_the_cpu():
    tree = ast.parse(ast.unparse(_OnTheCPU().visit(ast.parse(
        "MockNetwork()\nSignatureBatcher(use_device=False)\n"
        "VerifierWorker(bus.create_node('w1'), 'node')\n"
        "NodeConfiguration(**cfg)\nNodeConfiguration.load(p)\n"
        "driver(tmp_path, device='cuda')\n"))))
    assert ast.unparse(tree).splitlines() == [
        "MockNetwork(device='cpu')",
        "SignatureBatcher(use_device=False, device='cpu')",
        "VerifierWorker(bus.create_node('w1'), 'node', device='cpu')",
        "NodeConfiguration(**cfg)", "NodeConfiguration.load(p)",
        "driver(tmp_path, device='cuda')"]


# -- the same inputs through both packages ------------------------------------

#: The packages' modules that register flows startable over RPC.
STARTABLE_MODULES = ("finance", "samples.irs_demo")


def load_startable_flows() -> None:
    """Import in both packages every module of theirs that registers a flow
    startable over RPC, so that both registries hold the same flows
    whichever test files ran before in this process."""
    for pkg in PKGS:
        for path in STARTABLE_MODULES:
            mod(pkg, path)


def package_flows(names, pkg: str) -> list:
    """The registered flow names of ``pkg``'s own modules, in the
    reference's spelling (test modules register flows of their own)."""
    return [n.replace(f"{pkg}.", "corda_tpu.") for n in names
            if n.startswith(f"{pkg}.")]


def seeded_values(pkg: str, seed: int) -> dict:
    """Framework values of ``pkg`` made from ``seed``: the same values in
    either package."""
    rng = random.Random(seed)
    crypto = mod(pkg, "core.crypto")
    identity = mod(pkg, "core.identity")
    amount = mod(pkg, "core.contracts.amount")
    contracts = mod(pkg, "core.contracts")
    testing = mod(pkg, "testing")
    transactions = mod(pkg, "core.transactions")
    hashes = mod(pkg, "core.crypto.secure_hash")
    keys = [crypto.generate_keypair(entropy=rng.randbytes(32))
            for _ in range(2)]
    party = identity.Party(f"O=Party {seed}, L=London, C=GB", keys[0].public)
    notary = identity.Party(testing.DUMMY_NOTARY_NAME, keys[1].public)
    state = testing.DummyState(rng.randrange(1000), (keys[0].public,))
    wtx = transactions.WireTransaction(
        outputs=(contracts.TransactionState(state, notary),),
        commands=(contracts.Command(testing.DummyContract.Create(),
                                    (keys[0].public,)),),
        notary=notary, must_sign=(keys[0].public,))
    services = testing.MockServices(key_pairs=keys, parties=[notary])
    stx = services.sign_transaction(wtx, keys[0].public)
    return {
        "party": party, "key": keys[0].public,
        "hash": hashes.SecureHash.sha256(rng.randbytes(16)),
        "amount": amount.Amount(rng.randrange(10 ** 6), amount.currency(
            rng.choice(("USD", "GBP", "CHF")))),
        "bytes": rng.randbytes(rng.randrange(1, 9)),
        "when": datetime.datetime(2026, 1 + seed % 12, 1 + seed % 28,
                                  rng.randrange(24),
                                  tzinfo=datetime.timezone.utc),
        "numbers": (rng.randrange(-99, 99), rng.random(), None, True),
        "nested": {"parties": [party, notary], "empty": [], "none": {},
                   "set": frozenset({rng.randrange(10)})},
        "state": state, "notary_state": contracts.TransactionState(state,
                                                                   notary),
        "stx": stx,
    }


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_jackson_renderings_equal_on_seeded_values(seed):
    out = {}
    for pkg in PKGS:
        jackson = mod(pkg, "client.jackson")
        values = seeded_values(pkg, seed)
        out[pkg] = {name: (jackson.to_jsonable(v), jackson.to_json(v),
                           jackson.render_yaml(v))
                    for name, v in values.items()}
        out[pkg]["all"] = (jackson.to_json(values),
                           jackson.render_yaml(values))
    assert out["corda_tpu_torch"] == out["corda_tpu"]
    assert "O=Party" in out["corda_tpu"]["all"][1]


#: Command lines for the parser: (flow class, text); each binds or fails
#: with the same message in both packages.
PARSER_LINES = (
    ("CashIssueFlow", "amount: 100.50 USD, issuer_ref: 0x01, recipient: "
                      "O=Alice, L=London, C=GB, notary: O=Notary, L=Zurich, "
                      "C=CH"),
    ("CashIssueFlow", "notary: O=Notary, L=Zurich, C=CH, recipient: O=Alice, "
                      "L=London, C=GB, issuer_ref: 0xdeadbeef, amount: 7 GBP"),
    ("CashPaymentFlow", "amount: 12.00 USD, recipient: O=Bob, L=Paris, C=FR"),
    ("CashPaymentFlow", "recipient: O=Bob, L=Paris, C=FR, amount: 0.5 CHF"),
    ("CashPaymentFlow", "amount: nonsense, recipient: O=Bob, L=Paris, C=FR"),
    # an unknown X.500 name stays text: the recipient has no annotation
    ("CashPaymentFlow", "amount: 1.00 USD, recipient: O=Nobody, L=X, C=GB"),
    ("CashPaymentFlow", "amount: 1.00 USD"),
    ("CashPaymentFlow", "amount: 1.00 USD, wrong: 1"),
    ("CashIssueFlow", "amount 1.00 USD"),
)
TOKENS = ("42", "-7", "0x00ff", "100.00 USD", "3 GBP", '"quoted words"',
          "true", "false", "O=Alice, L=London, C=GB", "O=Nobody, L=X, C=GB",
          "bare", "1.5", "")


def _parsed(pkg: str) -> dict:
    jackson = mod(pkg, "client.jackson")
    identity = mod(pkg, "core.identity")
    crypto = mod(pkg, "core.crypto")
    finance = mod(pkg, "finance")
    ser = mod(pkg, "core.serialization")
    parties = {name: identity.Party(name, crypto.generate_keypair(
        entropy=bytes([i + 1]) * 32).public)
        for i, name in enumerate(("O=Alice, L=London, C=GB",
                                  "O=Bob, L=Paris, C=FR",
                                  "O=Notary, L=Zurich, C=CH"))}
    parser = jackson.StringToMethodCallParser(party_resolver=parties.get)
    out = {"tokens": [ser.serialize(parser.convert(t)) for t in TOKENS],
           "pairs": [jackson.StringToMethodCallParser.split_pairs(text)
                     for _, text in PARSER_LINES[:4]]}
    for flow, text in PARSER_LINES:
        try:
            args = parser.parse_arguments(getattr(finance, flow), text)
            out[text] = ("ok", ser.serialize(args))
        except jackson.UnparseableCallException as exc:
            out[text] = ("refused", str(exc))
    return out


def test_parser_equal_on_the_same_command_lines():
    ref, port = (_parsed(pkg) for pkg in PKGS)
    assert port == ref
    assert [ref[text][0] for _, text in PARSER_LINES] == \
        ["ok"] * 4 + ["refused", "ok"] + ["refused"] * 3


SHELL_SCRIPT = (
    "help", "flow list", "run notary_identities", "run node_identity",
    "output json", "run network_map_snapshot", "output yaml",
    "flow start CashIssueFlow amount: 25.00 USD, issuer_ref: 0x02, "
    "recipient: O=Bank, L=London, C=GB, notary: O=Notary Service, "
    "L=Zurich, C=CH",
    'flow start CashIssueFlow "3 USD" 0x03 "O=Bank, L=London, C=GB" '
    '"O=Notary Service, L=Zurich, C=CH"',
    "flow start CashPaymentFlow amount: nonsense", "flow start NoSuchFlow",
    "run nonexistent_op", "bogus", "run get_cash_balances")


def _shell_session(pkg: str) -> str:
    load_startable_flows()
    network = mock_network(pkg)
    network.create_notary_node()
    bank = network.create_node("O=Bank, L=London, C=GB")
    network.start_nodes()
    ops = mod(pkg, "node.rpc").CordaRPCOps(bank.services, bank.smm)
    out = io.StringIO()
    shell = mod(pkg, "tools.shell").Shell(ops, out=out)
    for line in SHELL_SCRIPT:
        assert shell.execute(line)
        network.run_network()
    assert not shell.execute("exit")
    # "flow list" names test modules' flows too: keep the package's own
    flows = set(mod(pkg, "flows.api").rpc_startable_flows())
    text = "".join(line for line in out.getvalue().splitlines(True)
                   if line.strip() not in flows
                   or line.startswith(f"{pkg}."))
    text = text.replace(f"{pkg}.", "<pkg>.")
    return re.sub(r"run_id: \"?[0-9a-f-]+\"?", "run_id: <id>", text)


def test_shell_session_equal_over_mock_networks():
    ref, port = (_shell_session(pkg) for pkg in PKGS)
    assert port == ref
    assert "USD: 2800" in ref and "cannot bind" in ref
    assert '"legal_identity"' in ref


# -- float-bearing results over RPC -------------------------------------------

def _live_node(pkg: str, tmp_path):
    node_mod = mod(pkg, "node.node")
    kw = {"device": "cpu"} if pkg == "corda_tpu_torch" else {}
    return node_mod.Node(node_mod.NodeConfiguration(
        "O=Solo, L=London, C=GB", port=0, notary="simple",
        base_directory=str(tmp_path / pkg), **kw)).start()


def test_web_server_over_rpc_serves_metrics_and_profile(tmp_path):
    """A NodeWebServer over a CordaRPCClient (DemoBench's topology) serves
    /metrics and /debug/profile: the port's node sends those float-bearing
    snapshots as JSON text. The reference's codec refuses the floats, so
    its server answers both with 500; every other route answers alike."""
    answers = {}
    load_startable_flows()
    for pkg in PKGS:
        node = _live_node(pkg, tmp_path)
        client = mod(pkg, "client.rpc").CordaRPCClient(
            "127.0.0.1", node.messaging.port)
        server = mod(pkg, "tools.webserver").NodeWebServer(client).start()
        try:
            answers[pkg] = {}
            for path in ("/metrics", "/debug/profile", "/api/metrics",
                         "/healthz", "/readyz", "/api/status", "/api/flows"):
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{server.port}{path}",
                            timeout=30) as r:
                        answers[pkg][path] = (r.status, r.read().decode())
                except urllib.error.HTTPError as e:
                    answers[pkg][path] = (e.code, e.read().decode())
            snap = client.metrics_snapshot() if pkg == "corda_tpu_torch" \
                else None
        finally:
            server.stop()
            client.close()
            node.stop()
    ref, port = answers["corda_tpu"], answers["corda_tpu_torch"]
    for path in ("/metrics", "/debug/profile", "/api/metrics"):
        assert ref[path][0] == 500 and "Floats are not permitted" in \
            ref[path][1], path
        assert port[path][0] == 200, path
    assert "# TYPE corda_tpu_kernel_batch_occupancy_pct histogram" in \
        port["/metrics"][1]
    assert set(json.loads(port["/debug/profile"][1])) >= {
        "kernels", "occupancy", "overlap", "compile_s_total"}
    assert json.loads(port["/api/metrics"][1]).keys() == snap.keys()
    assert any(isinstance(v, float) for fields in snap.values()
               if isinstance(fields, dict) for v in fields.values())
    assert package_flows(json.loads(port["/api/flows"][1]),
                         "corda_tpu_torch") == \
        package_flows(json.loads(ref["/api/flows"][1]), "corda_tpu")
    for path in ("/healthz", "/readyz", "/api/status"):
        assert port[path][0] == ref[path][0] == 200, path
        assert _unplaced(port[path][1].replace("corda_tpu_torch.",
                                               "corda_tpu.")) == \
            _unplaced(ref[path][1]), path


def _unplaced(text: str) -> str:
    """``text`` without what differs between two live nodes of one name:
    their TCP ports and their identity keys, drawn at first boot."""
    text = re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:<port>", text)
    return re.sub(r'"owning_key": "\w+"', '"owning_key": "<key>"', text)
