"""The port's remaining samples, the node scheduler and the progress tracker
against the JAX package's.

Every case of tests/test_{samples,trader_demo,simulation,irs_demo,
scheduler_progress}.py runs on both packages: as the reference's own
module, and as a twin of the port, its source executed with every
``corda_tpu.`` module naming ``corda_tpu_torch.`` and every MockNetwork,
demo and simulation on the CPU (``device="cpu"``). A case passes when it
passes on the reference, ends the same way on the port, and leaves every
MockNetwork it built, in the test or inside a sample, with the same ledger
on both packages (tests/test_torch_finance.py's ``ledger_of``). The trader
demo reads the wall clock for its paper's maturity and time window, so
both packages' runs of a case read one instant, taken when the case
starts.

Then the same inputs through both packages: the simulation's balances and
event stream for one seed, the trader demo's outcome, the IRS demo's two
scheduler-fired fixings (the rates, the tear-offs the oracle signs and its
signatures) and the schedulers' deadlines along the way. Every comparison
is exact."""
import datetime
import importlib
import pathlib
import types

import pytest
import torch

from test_torch_finance import ledger_of, reference_cases, run_case
from test_torch_flow_framework import PKGS, mod, twin_module

TESTS = pathlib.Path(__file__).resolve().parent

#: The sample modules that build MockNetworks of their own.
SAMPLE_MODULES = ("samples.trader_demo", "samples.bank_of_corda",
                  "samples.attachment_demo", "samples.simulation",
                  "samples.notary_demo")

#: Each reference file's lines that build a demo, the port's on the CPU.
SUBS = {
    "test_samples": (
        ("bank_of_corda.run_demo(amount_dollars=500)",
         'bank_of_corda.run_demo(amount_dollars=500, device="cpu")'),
        ("notary_demo.run_demo(rounds=2)",
         'notary_demo.run_demo(rounds=2, device="cpu")'),
        ("notary_demo.run_demo(rounds=1, validating=True)",
         'notary_demo.run_demo(rounds=1, validating=True, device="cpu")'),
        ("notary_demo.run_raft_demo(rounds=2)",
         'notary_demo.run_raft_demo(rounds=2, device="cpu")'),
        ("notary_demo.run_bft_demo(rounds=2)",
         'notary_demo.run_bft_demo(rounds=2, device="cpu")'),
        ("attachment_demo.run_demo()",
         'attachment_demo.run_demo(device="cpu")')),
    "test_trader_demo": (
        ("run_demo(price_dollars=1000, face_dollars=1100)",
         'run_demo(price_dollars=1000, face_dollars=1100, device="cpu")'),),
    "test_simulation": (
        ("Simulation(n_banks=3, seed=5, issue_cents=500_00)",
         'Simulation(n_banks=3, seed=5, issue_cents=500_00, device="cpu")'),),
}

FILES = ("test_samples", "test_trader_demo", "test_simulation",
         "test_irs_demo", "test_scheduler_progress")
CASES = [c for name in FILES for c in reference_cases(name)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def port_twin(name: str):
    """The port's twin of tests/<name>.py, its demos and MockNetworks on
    the CPU."""
    src = (TESTS / f"{name}.py").read_text()
    for old, new in SUBS.get(name, ()):
        assert old in src, old
        src = src.replace(old, new)
    src = src.replace("MockNetwork()", 'MockNetwork(device="cpu")')
    return twin_module("corda_tpu_torch", name, src)


def fix_the_clock(monkeypatch, now: datetime.datetime) -> None:
    """Both packages' trader demos read ``now`` as the current instant."""
    class Fixed(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return now

    shim = types.SimpleNamespace(datetime=Fixed, timedelta=datetime.timedelta,
                                 timezone=datetime.timezone)
    for pkg in PKGS:
        monkeypatch.setattr(mod(pkg, "samples.trader_demo"), "datetime", shim)


def record_sample_networks(monkeypatch) -> dict:
    """{pkg: the MockNetworks the sample modules build from now on}."""
    built = {}
    for pkg in PKGS:
        base = mod(pkg, "testing").MockNetwork
        networks = built[pkg] = []

        def __init__(self, *a, _base=base, _networks=networks, **kw):
            _base.__init__(self, *a, **kw)
            _networks.append(self)

        recording = type("RecordingNetwork", (base,), {"__init__": __init__})
        for path in SAMPLE_MODULES:
            monkeypatch.setattr(mod(pkg, path), "MockNetwork", recording)
    return built


def test_the_cases_cover_the_reference_files():
    by_file = {}
    for case in CASES:
        by_file[case.values[0]] = by_file.get(case.values[0], 0) + 1
    assert by_file == {"test_samples": 6, "test_trader_demo": 2,
                       "test_simulation": 2, "test_irs_demo": 4,
                       "test_scheduler_progress": 2}


@pytest.mark.parametrize("name,attr,params", CASES)
def test_reference_case(name, attr, params, monkeypatch):
    fix_the_clock(monkeypatch, datetime.datetime.now(datetime.timezone.utc))
    built = record_sample_networks(monkeypatch)
    modules = {"corda_tpu": importlib.import_module(name),
               "corda_tpu_torch": port_twin(name)}
    records = {pkg: run_case(pkg, modules[pkg], attr, params, monkeypatch)
               for pkg in PKGS}
    ref, port = records["corda_tpu"], records["corda_tpu_torch"]
    assert ref["outcome"] == ("ok",)
    assert port["outcome"] == ref["outcome"]
    assert port["ledgers"] == ref["ledgers"]
    samples = {pkg: [ledger_of(pkg, n) for n in built[pkg]] for pkg in PKGS}
    assert samples["corda_tpu_torch"] == samples["corda_tpu"]


def test_a_demo_that_differs_is_caught(monkeypatch):
    """The comparison sees a port whose demo ends otherwise: the port's
    bank of corda made to issue a cent less fails the case."""
    port_boc = mod("corda_tpu_torch", "samples.bank_of_corda")
    real = port_boc.CashIssueFlow

    def short(amount, *a, **kw):
        return real(amount.__class__(amount.quantity - 1, amount.token),
                    *a, **kw)

    monkeypatch.setattr(port_boc, "CashIssueFlow", short)
    with pytest.raises(AssertionError):
        test_reference_case("test_samples", "test_bank_of_corda_issuance",
                            {}, monkeypatch)


# -- the same inputs through both packages ------------------------------------

def _simulation(pkg: str):
    cls = mod(pkg, "samples.simulation").Simulation
    kw = {} if pkg == "corda_tpu" else {"device": "cpu"}
    sim = cls(n_banks=4, seed=23, issue_cents=750_00, **kw)
    seen = []
    sim.add_observer(seen.append)
    sim.run(steps=10)
    return {"events": sim.events, "seen": seen, "balances": sim.balances(),
            "total": sim.total_cents()}


def test_simulation_balances_and_events_agree():
    ref, port = (_simulation(pkg) for pkg in PKGS)
    assert port == ref
    assert ref["total"] == 4 * 750_00
    # the observer joins after the four funding issues
    assert len(ref["seen"]) == len(ref["events"]) - 4


def _trader(pkg: str):
    kw = {} if pkg == "corda_tpu" else {"device": "cpu"}
    out = mod(pkg, "samples.trader_demo").run_demo(
        price_dollars=700, face_dollars=900, **kw)
    final = out["final"]
    paper = out["buyer_paper"][0].state.data
    return {"final": final.id.bytes, "signatures": len(final.sigs),
            "face": paper.face_value.quantity,
            "paper_owner": paper.owner == out["buyer"].party.owning_key,
            "seller_cash": sorted(s.state.data.amount.quantity
                                  for s in out["seller_cash"]),
            "buyer_cash": sorted(s.state.data.amount.quantity
                                 for s in out["buyer_cash"]),
            "ledgers": ledger_of(pkg, out["network"])}


def test_trader_demo_outcome_agrees(monkeypatch):
    fix_the_clock(monkeypatch, datetime.datetime.now(datetime.timezone.utc))
    ref, port = (_trader(pkg) for pkg in PKGS)
    assert port == ref
    assert ref["face"] == 900_00 and ref["paper_owner"]
    assert ref["signatures"] == 3
    assert sum(ref["seller_cash"]) == 700_00
    assert sum(ref["buyer_cash"]) == 200_00


T0 = datetime.datetime(2026, 3, 1, tzinfo=datetime.timezone.utc)


def _irs(pkg: str, monkeypatch):
    """Deal entry and two scheduler-fired fixings (tests/test_irs_demo.py's
    network): what the oracle signed, its signatures, the applied rates and
    the schedulers' next deadlines after each step."""
    irs = mod(pkg, "samples.irs_demo")
    oracle_mod = mod(pkg, "samples.rates_oracle")
    ser = mod(pkg, "core.serialization").serialize
    signed = []
    real_sign = oracle_mod.RatesOracle.sign

    def sign(self, ftx):
        sig = real_sign(self, ftx)
        signed.append({"ftx": ser(ftx), "sig": sig.bytes,
                       "root": ftx.root_hash.bytes})
        return sig

    monkeypatch.setattr(oracle_mod.RatesOracle, "sign", sign)
    network = (mod(pkg, "testing").MockNetwork() if pkg == "corda_tpu"
               else mod(pkg, "testing").MockNetwork(device="cpu"))
    notary = network.create_notary_node()
    bank_a = network.create_node("O=Bank A, L=London, C=GB")
    bank_b = network.create_node("O=Bank B, L=Paris, C=FR")
    oracle_node = network.create_node("O=Rates Oracle, L=London, C=GB")
    network.start_nodes()
    FixOf = oracle_mod.FixOf
    oracle = oracle_mod.RatesOracle(oracle_node.services, {
        FixOf("LIBOR", "2026-03-10", "3M"): 525,
        FixOf("LIBOR", "2026-06-10", "3M"): 550})
    oracle.install(oracle_node.smm)
    irs.install_irs_demo(bank_a)
    irs.install_irs_demo(bank_b)
    clock = {"t": T0}
    schedulers = []
    for node in (bank_a, bank_b):
        sched = mod(pkg, "node.scheduler").NodeSchedulerService(
            node.services, clock=lambda: clock["t"])
        sched.start()
        schedulers.append(sched)
    swap = irs.InterestRateSwapState(
        fixed_leg=irs.FixedLeg(bank_a.party, rate_bp=450),
        floating_leg=irs.FloatingLeg(bank_b.party, "LIBOR", "3M"),
        notional=10_000_000, oracle=oracle_node.party,
        fixing_dates=("2026-03-10", "2026-06-10"))
    fsm = bank_a.start_flow(irs.AgreeSwapFlow(swap, notary.party))
    network.run_network()
    fsm.result_future.result(timeout=5)
    deadlines = [[s.next_deadline_micros() for s in schedulers]]
    fired = []
    for days in (15, 120):
        clock["t"] = T0 + datetime.timedelta(days=days)
        started = [fsm for s in schedulers for fsm in s.wake()]
        network.run_network()
        fired.append([fsm.result_future.result(timeout=5) is None
                      for fsm in started])
        deadlines.append([s.next_deadline_micros() for s in schedulers])
    rates = [[f.value_bp for f in node.services.vault.unconsumed_states(
        irs.InterestRateSwapState)[0].state.data.applied_fixes]
        for node in (bank_a, bank_b)]
    return {"signed": signed, "rates": rates, "deadlines": deadlines,
            "fired": fired, "ledgers": ledger_of(pkg, network)}


def test_irs_fixings_through_the_scheduler_agree(monkeypatch):
    ref, port = (_irs(pkg, monkeypatch) for pkg in PKGS)
    assert port == ref
    assert ref["rates"] == [[525, 550], [525, 550]]
    assert len(ref["signed"]) == 2
    # both parties' schedulers fire each fixing; the fixed-leg payer's run
    # returns None, the floating-leg payer's finalises the fixing
    assert ref["fired"] == [[True, False], [True, False]]
    assert ref["deadlines"][0][0] == ref["deadlines"][0][1] is not None
    assert ref["deadlines"][-1] == [None, None]


def test_progress_tracker_renders_alike():
    def run(pkg):
        progress = mod(pkg, "utils.progress")
        Step = progress.Step
        steps = [Step("Verifying"), Step("Signing"), Step("Notarising")]
        child_steps = [Step("Collecting"), Step("Finalising")]
        parent = progress.ProgressTracker(*steps)
        child = progress.ProgressTracker(*child_steps)
        parent.set_child_progress_tracker(steps[2], child)
        seen = []
        parent.subscribe(lambda ev: seen.append((ev[0], ev[2].label)))
        frames = []
        for _ in range(3):
            parent.next_step()
            frames.append(parent.render())
        child.next_step()
        frames.append(parent.render())
        parent.next_step()
        return {"seen": seen, "frames": frames, "ended": parent.has_ended}
    ref, port = (run(pkg) for pkg in PKGS)
    assert port == ref
    assert ref["ended"]
