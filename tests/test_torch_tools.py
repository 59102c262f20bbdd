"""The port's web server and load-test harness against the JAX package's,
with the observability surfaces the server exposes: the REST and health
routes, the Prometheus exposition, ``/traces``, the tracer and histograms,
the kernel profiler, the metric-name rules and the generated-ledger load
tests.

Every case of tests/test_{webserver,traces_endpoint,observability,
profiling,metric_name_lint,loadtest_generated}.py runs on the port's twin
of the file with the reference's marks (tests/test_torch_client.py's
``run_twin_case``, every card constructor on the CPU).

Then the same inputs through both packages, compared exactly:
``prometheus_text`` of the same registry snapshots (seeded stage
histograms and meters, a federated fleet snapshot) byte for byte, the port
keeping the reference's ``corda_tpu_`` family prefix; and the web server's
answer to every route over each package's MockNetwork after the same REST
flow start: status codes, content types and JSON bodies, with each
package's module prefix mapped and every float (a duration or a rate)
compared by type; each package's process-wide retry registry, profiler
and tracer fresh (``fresh_process_stores``). Routes that serve a
process-wide store (the profiler, the time series, the tracer, the soak
accounting) are compared by shape: keys and types."""
import json
import random
import re
import urllib.error
import urllib.request

import pytest

from test_torch_client import (load_startable_flows, package_flows,
                               run_twin_case, twin_cases)
from test_torch_flow_framework import PKGS, mock_network, mod
from test_torch_obs import registry_snapshot

FILES = ("test_webserver", "test_traces_endpoint", "test_observability",
         "test_profiling", "test_metric_name_lint", "test_loadtest_generated")


def test_the_cases_cover_the_reference_files():
    by_file = {}
    for case in twin_cases(*FILES):
        by_file[case.values[0]] = by_file.get(case.values[0], 0) + 1
    assert by_file == {"test_webserver": 11, "test_traces_endpoint": 6,
                       "test_observability": 14, "test_profiling": 12,
                       "test_metric_name_lint": 4,
                       "test_loadtest_generated": 4}


@pytest.mark.parametrize("name,attr,params", twin_cases(*FILES))
def test_reference_case_on_the_port(name, attr, params, request):
    run_twin_case(name, attr, params, request)


# -- the same inputs through both packages ------------------------------------

def federated_snapshot(seed: int) -> dict:
    """The reference's federated fleet snapshot: two workers' batcher
    families under ``worker`` labels and the fleet aggregate."""
    from corda_tpu.observability import FleetMetricsFederation
    from corda_tpu.utils.metrics import MetricRegistry
    rng = random.Random(seed)
    node = MetricRegistry()
    fed = FleetMetricsFederation()
    for worker in ("w0", 'w"1\\'):
        reg = MetricRegistry()
        reg.meter("SigBatcher.DeviceChecked").mark(rng.randrange(1, 99))
        reg.meter("SigBatcher.Flushes").mark(rng.randrange(1, 9))
        hist = reg.histogram("verifier_batch_size")
        for _ in range(rng.randrange(1, 20)):
            hist.update(rng.randrange(1, 4096))
        fed.ingest(worker, reg.snapshot())
    node.add_collector(fed.snapshot)
    return node.snapshot()


@pytest.mark.parametrize("seed", [11, 12])
def test_prometheus_text_equal_on_one_snapshot(seed):
    for snap in (registry_snapshot(seed), federated_snapshot(seed)):
        texts = {pkg: mod(pkg, "tools.webserver").prometheus_text(snap)
                 for pkg in PKGS}
        assert texts["corda_tpu_torch"] == texts["corda_tpu"]
        assert "# TYPE corda_tpu_" in texts["corda_tpu"]


ROUTES = ("/healthz", "/readyz", "/api/status", "/api/network",
          "/api/notaries", "/api/vault", "/api/transactions", "/api/flows",
          "/api/metrics", "/api/fleet", "/debug/requests",
          "/debug/requests?limit=2", "/debug/critpath",
          "/debug/critpath?top_k=1", "/debug/raft", "/api/nope",
          "/web/none/index.html", "/debug/critpath?top_k=x",
          "/api/timeseries?limit=0")
#: routes that read a store shared by the whole process
SHARED_ROUTES = ("/debug/profile", "/debug/soak", "/api/timeseries",
                 "/traces", "/traces?format=jsonl")
ISSUE_ARGS = [{"amount": 12300, "currency": "USD"}, {"hex": "01"},
              {"party": "O=Alice, L=Madrid, C=ES"},
              {"party": "O=Notary Service, L=Zurich, C=CH"}]


def _fetch(port: int, path: str, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


#: fields drawn at random in each run (flow run ids)
RANDOM_KEYS = ("run_id",)


def _le(bound: str) -> str:
    """A histogram bucket's upper bound: a duration, so by type, unless it
    is the last bucket's."""
    return bound if bound == "+Inf" else "le"


def _masked(value, pkg: str, numbers: bool):
    """``value`` with ``pkg``'s module prefix mapped to the reference's and
    every float (every number too when ``numbers``) replaced by its type."""
    if isinstance(value, dict):
        return {_masked(k, pkg, numbers):
                type(v).__name__ if k in RANDOM_KEYS
                else [[_le(le), n] for le, n in v] if k == "buckets"
                else _masked(v, pkg, numbers) for k, v in value.items()}
    if isinstance(value, list):
        return [_masked(v, pkg, numbers) for v in value]
    if isinstance(value, str):
        return value.replace(f"{pkg}.", "corda_tpu.")
    if isinstance(value, float) or (numbers and isinstance(value, int)
                                    and not isinstance(value, bool)):
        return type(value).__name__
    return value


def _shape(value):
    """Keys and types of a JSON value (lists by their first item)."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(value[0])] if value else []
    return type(value).__name__


def fresh_process_stores(pkg: str, monkeypatch) -> None:
    """``pkg``'s process-wide stores that every node's metrics read (the
    retry registry, the kernel profiler, the tracer) as a fresh process has
    them: the same input in each package, whatever ran before."""
    reg = mod(pkg, "utils.metrics").MetricRegistry()
    reg.meter("Retry.Attempts")
    reg.meter("Retry.GiveUps")
    monkeypatch.setattr(mod(pkg, "utils.retry"), "_REGISTRY", reg)
    profiling = mod(pkg, "observability.profiling")
    monkeypatch.setattr(profiling, "_PROFILER", profiling.KernelProfiler())
    tracing = mod(pkg, "observability.tracing")
    monkeypatch.setattr(tracing, "_TRACER", tracing.NOOP_TRACER)


def _web_answers(pkg: str, monkeypatch) -> dict:
    fresh_process_stores(pkg, monkeypatch)
    load_startable_flows()
    network = mock_network(pkg)
    network.create_notary_node()
    alice = network.create_node("O=Alice, L=Madrid, C=ES")
    network.start_nodes()
    ops = mod(pkg, "node.rpc").CordaRPCOps(alice.services, alice.smm)
    server = mod(pkg, "tools.webserver").NodeWebServer(
        ops, pump=network.run_network).start()
    try:
        out = {"POST": _fetch(server.port, "/api/flows/CashIssueFlow",
                              ISSUE_ARGS)}
        for path in ROUTES + SHARED_ROUTES:
            out[path] = _fetch(server.port, path)
        return out
    finally:
        server.stop()


def _prometheus_lines(text: str) -> list:
    """The exposition's lines, each sample's value replaced by its type
    and each bucket bound but the last by ``le``."""
    out = []
    for line in text.splitlines():
        if line.startswith("#"):
            out.append(line)
            continue
        name, value = line.rsplit(" ", 1)
        name = re.sub(r'le="([^"]*)"', lambda m: f'le="{_le(m[1])}"', name)
        out.append((name, "int" if re.fullmatch(r"-?\d+", value)
                    else "float"))
    return out


def test_web_routes_answer_alike_over_mock_networks(monkeypatch):
    answers = {pkg: _web_answers(pkg, monkeypatch) for pkg in PKGS}
    ref, port = answers["corda_tpu"], answers["corda_tpu_torch"]
    for path in ("POST",) + ROUTES:
        (rc, rt, rb), (pc, pt, pb) = ref[path], port[path]
        assert (pc, pt) == (rc, rt), path
        if path == "/api/flows":   # test modules register flows of their own
            assert package_flows(json.loads(pb), "corda_tpu_torch") == \
                package_flows(json.loads(rb), "corda_tpu")
            continue
        assert _masked(json.loads(pb), "corda_tpu_torch", False) == \
            _masked(json.loads(rb), "corda_tpu", False), path
    for path in SHARED_ROUTES:
        (rc, rt, rb), (pc, pt, pb) = ref[path], port[path]
        assert (pc, pt) == (rc, rt), path
        if path.endswith("jsonl"):
            assert {tuple(_shape(json.loads(line)))
                    for line in pb.splitlines()} <= \
                {tuple(_shape(json.loads(line)))
                 for line in rb.splitlines()} | {()}, path
        else:
            assert set(_shape(json.loads(pb))) == \
                set(_shape(json.loads(rb))), path
    assert ref["POST"][0] == 200 and json.loads(ref["POST"][2])["done"]
    assert json.loads(ref["/api/vault"][2])[0]["state"]["data"]["amount"][
        "quantity"] == 12300


def test_prometheus_scrapes_alike_over_mock_networks(monkeypatch):
    """/metrics after the same flow: the same families, types and sample
    names; values by type (durations and rates differ run to run)."""
    texts = {}
    load_startable_flows()
    for pkg in PKGS:
        fresh_process_stores(pkg, monkeypatch)
        network = mock_network(pkg)
        network.create_notary_node()
        alice = network.create_node("O=Alice, L=Madrid, C=ES")
        network.start_nodes()
        ops = mod(pkg, "node.rpc").CordaRPCOps(alice.services, alice.smm)
        server = mod(pkg, "tools.webserver").NodeWebServer(
            ops, pump=network.run_network).start()
        try:
            assert _fetch(server.port, "/api/flows/CashIssueFlow",
                          ISSUE_ARGS)[0] == 200
            code, ctype, text = _fetch(server.port, "/metrics")
            assert (code, ctype) == (200, "text/plain; version=0.0.4")
            texts[pkg] = _prometheus_lines(text)
        finally:
            server.stop()
    assert texts["corda_tpu_torch"] == texts["corda_tpu"]
    assert ("corda_tpu_flows_inflight_value", "int") in texts["corda_tpu"]
