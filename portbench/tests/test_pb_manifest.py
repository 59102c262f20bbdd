"""BENCHMARK.json against its contract and against the files the harness
finds by name."""
import json
import os
import re

import pytest
from conftest import bench_copy

from harness import runner

PORTBENCH = runner.ROOT
REPO = os.path.dirname(PORTBENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for e in bench["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for text in ([c["why"] for c in bench["configs"] + bench["workloads"]]
                 + [c["source"] for c in bench["configs"]]
                 + [m["layer"] for m in bench["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(bench)) <= 64 * 1024


def test_cells_configs_and_traffic_are_files_found_by_name(bench):
    used = set()
    for w in bench["workloads"]:
        cell = runner.load("cells", w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                    w["traffic"])
        assert cell["chips"] == w["chips"] == 1
        runner.load("traffic", w["traffic"])
        used.add(w["config"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(REPO, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []


def _synthetic_run(cell, trace):
    class Trace:
        busy_s, window_s = 0.05, 10.0

        def seconds_of(self, names):
            return 0.01

    cell_file = runner.load("cells", cell)
    return {"cell": cell, "config": runner.load("configs",
                                                 cell_file["config"]),
            "mix": runner.load("traffic", cell_file["traffic"]),
            "trace": trace, "setup_s": 20.0, "window": None,
            "window_s": 10.0, "items_done": 1000,
            "readings": {"verifier_batch_size": (10, 5000),
                         "verifier_prep_seconds": (10, 0.5),
                         "device_checked": 5000},
            "spans": [], "device": Trace()}


def test_every_metric_has_a_reader_reporting_in_its_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layer = {m["name"]: m for m in bench["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(PORTBENCH, "metrics"))
             if f.endswith(".py")}
    assert files == set(e2e) | set(layer)
    readers = runner.metric_readers(files)
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              cells))
    for cell in cells:
        names = runner.cell_metrics(bench, cell)
        for kind in ("end_to_end", "per_layer"):
            run = _synthetic_run(cell, kind == "per_layer")
            for name in names[kind]:
                assert readers[name].KIND == kind
                assert readers[name].UNIT == (e2e.get(name)
                                              or layer[name])["unit"]
                assert readers[name].read(run) is not None, (cell, name)
        assert "setup_s" in names["end_to_end"]
        assert len(names["end_to_end"]) >= 2 and names["per_layer"]


def test_a_cell_added_as_a_file_alone_is_found_and_runs(tmp_path):
    """mixed-scheme-node x bulk, a pair no cell has: the cell's file and
    its line in BENCHMARK.json, and no code."""
    root = bench_copy(tmp_path, [("mixed.bulk", "mixed-scheme-node", "bulk",
                                  ["verifies_per_s"])])
    result = runner.run_cell(
        "mixed.bulk", 2 ** 33 + 5, 2.0, False, device="cpu", root=root,
        overrides={"distinct": 48, "group_size": 8, "outstanding": 2,
                   "warmup_submissions": 2, "tamper_every": 5})
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "verifies_per_s"}
    assert list(result)[-1] == "checks"


def test_the_signature_mix_follows_the_configuration():
    from entries import submit_group
    config = runner.load("configs", "mixed-scheme-node")
    mix = dict(runner.load("traffic", "bulk"), distinct=24, tamper_every=64)
    rows = [r for job in submit_group.jobs(7, mix, config, 2)
            for r in submit_group.chunk(job)]
    owners = [r[1] for r in rows if r[0] % 2 == 0]
    notary = {r[1] for r in rows if r[0] % 2 == 1}
    assert sorted(owners) == sorted(config["owner_schemes"] * 4)
    assert notary == {config["notary_scheme"]}
    prepared = submit_group.prepare(sorted(rows), 7, mix, config)
    keys = [key for group in prepared.program_inputs for key, _, _ in group]
    assert [k.scheme.scheme_code_name for k in keys] == [
        r[1] for r in sorted(rows)]


@pytest.mark.parametrize("change", [{"owner_schemes": ["RSA_SHA256"]},
                                    {"parties": 4}])
def test_a_configuration_the_inputs_cannot_follow_is_refused(change):
    from entries import submit_group
    config = dict(runner.load("configs", "mixed-scheme-node"), **change)
    with pytest.raises(ValueError):
        submit_group.jobs(7, runner.load("traffic", "bulk"), config, 2)
