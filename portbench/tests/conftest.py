"""Puts the checkout (the port) and the benchmark's harness on sys.path,
and makes copies of the benchmark with cells added as files."""
import json
import os
import shutil
import sys

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PORTBENCH)
sys.path.insert(0, REPO)
sys.path.insert(0, PORTBENCH)

#: A payments mix at a size a test run holds, with a broken payment in
#: every few so that a short window on the CPU judges some of each kind.
PAYMENTS = {"entry": "verify_signed", "loop": "closed",
            "why": "cash payments at a test's size",
            "outstanding": 8, "wave": 4, "distinct": 48,
            "input_cents": [1000, 100000],
            "bad_signature_every": 3, "bad_signature_offset": 1,
            "bad_signature_kinds": 6, "unconserved_every": 4,
            "unconserved_offset": 2, "warmup_submissions": 4}


def bench_copy(tmp_path, cells=(), mixes=None) -> str:
    """A copy of the benchmark at ``tmp_path``: ``portbench/`` with the
    ``mixes`` ({name: parameters}) added under ``traffic/`` and the
    ``cells`` ([(name, config, traffic, metrics)]) added as cell files and
    as workloads of a copy of ``BENCHMARK.json``, each listed under the
    end-to-end ``metrics`` named. Returns the copy's ``portbench``."""
    root = os.path.join(str(tmp_path), "portbench")
    shutil.copytree(PORTBENCH, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, mix in (mixes or {}).items():
        with open(os.path.join(root, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, config, traffic, metrics in cells:
        with open(os.path.join(root, "cells", name + ".json"), "w") as f:
            json.dump({"config": config, "traffic": traffic, "chips": 1}, f)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "added as a file"})
        for m in bench["end_to_end"]:
            if m["name"] in metrics:
                m["workloads"].append(name)
    with open(os.path.join(str(tmp_path), "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
