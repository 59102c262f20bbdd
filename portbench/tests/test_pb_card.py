"""On the card: every cell runs briefly through the real command and comes
out correct. Skips where there is no CUDA device.

    python3 -m pytest portbench/tests/test_pb_card.py -m gpu -rA
"""
import json
import os
import subprocess
import sys

import pytest

from harness import runner

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.parametrize(
    "cell", [w["name"] for w in runner.manifest()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    repo = os.path.dirname(runner.ROOT)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 33 + 31), "--seconds", "2", "--trace", str(trace)],
        cwd=repo, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
