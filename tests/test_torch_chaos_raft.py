"""The port's Raft under chaos against the JAX package's: every case of
tests/test_chaos_raft.py and tests/test_chaos_snapshot.py run on both
packages with the same seeds (tests/test_torch_raft.py's harness).

Each case pumps the bus itself, so the two runs are compared tick by
tick: partitions and append-drop storms come from each package's own
fault injector on the case's seed, and the port's replicas must take the
reference's course row for row (roles, terms, leaders, commit indexes,
logs, applied entries, maps, compaction points), restarts and
InstallSnapshot catch-ups included. The coordinator-log GC case compares
the logs' in-doubt sets and sizes.

The consensus observatory (``observability/consensus_obs.py``) is not in
the port yet: for the election-episode case the reference's module stands
in under the port's name, its ``raft_report`` reading the port's replicas
through their ``stats()``."""
import sys

import pytest

from test_torch_finance import reference_cases
from test_torch_raft import run_twin

pytestmark = pytest.mark.chaos


@pytest.mark.parametrize("name,attr,params",
                         reference_cases("test_chaos_raft")
                         + reference_cases("test_chaos_snapshot"))
def test_chaos_case_matches_reference(name, attr, params, monkeypatch,
                                      tmp_path):
    from corda_tpu.observability import consensus_obs
    monkeypatch.setitem(sys.modules,
                        "corda_tpu_torch.observability.consensus_obs",
                        consensus_obs)
    run_twin(name, attr, params, tmp_path)
