"""The port's Raft under chaos against the JAX package's: every case of
tests/test_chaos_raft.py and tests/test_chaos_snapshot.py run on both
packages with the same seeds (tests/test_torch_raft.py's harness).

Each case pumps the bus itself, so the two runs are compared tick by
tick: partitions and append-drop storms come from each package's own
fault injector on the case's seed, and the port's replicas must take the
reference's course row for row (roles, terms, leaders, commit indexes,
logs, applied entries, maps, compaction points), restarts and
InstallSnapshot catch-ups included. The coordinator-log GC case compares
the logs' in-doubt sets and sizes. The election-episode case reads each
package's replicas through its own consensus observatory
(``observability/consensus_obs.py``'s ``raft_report``)."""
import pytest

from test_torch_finance import reference_cases
from test_torch_raft import run_twin

pytestmark = pytest.mark.chaos


@pytest.mark.parametrize("name,attr,params",
                         reference_cases("test_chaos_raft")
                         + reference_cases("test_chaos_snapshot"))
def test_chaos_case_matches_reference(name, attr, params, tmp_path):
    run_twin(name, attr, params, tmp_path)
