"""The port's group committer and sharded notary under chaos against the
JAX package's: every case of tests/test_chaos_group_commit.py and
tests/test_chaos_sharded_notary.py run on both packages with the same
seeds (tests/test_torch_raft.py's harness).

The committers run a ticker and a batch pool on threads, the sharded
provider its 2PC coordinator's pool, and each case pumps its Raft groups
from a background thread, so batch cuts follow the clock: the twins
compare outcomes — every commit's and recovery's verdict (the result, or
the exception's type and message) in call order, the map and
reservations the replicas converge to, and the coordinator logs'
in-doubt sets and sizes — with both packages' runs going at once (the
leader-kill cases wait out their timeouts side by side)."""
import pytest

from test_torch_finance import reference_cases
from test_torch_raft import run_twin

pytestmark = pytest.mark.chaos


@pytest.mark.parametrize("name,attr,params",
                         reference_cases("test_chaos_group_commit")
                         + reference_cases("test_chaos_sharded_notary"))
def test_commit_case_matches_reference(name, attr, params, tmp_path):
    run_twin(name, attr, params, tmp_path, "threads")
