"""The port's soak observatory against the JAX package's: every case of
tests/test_soak.py on the port's twin of the file, over one accelerated
smoke soak of the port on the CPU for the whole module (``smoke_report``,
``SoakConfig.smoke(seed=7)`` with ``device="cpu"``), as the reference
runs one for its module.

The port's report is also held to the reference's own soak gate
(``guard_soak`` and its required fields), so its field set is the
reference's without a second soak, and it must carry the staging pool's
``Staging.Buffers`` probe: the soak registers it inside a ``try`` that
swallows any error, so a pool the probe could not read would vanish from
the verdicts instead of failing the run."""
import pytest

from test_torch_finance import reference_cases
from test_torch_ledger import _warm  # noqa: F401  (module fixture)
from test_torch_obs import run_port_case

pytestmark = [pytest.mark.soak, pytest.mark.ledger]


@pytest.fixture(scope="module")
def smoke_report():
    from corda_tpu_torch.observability.soak import SoakConfig, run_soak
    cfg = SoakConfig.smoke(seed=7)
    cfg.device = "cpu"
    return run_soak(cfg)


@pytest.mark.parametrize("name,attr,params", reference_cases("test_soak"))
def test_soak_case_on_the_port(name, attr, params, request):
    run_port_case(name, attr, params, request)


def test_port_soak_passes_the_reference_gate(smoke_report):
    from corda_tpu.tools.benchguard import SOAK_REQUIRED, guard_soak
    for field in SOAK_REQUIRED:
        assert field in smoke_report, field
    assert guard_soak(smoke_report, trajectory_paths=[]) == []


def test_port_soak_reads_the_ports_staging_pool(smoke_report, monkeypatch):
    """``Staging.Buffers`` is a verdict of the port's soak, and its probe
    reads the port's pool: the count it reports is the pool's free and
    attached buffers."""
    from corda_tpu_torch.ops import staging
    from corda_tpu_torch.observability.soak import SoakConfig, SoakObserver
    verdict = smoke_report["soak_leak_verdicts"]["Staging.Buffers"]
    assert verdict["verdict"] == "bounded"
    assert "Staging.Buffers" in smoke_report["soak_resources"]

    pool = staging.StagingPool()
    pool._free = {("k",): [object(), object()]}
    pool._attached = {1: object()}
    monkeypatch.setattr(staging, "_POOL", pool)
    observer = SoakObserver(SoakConfig.smoke())
    observer._register_probes({})
    observer.resources.sample()
    assert observer.resources.sizes()["Staging.Buffers"] == 3.0
