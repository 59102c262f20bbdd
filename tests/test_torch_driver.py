"""The port's process driver, its runners and DemoBench against the JAX
package's: real node and verifier processes (``python -m
corda_tpu_torch.node`` / ``.verifier``) on the CPU.

Every case of tests/test_{driver_integration,smoke,runner,demobench}.py
runs on the port's twin of the file with the reference's marks
(tests/test_torch_client.py's ``run_twin_case``): the driver is
``DriverDSL(..., device="cpu")``, so every node and device worker it spawns
gets ``--device cpu``; the black-box node smoke passes ``--device cpu``;
DemoBench's spec names ``"device": "cpu"``. The reference's ``slow`` cases
stay ``slow``; its ``medium`` driver-cluster and worker cases run in the
gate. tests/test_torch_driver_cluster.py holds the rest of this slice's
process tests."""
import pytest

from test_torch_client import run_twin_case, twin_cases

SUBS = {
    "test_smoke": (('exe = shutil.which("corda-tpu-node")', "exe = None"),
                   ('"--notary", "simple", "--quiet"]',
                    '"--notary", "simple", "--quiet", "--device", "cpu"]')),
    "test_demobench": (('"base_directory": str(tmp_path / "net"),',
                        '"base_directory": str(tmp_path / "net"), '
                        '"device": "cpu",'),),
}
FILES = ("test_driver_integration", "test_smoke", "test_runner",
         "test_demobench")


def test_the_cases_cover_the_reference_files():
    by_file, marks = {}, {}
    for case in twin_cases(*FILES):
        by_file[case.values[0]] = by_file.get(case.values[0], 0) + 1
        for m in case.marks:
            marks[m.name] = marks.get(m.name, 0) + 1
    assert by_file == {"test_driver_integration": 4, "test_smoke": 1,
                       "test_runner": 4, "test_demobench": 2}
    assert marks == {"medium": 2, "slow": 4}


@pytest.mark.parametrize("name,attr,params", twin_cases(*FILES))
def test_reference_case_on_the_port(name, attr, params, request):
    run_twin_case(name, attr, params, request, SUBS.get(name, ()))
