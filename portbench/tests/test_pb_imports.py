"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (the port's own name begins with the JAX package's),
and the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

from harness import runner

PORTBENCH = runner.ROOT
REFERENCE = ("harness/reference.py", "harness/plaincrypto.py",
             "harness/yardsticks.py", "harness/inputs.py")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for base, _, files in os.walk(PORTBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_imports(path)) & set(runner.FORBIDDEN)
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for rel in REFERENCE:
        tops = set(_imports(os.path.join(PORTBENCH, rel)))
        assert not tops & {"corda_tpu_torch", "torch", "corda_tpu"}, rel


def test_the_reference_loads_nothing_of_the_program_when_run():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from harness import reference, plaincrypto, yardsticks, inputs\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'corda_tpu_torch', 'corda_tpu', 'torch', 'jax'}))"
            % PORTBENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_a_run_loads_no_jax_module():
    runner.run_cell("ed25519.bulk", 2 ** 36 + 1, 0.5, False,
                    device="cpu", overrides={"distinct": 32,
                                             "group_size": 8,
                                             "outstanding": 2,
                                             "warmup_submissions": 2})
    assert runner.forbidden_modules() == []
