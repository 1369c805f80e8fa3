"""No JAX in a run: a cell's set-up, window and check in a fresh process
load no module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``lkpy_tpu`` (compared whole: ``lkpy_tpu_torch`` is the program), and the
plain references import nothing of the program."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.core.cli import banned_modules

SCRIPT = """
import sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from tiny import run_tiny
from portbench.core.cli import banned_modules
res = run_tiny({workload!r})
assert "lkpy_tpu_torch" in sys.modules
print("BANNED", banned_modules())
"""


def test_banned_names_are_compared_whole():
    assert banned_modules(["lkpy_tpu_torch", "lkpy_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert banned_modules(["lkpy_tpu.models", "jax", "jaxlib.xla_client", "flax"]) == ["flax", "jax", "jaxlib.xla_client", "lkpy_tpu.models"]


@pytest.mark.parametrize("workload", ["als-implicit-ml20m.train", "als-implicit-ml20m.serve"])
def test_a_run_loads_no_jax(workload):
    code = SCRIPT.format(root=str(ROOT), tests=str(ROOT / "portbench" / "tests"), workload=workload)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BANNED []" in proc.stdout


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    tops = {n.split(".")[0] for n in names}
    assert tops <= {"__future__", "math", "torch", "portbench"}, tops
    assert all(n.startswith("portbench.reference") for n in names if n.split(".")[0] == "portbench")
