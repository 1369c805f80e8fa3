"""On the card, at each cell's own size: the program's numbers within their
limits and the control's over them, on three seeds, through ``control.py``.
Skips without a card."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_and_program_passes_at_full_size(card, workload):
    seeds = "2147483901,2147483902,2147483903"
    proc = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", workload, "--seeds", seeds, "--control-seeds", seeds, "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    limits = _limits(workload)
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(rows) == 3
    for r in rows:
        assert r["correct"], r["numbers"]
        assert any(v > limits[k] for k, v in r["control"].items()), r["control"]


def _limits(workload: str) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = next(c for c in bench["workloads"] if c["name"] == workload)["config"]
    file = next(c for c in bench["configs"] if c["name"] == cfg)["file"]
    return json.loads((ROOT / file).read_text())["limits"]
