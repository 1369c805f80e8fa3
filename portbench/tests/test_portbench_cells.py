"""Every cell driven on the CPU at a tiny size: the port against the plain
reference (``correct``), the control put in the program's place failing the
limits, and the timed path broken underneath failing the check."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.core.cell import load_benchmark
from portbench.core.cli import result_line
from portbench.faults import FAULTS
from tiny import WORKLOADS, run_tiny


def _kind(workload: str) -> tuple[str, str]:
    """(the loop, the family) of a cell."""
    bench = load_benchmark()
    w = next(x for x in bench["workloads"] if x["name"] == workload)
    file = next(c for c in bench["configs"] if c["name"] == w["config"])["file"]
    family = json.loads((ROOT / file).read_text())["family"]
    loop = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())["loop"]
    return loop, family


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_matches_the_reference_and_the_control_does_not(workload):
    res = run_tiny(workload, control=True)
    assert res["correct"], res["numbers"]
    assert res["attempted"] > 0 and res["failed"] == 0
    control = res["control"]
    assert any(control[k] > res["limits"][k] for k in control), control
    for name, m in res["metrics"].items():
        assert np.isfinite(m["value"]) and m["value"] > 0, name


def test_result_line_keys():
    res = run_tiny("als-implicit-ml20m.serve")
    line = json.loads(result_line(res, {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert set(line["metrics"]) == {"serve_users_per_s", "serve_ms_p95", "setup_s"}
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())


def test_traced_line_has_per_layer_metrics_and_breakdown():
    res = run_tiny("als-implicit-ml20m.serve", trace=True)
    line = json.loads(result_line(res, {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0, **res["trace"]}))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "check"]
    # no device here: only the host-clock reader finds something to read
    assert set(line["metrics"]) == {"serve.host_ms_per_request"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


CASES = [(w, f) for w in WORKLOADS for (loop, family), faults in FAULTS.items() for f in faults if _kind(w) == (loop, family)]


@pytest.mark.parametrize(("workload", "fault"), CASES, ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch.setattr)
    res = run_tiny(workload)
    assert not res["correct"], res["numbers"]
