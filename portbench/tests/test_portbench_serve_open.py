"""The open serving loop (``loops/serve_open.py``) on the CPU at a
tiny size, in a copy of the benchmark whose ``BENCHMARK.json`` and traffic
mixes hold one more cell of it (no cell of the benchmark runs the loop yet):
the lists against the reference (``correct``), the TF32 control failing a
limit, the serving faults failing the check, the schedule's mean rate and
bursts, and latency counted from each request's scheduled arrival."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.core.cell import load_benchmark, run_cell
from portbench.faults import FAULTS
from portbench.loops.serve_open import schedule

WORKLOAD = "als-implicit-ml20m.serve-open"
#: an open mix of bursts: 1,024-user requests, 150 ms of every 1,000 ms at
#: 200 requests/s and 850 ms at 111.76/s, a mean of 125/s
MIX = {
    "loop": "serve_open",
    "users_per_request": 1024,
    "n": 100,
    "period_ms": 1000,
    "burst_ms": 150,
    "burst_per_s": 200.0,
    "base_per_s": 111.76,
    "warmup_in_flight": 4,
    "check_requests": 4,
    "template_seed": 0,
    "spans": [["lkpy_tpu_torch.batch.serving", "_serve_block", "serve_block"], ["lkpy_tpu_torch.batch.serving", "_history", "history"]],
}
#: the configuration's file names no control for this loop; the check is
#: the closed loop's, so its TF32 control is given here
TINY = {
    "config": {
        "data": {"n_users": 120, "n_items": 300, "n_pairs": 5000, "max_per_user": 150, "item_max": 110, "item_median": 8},
        "control": {"serve_open": "tf32"},
    },
    "traffic": {"users_per_request": 32, "check_requests": 2, "burst_per_s": 40.0, "base_per_s": 20.0, "warmup_in_flight": 2},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the open cell: its entry, the serving
    metrics' lists and the traffic file are all it takes."""
    out = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", out / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = load_benchmark()
    bench["workloads"].append({"name": WORKLOAD, "config": "als-implicit-ml20m", "traffic": "serve-open", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_users_per_s", "serve_ms_p95"):
            m["workloads"].append(WORKLOAD)
    (out / "BENCHMARK.json").write_text(json.dumps(bench))
    (out / "portbench" / "traffic" / "serve-open.json").write_text(json.dumps(MIX))
    return out


def run_tiny(root, *, seed=2147483711, control=False, seconds=1.0):
    return run_cell(WORKLOAD, seed, seconds, False, torch.device("cpu"), t_start=time.perf_counter(), root=root, overrides=TINY, control=control)


def test_port_matches_the_reference_and_the_control_does_not(root):
    res = run_tiny(root, control=True)
    assert res["correct"], res["numbers"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert any(res["control"][k] > res["limits"][k] for k in res["control"]), res["control"]
    assert set(res["metrics"]) == {"serve_users_per_s", "serve_ms_p95", "setup_s"}
    # every request due in the window was served: 40/s for 150 ms and 20/s for 850 ms
    assert res["attempted"] == 6 + 17
    assert res["host"]["offered_users_per_s"] == 23 * 32
    assert res["metrics"]["serve_users_per_s"]["value"] <= res["host"]["offered_users_per_s"]


@pytest.mark.parametrize("fault", FAULTS[("serve_closed", "als_implicit")], ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch.setattr)
    assert not run_tiny(root, seconds=0.5)["correct"]


def test_schedule_has_the_mean_rate_and_the_bursts():
    t = schedule(MIX, 10.0, np.random.default_rng(2147483711))
    assert len(t) == 1250  # 30 in each 150 ms burst, 95 in each 850 ms after it: 125 a second
    assert np.all(np.diff(t) >= 0) and t[0] >= 0 and t[-1] < 10.0
    phase = t % 1.0
    assert np.sum(phase < 0.15) == 300 and np.sum(phase >= 0.15) == 950
    assert len(t) / 10.0 * MIX["users_per_request"] == 128_000
    # another seed moves the arrivals, not their counts
    u = schedule(MIX, 10.0, np.random.default_rng(7))
    assert len(u) == len(t) and not np.allclose(u, t)


def test_latency_counts_from_the_scheduled_arrival(root, monkeypatch):
    """Each dispatch made to take 30 ms against arrivals 25–50 ms apart:
    requests queue behind it, and each latency holds its dispatch's lateness."""
    import lkpy_tpu_torch.batch.device as device

    orig = device.device_recommend_async

    def slow(*a, **kw):
        time.sleep(0.03)
        return orig(*a, **kw)

    monkeypatch.setattr(device, "device_recommend_async", slow)
    captured = {}
    import portbench.loops.serve_open as serve_open

    run = serve_open.run

    def keep(cell, t_start):
        out = run(cell, t_start)
        captured.update(out.counters)
        return out

    monkeypatch.setattr(serve_open, "run", keep)
    res = run_tiny(root, seconds=1.0)
    assert res["correct"]
    latency, late = np.asarray(captured["latency_ms"]), np.asarray(captured["late_ms_each"])
    assert len(latency) == len(late) == res["attempted"]
    assert np.all(latency >= late + 30.0)
    assert late.max() > 5.0  # the burst's arrivals waited for the dispatches before them
    assert res["metrics"]["serve_ms_p95"]["value"] >= np.percentile(late, 95) + 30.0
