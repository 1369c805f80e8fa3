"""The LightGCN cell driven on the CPU at a tiny size: the port against the
plain reference (``correct``), the bfloat16 control failing a limit, each
fault of ``faults_graph.py`` failing the check, the graph's operation and
byte counts against a hand count, and the cell's readers on a hand-made
trace around the spans and counters of a real step."""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.core.cell import Reading, load_benchmark, load_reader, run_cell
from portbench.core.trace import DeviceOp, Trace
from portbench.faults_graph import FAULTS
from portbench.roofline import counts, graph, peaks

WORKLOAD = "lightgcn-ml20m.train"
TINY = {
    "config": {
        "data": {"n_users": 120, "n_items": 300, "n_pairs": 5000, "max_per_user": 150, "item_max": 110, "item_median": 8},
        "model": {"settings": {"batch_size": 256}},
    },
}
READERS = ["lightgcn.spmm_roofline", "lightgcn.spmm_busy_share", "lightgcn.mfu", "lightgcn.device_idle", "lightgcn.step_host_us"]


def run_tiny(*, seed=2147483711, trace=False, control=False, seconds=1.0):
    return run_cell(WORKLOAD, seed, seconds, trace, torch.device("cpu"), t_start=time.perf_counter(), overrides=TINY, control=control)


def test_port_matches_the_reference_and_the_control_does_not():
    res = run_tiny(control=True)
    assert res["correct"], res["numbers"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["numbers"]) == {"lgcn_embed_err", "lgcn_grad_err", "lgcn_update_err", "lgcn_loss_err", "lgcn_negative_hits"}
    assert res["numbers"]["lgcn_negative_hits"] == 0
    control = res["control"]
    assert any(control[k] > res["limits"][k] for k in control), control
    assert set(res["metrics"]) == {"train_interactions_per_s", "setup_s"}
    for name, m in res["metrics"].items():
        assert np.isfinite(m["value"]) and m["value"] > 0, name


def test_a_run_loads_no_jax():
    code = (
        f"import sys, time, torch; sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench.core.cell import run_cell\n"
        "from portbench.core.cli import banned_modules\n"
        f"run_cell({WORKLOAD!r}, 7, 0.3, False, torch.device('cpu'), t_start=time.perf_counter(), overrides={TINY!r})\n"
        "assert 'lkpy_tpu_torch' in sys.modules\n"
        "print('BANNED', banned_modules())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BANNED []" in proc.stdout


@pytest.mark.parametrize("fault", FAULTS[("train_epochs", "lightgcn")], ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch.setattr)
    res = run_tiny(seconds=0.3)
    assert not res["correct"], res["numbers"]


def test_the_cell_reports_the_new_metrics():
    bench = load_benchmark()
    names = [m["name"] for m in bench["per_layer"] if WORKLOAD in m.get("workloads", [])]
    assert names == READERS
    e2e = [m["name"] for m in bench["end_to_end"] if WORKLOAD in m.get("workloads", [WORKLOAD])]
    assert e2e == ["train_interactions_per_s", "setup_s"]


def test_graph_counts_by_hand():
    # 10 edges, k = 4: a multiply-add an edge and column; bytes 10 × 8 and 6 rows × 4 columns × 4
    assert graph.spmm_ops(10, 4) == 80
    assert graph.spmm_bytes(10, 6, 4) == 80 + 96
    # two products of 5 edges each, as one of 5 taken twice
    assert graph.spmm_bound_s(2, 10, 6, 4) == pytest.approx(2 * counts.bound_s(40, 40 + 96))
    # a 20 M-edge product at k = 64 is bound by its bytes
    e, rows = 20_000_263, 165_237
    assert graph.spmm_bound_s(1, e, rows, 64) == pytest.approx((8 * e + 4 * rows * 64) / peaks.BYTES_PER_S)
    # blend (4 × 4 a layer) and Adam (12) on 6 rows × 4, loss 20 an example and column
    assert graph.other_step_ops(2, 6, 4, 3) == 6 * 4 * (16 + 12) + 20 * 2 * 4
    assert graph.spmm_kernel("void cusparse::csrmm_alg2_kernel<float>") and not graph.spmm_kernel("void at::native::index_kernel")


@pytest.fixture(scope="module")
def step_spans():
    """The spans and counters of three LightGCN steps on the CPU."""
    from lkpy_tpu_torch.data import from_interactions_df
    from lkpy_tpu_torch.logging import counts as program_counts
    from lkpy_tpu_torch.logging import record_spans, take_spans
    from lkpy_tpu_torch.models import LightGCNScorer
    from lkpy_tpu_torch.training import TrainingOptions
    import pandas as pd

    rng = np.random.default_rng(0)
    users = np.repeat(np.arange(50), 6)
    items = np.concatenate([rng.choice(30, 6, replace=False) for _ in range(50)])
    ds = from_interactions_df(pd.DataFrame({"user_id": users, "item_id": items}))
    trainer = LightGCNScorer(embedding_size=8, layer_count=3, batch_size=32).create_trainer(ds, TrainingOptions(rng=1, device="cpu"))
    take_spans()
    before = program_counts()
    with record_spans():
        for _ in range(3):
            trainer.train_step()
    after = program_counts()
    added = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    return take_spans(), added, len(users)


def test_readers_on_a_hand_made_trace(monkeypatch, step_spans):
    """Device activities made up inside the steps' window: two cuSPARSE
    products of 1 ms each and 2 ms of other kernels in a 10 ms window."""
    from portbench.core import program_trace

    spans, added, nnz = step_spans
    assert added["graph.spmm_products"] == 36 and added["graph.spmm_edges"] == 36 * nnz
    monkeypatch.setattr(program_trace, "_store", lambda: type("S", (), {"spans": staticmethod(lambda: spans), "counts": staticmethod(lambda: added)}))
    lo = min(s.start_ns for s in spans)
    hi = lo + 10_000_000
    ops = [
        DeviceOp("void cusparse::csrmm_alg2_kernel<float>", lo, 1_000_000, None),
        DeviceOp("void cusparse::csrmm_alg2_kernel<float>", lo + 3_000_000, 1_000_000, None),
        DeviceOp("void at::native::elementwise_kernel", lo + 5_000_000, 2_000_000, None),
    ]
    counters = {"edges": nnz, "n_rows": 80, "k": 8, "layers": 3, "batch": 32, "steps": 3, "window_s": 0.01}
    r = Reading({}, Trace(ops, [], lo, max(hi, max(s.end_ns for s in spans))), counters)
    values = {name: load_reader(name).read(r) for name in READERS}
    window = r.trace.window_s
    bound = graph.spmm_bound_s(36, 36 * nnz, 80, 8)
    assert values["lightgcn.spmm_roofline"] == pytest.approx(100 * bound / 0.002)
    assert values["lightgcn.spmm_busy_share"] == pytest.approx(50.0)
    ops_total = graph.spmm_ops(36 * nnz, 8) + 3 * graph.other_step_ops(32, 80, 8, 3)
    assert values["lightgcn.mfu"] == pytest.approx(100 * ops_total / 0.01 / peaks.F32_FLOP_PER_S)
    assert values["lightgcn.device_idle"] == pytest.approx(100 * (1 - 0.004 / window))
    steps = [s.end_ns - s.start_ns for s in spans if s.name == "lkt.grad.step"]
    assert len(steps) == 3 and values["lightgcn.step_host_us"] == pytest.approx(np.mean(steps) / 1e3)


def test_readers_find_nothing_without_device_activity(step_spans):
    r = Reading({}, Trace([], [], 0, 10), {"edges": 1, "n_rows": 2, "k": 8, "layers": 3, "batch": 1, "steps": 1, "window_s": 1e-8})
    assert all(load_reader(name).read(r) is None for name in READERS)
