"""The readers of the program's own spans and counters
(``core/program_trace.py`` and the metrics that use it), on a hand-made
reading: device activities made up around the spans of a tiny CPU run of
the program, with idle gaps of known length at known places."""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from conftest import ROOT
from portbench.core import program_trace
from portbench.core.cell import Reading, load_reader
from portbench.core.trace import DeviceOp, Trace

NEW = {
    "train.chunk_host_us": "als-implicit-ml20m.train",
    "train.idle_in_chunk_loop": "als-implicit-ml20m.train",
    "train.padding_occupancy": "als-implicit-ml20m.train",
    "serve.dispatch_ms": "als-implicit-ml20m.serve",
    "serve.readback_ms": "als-implicit-ml20m.serve",
    "serve.assemble_ms": "als-implicit-ml20m.serve",
    "serve.idle_in_assembly": "als-implicit-ml20m.serve",
}
GAP = 50  # ns: every made-up gap


@pytest.fixture(scope="module")
def program_spans():
    """The spans of one ALS epoch and one serving call of the program,
    recorded on the CPU."""
    from lkpy_tpu_torch.batch.device import device_recommend_async
    from lkpy_tpu_torch.data import from_interactions_df
    from lkpy_tpu_torch.data.matrix import CSR
    from lkpy_tpu_torch.logging import record_spans, take_spans
    from lkpy_tpu_torch.ops import als as als_ops
    from lkpy_tpu_torch.ops.sparse import bucket_rows

    rng = np.random.default_rng(5)
    n_users, n_items, k = 60, 40, 4
    lens = rng.integers(2, 12, size=n_users)
    users = np.repeat(np.arange(n_users), lens)
    items = np.concatenate([rng.choice(n_items, size=n, replace=False) for n in lens])
    csr = CSR.from_coo(users, items, np.full(len(users), 40.0, np.float32), (n_users, n_items))
    chunks = [als_ops.chunk_buckets(bucket_rows(m), entries=64, device="cpu") for m in (csr, csr.transpose())]
    tables = [torch.rand((n, k)) * 0.01 for n in (n_users, n_items)]
    ds = from_interactions_df(pd.DataFrame({"user_id": users, "item_id": items}))
    arrays = {"u_embed": torch.rand((len(ds.users), k)).numpy(), "i_embed": torch.rand((len(ds.items), k)).numpy()}

    class Scorer:
        def batch_score_arrays(self):
            return arrays

    take_spans()
    with record_spans():
        als_ops.als_epoch(*chunks, *tables, 0.1, 0.1, mode="implicit")
        device_recommend_async(Scorer(), np.arange(n_users), 5, ds.interaction_matrix(), chunk=16, device="cpu").result()
    return take_spans()


@pytest.fixture(autouse=True)
def _empty_store():
    """The readers read the program's store: each test fills it and leaves it empty."""
    from lkpy_tpu_torch.logging import take_spans

    yield
    take_spans()


def _reading(spans, gap_starts, *, lo=None, hi=None, ops=True):
    """A reading whose device is busy over the window but for a gap of
    ``GAP`` ns at each of ``gap_starts``, with ``spans`` in the program's
    store."""
    from lkpy_tpu_torch.logging import tracing

    tracing.take_spans()
    for s in spans:
        tracing._keep(s)
    lo = min(s.start_ns for s in spans) - 1000 if lo is None else lo
    hi = max(s.end_ns for s in spans) + 1000 if hi is None else hi
    made, at = [], lo
    for g in sorted(gap_starts):
        made.append(DeviceOp("kernel", at, g - at, None))
        at = g + GAP
    made.append(DeviceOp("kernel", at, hi - at, None))
    return Reading({}, Trace(made if ops else [], [], lo, hi), {})


def _first(spans, name):
    return min((s for s in spans if s.name == name), key=lambda s: s.start_ns)


def test_idle_gaps_go_to_the_innermost_program_span(program_spans):
    half, chunk = _first(program_spans, "lkt.als.half"), _first(program_spans, "lkt.als.chunk")
    assemble = _first(program_spans, "lkt.serve.assemble")
    lo = min(s.start_ns for s in program_spans) - 1000
    assert half.start_ns + GAP < chunk.start_ns and chunk.parent == half.index
    # one gap outside every span, one in the half's set-up, one in a chunk, one in the assembly
    r = _reading(program_spans, [lo + 1, half.start_ns + 1, chunk.start_ns + 1, assemble.start_ns + 1], lo=lo)
    window = r.trace.window_s
    assert load_reader("train.idle_in_chunk_loop").read(r) == pytest.approx(100.0 * 2 * GAP / 1e9 / window)
    assert load_reader("serve.idle_in_assembly").read(r) == pytest.approx(100.0 * GAP / 1e9 / window)
    # the same walk as the benchmark's idle gaps, with the program's spans in place of its own
    gaps = dict(Trace(r.trace.ops, [(s.name, s.start_ns, s.end_ns) for s in program_spans], lo, r.trace.window_end_ns).idle_gaps())
    assert gaps["lkt.als.chunk"] == gaps["lkt.als.half"] == gaps["outside spans"] == gaps["lkt.serve.assemble"] == GAP / 1e9


def test_means_and_counters(program_spans):
    from lkpy_tpu_torch.logging import counts

    r = _reading(program_spans, [])
    for metric, name, scale in [("train.chunk_host_us", "lkt.als.chunk", 1e-3), ("serve.dispatch_ms", "lkt.serve.dispatch", 1e-6),
                                ("serve.readback_ms", "lkt.serve.readback", 1e-6), ("serve.assemble_ms", "lkt.serve.assemble", 1e-6)]:  # fmt: skip
        durations = [s.end_ns - s.start_ns for s in program_spans if s.name == name]
        assert durations and load_reader(metric).read(r) == pytest.approx(scale * np.mean(durations))
    c = counts()
    assert load_reader("train.padding_occupancy").read(r) == pytest.approx(100.0 * c["als.entries_real"] / c["als.entries_padded"])
    assert 0 < load_reader("train.padding_occupancy").read(r) <= 100


def test_spans_outside_the_window_are_left_out(program_spans):
    dispatch = _first(program_spans, "lkt.serve.dispatch")
    r = _reading(program_spans, [], hi=dispatch.start_ns)
    assert load_reader("serve.dispatch_ms").read(r) is None
    assert load_reader("train.chunk_host_us").read(r) is not None


def test_readers_return_none_without_device_activity_or_without_the_store(program_spans, monkeypatch):
    r = _reading(program_spans, [], ops=False)
    assert all(load_reader(name).read(r) is None for name in NEW)
    monkeypatch.setattr(program_trace, "_store", lambda: None)
    r = _reading(program_spans, [])
    assert all(load_reader(name).read(r) is None for name in NEW)


def test_every_new_metric_has_its_reader_and_its_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, cell in NEW.items():
        m = entries[name]
        assert m["workloads"] == [cell] and m["source"] in ("program_span", "program_counter")
        assert (ROOT / "portbench" / "metrics" / f"{name}.py").is_file() and callable(load_reader(name).read)
