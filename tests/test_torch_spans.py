"""The program's spans and counters (``lkpy_tpu_torch.logging.tracing``) on
the CPU: nothing is recorded while they are off; under ``record_spans()``
an ALS epoch records its halves and chunks and counts the chunks' real and
padded entries, and a serving call records its dispatch, readback and
assembly under one request id; under ``torch.profiler`` every span is also a
``record_function`` range of its name; the store stays bounded.

The file imports neither JAX nor ``lkpy_tpu``; its ``cuda`` test checks the
chunk spans against the training kernel's launches on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""

import collections

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu_torch import logging as lkt_logging
from lkpy_tpu_torch.batch.device import device_recommend_async
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.logging import counts, dropped_spans, record_spans, span, spans, take_spans
from lkpy_tpu_torch.logging import tracing
from lkpy_tpu_torch.ops import als as als_ops
from lkpy_tpu_torch.ops.sparse import bucket_rows
from lkpy_tpu_torch.ops.spd_solve_chunked import spd_solve_chunked

torch.set_num_threads(1)

N_USERS, N_ITEMS, K = 200, 80, 8
HALVES, CHUNK = "lkt.als.half", "lkt.als.chunk"
SERVE = ("lkt.serve.dispatch", "lkt.serve.readback", "lkt.serve.assemble")


def _interactions(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, size=N_USERS) + 1, N_ITEMS // 2)
    users = np.repeat(np.arange(N_USERS), lens)
    items = np.concatenate([rng.choice(N_ITEMS, size=n, replace=False) for n in lens])
    return users, items


def _epoch_inputs(device="cpu"):
    """Chunked buckets of both halves, small enough chunks that every bucket
    splits, and implicit-ALS tables."""
    u, i = _interactions()
    csr = CSR.from_coo(u, i, np.full(len(u), 40.0, np.float32), (N_USERS, N_ITEMS))
    chunks = [als_ops.chunk_buckets(bucket_rows(m), entries=256, device=device) for m in (csr, csr.transpose())]
    rng = np.random.default_rng(1)
    tables = [torch.from_numpy((rng.standard_normal((n, K)) * 0.1).astype(np.float32) ** 2).to(device) for n in (N_USERS, N_ITEMS)]
    return chunks, tables


def _epoch(chunks, tables):
    return als_ops.als_epoch(*chunks, *tables, 0.1, 0.1, mode="implicit")


@pytest.fixture(scope="module")
def served():
    u, i = _interactions(2)
    ds = from_interactions_df(pd.DataFrame({"user_id": u + 1, "item_id": i + 1}))
    rng = np.random.default_rng(3)
    tables = {"u_embed": rng.standard_normal((N_USERS, K)).astype(np.float32), "i_embed": rng.standard_normal((N_ITEMS, K)).astype(np.float32)}

    class TableScorer:
        def batch_score_arrays(self):
            return tables

    return TableScorer(), ds.interaction_matrix(), np.arange(1, 60)


def _serve(served, **kw):
    scorer, matrix, users = served
    return device_recommend_async(scorer, users, 5, matrix, chunk=16, device="cpu", **kw).result()


@pytest.fixture(autouse=True)
def _empty_store():
    take_spans()
    yield
    take_spans()


def test_off_records_nothing(served):
    before = counts()
    _epoch(*_epoch_inputs())
    _serve(served, timings={})
    assert spans() == [] and counts() == before
    # off, every span is one shared object that reads no clock
    assert span("lkt.a") is span("lkt.b", request=3)
    assert not hasattr(span("lkt.a"), "start_ns")


def test_epoch_records_halves_and_chunks(monkeypatch):
    chunks, tables = _epoch_inputs()
    solves = []

    def counted(A, y):
        solves.append(A.shape[0])
        return spd_solve_chunked(A, y)

    monkeypatch.setattr(als_ops, "spd_solve_chunked", counted)
    with record_spans():
        _epoch(chunks, tables)
    got = spans()
    halves = [s for s in got if s.name == HALVES]
    chunk_spans = [s for s in got if s.name == CHUNK]
    assert len(halves) == 2 and {s.parent for s in halves} == {-1}
    assert {s.parent for s in chunk_spans} <= {h.index for h in halves}
    assert len(chunk_spans) == len(solves) == sum(ch.rows.shape[0] for side in chunks for ch in side)
    for s in chunk_spans:
        h = next(h for h in halves if h.index == s.parent)
        assert h.start_ns <= s.start_ns <= s.end_ns <= h.end_ns
    assert all(s.request is None for s in got)


def test_entry_counters_equal_chunk_stats():
    chunks, tables = _epoch_inputs()
    before = counts()
    with record_spans():
        _epoch(chunks, tables)
    after = counts()
    stats = [als_ops.chunk_stats(side) for side in chunks]
    assert after["als.entries_real"] - before.get("als.entries_real", 0) == sum(s["real_entries"] for s in stats)
    assert after["als.entries_padded"] - before.get("als.entries_padded", 0) == sum(s["padded_entries"] for s in stats)
    # the per-chunk counts were taken on the host when the chunks were built
    for side in chunks:
        for ch in side:
            assert list(ch.real_entries) == ch.mask.sum(dim=(1, 2)).tolist()


def test_serving_call_records_three_spans_under_one_request(served):
    timings: dict = {}
    with record_spans():
        _serve(served, timings=timings)
        _serve(served)
    got = [s for s in spans() if s.name in SERVE]
    by_request = collections.defaultdict(dict)
    for s in got:
        by_request[s.request][s.name] = s
    assert len(got) == 6 and len(by_request) == 2 and None not in by_request
    for parts in by_request.values():
        d, r, a = (parts[name] for name in SERVE)
        # dispatch, then readback, then the assembly: one after another
        assert d.end_ns <= r.start_ns and r.end_ns <= a.start_ns
        assert d.parent == r.parent == a.parent == -1
    first = min(by_request)
    readback = by_request[first]["lkt.serve.readback"]
    # one pair of clock reads feeds both the span and readback_s
    assert timings["readback_s"] == (readback.end_ns - readback.start_ns) / 1e9


def test_timed_span_reads_the_clock_without_recording():
    with span("lkt.timed", timed=True) as s:
        pass
    assert s.seconds >= 0 and spans() == []
    with record_spans(), span("lkt.timed", timed=True) as s:
        pass
    assert [(r.name, r.start_ns, r.end_ns) for r in spans()] == [("lkt.timed", s.start_ns, s.end_ns)]


def test_profiler_records_and_mirrors_every_span(served):
    from torch.profiler import ProfilerActivity, profile

    chunks, tables = _epoch_inputs()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm-up"):
            pass
    before = counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _epoch(chunks, tables)
        _serve(served)
    got = take_spans()
    assert {s.name for s in got} == {HALVES, CHUNK, *SERVE}
    assert counts()["als.entries_real"] > before.get("als.entries_real", 0)
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("lkt."):
            events[e.name()].append(e.start_ns())
    offsets = []
    for name in {s.name for s in got}:
        mine = sorted(s.start_ns for s in got if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs)
        offsets += [abs(a - b) for a, b in zip(mine, theirs)]
    # the store reads its clock just after the range opens; on a shared host
    # the process can lose its core between the two, so a few may lie further
    assert sum(d <= 50_000 for d in offsets) >= 0.9 * len(offsets)


def test_store_is_bounded_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "_store", collections.deque(maxlen=4))
    with record_spans():
        for j in range(10):
            with span(f"lkt.s{j}"):
                pass
    assert [s.name for s in spans()] == [f"lkt.s{j}" for j in range(6, 10)]
    assert dropped_spans() == 6
    assert len(take_spans()) == 4 and spans() == [] and dropped_spans() == 0


def test_nested_spans_name_their_parent_and_counters_add():
    before = counts().get("test.n", 0)
    with record_spans():
        with span("lkt.outer") as outer:
            with span("lkt.inner", request=7):
                lkt_logging.count("test.n", 2)
            lkt_logging.count("test.n", 3)
    inner, outer_rec = spans()
    assert inner.name == "lkt.inner" and inner.parent == outer.index and inner.request == 7
    assert outer_rec.parent == -1
    assert counts()["test.n"] == before + 5
    lkt_logging.count("test.n", 100)  # off: not added
    assert counts()["test.n"] == before + 5


@pytest.mark.cuda
def test_chunk_spans_equal_the_training_kernel_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    chunks, tables = _epoch_inputs("cuda")
    _epoch(chunks, tables)  # builds the kernels
    before = spd_solve_chunked.launches
    with record_spans():
        _epoch(chunks, tables)
    torch.cuda.synchronize()
    assert sum(s.name == CHUNK for s in spans()) == spd_solve_chunked.launches - before
