"""
Serving in an open loop: the traffic mix's ``loop = "serve_open"``.

The requests are the closed loop's (:mod:`portbench.loops.serve_closed`):
``users_per_request`` users each from the same template of history lengths
in a seeded order, top ``n`` with the history masked; so is the check.
They arrive on a schedule drawn from the seed, whatever the program's pace.
Time is cut into periods of ``period_ms``; each opens with ``burst_ms`` at
``burst_per_s`` requests a second and goes on at ``base_per_s``.  Within a
phase the arrivals are the sorted uniform draws of its expected count
(``round(rate × length)``): a Poisson process conditioned on its count, so
every run offers the same requests at the mean rate exactly and the seed
decides when each falls (:func:`schedule`).

One thread runs the loop, as one event loop would: the oldest request's
lists are collected as soon as the device has finished it (a CUDA event
recorded after its dispatch; on the CPU at once), and otherwise the next
request is dispatched through ``device_recommend_async`` once it is due
(late, if the loop was busy then); finished work goes first, so a burst
cannot starve the collection of the requests it sent.  With nothing to do
the loop polls, and sleeps only to a millisecond before an arrival when no
request is in flight.  A request is timed from its **scheduled** arrival to
its ``ItemListCollection``, so a late dispatch counts; how late each
dispatch ran is kept beside it.  Every request scheduled in the window is
served; the rate counts the users whose lists were assembled inside the
window.  Set-up serves one request of each history-length rung and then
``warmup_in_flight`` at once, so every shape is warm before the window.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from portbench.core.cell import Cell, Outcome, host_clocks, sub_seed
from portbench.core.data import make_interactions, summary
from portbench.core.program import build_dataset
from portbench.core.trace import wrap_spans
from portbench.loops.serve_closed import _users, check

__all__ = ["check", "run", "schedule"]


def schedule(mix: dict, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """The arrival times (s, from the window's start, sorted) of the
    requests due in ``seconds``."""
    period, burst = mix["period_ms"] / 1e3, mix["burst_ms"] / 1e3
    times = []
    for lo in np.arange(0.0, seconds, period):
        for start, length, rate in ((lo, burst, mix["burst_per_s"]), (lo + burst, period - burst, mix["base_per_s"])):
            length = min(length, seconds - start)
            if length > 0:
                times.append(start + np.sort(rng.uniform(0.0, length, int(round(rate * length)))))
    return np.concatenate(times) if times else np.zeros(0)


def _template(inter, mix: dict, seed: int, size: int):
    """The closed loop's template: users in the order of their places in the
    fixed lengths' draw, and the seeded order of the requests in a pass."""
    by_slot = np.empty(inter.n_users, dtype=np.int64)
    by_slot[inter.slots] = np.arange(inter.n_users)
    order = by_slot[np.random.default_rng(mix["template_seed"]).permutation(inter.n_users)]
    passes = np.random.default_rng(sub_seed(seed, 3)).permutation(-(-inter.n_users // size))
    return order, passes


def run(cell: Cell, t_start: float) -> Outcome:
    from lkpy_tpu_torch.batch.device import device_recommend_async

    cfg, mix, fam, dev = cell.cfg, cell.mix, cell.fam, cell.device
    size, n = mix["users_per_request"], mix["n"]
    t = time.perf_counter()
    cell.setup["imports"] = t - t_start
    inter = make_interactions(cfg["data"], sub_seed(cell.seed, 1), dev)
    t = cell.part("data", t)
    cell.reset_peak()
    ds = build_dataset(inter)
    matrix = ds.interaction_matrix()
    t = cell.part("dataset", t)
    scorer, tables = fam.serve_build(cfg, ds, inter, dev, cell.gen(2))
    t = cell.part("model", t)

    order, passes = _template(inter, mix, cell.seed, size)
    lengths = inter.lengths

    def users_of(i: int) -> np.ndarray:
        return _users(order, passes, i, size)

    def serve(i: int):
        return device_recommend_async(scorer, users_of(i), n, matrix, chunk=size, device=dev)

    rungs = {}
    for i in range(len(passes)):
        rungs.setdefault(int(lengths[users_of(i)].max() - 1).bit_length(), i)
    longest = int(np.argmax(lengths))
    longest_req = int(np.flatnonzero(passes == int(np.flatnonzero(order == longest)[0]) // size)[0])
    for i in rungs.values():
        serve(i).result()
    for p in [serve(i) for i in range(mix["warmup_in_flight"])]:
        p.result()
    t = cell.part("warmup", t)
    cell.setup["total"] = t - t_start

    due = schedule(mix, cell.seconds, np.random.default_rng(sub_seed(cell.seed, 6)))
    tracer = cell.tracer
    pick = np.random.default_rng(sub_seed(cell.seed, 4))
    keep_n = mix["check_requests"]
    kept: list = []
    longest_lists = None
    seen = 0
    latencies, late = [], []
    pending = collections.deque()
    users_done = 0
    with wrap_spans(tracer, mix.get("spans", []) + fam.SERVE_SPANS), host_clocks() as host_clock:
        tracer.start()
        t0 = time.perf_counter()
        t_end = t0 + cell.seconds
        at = t0 + due
        sent = 0
        while sent < len(at) or pending:
            now = time.perf_counter()
            if pending and (pending[0][2] is None or pending[0][2].query()):
                i, p, _ = pending.popleft()
                with tracer.span("result"):
                    lists = p.result()
                done = time.perf_counter()
                latencies.append(done - at[i])
                if done <= t_end:
                    users_done += size
                # a seeded sample of the requests served (reservoir), and the
                # one with the longest history
                if i == longest_req:
                    longest_lists = lists
                else:
                    seen += 1
                    if len(kept) < keep_n:
                        kept.append((i, lists))
                    elif (j := int(pick.integers(seen))) < keep_n:
                        kept[j] = (i, lists)
            elif sent < len(at) and at[sent] <= now:
                late.append(now - at[sent])
                with tracer.span("dispatch"):
                    p = serve(sent)
                done_event = None
                if dev.type == "cuda":
                    done_event = torch.cuda.Event()
                    done_event.record()
                pending.append((sent, p, done_event))
                sent += 1
            elif not pending and at[sent] - now > 2e-3:
                # idle until the next arrival: sleep to a millisecond before
                # it, then poll, so the loop is awake when it falls due
                time.sleep(at[sent] - now - 1e-3)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        trace = tracer.stop()

    if not latencies:
        raise RuntimeError(f"no request was due in the {cell.seconds} s window")
    late_ms = np.asarray(late) * 1e3
    # how late the dispatches ran, on the line of the window's host clocks
    host_clock["late_ms"] = {"p50": float(np.percentile(late_ms, 50)), "p95": float(np.percentile(late_ms, 95)), "max": float(late_ms.max())}
    host_clock["offered_users_per_s"] = sent * size / cell.seconds
    counters = {
        "requests": sent,
        "users_per_request": size,
        "latency_ms": [float(v) * 1e3 for v in latencies],
        "late_ms_each": [float(v) for v in late_ms],
        "host": host_clock,
        "data": summary(inter),
    }
    values = {
        "serve_users_per_s": users_done / cell.seconds,
        "serve_ms_p95": float(np.percentile(np.asarray(latencies) * 1e3, 95)),
    }
    if longest_lists is not None:
        kept.append((longest_req, longest_lists))
    sample = {}
    for i, lists in kept:
        ids = users_of(i)
        items = np.full((size, n), -1, dtype=np.int64)
        scores = np.full((size, n), np.nan, dtype=np.float64)
        lens = np.zeros(size, dtype=np.int64)
        for r, uid in enumerate(ids):
            il = lists.lookup(int(uid))
            m = 0 if il is None else len(il)
            if m:
                items[r, :m] = il.ids()
                scores[r, :m] = il.scores()
            lens[r] = m
        sample[i] = (ids, items, scores, lens)
    return Outcome(values, sent, 0, counters, trace, {"inter": inter, "tables": tables, "sample": sample, "n": n})
