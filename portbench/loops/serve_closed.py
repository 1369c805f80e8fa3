"""
Serving in a closed loop: the traffic mix's ``loop = "serve_closed"``.

Requests take ``users_per_request`` users at a time, round and round over
all users.  Which places in the data set's fixed draw of history lengths
make up each request is drawn once from ``template_seed``, so every run
serves the same requests' work; the seed decides which users hold those
places (through the data set) and the order of the requests in a pass.  The loop keeps
``in_flight`` requests dispatched through the program's
``device_recommend_async`` and, each time the oldest one's ``result()``
returns its lists, dispatches the next, until ``seconds`` have passed; the
requests still in flight are then drained.  A request is timed from its
dispatch to its ``ItemListCollection``.  Set-up serves one request of each
history-length rung (powers of two) that the traffic holds and then
``in_flight`` requests, so every shape is warm before the window.

The check takes, after the window, ``check_requests`` requests drawn from
the seed among those completed in it, and the request of the user with the
longest history, and holds each list against the family's reference.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from portbench.core.cell import Cell, Outcome, host_clocks, sub_seed
from portbench.core.compare import list_gaps
from portbench.core.data import make_interactions, summary
from portbench.core.program import build_dataset
from portbench.core.trace import wrap_spans

__all__ = ["check", "run"]


def _users(order: np.ndarray, passes: np.ndarray, i: int, size: int) -> np.ndarray:
    """The users of request ``i``: template request ``passes[i % len(passes)]``."""
    j = passes[i % len(passes)]
    return order[np.arange(j * size, (j + 1) * size) % len(order)]


def run(cell: Cell, t_start: float) -> Outcome:
    from lkpy_tpu_torch.batch.device import device_recommend_async

    cfg, mix, fam, dev = cell.cfg, cell.mix, cell.fam, cell.device
    size, n, depth = mix["users_per_request"], mix["n"], mix["in_flight"]
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

    # the template: users in the order of their places in the fixed lengths' draw
    by_slot = np.empty(inter.n_users, dtype=np.int64)
    by_slot[inter.slots] = np.arange(inter.n_users)
    order = by_slot[np.random.default_rng(mix["template_seed"]).permutation(inter.n_users)]
    per_pass = -(-inter.n_users // size)
    passes = np.random.default_rng(sub_seed(cell.seed, 3)).permutation(per_pass)
    lengths = inter.lengths
    rungs = {}
    for i in range(per_pass):
        rungs.setdefault(int(lengths[_users(order, passes, i, size)].max() - 1).bit_length(), i)
    longest = int(np.argmax(lengths))
    longest_req = int(np.flatnonzero(passes == int(np.flatnonzero(order == longest)[0]) // size)[0])

    def users_of(i: int) -> np.ndarray:
        return _users(order, passes, i, size)

    def serve(i: int, timings: dict | None = None):
        return device_recommend_async(scorer, users_of(i), n, matrix, chunk=size, device=dev, timings=timings)

    for i in rungs.values():
        serve(i).result()
    for p in [serve(i) for i in range(depth)]:
        p.result()
    t = cell.part("warmup", t)
    cell.setup["total"] = t - t_start

    tracer = cell.tracer
    pick = np.random.default_rng(sub_seed(cell.seed, 4))
    keep_n = mix["check_requests"]
    kept: list = []
    longest_lists = None
    seen = 0
    latencies, host = [], []
    pending = collections.deque()
    with wrap_spans(tracer, mix.get("spans", []) + fam.SERVE_SPANS), host_clocks() as host_clock:
        tracer.start()
        t0 = time.perf_counter()
        t_end = t0 + cell.seconds
        sent = 0

        def dispatch():
            nonlocal sent
            tm: dict = {}
            td = time.perf_counter()
            with tracer.span("dispatch"):
                p = serve(sent, tm)
            pending.append((sent, td, time.perf_counter() - td, p, tm))
            sent += 1

        for _ in range(depth):
            dispatch()
        completed = users_done = 0
        while pending:
            i, td, d_host, p, tm = pending.popleft()
            tr = time.perf_counter()
            with tracer.span("result"):
                lists = p.result()
            done = time.perf_counter()
            completed += 1
            if done <= t_end:
                latencies.append(done - td)
                users_done += size
                host.append(d_host + (done - tr) - tm["readback_s"])
                # a seeded sample of the requests completed in the window
                # (reservoir), and the one with the longest history
                if i == longest_req:
                    longest_lists = lists
                else:
                    seen += 1
                    if len(kept) < keep_n:
                        kept.append((i, lists))
                    elif (j := int(pick.integers(seen))) < keep_n:
                        kept[j] = (i, lists)
            if done < t_end:
                dispatch()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        trace = tracer.stop()

    if not latencies:
        raise RuntimeError(f"no request completed in the {cell.seconds} s window")
    sent_lengths = [int(lengths[users_of(i)].sum()) for i in range(sent)]
    counters = {
        "requests": sent,
        "requests_in_window": len(latencies),
        "users_per_request": size,
        "entries": sum(sent_lengths),
        "n_items": inter.n_items,
        "host_s": host,
        "host": host_clock,
        "data": summary(inter),
        "work": [fam.serve_work(cfg, e, size, inter.n_items) for e in sent_lengths],
    }
    values = {
        "serve_users_per_s": users_done / cell.seconds,
        "serve_ms_p95": float(np.percentile(np.asarray(latencies) * 1e3, 95)),
    }
    # the sampled lists as arrays, keyed by request: the program's objects stay here
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
    return Outcome(values, sent, sent - completed, counters, trace, {"inter": inter, "tables": tables, "sample": sample, "n": n})


def check(cell: Cell, state: dict, control: str | None = None) -> tuple[dict, dict | None]:
    """``serve_list_gap`` and ``serve_score_err`` of :func:`list_gaps`, the
    worst over the sampled requests; and with ``control`` (a lower
    precision) the same numbers of the reference in that precision serving
    the same users in the program's place."""
    fam, cfg = cell.fam, cell.cfg
    inter, tables, n = state["inter"], state["tables"], state["n"]
    dev = inter.users.device
    hist_keys = inter.users * inter.n_items + inter.items
    worst = {"prog": [0.0, 0.0], "ctrl": [0.0, 0.0]}

    def judge(side, items, scores, lens, ref):
        g, e = list_gaps(items, scores, lens, ref, n)
        worst[side] = [max(worst[side][0], g), max(worst[side][1], e)]

    for ids, items, scores, lens in state["sample"].values():
        users = torch.as_tensor(ids, device=dev)
        keys = users[:, None] * inter.n_items + torch.arange(inter.n_items, device=dev)[None, :]
        pos = torch.searchsorted(hist_keys, keys).clamp_(max=hist_keys.shape[0] - 1)
        seen = hist_keys[pos] == keys
        ref = fam.serve_scores(cfg, inter, tables, users, "float64").masked_fill(seen, -torch.inf)
        judge("prog", *(torch.as_tensor(a, device=dev) for a in (items, scores, lens)), ref)
        if control is not None:
            lower = fam.serve_scores(cfg, inter, tables, users, control).float().masked_fill(seen, -torch.inf)
            top = torch.topk(lower, n, dim=1)
            judge("ctrl", top.indices, top.values, torch.full((len(ids),), n, device=dev), ref)

    def named(side):
        return {"serve_list_gap": worst[side][0], "serve_score_err": worst[side][1]}

    return named("prog"), (named("ctrl") if control is not None else None)
