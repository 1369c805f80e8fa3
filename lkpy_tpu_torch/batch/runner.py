"""
BatchPipelineRunner (port of ``lkpy_tpu/batch/runner.py``; reference:
src/lenskit/batch/_runner.py:60).

Runs pipeline invocations over batches of queries, one query at a time on
the host (reference ``_sequential_results``, _runner.py:283), or in a pool
of ``n_jobs`` threads (reference _runner.py:292-308), which share ONE
pipeline: a component's ``__call__`` must not change the component's
state, as no component of the package does.

Queries (reference: batch/_queries.py:178) are an ItemListCollection (keys
become queries, lists the ``items`` of predict and score), a mapping of user
IDs to candidate lists, or a sequence of user IDs or ``RecQuery`` objects.
Data frames of queries wait for ``ItemListCollection.from_df``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import pandas as pd

from lkpy_tpu_torch.data import ItemList, ItemListCollection, RecQuery
from lkpy_tpu_torch.logging import Stopwatch, get_logger, item_progress
from lkpy_tpu_torch.pipeline import Pipeline

_log = get_logger(__name__)

__all__ = ["BatchPipelineRunner", "InvocationSpec"]


@dataclass
class InvocationSpec:
    """A pipeline invocation in a batch run (reference: _runner.py ``InvocationSpec``)."""

    name: str
    components: dict[str, str]  # output name -> node name
    extra_inputs: dict[str, Any] = field(default_factory=dict)


class BatchPipelineRunner:
    """
    Batch runner with composable invocations.

    Args:
        n_jobs: number of worker threads (None/1 = sequential).
    """

    def __init__(self, *, n_jobs: int | None = None, progress: bool = True):
        self.n_jobs = n_jobs
        self.progress = progress
        self.invocations: list[InvocationSpec] = []

    def add_invocation(self, inv: InvocationSpec):
        self.invocations.append(inv)

    def recommend(self, component: str = "recommender", n: int | None = None, **extra):
        inputs = dict(extra)
        if n is not None:
            inputs["n"] = n
        self.add_invocation(InvocationSpec("recommend", {"recommendations": component}, inputs))

    def predict(self, component: str = "rating-predictor", **extra):
        self.add_invocation(InvocationSpec("predict", {"predictions": component}, extra))

    def score(self, component: str = "scorer", **extra):
        self.add_invocation(InvocationSpec("score", {"scores": component}, extra))

    # ---- query normalization (reference: batch/_queries.py:178) -----------
    # Each normalized entry carries an item ROLE (reference:
    # TestRequestAdapter ``items_as``): ItemListCollection values are TEST
    # items — they feed predict/score's ``items`` input but NEVER gate
    # recommendation (that would leak the answer); Mapping values are
    # CANDIDATES and gate every invocation via the pipeline's items input.
    @staticmethod
    def _normalize_queries(queries) -> list[tuple[tuple, RecQuery, ItemList | None, str]]:
        out = []
        if isinstance(queries, ItemListCollection):
            for key, il in queries.items():
                q = RecQuery(user_id=key[0] if len(key) == 1 else None, query_id=tuple(key))
                out.append((tuple(key), q, il, "test"))
        elif isinstance(queries, Mapping):
            for uid, il in queries.items():
                out.append(((uid,), RecQuery(user_id=uid, query_id=uid), il, "candidates"))
        else:
            if isinstance(queries, pd.DataFrame):
                raise TypeError("a data frame of queries is not supported yet: pass an ItemListCollection")
            for uid in queries:
                if isinstance(uid, RecQuery):
                    out.append(((uid.query_id if uid.query_id is not None else uid.user_id,), uid, None, "test"))
                else:
                    uid_py = uid.item() if isinstance(uid, np.generic) else uid
                    out.append(((uid_py,), RecQuery(user_id=uid_py, query_id=uid_py), None, "test"))
        return out

    # ---- running ----------------------------------------------------------
    def run(self, pipeline: Pipeline, queries) -> "BatchResults":
        from lkpy_tpu_torch.batch.results import BatchResults

        norm = self._normalize_queries(queries)
        key_fields = queries.key_fields if isinstance(queries, ItemListCollection) else ("user_id",)
        results = BatchResults(tuple(key_fields))
        n = len(norm)
        log = _log.bind(queries=n, pipeline=pipeline.name)
        log.info("starting batch run", invocations=[i.name for i in self.invocations])
        sw = Stopwatch()

        def work(entry):
            key, query, items, role = entry
            return key, self._run_query(pipeline, query, items, role)

        pb = item_progress("batch run", n) if self.progress else None
        try:
            if self.n_jobs and self.n_jobs > 1:
                with ThreadPoolExecutor(max_workers=self.n_jobs) as pool:
                    for key, outs in pool.map(work, norm, chunksize=64):
                        for oname, val in outs.items():
                            results.add_result(oname, key, val)
                        if pb:
                            pb.update()
            else:
                for entry in norm:
                    key, outs = work(entry)
                    for oname, val in outs.items():
                        results.add_result(oname, key, val)
                    if pb:
                        pb.update()
        finally:
            if pb:
                pb.finish()
        sw.stop()
        log.info(
            "finished batch run",
            time=str(sw),
            ms_per_query=round(sw.elapsed() * 1000 / max(n, 1), 2),
        )
        return results

    def _run_query(
        self, pipeline: Pipeline, query: RecQuery, items: ItemList | None, role: str = "test"
    ) -> dict[str, Any]:
        outs: dict[str, Any] = {}
        for inv in self.invocations:
            kwargs: dict[str, Any] = {"query": query}
            kwargs.update(inv.extra_inputs)
            if items is not None and (role == "candidates" or inv.name in ("predict", "score")):
                # test items feed predict/score's items input (reference:
                # _runner.py:332 "test-items"); candidate lists additionally
                # gate recommend via use_first_of(items, selector)
                kwargs["items"] = items
            nodes = list(inv.components.values())
            state = pipeline.run_all(*nodes, **kwargs)
            for oname, node in inv.components.items():
                outs[oname] = state[pipeline.node(node).name]
        return outs
