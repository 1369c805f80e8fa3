"""
Pipeline tuner: random search + iterative per-epoch trials (port of
``lkpy_tpu/tuning/search.py``).

Capability parity with the reference's Optuna tuner
(reference: src/lenskit/tuning/_optuna/search.py:40 ``OptunaPipelineTuner``,
iterative trials :135-223, ``SearchPoint`` _optuna/point.py:17, measurement
tuning/_measure.py:31) on a native random-search engine.

Every trial trains on ``device``, the card unless the tuner is given
``device="cpu"``; the per-query measurement runs where the trained tables
lie.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import pandas as pd
import torch

from lkpy_tpu_torch.batch import BatchPipelineRunner
from lkpy_tpu_torch.logging import Stopwatch, get_logger
from lkpy_tpu_torch.metrics import NDCG, RBP, RMSE, Hit, Precision, Recall, RecipRank, RunAnalysis
from lkpy_tpu_torch.pipeline import topn_pipeline
from lkpy_tpu_torch.random import RNGInput, random_generator
from lkpy_tpu_torch.splitting import TTSplit
from lkpy_tpu_torch.training import TrainingOptions, UsesTrainer
from lkpy_tpu_torch.data.flatten import unflatten_dict as _unflatten
from lkpy_tpu_torch.tuning.spec import TuningSpec
from lkpy_tpu_torch.tuning.stopping import PlateauStopRule


_log = get_logger(__name__)

__all__ = ["PipelineTuner", "SearchPoint", "TuneResults"]


@dataclass
class SearchPoint:
    """One evaluated configuration (reference: _optuna/point.py:17)."""

    params: dict[str, Any]
    value: float
    epochs: int | None = None
    time: float = 0.0
    metrics: dict[str, float] = field(default_factory=dict)


@dataclass
class TuneResults:
    """Search outcome (reference: tuning/_base.py:127)."""

    best_params: dict[str, Any]
    best_value: float
    points: list[SearchPoint]

    def to_df(self) -> pd.DataFrame:
        return pd.DataFrame(
            [{**p.params, "value": p.value, "epochs": p.epochs, "time": p.time} for p in self.points]
        )


class PipelineTuner:
    """
    Tune a scorer's hyperparameters on a train/validation split.

    Args:
        spec: the tuning specification.
        split: TTSplit with validation test lists.
        rng: search randomness.
        device: where every trial trains; None means the card (``cuda``),
            ``"cpu"`` the CPU.
    """

    def __init__(
        self, spec: TuningSpec, split: TTSplit, *, rng: RNGInput = None, device: str | torch.device | None = None
    ):
        self.spec = spec
        self.split = split
        self.rng = random_generator(rng)
        self.device = device
        self.points: list[SearchPoint] = []

    # ---- measurement ------------------------------------------------------
    def _measure(self, pipe) -> dict[str, float]:
        runner = BatchPipelineRunner(progress=False)
        runner.recommend(n=self.spec.n_recs)
        if self.spec.predicts_ratings:
            runner.predict()
        outs = runner.run(pipe, self.split.test)
        n = self.spec.n_recs
        ra = RunAnalysis(NDCG(n), RBP(n), Precision(n), Recall(n), RecipRank(n), Hit(n))
        res = ra.measure(outs.output("recommendations"), self.split.test)
        metrics = res.list_summary()["mean"].to_dict()
        if self.spec.predicts_ratings:
            pa = RunAnalysis(RMSE("ignore", "ignore"))
            pres = pa.measure(outs.output("predictions"), self.split.test)
            metrics.update(pres.list_summary()["mean"].to_dict())
        return metrics

    def _make_scorer(self, params: dict[str, Any]):
        from lkpy_tpu_torch.cli.common import resolve_model

        cfg = dict(self.spec.fixed)
        cfg.update(params)
        return resolve_model(self.spec.model, _unflatten(cfg))

    def _make_sampler(self):
        from lkpy_tpu_torch.tuning.sampler import RandomSampler, TPESampler

        if self.spec.sampler == "tpe":
            return TPESampler(
                self.spec.space,
                self.rng,
                n_startup=self.spec.n_startup,
                maximize=self.spec.mode == "maximize",
            )
        return RandomSampler(self.spec.space, self.rng)

    # ---- trials -----------------------------------------------------------
    def _simple_trial(self, params: dict[str, Any]) -> SearchPoint:
        """Full training then measurement (reference: search.py:225 simple trials)."""
        sw = Stopwatch()
        scorer = self._make_scorer(params)
        pipe = topn_pipeline(scorer, predicts_ratings=self.spec.predicts_ratings, n=self.spec.n_recs)
        pipe.train(self.split.train, TrainingOptions(rng=int(self.rng.integers(2**31)), device=self.device))
        metrics = self._measure(pipe)
        sw.stop()
        value = metrics[self.spec.metric]
        return SearchPoint(params, value, time=sw.elapsed(), metrics=metrics)

    def _iterative_trial(self, params: dict[str, Any]) -> SearchPoint:
        """Per-epoch evaluation with plateau stopping
        (reference: search.py:135-223 iterative trials)."""
        sw = Stopwatch()
        scorer = self._make_scorer(params)
        if not isinstance(scorer, UsesTrainer):
            return self._simple_trial(params)
        pipe = topn_pipeline(scorer, predicts_ratings=self.spec.predicts_ratings, n=self.spec.n_recs)
        # train non-scorer components normally, then drive the scorer's trainer
        for node in pipe.component_nodes():
            comp = node.component
            if comp is scorer:
                continue
            if hasattr(comp, "train"):
                comp.train(self.split.train, TrainingOptions(device=self.device))
        trainer = scorer.create_trainer(
            self.split.train, TrainingOptions(rng=int(self.rng.integers(2**31)), device=self.device)
        )
        stop = PlateauStopRule(maximize=self.spec.mode == "maximize")
        best_val = -np.inf if self.spec.mode == "maximize" else np.inf
        best_metrics: dict[str, float] = {}
        epochs = 0
        for epoch in range(self.spec.max_epochs):
            trainer.train_epoch()
            epochs = epoch + 1
            trainer.finalize()
            metrics = self._measure(pipe)
            value = metrics[self.spec.metric]
            better = value > best_val if self.spec.mode == "maximize" else value < best_val
            if better:
                best_val = value
                best_metrics = metrics
            _log.debug("iterative trial epoch", epoch=epochs, value=value)
            if stop.update(value):
                break
        sw.stop()
        return SearchPoint(params, best_val, epochs=epochs, time=sw.elapsed(), metrics=best_metrics)

    def _run_trial(self, params: dict[str, Any]) -> SearchPoint:
        if self.spec.method == "iterative":
            return self._iterative_trial(params)
        return self._simple_trial(params)

    # ---- search -----------------------------------------------------------
    def run(self) -> TuneResults:
        """Drive the search: TPE (or random) proposals, optionally with
        ``spec.n_concurrent`` overlapping trial evaluations (the reference
        runs concurrent Optuna trials on Ray; here a thread pool overlaps
        host-side work, and the trials' kernels share the card's default
        stream).  Pending
        points are fed back to the sampler (constant-liar)."""
        maximize = self.spec.mode == "maximize"
        sampler = self._make_sampler()
        observed: list[tuple[dict[str, Any], float]] = []

        if self.spec.n_concurrent <= 1:
            for i in range(self.spec.max_points):
                params = sampler.suggest(observed, [])
                log = _log.bind(point=i + 1, **params)
                log.info("evaluating search point")
                point = self._run_trial(params)
                log.info("search point finished", value=point.value, time=point.time)
                self.points.append(point)
                observed.append((params, point.value))
        else:
            from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

            pending: dict[object, dict[str, Any]] = {}
            submitted = 0
            with ThreadPoolExecutor(max_workers=self.spec.n_concurrent) as pool:
                while submitted < self.spec.max_points or pending:
                    while submitted < self.spec.max_points and len(pending) < self.spec.n_concurrent:
                        params = sampler.suggest(observed, list(pending.values()))
                        fut = pool.submit(self._run_trial, params)
                        pending[fut] = params
                        submitted += 1
                    done, _ = wait(pending.keys(), return_when=FIRST_COMPLETED)
                    for fut in done:
                        params = pending.pop(fut)
                        point = fut.result()
                        _log.info("search point finished", value=point.value, time=point.time, **params)
                        self.points.append(point)
                        observed.append((params, point.value))

        best = max(self.points, key=lambda p: p.value if maximize else -p.value)
        return TuneResults(best.params, best.value, self.points)
