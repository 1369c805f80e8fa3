"""The port's pipeline profiler against the JAX package's on the CPU.

``Pipeline.run_all(_profile=)`` and ``BatchPipelineRunner.run(profile=)``
write one CSV row of component wall times a pipeline run, with the
pipeline's component nodes as columns: the same columns and row count as the
JAX package's for the same pipeline and queries.  ``summarize_profile`` of
one CSV is equal in both packages.
"""

import gzip

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.batch import BatchPipelineRunner as JaxRunner
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models.bias import BiasScorer as JaxBiasScorer
from lkpy_tpu.pipeline import PipelineProfiler as JaxProfiler
from lkpy_tpu.pipeline import summarize_profile as jax_summarize
from lkpy_tpu.pipeline import topn_pipeline as jax_topn
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.batch import BatchPipelineRunner
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.models.bias import BiasScorer
from lkpy_tpu_torch.pipeline import PipelineProfiler, summarize_profile, topn_pipeline
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

USERS = [1, 2, 3, 5, 8, 13, 21]


@pytest.fixture(scope="module")
def pipes():
    rng = np.random.default_rng(9)
    keys = rng.choice(30 * 25, size=300, replace=False)
    df = pd.DataFrame({"user_id": keys // 25 + 1, "item_id": keys % 25 + 1, "rating": rng.integers(1, 6, 300).astype(float)})
    pipe = topn_pipeline(BiasScorer(damping=2.0), n=5)
    pipe.train(from_interactions_df(df.copy()), TrainingOptions(device="cpu"))
    jpipe = jax_topn(JaxBiasScorer(damping=2.0), n=5)
    jpipe.train(jax_from_df(df.copy()), JaxTrainingOptions())
    return pipe, jpipe


def _read(path):
    return pd.read_csv(path)


@pytest.mark.parametrize("suffix", [".csv", ".csv.gz"])
def test_run_all_profile_equal_columns(pipes, tmp_path, suffix):
    pipe, jpipe = pipes
    got, want = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    with PipelineProfiler(pipe, got) as prof:
        for u in USERS:
            pipe.run_all(query=u, n=5, _profile=prof)
    with JaxProfiler(jpipe, want) as jprof:
        for u in USERS:
            jpipe.run_all(query=u, n=5, _profile=jprof)
    g, w = _read(got), _read(want)
    assert list(g.columns) == list(w.columns) == [n.name for n in pipe.component_nodes()]
    assert len(g) == len(w) == len(USERS)
    ran = [c for c in g.columns if g[c].notna().all()]
    assert ran == [c for c in w.columns if w[c].notna().all()] and "scorer" in ran
    assert (g[ran] >= 0).all().all()
    if suffix == ".csv.gz":
        with gzip.open(got, "rt") as f:
            assert f.readline().strip().split(",") == list(g.columns)


def test_run_all_without_profile_records_nothing(pipes, tmp_path):
    pipe, _ = pipes
    with PipelineProfiler(pipe, tmp_path / "p.csv") as prof:
        pipe.run_all(query=1, n=5)
    assert len(_read(tmp_path / "p.csv")) == 0 and prof.stages


@pytest.mark.parametrize("n_jobs", [1, 3])
def test_runner_profile_equal_rows(pipes, tmp_path, n_jobs):
    pipe, jpipe = pipes
    runner, jrunner = BatchPipelineRunner(n_jobs=n_jobs, progress=False), JaxRunner(n_jobs=n_jobs, progress=False)
    runner.recommend(n=5)
    jrunner.recommend(n=5)
    with PipelineProfiler(pipe, tmp_path / "port.csv") as prof:
        recs = runner.run(pipe, USERS, profile=prof).output("recommendations")
    with JaxProfiler(jpipe, tmp_path / "jax.csv") as jprof:
        jrunner.run(jpipe, USERS, profile=jprof)
    g, w = _read(tmp_path / "port.csv"), _read(tmp_path / "jax.csv")
    assert list(g.columns) == list(w.columns) and len(g) == len(w) == len(USERS)
    assert len(recs) == len(USERS)
    # a runner without a profile still runs, and writes nothing
    with PipelineProfiler(pipe, tmp_path / "none.csv"):
        runner.run(pipe, USERS)
    assert len(_read(tmp_path / "none.csv")) == 0


def test_summarize_profile_equal(tmp_path):
    rng = np.random.default_rng(2)
    path = tmp_path / "profile.csv"
    df = pd.DataFrame({"history-lookup": rng.random(9), "scorer": rng.random(9), "ranker": rng.random(9)})
    df.loc[3, "ranker"] = np.nan
    df.to_csv(path, index=False)
    got, want = summarize_profile(path), jax_summarize(path)
    pd.testing.assert_frame_equal(got, want)
    assert got.loc["ranker", "runs"] == 8 and got.index.name == "stage"
