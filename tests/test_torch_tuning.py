"""The port's tuner against the JAX package's on the CPU.

The search space, the samplers and the stop rule are NumPy only: with the
same ``numpy.random.Generator`` and the same observations both packages must
propose the same points, exactly.  The tuner itself runs on the same
synthetic ratings, split by each package with the same seed: the bias model
over three random points (values within 1e-6), and an iterative implicit-ALS
search (8 features, 2 points, at most 3 epochs: the same epochs, values
within 1e-3).  The port trains with ``device="cpu"``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.splitting import SampleFrac as JaxSampleFrac
from lkpy_tpu.splitting import sample_users as jax_sample_users
from lkpy_tpu.tuning import ParamSpace as JaxParamSpace
from lkpy_tpu.tuning import PipelineTuner as JaxPipelineTuner
from lkpy_tpu.tuning import PlateauStopRule as JaxPlateau
from lkpy_tpu.tuning import RandomSampler as JaxRandomSampler
from lkpy_tpu.tuning import TPESampler as JaxTPESampler
from lkpy_tpu.tuning import TuningSpec as JaxTuningSpec
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.splitting import SampleFrac, sample_users
from lkpy_tpu_torch.tuning import ParamSpace, PipelineTuner, PlateauStopRule, RandomSampler, TPESampler, TuningSpec

torch.set_num_threads(1)

SPACES = {
    "linear": {"type": "float", "min": 5, "max": 100},
    "log": {"type": "float", "min": 1e-4, "max": 1, "scale": "log"},
    "log-flag": {"type": "float", "min": 0.5, "max": 25.0, "log": True},
    "int": {"type": "int", "min": 1, "max": 50},
    "int-log": {"type": "int", "min": 2, "max": 500, "log": True},
    "pow2": {"type": "int", "min": 8, "max": 256, "scale": "pow2"},
    "pow2-odd": {"type": "int", "min": 3, "max": 100, "scale": "pow2"},
    "categorical": {"type": "categorical", "choices": ["cosine", "pearson", "jaccard"]},
}


def _spaces(cls, names):
    return {n: cls.model_validate(SPACES[n]) for n in names}


@pytest.mark.parametrize("name", list(SPACES))
def test_param_space_samples_equal(name):
    got, want = ParamSpace.model_validate(SPACES[name]), JaxParamSpace.model_validate(SPACES[name])
    assert got.model_dump() == want.model_dump()
    g, w = np.random.default_rng(7), np.random.default_rng(7)
    a = [got.sample(g) for _ in range(200)]
    b = [want.sample(w) for _ in range(200)]
    assert a == b
    if got.choices is None:
        assert min(a) >= got.min and max(a) <= got.max
    else:
        assert set(a) <= set(got.choices)
    if name == "pow2":
        assert got.choices == [8, 16, 32, 64, 128, 256]


def _objective(params):
    """A deterministic value of a point, so both packages observe the same."""
    v = 0.0
    for k, x in sorted(params.items()):
        v += (len(str(x)) % 7) * 0.01 if isinstance(x, str) else float(np.sin(float(x) + len(k)))
    return v


def _suggestions(sampler_cls, space_cls, names, n, seed, pending_every=0, **kwargs):
    space = _spaces(space_cls, names)
    sampler = sampler_cls(space, np.random.default_rng(seed), **kwargs)
    observed, pending, out = [], [], []
    for i in range(n):
        p = sampler.suggest(observed, list(pending))
        out.append(p)
        if pending_every and i % pending_every == 0:
            pending.append(p)
        else:
            observed.append((p, _objective(p)))
    return out


@pytest.mark.parametrize("seed", [0, 42])
def test_random_sampler_equal(seed):
    names = ["linear", "log", "int", "pow2", "categorical"]
    assert _suggestions(RandomSampler, ParamSpace, names, 12, seed) == _suggestions(JaxRandomSampler, JaxParamSpace, names, 12, seed)


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"n_startup": 2},
        {"n_startup": 3, "maximize": False},
        {"n_startup": 1, "gamma": 0.5, "n_candidates": 8},
    ],
)
@pytest.mark.parametrize("pending_every", [0, 3])
def test_tpe_sampler_equal(kwargs, pending_every):
    names = ["linear", "log-flag", "int", "int-log", "pow2-odd", "categorical"]
    got = _suggestions(TPESampler, ParamSpace, names, 14, 5, pending_every, **kwargs)
    want = _suggestions(JaxTPESampler, JaxParamSpace, names, 14, 5, pending_every, **kwargs)
    assert got == want
    for p in got:
        assert 5 <= p["linear"] <= 100 and 1 <= p["int"] <= 50 and isinstance(p["int"], int)
        assert p["categorical"] in SPACES["categorical"]["choices"]


@pytest.mark.parametrize("maximize", [True, False])
@pytest.mark.parametrize("patience,min_delta", [(3, 1e-4), (1, 0.0), (2, 0.05)])
def test_plateau_stop_rule_equal(maximize, patience, min_delta):
    values = [0.1, 0.2, 0.2, 0.21, 0.2101, 0.19, 0.3, 0.3, 0.3, 0.29, 0.1, 0.5]
    if not maximize:
        values = [1 - v for v in values]
    got, want = PlateauStopRule(patience, min_delta, maximize), JaxPlateau(patience, min_delta, maximize)
    decisions = [(got.update(v), want.update(v)) for v in values]
    assert all(a == b for a, b in decisions)
    assert got.best == want.best and got.stale == want.stale


def _ratings(seed=3, n_users=60, n_items=45, nnz=900):
    rng = np.random.default_rng(seed)
    keys = rng.choice(n_users * n_items, size=nnz, replace=False)
    return pd.DataFrame(
        {
            "user_id": keys // n_items + 1,
            "item_id": keys % n_items + 100,
            "rating": rng.integers(1, 11, nnz) / 2.0,
        }
    )


def _splits(n_test=30, seed=11):
    df = _ratings()
    jds, ds = jax_from_df(df.copy()), from_interactions_df(df.copy())
    jsplit = jax_sample_users(jds, n_test, JaxSampleFrac(0.2, rng=seed), rng=seed)
    split = sample_users(ds, n_test, SampleFrac(0.2, rng=seed), rng=seed)
    return jsplit, split


def _assert_same_points(got, want, tol):
    assert len(got.points) == len(want.points)
    for p, q in zip(got.points, want.points):
        assert p.params == q.params
        assert p.epochs == q.epochs
        assert abs(p.value - q.value) <= tol, (p.value, q.value)
        assert set(p.metrics) == set(q.metrics)
        for k in q.metrics:
            assert abs(p.metrics[k] - q.metrics[k]) <= tol, k
    assert got.best_params == want.best_params


def test_bias_tuner_equals_jax():
    jsplit, split = _splits()
    spec = dict(
        model="bias",
        space={"damping": {"type": "float", "min": 0.5, "max": 25.0, "log": True}},
        metric="RMSE",
        mode="minimize",
        max_points=3,
        sampler="random",
        predicts_ratings=True,
        n_recs=10,
    )
    got = PipelineTuner(TuningSpec.model_validate(spec), split, rng=42, device="cpu").run()
    want = JaxPipelineTuner(JaxTuningSpec.model_validate(spec), jsplit, rng=42).run()
    _assert_same_points(got, want, 1e-6)
    assert got.best_value == min(p.value for p in got.points)
    assert list(got.to_df().columns) == list(want.to_df().columns)


def test_iterative_als_tuner_equals_jax():
    jsplit, split = _splits()
    spec = dict(
        model="lkpy_tpu.models.als:ImplicitMFScorer",
        space={
            "weight": {"type": "float", "min": 5, "max": 60},
            "regularization.user": {"type": "float", "min": 1e-3, "max": 1, "scale": "log"},
            "regularization.item": {"type": "float", "min": 1e-3, "max": 1, "scale": "log"},
        },
        metric="NDCG@10",
        max_points=2,
        method="iterative",
        max_epochs=3,
        n_recs=10,
        fixed={"embedding_size": 8, "user_embeddings": True},
    )
    tuner = PipelineTuner(TuningSpec.model_validate(spec), split, rng=42, device="cpu")
    got = tuner.run()
    want = JaxPipelineTuner(JaxTuningSpec.model_validate(spec), jsplit, rng=42).run()
    _assert_same_points(got, want, 1e-3)
    assert all(p.epochs is not None and 1 <= p.epochs <= 3 for p in got.points)
    assert got.best_value == max(p.value for p in got.points)


def test_iterative_trial_trains_on_its_own_tables():
    """After ``finalize`` the scorer holds the epoch's tables; the next
    epoch makes new ones and leaves the scorer's as they were."""
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.training import TrainingOptions

    _, split = _splits()
    scorer = ImplicitMFScorer(features=8, epochs=3, user_embeddings=True)
    trainer = scorer.create_trainer(split.train, TrainingOptions(rng=1, device="cpu"))
    trainer.train_epoch()
    trainer.finalize()
    items, otor = scorer.item_embeddings.clone(), scorer._OtOr.clone()
    trainer.train_epoch()
    assert torch.equal(scorer.item_embeddings, items) and torch.equal(scorer._OtOr, otor)
    assert not torch.equal(trainer.i_factors, items)
    trainer.finalize()
    assert scorer.item_embeddings is trainer.i_factors


def test_tuner_on_the_card_by_default(monkeypatch):
    """Without ``device`` a trial trains on the card, and raises where there is none."""
    _, split = _splits()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TuningSpec(model="bias", space={"damping": {"type": "float", "min": 1, "max": 5}}, max_points=1, sampler="random")
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineTuner(spec, split, rng=1).run()


def test_concurrent_trials_give_every_point():
    _, split = _splits()
    spec = TuningSpec(
        model="bias",
        space={"damping": {"type": "float", "min": 0.5, "max": 25.0}},
        metric="RMSE",
        mode="minimize",
        max_points=4,
        n_concurrent=2,
        predicts_ratings=True,
        n_recs=10,
    )
    res = PipelineTuner(spec, split, rng=3, device="cpu").run()
    assert len(res.points) == 4 and all(np.isfinite(p.value) for p in res.points)
    assert res.best_value == min(p.value for p in res.points)
