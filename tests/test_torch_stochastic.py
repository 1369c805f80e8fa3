"""Stochastic ranking (``lkpy_tpu_torch.models.stochastic`` and
``models.basic.SoftmaxRanker``) against the JAX package's on the CPU: the
same scored lists and seeds give lists equal to the bit, with NaN scores,
list lengths, scales, per-user seeds and pipeline configs."""

import numpy as np
import pytest
import torch

from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.models.basic import SoftmaxRanker as JaxSoftmaxRanker
from lkpy_tpu.models.stochastic import StochasticTopNRanker as JaxStochasticTopNRanker
from lkpy_tpu.models.stochastic import stochastic_rank as jax_stochastic_rank
from lkpy_tpu_torch.data import ItemList
from lkpy_tpu_torch.models import SoftmaxRanker, StochasticTopNRanker
from lkpy_tpu_torch.models.basic import SoftmaxConfig
from lkpy_tpu_torch.models.stochastic import StochasticTopNConfig, stochastic_rank

torch.set_num_threads(1)


def _lists(seed=0, n=60, nan_share=0.1):
    rng = np.random.default_rng(seed)
    ids = rng.choice(10_000, n, replace=False)
    scores = (rng.standard_normal(n) * 2).astype(np.float32)
    scores[rng.random(n) < nan_share] = np.nan
    return ItemList(item_ids=ids, scores=scores), JaxItemList(item_ids=ids, scores=scores)


def _same(got, want):
    assert len(got) == len(want) and got.ordered and want.ordered
    np.testing.assert_array_equal(got.ids(), want.ids())
    np.testing.assert_array_equal(got.scores(), want.scores())
    np.testing.assert_array_equal(got.ranks(), want.ranks())


@pytest.mark.parametrize("n", [None, -1, 0, 5, 200])
@pytest.mark.parametrize("scale", [1.0, 0.25, 8.0])
def test_stochastic_rank_equal(n, scale):
    il, jil = _lists()
    _same(stochastic_rank(il, n, 42, scale=scale), jax_stochastic_rank(jil, n, 42, scale=scale))


def test_stochastic_rank_needs_scores():
    with pytest.raises(ValueError):
        stochastic_rank(ItemList(item_ids=[1, 2]), 2, 1)


@pytest.mark.parametrize("cls,jcls,kw", [
    (StochasticTopNRanker, JaxStochasticTopNRanker, dict(n=10, rng=7, scale=2.0)),
    (StochasticTopNRanker, JaxStochasticTopNRanker, dict(rng=3)),
    (SoftmaxRanker, JaxSoftmaxRanker, dict(n=10, rng=7)),
    (SoftmaxRanker, JaxSoftmaxRanker, dict(rng=11)),
])  # fmt: skip
def test_rankers_equal(cls, jcls, kw):
    r, jr = cls(**kw), jcls(**kw)
    for seed, user in ((0, 1), (1, 2), (2, None), (0, 5)):
        il, jil = _lists(seed)
        _same(r(il, query=user), jr(jil, query=user))
        _same(r(il, query=user, n=3), jr(jil, query=user, n=3))
    # a user's list is reproducible, and differs between users
    il, _ = _lists(4)
    np.testing.assert_array_equal(r(il, query=9).ids(), r(il, query=9).ids())
    assert not np.array_equal(r(il, query=9).ids(), r(il, query=10).ids())


def test_configs_round_trip():
    s = StochasticTopNRanker(n=4, rng=2, scale=0.5)
    assert isinstance(s.config, StochasticTopNConfig) and s.config.scale == 0.5
    assert s.dump_config() == JaxStochasticTopNRanker(n=4, rng=2, scale=0.5).dump_config()
    f = SoftmaxRanker(n=4, rng=2)
    assert isinstance(f.config, SoftmaxConfig)
    assert SoftmaxRanker(SoftmaxRanker.validate_config(f.dump_config())).config == f.config
