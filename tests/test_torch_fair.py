"""The port's FA*IR reranker (``lkpy_tpu_torch.models.fair``) against the
JAX package's on the CPU: the same datasets (a boolean ``protected`` item
attribute through each package's ``DatasetBuilder``), made with numpy from a
seed, give the same significance, quota table and reranked order, item for
item."""

import numpy as np
import pandas as pd
import pytest

from lkpy_tpu.data import DatasetBuilder as JaxDatasetBuilder
from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.models.fair import FAIRReranker as JaxFAIR
from lkpy_tpu_torch.data import DatasetBuilder, ItemList
from lkpy_tpu_torch.models.fair import FAIRReranker, FAIRRerankerConfig
from lkpy_tpu_torch.pipeline import Component


def _dataset(builder_cls, items, protected, attr="protected"):
    dsb = builder_cls()
    dsb.add_entities("item", items)
    dsb.add_scalar_attribute("item", attr, items, protected)
    df = pd.DataFrame({"user_id": np.zeros(len(items), np.int64), "item_id": items})
    dsb.add_interactions("click", df, entities=["user", "item"], missing="insert")
    return dsb.build()


def _pair(n, p, alpha, n_items, share, seed):
    rng = np.random.default_rng(seed)
    items = rng.permutation(np.arange(1, n_items + 1))
    protected = rng.random(n_items) < share
    jr, tr = JaxFAIR(n=n, p=p, alpha=alpha), FAIRReranker(n=n, p=p, alpha=alpha)
    jr.train(_dataset(JaxDatasetBuilder, items, protected))
    tr.train(_dataset(DatasetBuilder, items, protected))
    return jr, tr, items, protected


@pytest.mark.parametrize(
    "n,p,alpha,share,seed",
    [(10, 0.5, 0.1, 0.3, 1), (20, 0.5, 0.2, 0.5, 2), (50, 0.5, 0.1, 0.2, 3), (100, 0.1, 0.3, 0.1, 4), (100, 0.5, 0.1, 0.4, 5)],
)
def test_orders_match_jax(n, p, alpha, share, seed):
    jr, tr, items, protected = _pair(n, p, alpha, n + 30, share, seed)
    assert tr.alpha_c == jr.alpha_c
    np.testing.assert_array_equal(tr.m_list, jr.m_list)
    np.testing.assert_array_equal(tr.protected_attributes, jr.protected_attributes)
    rng = np.random.default_rng(seed + 100)
    for _ in range(5):
        cand = rng.permutation(items)[: n + 10]
        cand = np.r_[cand, 999_999]  # an unknown item counts as unprotected
        scores = np.sort(rng.random(len(cand)))[::-1]
        for k in (None, n // 2):
            got = tr(ItemList(item_ids=cand, scores=scores, ordered=True), n=k)
            want = jr(JaxItemList(item_ids=cand, scores=scores, ordered=True), n=k)
            np.testing.assert_array_equal(got.ids(), want.ids())
            np.testing.assert_array_equal(got.scores(), want.scores())
            assert got.ordered
            # the prefix quota holds while protected candidates remain
            prot = set(items[protected].tolist())
            counts = np.cumsum([int(i in prot) for i in got.ids()])
            available = sum(int(i in prot) for i in cand)
            assert np.all(counts >= np.minimum(tr.m_list[: len(counts)], available))


def test_short_lists_and_refusals():
    jr, tr, items, _ = _pair(12, 0.5, 0.1, 12, 0.0, 6)
    out = tr(ItemList(item_ids=items, ordered=True), n=6)
    assert np.array_equal(out.ids(), items[:6])  # no protected item: the order is kept
    assert len(tr(ItemList(item_ids=items[:3], ordered=True))) == 3
    with pytest.raises(ValueError, match="exceeds"):
        tr(ItemList(item_ids=items, ordered=True), n=13)
    bare = _dataset(DatasetBuilder, items, np.zeros(len(items), bool), attr="other")
    with pytest.raises(ValueError, match="protected"):
        FAIRReranker(n=5).train(bare)


def test_config_round_trip():
    rr = FAIRReranker(n=7, p=0.3, alpha=0.05)
    assert isinstance(rr, Component) and isinstance(rr.config, FAIRRerankerConfig)
    assert FAIRReranker(FAIRReranker.validate_config(rr.dump_config())).config == rr.config
    with pytest.raises(ValueError):
        FAIRRerankerConfig(n=5, p=1.5)
