"""
Top-N ranking metrics (port of ``lkpy_tpu/metrics/ranking.py``).

Capability parity with reference ``lenskit.metrics.ranking``
(reference: src/lenskit/metrics/ranking/): NDCG/DCG (_dcg.py:34,148),
Precision/Recall (_pr.py), Hit (_hit.py), RecipRank (_recip.py),
AveragePrecision (_map.py), RBP (_rbp.py), MeanPopRank (_pop.py),
Entropy/RankBiasedEntropy (_entropy.py), ListGini/ExposureGini (_gini.py),
ILS (_ils.py).
"""

from __future__ import annotations

import numpy as np

from lkpy_tpu_torch.data import Dataset, ItemList, ItemListCollection, Vocabulary
from lkpy_tpu_torch.metrics._base import GlobalMetric, ListMetric, RankingMetricBase
from lkpy_tpu_torch.metrics._weighting import GeometricRankWeight, LogRankWeight, RankWeight
from lkpy_tpu_torch.utils.stats import gini

__all__ = [
    "NDCG",
    "DCG",
    "Precision",
    "Recall",
    "Hit",
    "RecipRank",
    "AveragePrecision",
    "RBP",
    "MeanPopRank",
    "Entropy",
    "RankBiasedEntropy",
    "ListGini",
    "ExposureGini",
    "ILS",
    "array_dcg",
    "fixed_dcg",
]


class NDCG(ListMetric, RankingMetricBase):
    """Normalized discounted cumulative gain (reference: _dcg.py:34).

    Binary gain by default; ``gain='rating'`` uses graded gains (clipped ≥0)."""

    def __init__(self, n: int | None = None, *, k: int | None = None, weight: RankWeight | None = None, gain: str | None = None):
        super().__init__(n, k=k)
        self.weight = weight or LogRankWeight()
        self.gain = gain

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(test) == 0:
            return np.nan
        if self.gain:
            gains = test.field(self.gain)
            if gains is None:
                raise KeyError(f"test items have no field {self.gain!r}")
            gains = np.clip(np.nan_to_num(gains, nan=0.0), 0.0, None)
            # realized DCG
            t_ids = test.ids()
            pos = {k: i for i, k in enumerate(t_ids.tolist())}
            r_gain = np.array([gains[pos[i]] if i in pos else 0.0 for i in recs.ids().tolist()])
            w = self.weight.weight(np.arange(1, len(recs) + 1))
            realized = float(np.dot(r_gain, w))
            ideal_g = np.sort(gains)[::-1]
            if self.n:
                ideal_g = ideal_g[: self.n]
            iw = self.weight.weight(np.arange(1, len(ideal_g) + 1))
            ideal = float(np.dot(ideal_g, iw))
            if ideal == 0:
                return 0.0
        else:
            good = recs.isin(test)
            w = self.weight.weight(np.arange(1, len(recs) + 1))
            realized = float(np.sum(w[good]))
            n_ideal = min(len(test), self.n) if self.n else len(test)
            ideal = float(np.sum(self.weight.weight(np.arange(1, n_ideal + 1))))
        return realized / ideal


class DCG(ListMetric, RankingMetricBase):
    """Unnormalized DCG (reference: _dcg.py:148)."""

    def __init__(self, n: int | None = None, *, k: int | None = None, weight: RankWeight | None = None, gain: str | None = None):
        super().__init__(n, k=k)
        self.weight = weight or LogRankWeight()
        self.gain = gain

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(test) == 0:
            return np.nan
        w = self.weight.weight(np.arange(1, len(recs) + 1))
        if self.gain:
            gains = test.field(self.gain)
            pos = {k: i for i, k in enumerate(test.ids().tolist())}
            r_gain = np.array([gains[pos[i]] if i in pos else 0.0 for i in recs.ids().tolist()])
            return float(np.dot(np.clip(r_gain, 0, None), w))
        good = recs.isin(test)
        return float(np.sum(w[good]))


class Precision(ListMetric, RankingMetricBase):
    """Fraction of recommended items that are relevant (reference: _pr.py)."""

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(recs) == 0:
            return np.nan
        return float(np.sum(recs.isin(test)) / len(recs))


class Recall(ListMetric, RankingMetricBase):
    """Fraction of relevant items that are recommended (reference: _pr.py)."""

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(test) == 0:
            return np.nan
        return float(np.sum(recs.isin(test)) / len(test))


class Hit(ListMetric, RankingMetricBase):
    """1 if any relevant item is recommended (reference: _hit.py)."""

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(test) == 0:
            return np.nan
        return 1.0 if np.any(recs.isin(test)) else 0.0


class RecipRank(ListMetric, RankingMetricBase):
    """Reciprocal rank of the first relevant item (reference: _recip.py)."""

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(test) == 0:
            return np.nan
        good = np.nonzero(recs.isin(test))[0]
        if len(good) == 0:
            return 0.0
        return 1.0 / (good[0] + 1)


class AveragePrecision(ListMetric, RankingMetricBase):
    """Average precision at each relevant position (reference: _map.py)."""

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(recs) == 0 or len(test) == 0:
            return np.nan
        good = recs.isin(test)
        cum_good = np.cumsum(good)
        ranks = np.arange(1, len(recs) + 1)
        ap_sum = float(np.sum(cum_good[good] / ranks[good]))
        return ap_sum / min(len(test), len(recs))


class RBP(ListMetric, RankingMetricBase):
    """Rank-biased precision (reference: _rbp.py:40)."""

    def __init__(
        self,
        n: int | None = None,
        *,
        k: int | None = None,
        patience: float = 0.85,
        normalize: bool = False,
        weight: RankWeight | None = None,
    ):
        super().__init__(n, k=k)
        self.weight = weight or GeometricRankWeight(patience)
        self.patience = patience
        self.normalize = normalize

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(test) == 0:
            return np.nan
        good = recs.isin(test)
        ranks = np.arange(1, len(recs) + 1)
        rbp = float(np.sum(self.weight.weight(ranks)[good]))
        if self.normalize:
            n_ideal = min(len(test), self.n) if self.n else len(test)
            ideal = float(np.sum(self.weight.weight(np.arange(1, n_ideal + 1))))
            return rbp / ideal if ideal > 0 else 0.0
        ssum = self.weight.series_sum()
        return rbp / ssum if ssum else rbp


class MeanPopRank(ListMetric, RankingMetricBase):
    """Mean popularity percentile of recommended items (reference: _pop.py:19)."""

    def __init__(self, dataset: Dataset, n: int | None = None, *, k: int | None = None):
        super().__init__(n, k=k)
        stats = dataset.item_stats()
        counts = stats["count"].to_numpy()
        # percentile rank in [0, 1]: fraction of items with strictly lower count
        order = np.argsort(counts, kind="stable")
        ranks = np.empty(len(counts), dtype=np.float64)
        ranks[order] = np.arange(len(counts))
        self.pop_rank = ranks / max(len(counts) - 1, 1)
        self.items = dataset.items

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        nums = recs.numbers(vocabulary=self.items, missing="negative")
        ok = nums >= 0
        if not np.any(ok):
            return np.nan
        return float(np.mean(self.pop_rank[nums[ok]]))


def _category_matrix(items: ItemList, vectors) -> np.ndarray:
    if callable(vectors):
        return np.asarray(vectors(items))
    return np.asarray(vectors)


class Entropy(ListMetric, RankingMetricBase):
    """Shannon entropy of category exposure in a list (reference: _entropy.py:91).

    ``categories`` maps an ItemList to an (n_items, n_cats) indicator/weight
    matrix (e.g. genres); default is item identity (entropy over items)."""

    def __init__(self, n: int | None = None, *, k: int | None = None, categories=None):
        super().__init__(n, k=k)
        self.categories = categories

    @staticmethod
    def _entropy(p: np.ndarray) -> float:
        p = p[p > 0]
        if p.size == 0:
            return np.nan
        p = p / p.sum()
        return float(-np.sum(p * np.log2(p)))

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(recs) == 0:
            return np.nan
        if self.categories is None:
            return float(np.log2(len(recs)))  # uniform over distinct items
        mat = _category_matrix(recs, self.categories)
        return self._entropy(mat.sum(axis=0).astype(np.float64))


class RankBiasedEntropy(Entropy):
    """Entropy with geometric rank weighting (reference: _entropy.py:36)."""

    def __init__(self, n: int | None = None, *, k: int | None = None, categories=None, patience: float = 0.85):
        super().__init__(n, k=k, categories=categories)
        self.weight = GeometricRankWeight(patience)

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(recs) == 0:
            return np.nan
        w = self.weight.weight(np.arange(1, len(recs) + 1))
        if self.categories is None:
            return self._entropy(w)
        mat = _category_matrix(recs, self.categories).astype(np.float64)
        return self._entropy((mat * w[:, None]).sum(axis=0))


class _GiniBase(GlobalMetric, RankingMetricBase):
    def __init__(self, n: int | None = None, *, k: int | None = None, items: Vocabulary | Dataset):
        RankingMetricBase.__init__(self, n, k=k)
        self.item_vocab = items.items if isinstance(items, Dataset) else items

    def _exposure(self, outputs: ItemListCollection, weighted: bool) -> np.ndarray:
        exp = np.zeros(len(self.item_vocab))
        for _key, recs in outputs.items():
            recs = self.truncate(recs)
            nums = recs.numbers(vocabulary=self.item_vocab, missing="negative")
            ok = nums >= 0
            if weighted:
                w = LogRankWeight().weight(np.arange(1, len(recs) + 1))
                np.add.at(exp, nums[ok], w[ok])
            else:
                np.add.at(exp, nums[ok], 1.0)
        return exp


class ListGini(_GiniBase):
    """Gini concentration of list appearances per item (reference: _gini.py)."""

    def measure_run(self, outputs: ItemListCollection, test: ItemListCollection) -> float:
        return gini(self._exposure(outputs, weighted=False))


class ExposureGini(_GiniBase):
    """Gini concentration of rank-weighted exposure (reference: _gini.py)."""

    def measure_run(self, outputs: ItemListCollection, test: ItemListCollection) -> float:
        return gini(self._exposure(outputs, weighted=True))


class ILS(ListMetric, RankingMetricBase):
    """Intra-list similarity: mean pairwise cosine of item vectors
    (reference: _ils.py:49)."""

    def __init__(self, n: int | None = None, *, k: int | None = None, vectors=None, field: str | None = None):
        super().__init__(n, k=k)
        self.vectors = vectors
        self.field = field

    def measure_list(self, recs: ItemList, test: ItemList) -> float:
        recs = self.truncate(recs)
        if len(recs) < 2:
            return np.nan
        if self.field is not None:
            mat = recs.field(self.field)
            if mat is None:
                raise KeyError(f"items have no field {self.field!r}")
            mat = np.stack([np.asarray(v, dtype=np.float64) for v in mat])
        else:
            mat = _category_matrix(recs, self.vectors).astype(np.float64)
        norms = np.linalg.norm(mat, axis=1, keepdims=True)
        norms = np.where(norms > 0, norms, 1.0)
        unit = mat / norms
        sim = unit @ unit.T
        m = len(recs)
        iu = np.triu_indices(m, k=1)
        return float(np.mean(sim[iu]))


def array_dcg(scores: np.ndarray, weight: RankWeight | None = None, *, graded: bool = True) -> float:
    """DCG of an array of relevance scores in recommendation order — a
    utility for other metrics, not a top-N metric itself
    (reference: ranking/_dcg.py:258).

    With ``graded=True`` the scores are gains (clipped at 0); with
    ``graded=False`` any positive score counts as binary relevance 1.
    """
    scores = np.asarray(scores, dtype=np.float64)
    if len(scores) == 0:
        return np.nan
    w = (weight or LogRankWeight()).weight(np.arange(1, len(scores) + 1))
    if graded:
        return float(np.dot(np.clip(np.nan_to_num(scores, nan=0.0), 0.0, None), w))
    return float(np.sum(w[scores > 0]))


def fixed_dcg(n: int, weight: RankWeight | None = None) -> float:
    """DCG of ``n`` items with relevance 1 (reference: ranking/_dcg.py:293)."""
    return float(np.sum((weight or LogRankWeight()).weight(np.arange(1, n + 1))))
