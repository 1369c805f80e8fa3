"""
FA*IR fair top-N reranking (Zehlike et al. 2017).

Port of ``lkpy_tpu/models/fair.py`` (reference:
src/lenskit/reranking/fair.py:61): binomial prefix quotas with
multiple-test-adjusted significance, greedy merge of protected/unprotected
queues.  Host NumPy and SciPy, as in the JAX package (an inherently
sequential loop over a short list); the protected attribute is read through
the dataset's item :class:`~lkpy_tpu_torch.data.dataset.EntitySet`.
"""

from __future__ import annotations

from collections import deque

import numpy as np
from pydantic import BaseModel, Field
from scipy.stats import binom

from lkpy_tpu_torch.data import Dataset, ItemList, Vocabulary
from lkpy_tpu_torch.logging import get_logger
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

_log = get_logger(__name__)

__all__ = ["FAIRRerankerConfig", "FAIRReranker"]


class FAIRRerankerConfig(BaseModel):
    """Configuration (reference: fair.py:29)."""

    n: int
    p: float = Field(0.5, gt=0.0, lt=1.0)
    alpha: float = Field(0.1, gt=0.0, lt=1.0)
    protected_attribute: str = "protected"


class FAIRReranker(Component):
    """FA*IR reranker (reference: fair.py:61)."""

    config: FAIRRerankerConfig

    alpha_c: float
    m_list: np.ndarray
    vocab: Vocabulary
    protected_attributes: np.ndarray

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "alpha_c")

    @is_trained.setter
    def is_trained(self, v):
        pass

    # ---- threshold computation (reference: fair.py:85-147) ----------------
    def _compute_m_list(self, n, p, alpha):
        n_vals = np.arange(1, n + 1)
        m = binom.ppf(alpha, n_vals, p)
        return np.clip(m, 0, n_vals).astype(int)

    def _compute_blocks(self, m_list):
        max_m = int(m_list[-1]) if len(m_list) else 0
        if max_m == 0:
            return np.array([], dtype=int)
        change_points = np.flatnonzero(np.diff(m_list, prepend=0)) + 1
        return np.diff(change_points, prepend=0)

    def _compute_rejection_prob(self, n, p, alpha_c):
        m_list = self._compute_m_list(n, p, alpha_c)
        blocks = self._compute_blocks(m_list)
        S = np.array([1.0])
        for j, bsize in enumerate(blocks, start=1):
            if bsize not in self._pmf_cache:
                self._pmf_cache[bsize] = binom.pmf(np.arange(bsize + 1), bsize, p)
            S = np.convolve(self._pmf_cache[bsize], S)
            S[j - 1] = 0
        return float(1 - S.sum())

    def _binary_search_significance(self, n, p, alpha, tolerance=1e-10, max_iter=100):
        lo, hi = 0.0, alpha
        a_c = alpha / 2
        for _ in range(max_iter):
            a_c = (lo + hi) / 2
            rej = self._compute_rejection_prob(n, p, a_c)
            if abs(rej - alpha) < tolerance:
                break
            if rej > alpha:
                hi = a_c
            else:
                lo = a_c
        return a_c

    # ---- training ---------------------------------------------------------
    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        self._pmf_cache: dict[int, np.ndarray] = {}
        self.alpha_c = self._binary_search_significance(self.config.n, self.config.p, self.config.alpha)
        self.m_list = self._compute_m_list(self.config.n, self.config.p, self.alpha_c)

        items = data.entities("item")
        attr = self.config.protected_attribute
        if attr not in items.attribute_names:
            raise ValueError(f"dataset items have no {attr!r} attribute")
        prot = items.attribute(attr).to_numpy()
        self.protected_attributes = np.equal(prot, True)
        self.vocab = items.vocabulary

    def __call__(self, items: ItemList, n: int | None = None) -> ItemList:
        nums = items.numbers(vocabulary=self.vocab, missing="negative")
        is_prot = np.full(len(items), False)
        ok = nums >= 0
        is_prot[ok] = self.protected_attributes[nums[ok]]

        p_items = deque(np.nonzero(is_prot)[0])
        up_items = deque(np.nonzero(~is_prot)[0])

        n_config = self.config.n
        if n is not None and n > n_config:
            raise ValueError(f"requested rerank length n={n} exceeds configured n={n_config}")
        n = min(n or n_config, len(items))

        count_prot = 0
        order = []
        for i in range(n):
            if count_prot < self.m_list[i] and p_items:
                order.append(p_items.popleft())
                count_prot += 1
            elif p_items and up_items:
                if p_items[0] < up_items[0]:
                    order.append(p_items.popleft())
                    count_prot += 1
                else:
                    order.append(up_items.popleft())
            elif up_items:
                order.append(up_items.popleft())
            else:
                order.append(p_items.popleft())
                count_prot += 1

        return ItemList(items[order], ordered=True)
