"""
Model-based search sampling (port of ``lkpy_tpu/tuning/sampler.py``: the
same NumPy draws, so the same generator and observations give the same
points).

Capability parity with the reference's Optuna TPE backend
(reference: src/lenskit/tuning/_optuna/search.py:40 uses
``optuna.samplers.TPESampler``): a native Tree-structured Parzen Estimator —
after a few random startup points, observed points split into a "good" (top
γ-quantile) and "bad" set; each dimension gets Parzen (kernel-density)
models l(x) and g(x) over the two sets, candidates are drawn from l and the
candidate maximizing l(x)/g(x) (the expected-improvement proxy) is chosen.

Pending (in-flight) trials are handled with the constant-liar strategy:
they count as "bad" so concurrent workers spread out instead of dog-piling
one region.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from lkpy_tpu_torch.tuning.spec import ParamSpace

__all__ = ["RandomSampler", "TPESampler"]


class RandomSampler:
    """Uniform random sampling of the spec (the round-1 behavior)."""

    def __init__(self, space: dict[str, ParamSpace], rng: np.random.Generator):
        self.space = space
        self.rng = rng

    def suggest(self, observed, pending) -> dict[str, Any]:
        return {name: dim.sample(self.rng) for name, dim in self.space.items()}


def _to_unit(dim: ParamSpace, v) -> float:
    """Map a value into [0, 1] over its (possibly log) range."""
    lo, hi = float(dim.min), float(dim.max)
    if dim.log:
        return (math.log(v) - math.log(lo)) / (math.log(hi) - math.log(lo))
    return (float(v) - lo) / (hi - lo)


def _from_unit(dim: ParamSpace, u: float):
    u = min(max(u, 0.0), 1.0)
    lo, hi = float(dim.min), float(dim.max)
    if dim.log:
        v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        v = lo + u * (hi - lo)
    # the log-space round-trip can land an epsilon outside [lo, hi]; clamp
    # so proposals always satisfy the declared bounds exactly
    v = min(max(v, lo), hi)
    return int(round(v)) if dim.type == "int" else v


class _ParzenNumeric:
    """1-D Parzen mixture over [0,1] (truncated Gaussians + uniform prior)."""

    def __init__(self, points: np.ndarray):
        self.mu = np.concatenate([points, [0.5]])  # uniform-ish prior component
        n = len(self.mu)
        # Scott-style bandwidth on the unit interval, floored for stability
        self.sigma = np.full(n, max(1.0 / max(n, 1) ** 0.5 * 0.5, 0.08))
        self.sigma[-1] = 0.999  # broad prior component

    def sample(self, rng: np.random.Generator) -> float:
        i = int(rng.integers(0, len(self.mu)))
        return float(np.clip(rng.normal(self.mu[i], self.sigma[i]), 0.0, 1.0))

    def logpdf(self, x: float) -> float:
        z = (x - self.mu) / self.sigma
        comp = np.exp(-0.5 * z * z) / (self.sigma * math.sqrt(2 * math.pi))
        return float(np.log(np.mean(comp) + 1e-12))


class _ParzenCategorical:
    """Smoothed category frequencies."""

    def __init__(self, choices: list, values: list):
        counts = np.ones(len(choices))  # +1 smoothing
        index = {c: i for i, c in enumerate(choices)}
        for v in values:
            counts[index[v]] += 1
        self.choices = choices
        self.p = counts / counts.sum()

    def sample(self, rng: np.random.Generator):
        return self.choices[int(rng.choice(len(self.choices), p=self.p))]

    def logpdf(self, v) -> float:
        return float(np.log(self.p[self.choices.index(v)]))


class TPESampler:
    """
    Tree-structured Parzen Estimator sampler.

    Args:
        space: the search dimensions.
        rng: randomness.
        n_startup: random points before the model kicks in.
        gamma: good-set quantile.
        n_candidates: candidates drawn from l(x) per suggestion.
        maximize: direction of the objective.
    """

    def __init__(
        self,
        space: dict[str, ParamSpace],
        rng: np.random.Generator,
        *,
        n_startup: int = 5,
        gamma: float = 0.25,
        n_candidates: int = 24,
        maximize: bool = True,
    ):
        self.space = space
        self.rng = rng
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.maximize = maximize

    def suggest(self, observed: list[tuple[dict, float]], pending: list[dict]) -> dict[str, Any]:
        """Propose the next point.

        ``observed``: (params, value) pairs; ``pending``: params of in-flight
        trials (constant-liar: treated as members of the bad set).
        """
        if len(observed) < self.n_startup:
            return {name: dim.sample(self.rng) for name, dim in self.space.items()}

        vals = np.array([v for _, v in observed], dtype=float)
        order = np.argsort(-vals if self.maximize else vals)
        n_good = max(1, int(math.ceil(self.gamma * len(observed))))
        good_ix = set(order[:n_good].tolist())
        good = [observed[i][0] for i in good_ix]
        bad = [observed[i][0] for i in range(len(observed)) if i not in good_ix]
        bad = bad + list(pending)  # constant liar
        if not bad:
            bad = good

        out: dict[str, Any] = {}
        for name, dim in self.space.items():
            if dim.choices is not None:
                l_m = _ParzenCategorical(dim.choices, [p[name] for p in good])
                g_m = _ParzenCategorical(dim.choices, [p[name] for p in bad])
            else:
                l_m = _ParzenNumeric(np.array([_to_unit(dim, p[name]) for p in good]))
                g_m = _ParzenNumeric(np.array([_to_unit(dim, p[name]) for p in bad]))
            best_c, best_score = None, -np.inf
            for _ in range(self.n_candidates):
                c = l_m.sample(self.rng)
                score = l_m.logpdf(c) - g_m.logpdf(c)
                if score > best_score:
                    best_c, best_score = c, score
            if dim.choices is not None:
                out[name] = best_c
            else:
                out[name] = _from_unit(dim, best_c)
        return out
