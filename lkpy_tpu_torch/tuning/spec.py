"""
Tuning specification (port of ``lkpy_tpu/tuning/spec.py``; reference:
src/lenskit/schemas/tuning.py:149).
"""

from __future__ import annotations

from typing import Any, Literal

import numpy as np
from pydantic import BaseModel, Field, model_validator

__all__ = ["ParamSpace", "TuningSpec"]


class ParamSpace(BaseModel):
    """A search dimension: int/float range (optionally log-scaled) or choices.

    ``scale`` accepts the reference's pipeline-file vocabulary
    (reference: pipelines/als-implicit-search.toml): ``"log"`` maps to
    ``log=True``; ``"pow2"`` samples powers of two within [min, max]."""

    type: Literal["int", "float", "categorical"] = "float"
    min: float | None = None
    max: float | None = None
    log: bool = False
    scale: Literal["linear", "log", "pow2"] | None = None
    choices: list[Any] | None = None

    @model_validator(mode="after")
    def _apply_scale(self):
        if self.scale == "log":
            self.log = True
        elif self.scale == "pow2" and self.choices is None:
            lo = int(np.ceil(np.log2(float(self.min))))
            hi = int(np.floor(np.log2(float(self.max))))
            self.choices = [2**e for e in range(lo, hi + 1)]
        return self

    def sample(self, rng: np.random.Generator):
        if self.choices is not None:
            return self.choices[int(rng.integers(0, len(self.choices)))]
        lo, hi = float(self.min), float(self.max)
        if self.log:
            v = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        else:
            v = float(rng.uniform(lo, hi))
        if self.type == "int":
            return int(round(v))
        return v


class TuningSpec(BaseModel):
    """What to tune and how (reference: schemas/tuning.py:149)."""

    model: str
    "Model name (CLI registry) or module:Class path."
    space: dict[str, ParamSpace] = Field(default_factory=dict)
    metric: str = "NDCG@20"
    mode: Literal["maximize", "minimize"] = "maximize"
    max_points: int = 20
    "Number of search points to evaluate."
    method: Literal["random", "iterative"] = "random"
    "random = full trainings; iterative = per-epoch plateau-stopped trials."
    max_epochs: int = 20
    "Epoch cap for iterative trials."
    sampler: Literal["tpe", "random"] = "tpe"
    "Point proposal strategy: TPE (model-based, the reference's Optuna default) or uniform random."
    n_startup: int = 5
    "Random points before the TPE model kicks in."
    n_concurrent: int = 1
    "Concurrent trial evaluations (thread pool; constant-liar pending handling)."
    predicts_ratings: bool = False
    n_recs: int = 20
    fixed: dict[str, Any] = Field(default_factory=dict)
    "Fixed model config values."
