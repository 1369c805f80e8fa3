"""The port's model zoo (port of ``lkpy_tpu.models``): the ALS family, the
bias model, the basic components, item and user kNN and EASE."""

from lkpy_tpu_torch.models.als import BiasedMFScorer, ImplicitMFScorer
from lkpy_tpu_torch.models.basic import (
    FallbackScorer,
    KnownRatingScorer,
    PopScorer,
    RandomSelector,
    TimeBoundedPopScore,
    TopNRanker,
    TrainingItemsCandidateSelector,
    UserTrainingHistoryLookup,
)
from lkpy_tpu_torch.models.bias import BiasConfig, BiasModel, BiasScorer
from lkpy_tpu_torch.models.ease import EASEScorer
from lkpy_tpu_torch.models.knn import ItemKNNScorer, UserKNNScorer

__all__ = [
    "BiasedMFScorer",
    "EASEScorer",
    "ImplicitMFScorer",
    "ItemKNNScorer",
    "UserKNNScorer",
    "BiasConfig",
    "BiasModel",
    "BiasScorer",
    "FallbackScorer",
    "KnownRatingScorer",
    "PopScorer",
    "RandomSelector",
    "TimeBoundedPopScore",
    "TopNRanker",
    "TrainingItemsCandidateSelector",
    "UserTrainingHistoryLookup",
]
