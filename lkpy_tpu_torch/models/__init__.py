"""The port's model zoo (port of ``lkpy_tpu.models``): the ALS family, the
bias model, the basic components, item and user kNN, EASE, SLIM,
association rules, FunkSVD, the gradient family (FlexMF, LightGCN) and
stochastic ranking.  BiasedSVD, NMF, FA*IR and the ``hpfrec``/``implicit``
bridges are in their modules (``models.svd``, ``models.nmf``,
``models.fair``, ``models.hpf``, ``models.implicit_bridge``), as in the
JAX package."""

from lkpy_tpu_torch.models.als import BiasedMFScorer, ImplicitMFScorer
from lkpy_tpu_torch.models.association import AssociationScorer
from lkpy_tpu_torch.models.basic import (
    FallbackScorer,
    KnownRatingScorer,
    PopScorer,
    RandomSelector,
    SoftmaxRanker,
    TimeBoundedPopScore,
    TopNRanker,
    TrainingItemsCandidateSelector,
    UserTrainingHistoryLookup,
)
from lkpy_tpu_torch.models.bias import BiasConfig, BiasModel, BiasScorer
from lkpy_tpu_torch.models.ease import EASEScorer
from lkpy_tpu_torch.models.flexmf import (
    FlexMFExplicitConfig,
    FlexMFExplicitScorer,
    FlexMFImplicitConfig,
    FlexMFImplicitScorer,
)
from lkpy_tpu_torch.models.funksvd import FunkSVDScorer
from lkpy_tpu_torch.models.knn import ItemKNNScorer, UserKNNScorer
from lkpy_tpu_torch.models.lightgcn import LightGCNConfig, LightGCNScorer
from lkpy_tpu_torch.models.slim import SLIMScorer
from lkpy_tpu_torch.models.stochastic import StochasticTopNRanker

__all__ = [
    "AssociationScorer",
    "BiasedMFScorer",
    "EASEScorer",
    "FlexMFExplicitConfig",
    "FlexMFExplicitScorer",
    "FlexMFImplicitConfig",
    "FlexMFImplicitScorer",
    "FunkSVDScorer",
    "ImplicitMFScorer",
    "ItemKNNScorer",
    "SLIMScorer",
    "UserKNNScorer",
    "LightGCNConfig",
    "LightGCNScorer",
    "BiasConfig",
    "BiasModel",
    "BiasScorer",
    "FallbackScorer",
    "KnownRatingScorer",
    "PopScorer",
    "RandomSelector",
    "SoftmaxRanker",
    "StochasticTopNRanker",
    "TimeBoundedPopScore",
    "TopNRanker",
    "TrainingItemsCandidateSelector",
    "UserTrainingHistoryLookup",
]
