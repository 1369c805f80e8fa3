"""
Hyperparameter tuning (port of ``lkpy_tpu.tuning``).

Capability parity with the reference tuning subsystem
(reference: src/lenskit/tuning/ — ``TuningSpec`` schemas/tuning.py:149,
``PipelineTuner`` tuning/_optuna/search.py:40, ``PlateauStopRule``
tuning/_stopping.py:23).  Optuna/Ray are not in the image, so the search
engine is native: a TPE (Parzen-estimator) sampler with random fallback
(:mod:`lkpy_tpu_torch.tuning.sampler`), concurrent trial evaluation with
constant-liar pending handling, and *iterative* trials that evaluate
per-epoch through :class:`ModelTrainer` and stop on plateaus — the same
trial shapes the reference runs on Optuna.
"""

from lkpy_tpu_torch.tuning.sampler import RandomSampler, TPESampler
from lkpy_tpu_torch.tuning.search import PipelineTuner, SearchPoint, TuneResults
from lkpy_tpu_torch.tuning.spec import ParamSpace, TuningSpec
from lkpy_tpu_torch.tuning.stopping import PlateauStopRule

__all__ = [
    "ParamSpace",
    "PipelineTuner",
    "PlateauStopRule",
    "RandomSampler",
    "SearchPoint",
    "TPESampler",
    "TuneResults",
    "TuningSpec",
]
