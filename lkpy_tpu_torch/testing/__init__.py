"""
Reusable test harness (port of ``lkpy_tpu/testing``).

Capability parity with reference ``lenskit.testing``
(reference: src/lenskit/testing/_components.py:29 ``BasicComponentTests``,
:110 ``ScorerTests``; MovieLens fixtures _movielens.py:47-125; hypothesis
strategies _arrays.py:25-91).  The strategies live in
:mod:`lkpy_tpu_torch.testing.arrays`, imported on their own, since they
need hypothesis.
"""

import os
from contextlib import contextmanager

from lkpy_tpu_torch.testing.components import BasicComponentTests, ScorerTests, TrainingTests, synthetic_ratings
from lkpy_tpu_torch.testing.movielens import ml_test_dir

__all__ = ["BasicComponentTests", "ScorerTests", "TrainingTests", "ml_test_dir", "set_env_var", "synthetic_ratings"]


@contextmanager
def set_env_var(name: str, value: str | None):
    """Temporarily set (or unset, with ``None``) an environment variable
    (reference: testing/__init__.py ``set_env_var``)."""
    old = os.environ.get(name)
    try:
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old
