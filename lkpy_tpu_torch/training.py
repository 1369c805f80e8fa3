"""
Training interfaces.

Port of ``lkpy_tpu/training.py`` (reference: src/lenskit/training.py:40,232,
271,345): ``TrainingOptions``, the ``Trainable`` protocol, the
``UsesTrainer`` epoch-loop driver and the ``ModelTrainer`` ABC.

``TrainingOptions.device`` names the torch device to train on; ``None``
means the card (:func:`lkpy_tpu_torch.resolve_device`).  Multi-device
training (the JAX package's ``mesh``) is not part of the port yet.
``UsesTrainer`` reports its epochs through
:func:`lkpy_tpu_torch.logging.item_progress`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.logging import get_logger, item_progress
from lkpy_tpu_torch.random import RNGInput, random_generator

__all__ = ["TrainingOptions", "Trainable", "UsesTrainer", "ModelTrainer", "IterativeTraining"]


@dataclass
class TrainingOptions:
    """
    Options for training models (reference: training.py:40).

    Args:
        retrain: if False, components that are already trained are skipped
            (reference: training.py:45).
        device: the torch device to train on; None means the card (``cuda``),
            ``"cpu"`` the CPU.
        rng: seed material for training randomness.
        environment: local environment overrides consulted before
            ``os.environ`` by :meth:`env_var` / :meth:`env_flag`.
    """

    retrain: bool = True
    device: str | torch.device | None = None
    rng: RNGInput = None
    environment: dict[str, str] | None = None

    def env_var(self, name: str, default: str | None = None) -> str | None:
        """Look up a training environment variable: the local
        :attr:`environment` dict first, then ``os.environ``
        (reference: training.py ``env_var``)."""
        import os

        if self.environment is not None and name in self.environment:
            return self.environment[name]
        return os.environ.get(name, default)

    def env_flag(self, name: str, default: bool = False) -> bool:
        """Boolean training flag: ``1/t/true/y/yes/on`` (case-insensitive)
        are true, ``0/f/false/n/no/off`` false; anything else falls back to
        ``default`` (reference: training.py ``env_flag``)."""
        val = self.env_var(name)
        if val is None:
            return default
        low = val.strip().lower()
        if low in ("1", "t", "true", "y", "yes", "on"):
            return True
        if low in ("0", "f", "false", "n", "no", "off"):
            return False
        return default

    def random_generator(self) -> np.random.Generator:
        return random_generator(self.rng)

    def configured_device(self, *, use_default_rng: bool = False) -> torch.device:
        """The device training runs on: the card unless :attr:`device` says
        otherwise.  ``use_default_rng`` is the JAX package's keyword and, as
        there, changes nothing."""
        return resolve_device(self.device)


@runtime_checkable
class Trainable(Protocol):  # pragma: no cover - protocol
    """Protocol for trainable components (reference: training.py:232)."""

    def train(self, data: Any, options: TrainingOptions = ...) -> None: ...


class ModelTrainer(ABC):
    """
    Epoch-by-epoch trainer (reference: training.py:345).

    Supports mid-training evaluation (for iterative hyperparameter tuning)
    and checkpoint/resume via parameter containers.
    """

    @abstractmethod
    def train_epoch(self) -> float | torch.Tensor | None:
        """Train one epoch; returns a loss/delta metric if available."""

    @abstractmethod
    def finalize(self) -> None:
        """Finish training and install results on the scorer."""

    def get_parameters(self) -> dict[str, object]:
        """Current parameter state (reference: state/_container.py:14)."""
        raise NotImplementedError

    def load_parameters(self, state: dict[str, object]) -> None:
        raise NotImplementedError


class UsesTrainer:
    """
    Mixin driving a :class:`ModelTrainer` for a configured number of epochs
    (reference: training.py:271; loop at :319-329).

    Subclasses implement ``create_trainer`` and have a ``config.epochs``.
    """

    trainer_class: type[ModelTrainer] | None = None

    @property
    def expected_training_epochs(self) -> int:
        cfg = getattr(self, "config", None)
        return int(getattr(cfg, "epochs", 1))

    def create_trainer(self, data: Any, options: TrainingOptions) -> ModelTrainer:
        raise NotImplementedError

    def train(self, data: Any, options: TrainingOptions | None = None) -> None:
        options = options or TrainingOptions()
        if not options.retrain and getattr(self, "is_trained", False):
            return
        trainer = self.create_trainer(data, options)
        log = get_logger(type(self).__module__)
        n = self.expected_training_epochs
        with item_progress(f"train {type(self).__name__}", n) as pb:
            for epoch in range(n):
                metric = trainer.train_epoch()
                # the metric may be a device scalar: do NOT float() it here, that
                # would wait for the device every epoch and stop the host from
                # queueing the next epoch's work
                log.debug("epoch finished", epoch=epoch + 1, metric=metric if isinstance(metric, (int, float)) else None)
                pb.update()
        trainer.finalize()
        self.is_trained = True


# the name some reference documentation uses
IterativeTraining = UsesTrainer
