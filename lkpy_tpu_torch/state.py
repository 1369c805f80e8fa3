"""
Parameter serialization for checkpoint and resume.

Port of ``lkpy_tpu/state.py`` (reference: src/lenskit/state/_container.py:14
``ParameterContainer``): the ``get_parameters``/``load_parameters`` protocol
of the ALS, FlexMF and LightGCN trainers and scorers, and checkpoint files
as compressed NPZ in the JAX package's layout, so a checkpoint either
package writes loads into the other's trainer or scorer.
"""

from __future__ import annotations

from os import PathLike
from pathlib import Path
from typing import Protocol, runtime_checkable

import numpy as np
import torch

__all__ = ["ParameterContainer", "save_parameters", "load_parameters"]


@runtime_checkable
class ParameterContainer(Protocol):  # pragma: no cover - protocol
    """Objects whose learned parameters can be extracted and restored."""

    def get_parameters(self) -> dict[str, object]: ...

    def load_parameters(self, state: dict[str, object]) -> None: ...


def save_parameters(obj: ParameterContainer, path: str | PathLike) -> None:
    """Checkpoint an object's parameters to a compressed .npz file; tensors
    are copied to the host, entries that are None are left out."""
    arrays = {}
    for k, v in obj.get_parameters().items():
        if v is None:
            continue
        arrays[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    np.savez_compressed(Path(path), **arrays)


def load_parameters(obj: ParameterContainer, path: str | PathLike, **kwargs) -> None:
    """Restore parameters checkpointed with :func:`save_parameters` (of
    either package).  A trainer places the arrays on its training device; a
    scorer on the card unless given ``device="cpu"`` (``kwargs`` go to its
    ``load_parameters``)."""
    with np.load(Path(path)) as data:
        state = {k: data[k] for k in data.files}
    obj.load_parameters(state, **kwargs)
