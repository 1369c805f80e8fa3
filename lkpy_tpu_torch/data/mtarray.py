"""
Multi-backend array wrapper.

Port of ``lkpy_tpu/data/mtarray.py`` (reference: src/lenskit/data/_mtarray.py:26
``MTArray``): one logical array, converted lazily between NumPy, Torch and
Arrow, each conversion cached.  ``torch()`` gives a CPU tensor, as the JAX
package's does.  The port imports no JAX, so ``jax()`` raises.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["MTArray"]


class MTArray:
    """A lazily-converting multi-backend array."""

    def __init__(self, array: Any):
        self._cache: dict[str, Any] = {}
        self._cache[self._kind_of(array)] = array
        self._shape = tuple(array.shape) if hasattr(array, "shape") else (len(array),)

    @staticmethod
    def _kind_of(array: Any) -> str:
        mod = type(array).__module__
        if mod.startswith("jax"):
            return "jax"
        if mod.startswith("torch"):
            return "torch"
        if mod.startswith("pyarrow"):
            return "arrow"
        return "numpy"

    @property
    def shape(self) -> tuple[int, ...]:
        return self._shape

    def numpy(self) -> np.ndarray:
        if "numpy" not in self._cache:
            src_kind, src = next(iter(self._cache.items()))
            if src_kind == "arrow":
                self._cache["numpy"] = src.to_numpy(zero_copy_only=False)
            elif src_kind == "torch":
                self._cache["numpy"] = src.detach().cpu().numpy()
            else:
                self._cache["numpy"] = np.asarray(src)
        return self._cache["numpy"]

    def jax(self):
        raise NotImplementedError(
            "MTArray.jax: lkpy_tpu_torch imports no JAX; use numpy() and jax.numpy.asarray, or lkpy_tpu's MTArray"
        )

    def torch(self):
        if "torch" not in self._cache:
            import torch

            self._cache["torch"] = torch.from_numpy(np.ascontiguousarray(self.numpy()))
        return self._cache["torch"]

    def arrow(self):
        if "arrow" not in self._cache:
            import pyarrow as pa

            self._cache["arrow"] = pa.array(self.numpy())
        return self._cache["arrow"]

    def to(self, format: str):
        return getattr(self, format)()

    def __len__(self) -> int:
        return self._shape[0]
