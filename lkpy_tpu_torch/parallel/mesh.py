"""
Device mesh management.

Port of ``lkpy_tpu/parallel/mesh.py`` (reference: src/lenskit/parallel/
config.py:34 ``init_threading``): a ``data`` axis for batch and row
parallelism and a ``model`` axis for sharded tables.

The JAX mesh is single-controller: one process drives a grid of its local
devices and GSPMD moves the shards.  Its counterpart here is a grid of
``torch.device`` slots in one process.  Every move from one slot to another
is an explicit ``.to(slot device)``, so distinct cards need no other code
path, and a device may fill several slots: the CPU tests, and one card,
run a mesh of several slots with the same splitting, per-slot launches and
merges as a mesh of distinct cards.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lkpy_tpu_torch._device import resolve_device

__all__ = ["Mesh", "MeshSpec", "make_mesh", "get_mesh"]

_current_mesh: "Mesh | None" = None

AXES = ("data", "model")


@dataclass
class MeshSpec:
    """Logical mesh shape: data (batch/rows) × model (table shards)."""

    data: int = -1  # -1 = all remaining devices
    model: int = 1

    def resolve(self, n_devices: int | None = None) -> tuple[int, int]:
        n = n_devices if n_devices is not None else torch.cuda.device_count()
        model = max(self.model, 1)
        data = self.data if self.data > 0 else max(n // model, 1)
        if data * model > n:
            raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
        return data, model


class Mesh:
    """A ``(data, model)`` grid of device slots; ``shape`` is
    ``{"data": d, "model": m}`` as the JAX mesh's."""

    def __init__(self, grid: list[list[torch.device]]):
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.grid = tuple(tuple(torch.device(d) for d in row) for row in grid)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.grid), "model": len(self.grid[0])}

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The slots along ``axis`` (at index 0 of the other axis)."""
        if axis == "data":
            return [row[0] for row in self.grid]
        if axis == "model":
            return list(self.grid[0])
        raise ValueError(f"unknown mesh axis {axis!r}; expected one of {AXES}")

    @property
    def first(self) -> torch.device:
        """The first slot's device: where merged results and tables live."""
        return self.grid[0][0]

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the grid once, in slot order."""
        return list(dict.fromkeys(d for row in self.grid for d in row))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.grid]})"


def make_mesh(spec: MeshSpec | None = None, *, devices=None) -> Mesh:
    """Create (and set as current) a 2-D ('data', 'model') mesh over
    ``devices`` (default: every visible card).  A device may be named more
    than once; each naming is a slot."""
    global _current_mesh
    spec = spec or MeshSpec()
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    data, model = spec.resolve(len(devs))
    _current_mesh = Mesh([devs[r * model : (r + 1) * model] for r in range(data)])
    return _current_mesh


def get_mesh() -> Mesh:
    """The current mesh, creating the default one (every card on the
    ``data`` axis) if unset."""
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = make_mesh()
    return _current_mesh
