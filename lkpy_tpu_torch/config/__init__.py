"""
Global configuration and the configuration helpers of the port's component
configs.

Port of ``lkpy_tpu/config/__init__.py`` (reference:
src/lenskit/config/__init__.py:55,79 ``lenskit_config``/``configure`` and
src/lenskit/schemas/settings.py:218 ``LenskitSettings``): the same
:class:`Settings` read from the same files (``lkpy-tpu.toml`` and
``lkpy-tpu.local.toml`` at the configuration root), the same ``LKT_*``
environment variables and context-local :func:`configure` overrides, so one
file configures both packages.  Read by the ALS trainers
(``training_perf.ladder_ratio``) and by batch serving (``serving``).  The
JAX package's compile-cache machinery has no counterpart here.
"""

from __future__ import annotations

import os
import tomllib
from contextlib import contextmanager
from contextvars import ContextVar
from pathlib import Path
from typing import Any, Literal

from pydantic import BaseModel, Field, model_validator

__all__ = [
    "Settings",
    "ParallelSettings",
    "MachineSettings",
    "PrometheusSettings",
    "CompileCacheSettings",
    "ServingSettings",
    "TrainingPerfSettings",
    "load_config",
    "lkpy_tpu_config",
    "locate_configuration_root",
    "configure",
    "EmbeddingSizeMixin",
]

CONFIG_FILES = ["lkpy-tpu.toml", "lkpy-tpu.local.toml"]
ENV_PREFIX = "LKT_"


class ParallelSettings(BaseModel):
    """Parallelism knobs (reference: schemas/settings.py:104
    ``ParallelSettings``); no reader in the port yet."""

    processes: int | None = None
    threads: int | None = None
    backend_threads: int | None = None
    data_axis: int = -1
    "Mesh data-axis size (−1 = all remaining devices)."
    model_axis: int = 1
    "Mesh model-axis size (row-sharded tables)."


class MachineSettings(BaseModel):
    """The JAX package's platform preference; the port has no reader (its
    entry points take ``device``)."""

    platform: Literal["tpu", "cpu", "default"] = "default"


class PrometheusSettings(BaseModel):
    """Prometheus power scrape (reference: schemas/settings.py:68); no
    reader in the port yet."""

    url: str | None = None
    power_queries: dict[str, str] = Field(default_factory=dict)


class CompileCacheSettings(BaseModel):
    """The JAX package's persistent XLA compilation cache.  The port has no
    reader: its CUDA kernels are built once into ``build/lkpy_tpu_torch/``
    (``ops/_build.py``)."""

    enabled: bool = True
    dir: str | None = None
    min_compile_secs: float = 1.0


class ServingSettings(BaseModel):
    """Batch-serving policy, read by
    :func:`lkpy_tpu_torch.batch.device.device_recommend_async`.

    ``exact`` and ``approx_min_items`` resolve as in the JAX package, but
    every route of the port is exact (the TPU's approximate top-k has no
    counterpart), so they change no result.  ``readback_precision="f16"``
    returns the scores rounded to float16 (finite ones clamped to its
    range), the result the JAX package's compact readback gives; ``"auto"``
    and ``"f32"`` return float32 scores, as the JAX package does off a TPU.
    Item ids and the order of the lists are the same either way."""

    exact: bool | None = None
    approx_min_items: int = 200_000
    readback_precision: str = "auto"


class TrainingPerfSettings(BaseModel):
    """Training policy.  ``ladder_ratio`` is the ratio of the bucket-width
    ladder the ALS trainers bucket rows with
    (:func:`lkpy_tpu_torch.ops.sparse.bucket_rows`): a finer ladder pads
    fewer slots, a coarser one makes fewer, larger chunks."""

    ladder_ratio: float = 1.35


class Settings(BaseModel):
    """Root settings (reference: schemas/settings.py:218)."""

    random_seed: int | None = None
    parallel: ParallelSettings = Field(default_factory=ParallelSettings)
    machine: MachineSettings = Field(default_factory=MachineSettings)
    prometheus: PrometheusSettings = Field(default_factory=PrometheusSettings)
    compile_cache: CompileCacheSettings = Field(default_factory=CompileCacheSettings)
    serving: ServingSettings = Field(default_factory=ServingSettings)
    training_perf: TrainingPerfSettings = Field(default_factory=TrainingPerfSettings)
    data_dir: str | None = None


_loaded: Settings | None = None
_overrides: ContextVar[Settings | None] = ContextVar("lkt_config_overrides", default=None)


def _deep_merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _env_overrides() -> dict:
    """Parse LKT_SECTION_FIELD=value env vars into nested dicts."""
    out: dict[str, Any] = {}
    fields = Settings.model_fields
    for key, val in os.environ.items():
        if not key.startswith(ENV_PREFIX):
            continue
        path = key[len(ENV_PREFIX):].lower()
        # try to match "section_field" to nested models
        parts = path.split("_")
        node = out
        # greedy: if first token names a nested model, nest
        if parts[0] in fields and len(parts) > 1 and isinstance(fields[parts[0]].default_factory, type):
            node = out.setdefault(parts[0], {})
            path = "_".join(parts[1:])
        try:
            parsed: Any = tomllib.loads(f"v = {val}")["v"]
        except tomllib.TOMLDecodeError:
            parsed = val
        node[path] = parsed
    return out


def locate_configuration_root(
    *,
    cwd: Path | str | None = None,
    abort_at_pyproject: bool = True,
    abort_at_gitroot: bool = True,
) -> Path | None:
    """Search upward from ``cwd`` for a directory containing an
    ``lkpy-tpu.toml`` (reference: config/__init__.py:200
    ``locate_configuration_root``).  The search stops — returning None — at
    the first directory holding a ``pyproject.toml`` or ``.git`` without a
    config file, so a project cannot accidentally inherit configuration
    from outside its own root."""
    cur = Path(cwd) if cwd is not None else Path.cwd()
    cur = cur.resolve()
    while True:
        # ANY config file anchors the root (load_config merges them all) —
        # a directory holding only the gitignored local-override file must
        # still be recognized (round-5 review)
        if any((cur / name).exists() for name in CONFIG_FILES):
            return cur
        if abort_at_pyproject and (cur / "pyproject.toml").exists():
            return None
        if abort_at_gitroot and (cur / ".git").exists():
            return None
        if cur.parent == cur:
            return None
        cur = cur.parent


def load_config(root: Path | str | None = None) -> Settings:
    data: dict = {}
    if root is None:
        root = locate_configuration_root() or Path.cwd()
    root = Path(root)
    for name in CONFIG_FILES:
        f = root / name
        if f.exists():
            with open(f, "rb") as fp:
                data = _deep_merge(data, tomllib.load(fp))
    data = _deep_merge(data, _env_overrides())
    return Settings.model_validate(data)


def lkpy_tpu_config() -> Settings:
    """The active configuration (reference: config/__init__.py:55)."""
    ov = _overrides.get()
    if ov is not None:
        return ov
    global _loaded
    if _loaded is None:
        _loaded = load_config()
    return _loaded


@contextmanager
def configure(**kwargs):
    """Context-local configuration overrides (reference: config/__init__.py:79)."""
    base = lkpy_tpu_config()
    merged = Settings.model_validate(_deep_merge(base.model_dump(), kwargs))
    token = _overrides.set(merged)
    try:
        yield merged
    finally:
        _overrides.reset(token)


class EmbeddingSizeMixin:
    """Power-of-two embedding-size sugar (reference: config/common.py:16
    ``EmbeddingSizeMixin``): configs accept ``embedding_size_exp`` to set
    ``embedding_size = 2**exp`` for hyperparameter sweeps."""

    @model_validator(mode="before")
    @classmethod
    def _apply_embedding_exp(cls, data):
        if isinstance(data, dict) and "embedding_size_exp" in data:
            data = dict(data)
            exp = data.pop("embedding_size_exp")
            data.setdefault("embedding_size", 2 ** int(exp))
        return data
