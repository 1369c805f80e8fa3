"""
Component instance cache (port of ``lkpy_tpu/pipeline/cache.py``; reference: src/lenskit/pipeline/_cache.py:37
``PipelineCache``): share component instances across pipelines keyed by
(class, config-hash), so e.g. tuning loops reuse trained components.
"""

from __future__ import annotations

import json
from typing import Any

from lkpy_tpu_torch.pipeline.components import Component

__all__ = ["PipelineCache"]


class PipelineCache:
    def __init__(self):
        self._cache: dict[tuple[str, str], Any] = {}

    def _make_key(self, ctor: type, config: Any) -> tuple[str, str]:
        if isinstance(config, dict):
            cfg = config
        elif config is None:
            cfg = {}
        elif hasattr(config, "model_dump"):
            cfg = config.model_dump(mode="json")
        else:
            cfg = dict(config)
        return (f"{ctor.__module__}:{ctor.__qualname__}", json.dumps(cfg, sort_keys=True))

    def get_cached(self, ctor: type, config: Any):
        return self._cache.get(self._make_key(ctor, config))

    def cache(self, ctor: type, config: Any, instance: Any):
        self._cache[self._make_key(ctor, config)] = instance

    def get_instance(self, ctor: type, config: Any):
        """Get or construct a component instance (reference: _cache.py:67)."""
        inst = self.get_cached(ctor, config)
        if inst is None:
            if issubclass(ctor, Component):
                inst = ctor(ctor.validate_config(config if isinstance(config, dict) else (config.model_dump() if hasattr(config, "model_dump") else config)))
            else:
                inst = ctor()
            self.cache(ctor, config, inst)
        return inst
