"""
Component base class and config machinery.

Port of ``lkpy_tpu/pipeline/components.py``; capability parity with the
reference ``Component``
(reference: src/lenskit/pipeline/components.py:65,144) — components carry a
validated configuration object (pydantic model or dataclass), are callable,
and round-trip their configuration as JSON-able dicts.  Input introspection
(reference: components.py:218 ``component_inputs``) is done from the
``__call__`` signature.
"""

from __future__ import annotations

import dataclasses
import inspect
import sys
from importlib import import_module
from typing import Any, ClassVar, get_type_hints

from pydantic import BaseModel, TypeAdapter

__all__ = ["Component", "component_inputs", "instantiate_component"]


class Component:
    """
    Base class for pipeline components.

    Subclasses declare their configuration class with a ``config:`` annotation
    (a pydantic model, pydantic dataclass, or plain dataclass) and implement
    ``__call__``.  ``Component(config)`` or ``Component(**kwargs)`` both work.
    """

    config: Any = None

    CONFIG_CLASS: ClassVar[type | None] = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # discover config class from the class's own `config` annotation
        # (reference: components.py:102-144 config discovery); only that
        # annotation is evaluated, so a component that is also an
        # nn.Module does not depend on the module's own annotations
        cfg = cls.__dict__.get("__annotations__", {}).get("config")
        if isinstance(cfg, str):
            try:
                cfg = eval(cfg, vars(sys.modules[cls.__module__]), dict(vars(cls)))
            except (NameError, AttributeError):  # a name defined later: inherit
                cfg = None
        if isinstance(cfg, type):
            cls.CONFIG_CLASS = cfg
        # else inherit parent's CONFIG_CLASS

    def __init__(self, config: Any = None, **kwargs):
        ccls = self.CONFIG_CLASS
        if config is not None and kwargs:
            raise TypeError("pass a config object or keyword args, not both")
        if ccls is None:
            self.config = None
            return
        if config is None:
            self.config = ccls(**kwargs)
        elif isinstance(config, ccls):
            self.config = config
        elif isinstance(config, dict):
            self.config = self.validate_config(config)
        else:
            raise TypeError(f"invalid config of type {type(config)}, expected {ccls}")

    @classmethod
    def validate_config(cls, data: dict | None) -> Any:
        if cls.CONFIG_CLASS is None:
            return None
        data = data or {}
        if isinstance(cls.CONFIG_CLASS, type) and issubclass(cls.CONFIG_CLASS, BaseModel):
            return cls.CONFIG_CLASS.model_validate(data)
        return TypeAdapter(cls.CONFIG_CLASS).validate_python(data)

    def dump_config(self) -> dict[str, Any]:
        """The configuration as a JSON-able dict."""
        if self.config is None:
            return {}
        if isinstance(self.config, BaseModel):
            return self.config.model_dump(mode="json")
        if dataclasses.is_dataclass(self.config):
            return TypeAdapter(type(self.config)).dump_python(self.config, mode="json")
        return dict(self.config)

    def __call__(self, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.dump_config()!r}>"

    def __eq__(self, other):
        return type(self) is type(other) and self.dump_config() == other.dump_config()

    def __hash__(self):
        return hash((type(self), str(self.dump_config())))


def component_inputs(component: Any) -> dict[str, type | None]:
    """
    The input (parameter) names and types of a component, from its call
    signature (reference: components.py:218).
    """
    fn = component.__call__ if not inspect.isfunction(component) else component
    sig = inspect.signature(fn)
    try:
        hints = get_type_hints(fn)
    except Exception:
        hints = {}
    inputs = {}
    for name, param in sig.parameters.items():
        if name in ("self",) or param.kind in (param.VAR_POSITIONAL, param.VAR_KEYWORD):
            continue
        inputs[name] = hints.get(name)
    return inputs


def class_path(obj: type) -> str:
    return f"{obj.__module__}:{obj.__qualname__}"


def instantiate_component(path: str, config: dict | None) -> Any:
    """Instantiate a component from a ``module:Class`` path and config dict."""
    mod_name, _, qual = path.partition(":")
    mod = import_module(mod_name)
    obj: Any = mod
    for part in qual.split("."):
        obj = getattr(obj, part)
    if isinstance(obj, type) and issubclass(obj, Component):
        return obj(obj.validate_config(config))
    if isinstance(obj, type):
        return obj(**(config or {}))
    return obj

