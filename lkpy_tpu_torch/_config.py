"""
Configuration handling shared by the port's scorers: ``Scorer(config)``,
``Scorer({...})`` and ``Scorer(**kwargs)`` all yield a validated config
object (what ``lkpy_tpu.pipeline.components.Component`` does for the JAX
package's components).
"""

from __future__ import annotations

from pydantic import BaseModel

__all__ = ["validated_config"]


def validated_config(config_class: type[BaseModel], config, kwargs: dict) -> BaseModel:
    """The ``config_class`` object for a constructor's ``config`` argument
    (an object, a dict or None) and keyword arguments."""
    if config is not None and kwargs:
        raise TypeError("pass a config object or keyword args, not both")
    if config is None:
        return config_class.model_validate(kwargs)
    if isinstance(config, dict):
        return config_class.model_validate(config)
    if not isinstance(config, config_class):
        raise TypeError(f"invalid config of type {type(config)}, expected {config_class.__name__}")
    return config
