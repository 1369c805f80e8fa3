"""
Exception and warning taxonomy (copied from ``lkpy_tpu/diagnostics.py``;
reference: src/lenskit/diagnostics.py:12-55): the same class names as the
JAX package, so both raise the same errors.
"""

__all__ = [
    "DataWarning",
    "DataError",
    "FieldError",
    "ConfigWarning",
    "PipelineError",
    "PipelineWarning",
    "TypecheckWarning",
]


class DataWarning(UserWarning):
    """Warning raised for detectable problems with input data."""


class DataError(Exception):
    """Error raised for problems with input data."""


class FieldError(KeyError):
    """A requested entity/relationship field does not exist
    (reference: diagnostics.py:24)."""

    def __init__(self, entity, field):
        super().__init__(f"{entity}[{field}]")


class ConfigWarning(UserWarning):
    """Warning raised for detectable problems with component configuration."""


class PipelineError(Exception):
    """Pipeline structure or execution error (cycles, missing inputs, type errors)."""


class PipelineWarning(Warning):
    """Warning raised for detectable problems with pipeline configuration."""


class TypecheckWarning(UserWarning):
    """Warning raised when a pipeline connection cannot be statically
    type-checked (reference: diagnostics.py ``TypecheckWarning``)."""
