"""
Exceptions of the port's data layer (copied from ``lkpy_tpu/diagnostics.py``;
reference: src/lenskit/diagnostics.py).
"""

__all__ = ["DataError"]


class DataError(Exception):
    """Error raised for problems with input data."""
