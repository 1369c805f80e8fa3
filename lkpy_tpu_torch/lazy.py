"""Deferred pipeline inputs (port of ``lkpy_tpu/lazy.py``; reference:
src/lenskit/lazy.py:21 ``Lazy``)."""

from __future__ import annotations

from typing import Callable, Generic, Protocol, TypeVar, runtime_checkable

T = TypeVar("T", covariant=True)

__all__ = ["Lazy", "LazyValue"]


@runtime_checkable
class Lazy(Protocol[T]):  # pragma: no cover - protocol
    """Protocol for lazily-computed values."""

    def get(self) -> T: ...


class LazyValue(Generic[T]):
    """A lazy value from a thunk, memoized."""

    def __init__(self, thunk: Callable[[], T]):
        self._thunk = thunk
        self._set = False
        self._value: T | None = None

    def get(self) -> T:
        if not self._set:
            self._value = self._thunk()
            self._set = True
        return self._value  # type: ignore[return-value]
