"""
Identity-keyed caches of device copies of host structures.

Port of ``lkpy_tpu/utils/residency.py``.  In the port one cache uses it:
the user-major structure that the kNN similarity build uploads to the card
(:mod:`lkpy_tpu_torch.ops.knn`), so that a rebuild over the same matrix
skips the upload and the transpose.  An entry is keyed by ``id(obj)`` with a
weakref identity guard (a recycled id never serves a stale value), leaves
when its host object dies, and the oldest entry goes past ``max_entries``.

Every instance registers itself so :func:`invalidate_all_residency` can
sweep the lot; :func:`lkpy_tpu_torch.batch.device.invalidate_device_cache`
calls it.
"""

from __future__ import annotations

import weakref
from typing import Any, Hashable

__all__ = ["ResidentCache", "invalidate_all_residency"]

#: weak registry: short-lived caches are collectable and do not accumulate
_REGISTRY: "weakref.WeakSet[ResidentCache]" = weakref.WeakSet()


def invalidate_all_residency() -> None:
    """Clear every live registered :class:`ResidentCache`."""
    for cache in list(_REGISTRY):
        cache.clear()


class ResidentCache:
    """A bounded cache of per-object device state, keyed by object identity.

    An entry is served only while the weakly referenced anchor is still the
    SAME object; entries drop when the anchor is collected, and the oldest
    goes past ``max_entries``.
    """

    def __init__(self, name: str, max_entries: int = 8):
        self.name = name
        self.max_entries = max_entries
        self._entries: dict = {}
        _REGISTRY.add(self)

    def get(self, anchor: Any, extra: Hashable = None):
        """The cached payload for ``anchor`` (+ optional extra key), or None."""
        hit = self._entries.get((id(anchor), extra))
        if hit is not None and hit[0]() is anchor:
            return hit[1]
        return None

    def put(self, anchor: Any, payload, extra: Hashable = None) -> None:
        """Cache ``payload`` for the lifetime of ``anchor``."""
        key = (id(anchor), extra)
        # the dict is bound here: at interpreter exit the instance may be gone before the last anchors
        entries = self._entries
        try:
            ref = weakref.ref(anchor, lambda _r, k=key, e=entries: e.pop(k, None))
        except TypeError:  # pragma: no cover - unweakrefable anchor
            return
        while len(entries) >= self.max_entries:
            entries.pop(next(iter(entries)))
        entries[key] = (ref, payload)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
