"""
Seed and RNG management.

Port of ``lkpy_tpu/random.py`` (reference: src/lenskit/random.py:30-60):
``random_generator``, ``set_global_rng``, derivable per-key seeds.  The JAX
package's ``jax_key`` has no counterpart: the port draws its random numbers
with NumPy generators, and the same seed gives the same NumPy generator as
in the JAX package (the trainers' initial factors depend on that).

Design: a single root ``numpy.random.SeedSequence`` per process; components
derive child seeds by spawning or by hashing string keys into the entropy
stream, so results are reproducible regardless of execution order.
"""

from __future__ import annotations

import hashlib
from typing import Any, Sequence, TypeAlias

import numpy as np

__all__ = [
    "RNGInput",
    "SeedLike",
    "random_generator",
    "set_global_rng",
    "global_rng_seed",
    "derive_seed",
    "int_seed",
    "spawn_seed",
]

SeedLike: TypeAlias = "int | Sequence[int] | np.random.SeedSequence"
RNGInput: TypeAlias = "SeedLike | np.random.Generator | None"

_global_seed: np.random.SeedSequence | None = None


def set_global_rng(seed: SeedLike) -> None:
    """Set the global root seed (reference: random.py ``set_global_rng``)."""
    global _global_seed
    _global_seed = _coerce_seed(seed)


def global_rng_seed() -> np.random.SeedSequence:
    """The global root seed sequence, creating a default if unset."""
    global _global_seed
    if _global_seed is None:
        _global_seed = np.random.SeedSequence()
    return _global_seed


def _coerce_seed(seed: SeedLike | None) -> np.random.SeedSequence:
    if seed is None:
        return global_rng_seed()
    if isinstance(seed, np.random.SeedSequence):
        return seed
    if isinstance(seed, (int, np.integer)):
        return np.random.SeedSequence(int(seed))
    return np.random.SeedSequence([int(s) for s in seed])


def derive_seed(*keys: Any, base: SeedLike | None = None) -> np.random.SeedSequence:
    """
    Derive a child seed from string/int keys, deterministically: the same
    (base, keys) always yields the same child seed, so per-query and
    per-component RNG is reproducible (reference: src/lenskit/random.py).
    """
    root = _coerce_seed(base)
    raw = root.entropy
    if raw is None:
        raw_list: list[int] = []
    elif isinstance(raw, (int, np.integer)):
        raw_list = [int(raw)]
    else:
        raw_list = [int(x) for x in raw]
    # split arbitrary-size ints into 32-bit words (SeedSequence entropy can be 128-bit)
    entropy: list[int] = []
    for x in raw_list:
        if x == 0:
            entropy.append(0)
        while x > 0:
            entropy.append(x & 0xFFFF_FFFF)
            x >>= 32
    for key in keys:
        h = hashlib.blake2b(str(key).encode("utf8"), digest_size=8).digest()
        entropy.append(int.from_bytes(h, "little"))
    return np.random.SeedSequence(entropy)


def spawn_seed(base: SeedLike | None = None) -> np.random.SeedSequence:
    """Spawn a fresh child of the given (or global) seed."""
    return _coerce_seed(base).spawn(1)[0]


def random_generator(spec: RNGInput = None) -> np.random.Generator:
    """
    Obtain a NumPy generator from flexible input
    (reference: src/lenskit/random.py:30 ``random_generator``).
    """
    if isinstance(spec, np.random.Generator):
        return spec
    return np.random.default_rng(_coerce_seed(spec))


def int_seed(spec: RNGInput = None) -> int:
    """A 63-bit integer seed derived from the spec (for ``torch.Generator`` or hashing)."""
    if isinstance(spec, np.random.Generator):
        return int(spec.integers(0, 2**63 - 1))
    return int(_coerce_seed(spec).generate_state(1, dtype=np.uint64)[0] & 0x7FFF_FFFF_FFFF_FFFF)
