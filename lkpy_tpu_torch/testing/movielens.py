"""MovieLens test fixtures (port of ``lkpy_tpu/testing/movielens.py``;
reference: src/lenskit/testing/_movielens.py:47)."""

from __future__ import annotations

from pathlib import Path

#: where ml-latest-small is looked for: ``data/ml-latest-small`` under the
#: working directory, then under the checkout that holds the package
ML_CANDIDATES = [
    Path("data/ml-latest-small"),
    Path(__file__).resolve().parents[2] / "data" / "ml-latest-small",
]


def ml_test_dir() -> Path:
    """The first of :data:`ML_CANDIDATES` that exists; FileNotFoundError
    where none does."""
    for c in ML_CANDIDATES:
        if c.exists():
            return c
    raise FileNotFoundError("no bundled MovieLens test data found")
