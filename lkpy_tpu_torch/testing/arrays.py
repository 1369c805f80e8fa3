"""
Hypothesis strategies for arrays and item lists (port of
``lkpy_tpu/testing/arrays.py``; reference:
src/lenskit/testing/_arrays.py:25-91), built on the port's ``ItemList``
and ``CSR``.
"""

from __future__ import annotations

import numpy as np
from hypothesis import strategies as st
from hypothesis.extra import numpy as nph

from lkpy_tpu_torch.data import ItemList
from lkpy_tpu_torch.data.matrix import CSR

__all__ = ["sparse_csr", "scored_lists", "coo_arrays"]


@st.composite
def coo_arrays(draw, max_rows: int = 50, max_cols: int = 50, max_nnz: int = 200):
    """Random COO triples with unique (row, col) pairs."""
    nrows = draw(st.integers(1, max_rows))
    ncols = draw(st.integers(1, max_cols))
    nnz = draw(st.integers(0, min(max_nnz, nrows * ncols)))
    cells = draw(
        st.lists(
            st.tuples(st.integers(0, nrows - 1), st.integers(0, ncols - 1)),
            min_size=nnz,
            max_size=nnz,
            unique=True,
        )
    )
    rows = np.asarray([c[0] for c in cells], dtype=np.int64)
    cols = np.asarray([c[1] for c in cells], dtype=np.int64)
    vals = draw(
        nph.arrays(np.float32, len(cells), elements=st.floats(-10, 10, width=32))
    )
    return rows, cols, vals, (nrows, ncols)


@st.composite
def sparse_csr(draw, **kwargs):
    """Random CSR matrices (reference: _arrays.py sparse strategies)."""
    rows, cols, vals, shape = draw(coo_arrays(**kwargs))
    return CSR.from_coo(rows, cols, vals, shape)


@st.composite
def scored_lists(draw, max_len: int = 100, scores: str = "maybe"):
    """Random scored ItemLists (reference: _arrays.py ``scored_lists``)."""
    n = draw(st.integers(0, max_len))
    ids = draw(
        st.lists(st.integers(1, 10_000), min_size=n, max_size=n, unique=True)
    )
    svals = None
    if scores == "yes" or (scores == "maybe" and draw(st.booleans())):
        svals = draw(
            nph.arrays(
                np.float32,
                n,
                elements=st.floats(-100, 100, width=32, allow_nan=False),
            )
        )
    return ItemList(item_ids=np.asarray(ids, dtype=np.int64), scores=svals)
