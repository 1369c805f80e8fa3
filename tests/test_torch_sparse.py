"""Parity tests for the port's training layout: ``bucket_rows``
(``lkpy_tpu_torch.ops.sparse``) and ``chunk_buckets``/``chunk_stats``
(``lkpy_tpu_torch.ops.als``) give the JAX package's arrays for the same
CSR.  Inputs are made with numpy from a seed and handed to both."""

import numpy as np
import pytest
import torch

from lkpy_tpu.data.matrix import CSR as JaxCSR
from lkpy_tpu.ops import als as jax_als
from lkpy_tpu.ops import sparse as jax_sparse
from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.ops import als as torch_als
from lkpy_tpu_torch.ops import sparse as torch_sparse

torch.set_num_threads(1)

INT32_MAX = np.iinfo(np.int32).max


def _csrs(seed, n_rows=300, n_cols=120, empty_every=7, with_values=True):
    """The same skewed random matrix as a JAX-package CSR and a port CSR;
    every ``empty_every``-th row has no entries."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, size=n_rows), n_cols)
    lens[::empty_every] = 0
    rows = np.repeat(np.arange(n_rows), lens)
    cols = np.concatenate([rng.choice(n_cols, size=n, replace=False) for n in lens])
    vals = rng.uniform(0.5, 5.0, size=len(rows)).astype(np.float32) if with_values else None
    shape = (n_rows, n_cols)
    return JaxCSR.from_coo(rows, cols, vals, shape), CSR.from_coo(rows, cols, vals, shape)


def _assert_buckets_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.width == r.width and g.n == r.n
        np.testing.assert_array_equal(g.rows, np.asarray(r.rows))
        np.testing.assert_array_equal(g.cols, np.asarray(r.cols))
        np.testing.assert_array_equal(g.mask, np.asarray(r.mask))
        if r.values is None:
            assert g.values is None
        else:
            np.testing.assert_array_equal(g.values, np.asarray(r.values))


@pytest.mark.parametrize("ratio", [1.35, 2.0])
@pytest.mark.parametrize("max_width", [None, 24])
@pytest.mark.parametrize("field", ["rating", None])
def test_bucket_rows_matches_jax(ratio, max_width, field):
    jcsr, tcsr = _csrs(3)
    ref = jax_sparse.bucket_rows(jcsr, field=field, ratio=ratio, max_width=max_width)
    got = torch_sparse.bucket_rows(tcsr, field=field, ratio=ratio, max_width=max_width)
    _assert_buckets_equal(got, ref)
    # empty rows are left out; with max_width, long rows are truncated
    real = np.concatenate([b.rows[b.mask.any(axis=1)] for b in got])
    assert set(real) == set(np.nonzero(tcsr.row_lengths())[0])
    if max_width is not None:
        assert max(b.width for b in got) == max_width
        assert tcsr.row_lengths().max() > max_width


def test_bucket_rows_transpose_and_empty():
    jcsr, tcsr = _csrs(5, empty_every=3)
    _assert_buckets_equal(
        torch_sparse.bucket_rows(tcsr.transpose(), ratio=1.35), jax_sparse.bucket_rows(jcsr.transpose(), ratio=1.35)
    )
    jcsr, tcsr = _csrs(5, with_values=False)
    assert torch_sparse.bucket_rows(tcsr)[0].values is None
    empty = CSR.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64), None, (4, 5))
    assert torch_sparse.bucket_rows(empty) == []


@pytest.mark.parametrize("width", [None, 64])
def test_pad_rows_matches_jax(width):
    jcsr, tcsr = _csrs(9)
    rows = np.array([0, 5, 17, 42, 43], dtype=np.int32)
    ref = jax_sparse.pad_rows(jcsr, width=width, rows=rows)
    got = torch_sparse.pad_rows(tcsr, width=width, rows=rows)
    _assert_buckets_equal([got], [ref])
    with pytest.raises(ValueError, match="exceeds pad width"):
        torch_sparse.pad_rows(tcsr, width=1)


@pytest.mark.parametrize("ratio,entries", [(1.35, 4_000_000), (1.35, 600), (2.0, 900)])
@pytest.mark.parametrize("field", ["rating", None])
def test_chunk_buckets_and_stats_match_jax(ratio, entries, field):
    jcsr, tcsr = _csrs(11)
    jch = jax_als.chunk_buckets(jax_sparse.bucket_rows(jcsr, field=field, ratio=ratio), entries=entries)
    tch = torch_als.chunk_buckets(torch_sparse.bucket_rows(tcsr, field=field, ratio=ratio), entries=entries, device="cpu")
    assert len(tch) == len(jch)
    dummies = 0
    for g, r in zip(tch, jch):
        assert g.rows.dtype == torch.int32 and g.cols.dtype == torch.int32
        assert g.values.dtype == torch.float32 and g.mask.dtype == torch.bool
        for name in ("rows", "cols", "values", "mask"):
            np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(r, name)))
        # the real rows fill the first slots; the padding rows after them
        # carry INT32_MAX and no entries
        flat = g.rows.numpy().reshape(-1)
        assert (flat[: g.n_real] < INT32_MAX).all() and (flat[g.n_real :] == INT32_MAX).all()
        assert not g.mask.numpy().reshape(len(flat), -1)[g.n_real :].any()
        C, B = g.rows.shape
        assert sum(g.real_rows(c) for c in range(C)) == g.n_real
        dummies += len(flat) - g.n_real
    assert dummies > 0
    assert torch_als.chunk_stats(tch) == jax_als.chunk_stats(jch)
    if entries < 1000:
        assert any(g.rows.shape[0] > 1 for g in tch)  # buckets split into several chunks
