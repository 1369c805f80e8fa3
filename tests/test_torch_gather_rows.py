"""The port's row gather against the JAX package on the CPU.

``gather_rows`` replaces the Pallas kernels of
``benchmarks/probe_gather.py`` (DMA semaphores and scalar prefetch, which
run only on a TPU), so the oracle is the probe's own check, XLA's
``table[idx]`` under ``jax.jit``, and the same expression where the JAX
package's ALS gathers factor rows (``lkpy_tpu/ops/als.py:117``,
``G = right[cols]``).  On the CPU the wrapper runs its plain version; the
kernel is held against it on the card in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lkpy_tpu_torch.ops import als as torch_als
from lkpy_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain

torch.set_num_threads(1)

#: the JAX package's factor gather, ``right[cols]`` (lkpy_tpu/ops/als.py:117)
_jax_gather = jax.jit(lambda right, cols: right[cols])


@pytest.mark.parametrize("K", [1, 50, 64, 128])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("M", [0, 1, 37])
def test_plain_equals_jax_gather(K, dtype, M):
    rng = np.random.default_rng(K * 100 + M)
    n = 300
    table = rng.standard_normal((n, K)).astype(np.float32)
    idx = rng.integers(0, n, (M,)).astype(dtype)
    if M > 1:
        idx[0] = 0  # padding slots point at column 0 (ops/sparse.py)
        idx[-1] = n - 1  # the last row
    want = np.asarray(_jax_gather(jnp.asarray(table), jnp.asarray(idx)))
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == (M, K) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # a (B, P) block of column numbers, as a training chunk hands it over
    cols = rng.integers(0, n, (5, M)).astype(dtype)
    got2 = gather_rows_plain(torch.from_numpy(table), torch.from_numpy(cols))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(_jax_gather(jnp.asarray(table), jnp.asarray(cols))))


def test_probe_check_bit_equal():
    """The probe's own shapes and check (``main``: a (27,000, 128) table from
    ``default_rng(42)``, 65,536 int32 rows, ``jax.jit(lambda i: t[i])``)."""
    rng = np.random.default_rng(42)
    table = rng.standard_normal((27_000, 128)).astype(np.float32)
    idx = rng.integers(0, 27_000, 1 << 16).astype(np.int32)
    t = jnp.asarray(table)
    want = np.asarray(jax.jit(lambda i: t[i])(jnp.asarray(idx)))
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_views_and_checks():
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.standard_normal(64 * 53 + 1).astype(np.float32))
    view = base[1:].view(64, 53)[:, 2:52]  # offset, row stride 53, width 50
    idx = torch.tensor([[63, 0], [7, 7]])
    assert torch.equal(gather_rows(view, idx), view[idx])
    before = gather_rows.launches
    gather_rows(view, idx.int())
    assert gather_rows.launches == before  # CPU tensors never launch the kernel
    with pytest.raises(TypeError):
        gather_rows(view.double(), idx)
    with pytest.raises(TypeError):
        gather_rows(view, idx.float())
    with pytest.raises(IndexError):
        gather_rows(view, torch.tensor([64]))


def test_als_gather_goes_through_gather_rows(monkeypatch):
    calls = []

    def counting(table, idx):
        calls.append((tuple(table.shape), tuple(idx.shape)))
        return gather_rows(table, idx)

    monkeypatch.setattr(torch_als, "gather_rows", counting)
    rng = np.random.default_rng(2)
    right = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, 40, (6, 5)).astype(np.int32))
    mask = torch.ones((6, 5), dtype=torch.bool)
    conf = torch.full((6, 5), 40.0)
    x = torch_als.solve_implicit_bucket(cols, conf, mask, right, torch_als.implicit_otor(right, 0.1))
    assert x.shape == (6, 8) and calls == [((40, 8), (6, 5))]
    torch_als.solve_explicit_bucket(cols, conf, mask, right, 0.1)
    assert len(calls) == 2


@pytest.mark.parametrize("family", ["implicit", "explicit"])
def test_per_query_scoring_goes_through_gather_rows_and_spd_solve(monkeypatch, family):
    # one query scores where the tables lie: the fold-in gathers the history
    # rows and solves a bucket of one, and the candidates' rows are gathered
    import pandas as pd

    from lkpy_tpu_torch.data import ItemList, RecQuery, from_interactions_df
    from lkpy_tpu_torch.models import als as als_models
    from lkpy_tpu_torch.ops import spd_solve as spd_module
    from lkpy_tpu_torch.training import TrainingOptions

    gathers, solves = [], []

    def counting_gather(table, idx):
        gathers.append(tuple(idx.shape))
        return gather_rows(table, idx)

    def counting_solve(A, y):
        solves.append(tuple(y.shape))
        return spd_module.spd_solve(A, y)

    monkeypatch.setattr(torch_als, "gather_rows", counting_gather)
    monkeypatch.setattr(als_models, "gather_rows", counting_gather)
    monkeypatch.setattr(torch_als, "spd_solve", counting_solve)
    rng = np.random.default_rng(9)
    u, i = rng.integers(0, 30, 600), rng.integers(0, 25, 600)
    ds = from_interactions_df(pd.DataFrame({"user_id": u, "item_id": i, "rating": rng.uniform(1, 5, 600)}))
    if family == "implicit":
        scorer = als_models.ImplicitMFScorer(features=8, epochs=2)
    else:
        scorer = als_models.BiasedMFScorer(features=8, epochs=2)
    scorer.train(ds, TrainingOptions(rng=1, device="cpu"))
    hist = ds.interaction_matrix().row_items(ds.users.ids[0])
    gathers.clear()
    out = scorer(RecQuery(user_id=ds.users.ids[0], user_items=hist), ItemList(item_ids=np.array([3, 4, 999])))
    assert solves == [(1, 8)] and gathers == [(1, len(hist)), (2,)]
    scores = out.scores()
    assert np.isfinite(scores[:2]).all() and np.isnan(scores[2])
