"""The port's accumulators (``lkpy_tpu_torch.data.accum``) and
``BatchedRange`` (``lkpy_tpu_torch.data.batches``) against the JAX
package's on the same inputs, made with numpy from a seed: equal lists,
statistics within 1e-12 (both use NumPy) and equal batches."""

import math

import numpy as np
import pytest

from lkpy_tpu.data import BatchedRange as JaxBatchedRange
from lkpy_tpu.data import accum as jax_accum
from lkpy_tpu_torch.data import BatchedRange
from lkpy_tpu_torch.data import accum


def _values(seed):
    rng = np.random.default_rng(seed)
    vals = list(rng.normal(size=int(rng.integers(0, 40))))
    for pos in rng.integers(0, len(vals) + 1, 3):
        vals.insert(int(pos), None if pos % 2 else float("nan"))
    return vals


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("default", [0.0, None, 2.5])
def test_value_stats_match_jax(seed, default):
    got, want = accum.ValueStatAccumulator(default), jax_accum.ValueStatAccumulator(default)
    for v in _values(seed):
        got.add(v)
        want.add(v)
    g, w = got.accumulate(), want.accumulate()
    assert set(g) == set(w) == {"mean", "median", "std", "min", "max", "count"}
    assert g["count"] == w["count"]
    for key in ("mean", "median", "std", "min", "max"):
        if math.isnan(w[key]):
            assert math.isnan(g[key])
        else:
            assert g[key] == pytest.approx(w[key], rel=1e-12, abs=1e-12)


def test_empty_and_single_value_stats():
    for mod in (accum, jax_accum):
        empty = mod.ValueStatAccumulator().accumulate()
        assert empty["count"] == 0 and math.isnan(empty["mean"])
        one = mod.ValueStatAccumulator()
        one.add(3)
        assert one.accumulate() == {"mean": 3.0, "median": 3.0, "std": 0.0, "min": 3.0, "max": 3.0, "count": 1}


def test_object_list_and_protocols_match_jax():
    got, want = accum.ObjectListAccumulator(), jax_accum.ObjectListAccumulator()
    for v in ["a", 1, None, (2, 3)]:
        got.add(v)
        want.add(v)
    assert got.accumulate() == want.accumulate() == ["a", 1, None, (2, 3)]
    assert len(got) == len(want) == 4
    assert isinstance(got, accum.Accumulator) and isinstance(accum.ValueStatAccumulator(), accum.Accumulator)
    assert accum.__all__ == jax_accum.__all__


@pytest.mark.parametrize("n,batch", [(0, 4), (1, 4), (10, 3), (12, 4), (7, 100)])
def test_batched_range_matches_jax(n, batch):
    got, want = BatchedRange(n, batch), JaxBatchedRange(n, batch)
    assert len(got) == len(want)
    assert list(got) == list(want)
    assert list(got.slices()) == list(want.slices())
    covered = np.concatenate([np.arange(n)[s] for s in got.slices()] or [np.zeros(0, int)])
    np.testing.assert_array_equal(covered, np.arange(n))
