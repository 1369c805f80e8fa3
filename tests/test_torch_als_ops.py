"""Parity tests for the port's ALS serving operations (``lkpy_tpu_torch.ops.als``
and the fold-in of ``lkpy_tpu_torch.models.als``) against the JAX package on
the CPU.  Inputs are made with numpy from a seed and handed to both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lkpy_tpu.models import als as jax_models
from lkpy_tpu.ops import als as jax_ops
from lkpy_tpu_torch.models import als as torch_models
from lkpy_tpu_torch.ops import als as torch_ops

torch.set_num_threads(1)


def _bucket(rng, B, P, n_items, k):
    lens = rng.integers(0, P + 1, size=B)
    mask = np.arange(P)[None, :] < lens[:, None]
    cols = np.where(mask, rng.integers(0, n_items, size=(B, P)), 0).astype(np.int32)
    vals = np.where(mask, rng.uniform(0.5, 5.0, size=(B, P)), 0.0).astype(np.float32)
    right = (rng.standard_normal((n_items, k)) * 0.3).astype(np.float32)
    return cols, vals, mask, right


@pytest.mark.parametrize("n,k", [(50, 8), (400, 16), (1000, 64)])
def test_implicit_otor(n, k):
    rng = np.random.default_rng(n + k)
    right = rng.standard_normal((n, k)).astype(np.float32)
    ref = np.asarray(jax_ops.implicit_otor(jnp.asarray(right), jnp.float32(0.1)))
    got = torch_ops.implicit_otor(torch.from_numpy(right), 0.1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("B,P,k", [(16, 64, 8), (40, 128, 16), (7, 64, 64)])
def test_solve_implicit_bucket(B, P, k):
    rng = np.random.default_rng(B * P + k)
    cols, vals, mask, right = _bucket(rng, B, P, 300, k)
    otor = np.array(jax_ops.implicit_otor(jnp.asarray(right), jnp.float32(0.1)))
    conf = vals * 40.0
    ref = np.asarray(jax_ops.solve_implicit_bucket(*map(jnp.asarray, (cols, conf, mask, right, otor))))
    got = torch_ops.solve_implicit_bucket(
        torch.from_numpy(cols).long(),
        torch.from_numpy(conf),
        torch.from_numpy(mask),
        torch.from_numpy(right),
        torch.from_numpy(otor),
    ).numpy()
    # tolerance of tests/batch/test_serving_property.py::test_fold_in_matches_per_query_scoring
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("with_vals", [False, True])
def test_fold_implicit_kernel(with_vals):
    rng = np.random.default_rng(7)
    cols, vals, mask, right = _bucket(rng, 24, 64, 200, 16)
    otor = np.array(jax_ops.implicit_otor(jnp.asarray(right), jnp.float32(0.1)))
    v = vals if with_vals else None
    jv = None if v is None else jnp.asarray(v)
    ref_u, ref_b = jax_models._fold_implicit_kernel(
        jnp.asarray(cols), jv, jnp.asarray(mask), jnp.asarray(right), jnp.asarray(otor), jnp.float32(40.0)
    )
    tv = None if v is None else torch.from_numpy(v)
    got_u, got_b = torch_models._fold_implicit_kernel(
        torch.from_numpy(cols).long(), tv, torch.from_numpy(mask), torch.from_numpy(right), torch.from_numpy(otor), 40.0
    )
    np.testing.assert_allclose(got_u.numpy(), np.asarray(ref_u), rtol=2e-3, atol=1e-4)
    # implicit MF has no user bias: the JAX kernel returns zeros, the port None
    assert got_b is None
    assert not np.asarray(ref_b).any()
