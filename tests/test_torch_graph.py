"""The port's graph propagation (``lkpy_tpu_torch.ops.graph``) against the JAX
package's on the CPU.

Both packages get the same normalized bipartite graph, made with numpy from
a seed (300 users × 180 items, 10 items without any user, LightGCN's
symmetric weights), and the same float32 tables (k = 8).  Tolerances:
``sorted_conv`` and the dense adjacency equal; the sparse propagation and
its gradient of a scalar function within 1e-5 (relative to the largest
entry) of JAX's segment sums and ``jax.grad``, the CSR Function within 1e-5
of the plain ``index_add_`` product and its autograd gradient; the dense
bf16 route's products, forward and backward, within 1e-5 of float64 sums
of the same bf16-rounded operands, and the whole route and its gradient
within 1e-5 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lkpy_tpu.models.lightgcn import LightGCNConfig as JaxLightGCNConfig
from lkpy_tpu.ops import graph as jax_graph
from lkpy_tpu_torch.models.lightgcn import LightGCNConfig
from lkpy_tpu_torch.ops import graph
from lkpy_tpu_torch.ops.graph import build_dense_adjacency, propagate, propagate_dense, sorted_conv, spmm_plain

torch.set_num_threads(1)

N_USERS, N_ITEMS, EMPTY_ITEMS, K = 300, 180, 10, 8
TOL = 1e-5


def _edges(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, size=N_USERS) + 3, 60)
    rows = np.repeat(np.arange(N_USERS), lens).astype(np.int32)
    cols = np.concatenate([np.sort(rng.choice(N_ITEMS - EMPTY_ITEMS, size=n, replace=False)) for n in lens]).astype(np.int32)
    deg_u = np.maximum(np.bincount(rows, minlength=N_USERS), 1).astype(np.float32)
    deg_i = np.maximum(np.bincount(cols, minlength=N_ITEMS), 1).astype(np.float32)
    vals = (1.0 / np.sqrt(deg_u[rows] * deg_i[cols])).astype(np.float32)
    return rows, cols, vals


@pytest.fixture(scope="module")
def data():
    rows, cols, vals = _edges()
    rng = np.random.default_rng(1)
    u = rng.standard_normal((N_USERS, K)).astype(np.float32) * 0.1
    i = rng.standard_normal((N_ITEMS, K)).astype(np.float32) * 0.1
    wu = rng.standard_normal((N_USERS, K)).astype(np.float32)
    wi = rng.standard_normal((N_ITEMS, K)).astype(np.float32)
    return rows, cols, vals, u, i, wu, wi


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"relative error {err:.3e} above {tol}"


def test_sorted_conv_equals_jax(data):
    rows, cols, vals = data[:3]
    got = sorted_conv(rows, cols, vals, N_USERS, N_ITEMS, device="cpu")
    want = jax_graph.sorted_conv(rows, cols, vals, N_USERS, N_ITEMS)
    assert got[3:5] == want[3:5]
    for g, w in zip(got[:3] + got[5:], want[:3] + want[5:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _blend(layer_blend, layers):
    got = LightGCNConfig(layer_count=layers, layer_blend=layer_blend).blend_weights()
    want = JaxLightGCNConfig(layer_count=layers, layer_blend=layer_blend).blend_weights()
    np.testing.assert_array_equal(got, want)
    return got


def _torch_conv(rows, cols, vals, form):
    if form == 8:
        return sorted_conv(rows, cols, vals, N_USERS, N_ITEMS, device="cpu")
    # the 5-tuple promises no order: shuffle the edges
    order = np.random.default_rng(2).permutation(len(rows))
    return (torch.from_numpy(rows[order]), torch.from_numpy(cols[order]), torch.from_numpy(vals[order]), N_USERS, N_ITEMS)


def _jax_conv(conv):
    return tuple(jnp.asarray(c.numpy()) if isinstance(c, torch.Tensor) else c for c in conv)


@pytest.mark.parametrize("form", [5, 8])
@pytest.mark.parametrize("layer_blend,layers", [(None, 2), (0.5, 3), ([0.7, 0.3], 2), (None, 1)])
def test_propagate_and_gradient_match_jax(data, form, layer_blend, layers):
    rows, cols, vals, u, i, wu, wi = data
    blend = _blend(layer_blend, layers)
    conv = _torch_conv(rows, cols, vals, form)
    jconv = _jax_conv(conv)

    def jloss(u, i):
        ua, ia = jax_graph.propagate(u, i, jconv, jnp.asarray(blend))
        return jnp.sum(ua * wu) + jnp.sum(ia * wi)

    (ju, ji) = jax_graph.propagate(jnp.asarray(u), jnp.asarray(i), jconv, jnp.asarray(blend))
    jgu, jgi = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(i))

    tu = torch.from_numpy(u).requires_grad_()
    ti = torch.from_numpy(i).requires_grad_()
    ua, ia = propagate(tu, ti, conv, blend)
    (torch.sum(ua * torch.from_numpy(wu)) + torch.sum(ia * torch.from_numpy(wi))).backward()
    _close(ua.detach(), ju)
    _close(ia.detach(), ji)
    _close(tu.grad, jgu)
    _close(ti.grad, jgi)


def test_csr_function_matches_plain(data):
    rows, cols, vals, u, i, wu, wi = data
    conv = sorted_conv(rows, cols, vals, N_USERS, N_ITEMS, device="cpu")
    a, a_t = graph._csr_pair(conv)
    r, c, v = conv[:3]
    x = torch.from_numpy(i).requires_grad_()
    y = torch.from_numpy(u).requires_grad_()
    got_u = graph._CSRMM.apply(x, a, a_t)
    got_i = graph._CSRMM.apply(y, a_t, a)
    (torch.sum(got_u * torch.from_numpy(wu)) + torch.sum(got_i * torch.from_numpy(wi))).backward()
    gx, gy = x.grad.clone(), y.grad.clone()
    x.grad = y.grad = None
    want_u = spmm_plain(v, c, r, x, N_USERS)
    want_i = spmm_plain(v, r, c, y, N_ITEMS)
    (torch.sum(want_u * torch.from_numpy(wu)) + torch.sum(want_i * torch.from_numpy(wi))).backward()
    _close(got_u.detach(), want_u.detach())
    _close(got_i.detach(), want_i.detach())
    _close(gx, x.grad)
    _close(gy, y.grad)


def test_spmm_chunked_matches_jax(data, monkeypatch):
    rows, cols, vals, u, i = data[:5]
    for module in (graph, jax_graph):
        monkeypatch.setattr(module, "_SPMM_CHUNK", 257)
        monkeypatch.setattr(module, "_SPMM_CHUNK_MIN", 1000)
    assert len(rows) >= 1000 and len(rows) % 257  # a ragged last chunk
    got = spmm_plain(torch.from_numpy(vals), torch.from_numpy(cols), torch.from_numpy(rows), torch.from_numpy(i), N_USERS)
    want = jax_graph._spmm_chunked(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(rows), jnp.asarray(i), N_USERS)
    _close(got, want)
    got_i = graph._spmm_chunked(torch.from_numpy(vals), torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(u), N_ITEMS)
    want_i = jax_graph._spmm_chunked(jnp.asarray(vals), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(u), N_ITEMS)
    _close(got_i, want_i)
    # the 5-tuple JAX propagate takes the chunked route at the lowered threshold
    conv = sorted_conv(rows, cols, vals, N_USERS, N_ITEMS, device="cpu")
    blend = np.full(3, 1 / 3, dtype=np.float32)
    ju, ji = jax_graph.propagate(jnp.asarray(u), jnp.asarray(i), _jax_conv(conv), jnp.asarray(blend))
    tu, ti = propagate(torch.from_numpy(u), torch.from_numpy(i), conv, blend)
    _close(tu, ju)
    _close(ti, ji)


def test_dense_adjacency_equals_jax(data):
    rows, cols, vals = data[:3]
    got = build_dense_adjacency(torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals), N_USERS, N_ITEMS)
    want = jax_graph.build_dense_adjacency(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), N_USERS, N_ITEMS)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (304, 256)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, dtype=np.float32))
    assert not graph.dense_adjacency_eligible(len(rows), N_USERS, N_ITEMS)
    assert not graph.dense_adjacency_eligible(14_000_000, 138_000, 27_000)


def _bf16(a):
    return np.asarray(torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double())


@pytest.mark.parametrize("fn", ["mm", "tmm"])
def test_dense_functions_match_float64(data, fn):
    """Each Function's forward and backward: one product of bf16-rounded
    operands, against float64 sums of the same operands."""
    rows, cols, vals, u, i, wu, wi = data
    adj = build_dense_adjacency(torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals), N_USERS, N_ITEMS)
    A = adj.double().numpy()
    if fn == "tmm":
        func, A, x, w = graph._AdjTMM, A.T, u, wi
    else:
        func, x, w = graph._AdjMM, i, wu
    x_pad = np.zeros((A.shape[1], K), np.float32)
    x_pad[: len(x)] = x
    w_pad = np.zeros((A.shape[0], K), np.float32)
    w_pad[: len(w)] = w
    tx = torch.from_numpy(x_pad).requires_grad_()
    out = func.apply(adj, tx)
    (out * torch.from_numpy(w_pad)).sum().backward()
    assert out.dtype == torch.float32
    _close(out.detach(), A @ _bf16(x_pad))
    _close(tx.grad, A.T @ _bf16(w_pad))


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_propagate_dense_matches_jax(data, layers):
    rows, cols, vals, u, i, wu, wi = data
    blend = np.full(layers + 1, 1 / (layers + 1), dtype=np.float32)
    adj = build_dense_adjacency(torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals), N_USERS, N_ITEMS)
    tu = torch.from_numpy(u).requires_grad_()
    ti = torch.from_numpy(i).requires_grad_()
    ua, ia = propagate_dense(tu, ti, adj, blend)
    assert tuple(ua.shape) == (N_USERS, K) and tuple(ia.shape) == (N_ITEMS, K)
    (torch.sum(ua * torch.from_numpy(wu)) + torch.sum(ia * torch.from_numpy(wi))).backward()

    jadj = jax_graph.build_dense_adjacency(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), N_USERS, N_ITEMS)

    def jloss(u, i):
        a, b = jax_graph.propagate_dense(u, i, jadj, jnp.asarray(blend))
        return jnp.sum(a * wu) + jnp.sum(b * wi)

    jua, jia = jax_graph.propagate_dense(jnp.asarray(u), jnp.asarray(i), jadj, jnp.asarray(blend))
    jgu, jgi = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(i))
    _close(ua.detach(), jua)
    _close(ia.detach(), jia)
    _close(tu.grad, jgu)
    _close(ti.grad, jgi)
