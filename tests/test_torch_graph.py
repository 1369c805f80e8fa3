"""The port's graph propagation (``lkpy_tpu_torch.ops.graph``) against the JAX
package's on the CPU.

Both packages get the same normalized bipartite graph, made with numpy from
a seed (300 users × 180 items, 10 items without any user, LightGCN's
symmetric weights), and the same float32 tables (k = 8).  Tolerances:
``sorted_conv`` equal; the sparse propagation and its gradient of a scalar
function within 1e-5 (relative to the largest entry) of JAX's segment sums
and ``jax.grad``, the CSR Function within 1e-5 of the plain ``index_add_``
product and its autograd gradient.
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
from lkpy_tpu_torch.ops.graph import propagate, sorted_conv, spmm_plain

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


# ---------------------------------------------------------------------------
# the plan of the hand SpMM (csrc/spmm.cu), built with torch ops on any device
def _pair(data):
    rows, cols, vals = data[:3]
    return graph._csr_pair(sorted_conv(rows, cols, vals, N_USERS, N_ITEMS, device="cpu"))


def _kernel_sum(parts, x, n):
    """The plan's launches summed in order as the kernel sums them: each work
    item's rows or segment, a tiled part's from its tile's staged rows, then
    the scratch rows of each long row (or of each row's tiles) in order.
    Every row must be written."""
    k = x.shape[1]
    x = x.double()
    out = torch.full((n, k), float("nan"), dtype=torch.float64)
    for plan in parts:
        partial = torch.full((plan.n_slots, k), float("nan"), dtype=torch.float64)

        def row_sum(r, lo, hi):
            src = plan.src[lo:hi].long()
            if plan.tile_src is not None:
                # the tile's rows as the block stages them: columns count from its first source row
                t = r // plan.red_rows.shape[0]
                first, last = int(plan.tile_src[t]), int(plan.tile_src[t + 1])
                assert bool((src < last - first).all())
                got = x[first:last][src]
            else:
                got = x[src]
            return (plan.vals[lo:hi].double()[:, None] * got).sum(0)

        edges, rows, slots = plan.work_edge.tolist(), plan.work_row.tolist(), plan.work_slot.tolist()
        for i, slot in enumerate(slots):
            if slot >= 0:
                partial[slot] = row_sum(rows[i], edges[i], edges[i + 1])
            else:
                for r in range(rows[i], rows[i + 1]):
                    got = row_sum(r, int(plan.rowptr[r]), int(plan.rowptr[r + 1]))
                    if plan.row_slot is None:
                        out[r] = got
                    else:
                        partial[int(plan.row_slot[r])] = got
        ptr = plan.red_ptr.tolist()
        for j, r in enumerate(plan.red_rows.tolist()):
            out[r] = partial[ptr[j] : ptr[j + 1]].sum(0)
    assert not torch.isnan(out).any()
    return out


@pytest.mark.parametrize("blocks", [None, 1, 3])
def test_user_side_is_one_launch_of_the_csr(data, blocks):
    """SU gathers item rows through the read-only path: one launch over the
    CSR's own edges, no tiles, nothing from shared memory, one plan for
    every ``k``."""
    rows, cols, vals = data[:3]
    a, _ = _pair(data)
    (plan,) = a.plan(K, blocks)
    assert plan.tile_src is None and plan.row_slot is None and plan.staged == 0 and plan.hot_edges == 0
    np.testing.assert_array_equal(plan.rowptr.numpy(), np.r_[0, np.cumsum(np.bincount(rows, minlength=N_USERS))])
    np.testing.assert_array_equal(plan.src.numpy(), cols)
    np.testing.assert_array_equal(plan.vals.numpy(), vals)
    assert a.plan(16, blocks) is a.plan(50, blocks) is a.plan(K, blocks)


@pytest.mark.parametrize("tile_rows", [4, 16, 64])
def test_tiles_decode_to_the_csr(data, monkeypatch, tile_rows):
    """SI's two parts hold the item side's edges exactly once: the narrow
    rows' edges as the CSR has them, the wide rows' (at least 4 edges a
    block of 3) through their tiles, each tile's columns counted from its
    first user, within ``tile_rows`` users; every tiled edge is counted as
    read from shared memory."""
    monkeypatch.setattr(graph, "_TILE_BYTES", 4 * K * tile_rows)
    monkeypatch.setattr(graph, "_WIDE_EDGES", 4)
    rows, cols, vals = data[:3]
    _, a_t = _pair(data)
    narrow, wide = a_t.plan(K, 3)
    deg = np.bincount(cols, minlength=N_ITEMS)
    is_wide = deg >= 12
    got = list(zip(graph._dst(narrow.rowptr).tolist(), narrow.src.tolist(), narrow.vals.tolist()))
    assert not any(is_wide[i] for i, _, _ in got)
    out_rows, starts, wptr = wide.red_rows.numpy(), wide.tile_src.numpy(), wide.rowptr.numpy()
    n_wide = out_rows.shape[0]
    assert np.diff(starts).max() <= tile_rows
    for r in range(wptr.shape[0] - 1):
        t, j = divmod(r, n_wide)
        for u, v in zip(wide.src[wptr[r] : wptr[r + 1]].tolist(), wide.vals[wptr[r] : wptr[r + 1]].tolist()):
            assert 0 <= u < starts[t + 1] - starts[t]
            got.append((int(out_rows[j]), int(starts[t] + u), v))
    assert sorted(got) == sorted(zip(cols.tolist(), rows.tolist(), vals.tolist()))
    assert wide.hot_edges == len(wide.vals) == int(deg[is_wide].sum()) and narrow.hot_edges == 0


def test_five_and_eight_tuple_give_the_same_plan(data, monkeypatch):
    monkeypatch.setattr(graph, "_TILE_BYTES", 4 * K * 33)
    monkeypatch.setattr(graph, "_WIDE_EDGES", 4)
    rows, cols, vals = data[:3]
    eight = graph._csr_pair(sorted_conv(rows, cols, vals, N_USERS, N_ITEMS, device="cpu"))
    five = graph._csr_pair(_torch_conv(rows, cols, vals, 5))
    for x, y in zip(eight, five):
        assert x.shape == y.shape and len(x.plan(K, 3)) == len(y.plan(K, 3)) == 1 + x.tiled
        for px, py in zip(x.plan(K, 3), y.plan(K, 3)):
            for f in graph.SpmmPlan._fields:
                u, v = getattr(px, f), getattr(py, f)
                if isinstance(u, torch.Tensor):
                    assert torch.equal(u, v), f
                else:
                    assert u == v, f


def test_eight_tuple_plans_once(data):
    conv = sorted_conv(*data[:3], N_USERS, N_ITEMS, device="cpu")
    a, a_t = graph._csr_pair(conv)
    assert graph._csr_pair(conv)[0] is a and graph._csr_pair(tuple(conv))[1] is a_t
    assert a.plan(K) is a.plan(K)
    # another 8-tuple over the same rows but other values plans anew
    other = conv[:2] + (conv[2] * 2,) + conv[3:7] + (conv[7] * 2,)
    assert graph._csr_pair(other)[0] is not a


@pytest.mark.parametrize("seg,group_rows", [(1024, 256), (16, 4), (3, 1)])
@pytest.mark.parametrize("blocks", [None, 3, 1])
def test_plan_summed_as_the_kernel_sums_matches_plain(data, monkeypatch, seg, group_rows, blocks):
    """Each orientation's launches emulated from the plan, at lowered item
    sizes; with ``blocks`` the item side's tiles hold 1 KB of user rows and
    rows of 4 edges a block are wide, so both its parts run."""
    monkeypatch.setattr(graph, "_SEG", seg)
    monkeypatch.setattr(graph, "_TILE_SEG", seg)
    monkeypatch.setattr(graph, "_GROUP_ROWS", group_rows)
    monkeypatch.setattr(graph, "_TILE_BYTES", 1024)
    monkeypatch.setattr(graph, "_WIDE_EDGES", 4)
    rows, cols, vals, u, i = data[:5]
    a, a_t = _pair(data)
    tv, tr, tc = torch.from_numpy(vals), torch.from_numpy(rows), torch.from_numpy(cols)
    for op, x, want in (
        (a, i, spmm_plain(tv, tc, tr, torch.from_numpy(i), N_USERS)),
        (a_t, u, spmm_plain(tv, tr, tc, torch.from_numpy(u), N_ITEMS)),
    ):
        parts = op.plan(K, blocks)
        assert len(parts) == (2 if op is a_t and blocks else 1)
        for plan in parts:
            edges = plan.work_edge.numpy()
            assert edges[0] == 0 and edges[-1] == len(plan.vals) and (np.diff(edges) >= 0).all()
            for e, r, slot in zip(np.diff(edges), np.diff(plan.work_row.numpy()), plan.work_slot.numpy()):
                assert (e <= seg and r <= 1) if slot >= 0 else (e < 2 * seg + 1 and r <= group_rows)
        assert sum(len(p.vals) for p in parts) == len(vals)
        if len(parts) == 2:
            # the wide rows: those of at least 4 edges a block; each tile's source rows within 1 KB
            deg = np.bincount(cols, minlength=N_ITEMS)
            wide = parts[1]
            np.testing.assert_array_equal(wide.red_rows.numpy(), np.flatnonzero(deg >= 4 * blocks))
            assert wide.blocks == blocks and wide.row_slot is not None
            n_wide, starts = wide.red_rows.shape[0], wide.tile_src.numpy()
            assert starts[0] == 0 and starts[-1] == N_USERS and (np.diff(starts) >= 0).all()
            assert wide.staged == np.diff(starts).max() <= 1024 // (4 * K) and wide.hot_edges == len(wide.vals)
            assert (len(starts) - 1) % blocks == 0 and len(starts) - 1 >= graph.tile_count(N_USERS, K, blocks)
            items, vrows = wide.tile_item.numpy(), wide.work_row.numpy()
            assert items[0] == 0 and items[-1] == len(vrows) - 1
            for t in range(len(starts) - 1):
                assert ((vrows[items[t] : items[t + 1]] // n_wide) == t).all()
                lo, hi = wide.rowptr[t * n_wide], wide.rowptr[(t + 1) * n_wide]
                assert (wide.src[lo:hi].numpy() < starts[t + 1] - starts[t]).all()
        _close(_kernel_sum(parts, torch.from_numpy(x), op.shape[0]), want)


def test_wide_part_gives_way_where_no_tile_fits(monkeypatch):
    """A run of users with no edge to a wide item, longer than a tile may
    hold, cannot be cut by equal-edge tiles: the item side is one launch,
    still equal to the plain product."""
    monkeypatch.setattr(graph, "_TILE_BYTES", 4 * K * 20)
    monkeypatch.setattr(graph, "_WIDE_EDGES", 40)
    rng = np.random.default_rng(5)
    # item 0 (80 edges) is the one wide row at 40 edges a block of 2: users 0-39 and 100-139 rate
    # it, users 40-99 (60 rows, a tile holds 20) do not
    rows, cols = [], []
    for u in range(140):
        items = rng.choice(np.arange(1, 30), 3, replace=False) if 40 <= u < 100 else np.r_[0, rng.choice(np.arange(1, 30), 2, replace=False)]
        items = np.sort(items)
        rows += [u] * len(items)
        cols += list(items)
    rows, cols = np.array(rows, np.int32), np.array(cols, np.int32)
    vals = rng.uniform(0.1, 1.0, len(rows)).astype(np.float32)
    a_t = graph._csr_pair(sorted_conv(rows, cols, vals, 140, 30, device="cpu"))[1]
    parts = a_t.plan(K, 2)
    assert len(parts) == 1 and parts[0].tile_src is None
    u = torch.from_numpy(rng.standard_normal((140, K)).astype(np.float32))
    want = spmm_plain(torch.from_numpy(vals), torch.from_numpy(rows).long(), torch.from_numpy(cols).long(), u, 30)
    _close(_kernel_sum(parts, u, 30), want)
    # tiles of 80 rows hold the run: item 0 is summed tile by tile
    monkeypatch.setattr(graph, "_TILE_BYTES", 4 * K * 80)
    parts = graph._csr_pair(sorted_conv(rows, cols, vals, 140, 30, device="cpu"))[1].plan(K, 2)
    assert len(parts) == 2 and parts[1].red_rows.tolist() == [0]
    _close(_kernel_sum(parts, u, 30), want)


def test_tiles_follow_the_table_and_the_grid():
    # ML-20M's user table at k = 64 is 35 MB: 2 tiles a block of 132, each within 200 KB
    assert graph.tile_count(138_493, 64, 132) == 264
    assert graph.tile_count(138_493, 16, 132) == 132
    assert graph.tile_count(26_744, 64, 132) == 132
    assert graph.tile_count(138_493, 256, 132) == graph.tile_count(138_493, 128, 132) == 396


def test_products_count_their_hot_edges_on_the_cpu(data):
    from lkpy_tpu_torch.logging import counts, record_spans

    rows, cols, vals, u, i = data[:5]
    conv = sorted_conv(rows, cols, vals, N_USERS, N_ITEMS, device="cpu")
    before = counts()
    with record_spans():
        propagate(torch.from_numpy(u), torch.from_numpy(i), conv, np.full(3, 1 / 3, dtype=np.float32))
    added = {k: counts().get(k, 0) - before.get(k, 0) for k in ("graph.spmm_products", "graph.spmm_edges", "graph.spmm_hot_edges")}
    assert added == {"graph.spmm_products": 4, "graph.spmm_edges": 4 * len(vals), "graph.spmm_hot_edges": 0}
