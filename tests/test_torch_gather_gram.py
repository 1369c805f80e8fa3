"""The port's gather-and-Gram step against the JAX package on the CPU.

``gather_gram`` forms the ALS normal equations of a bucket of rows: on the
card one hand-written kernel gathers the factor rows and sums A and y (held
against the plain version in ``tests/test_torch_cuda.py``); on the CPU it
runs its plain version, which is held here against the JAX package's
per-chunk equations, ``_gram_scan_implicit`` and ``_gram_scan_explicit``
(``lkpy_tpu/ops/als.py:309``, ``:335``: ``right[cols]`` and einsums in
float32 on the CPU).  Inputs are made with numpy from a seed and handed to
both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lkpy_tpu.ops import als as jax_als
from lkpy_tpu_torch.ops import als as torch_als
from lkpy_tpu_torch.ops import gather_gram as gram_module
from lkpy_tpu_torch.ops.gather_gram import gather_gram, gather_gram_plain

torch.set_num_threads(1)

N_RIGHT, B, P = 40, 7, 9


def _bucket(rng, k: int, index_dtype):
    """A bucket of B rows: ragged prefix masks (lengths 1 to P), a row with
    holes (a mask that is not a prefix) and a row of padding only.  Masked
    slots carry in-range column numbers and nonzero values, which must add
    nothing."""
    right = rng.standard_normal((N_RIGHT, k)).astype(np.float32)
    cols = rng.integers(0, N_RIGHT, (B, P)).astype(index_dtype)
    vals = rng.uniform(0.5, 4.0, (B, P)).astype(np.float32)
    lens = np.array([P, 1, 4, P - 1, 6])
    mask = np.arange(P)[None, :] < lens[:, None]
    holes = rng.random(P) < 0.5
    holes[[0, -1]] = False, True
    mask = np.concatenate([mask, holes[None, :], np.zeros((1, P), dtype=bool)])
    X = rng.standard_normal((N_RIGHT, k)).astype(np.float32)
    otor = (X.T @ X / N_RIGHT + 0.1 * np.eye(k)).astype(np.float32)
    return right, cols, vals, mask, otor


def _assert_lower_close(A, y, A_ref, y_ref):
    # both sum P float32 products in another order (XLA's dot against
    # torch.bmm): each entry rounds within a few units of P·2⁻²⁴ of the sum
    # of magnitudes, which max|A| bounds
    k = A.shape[-1]
    low = np.tril_indices(k)
    scale = max(float(np.abs(A_ref).max()), 1.0)
    np.testing.assert_allclose(A[:, low[0], low[1]], A_ref[:, low[0], low[1]], rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-6 * max(float(np.abs(y_ref).max()), 1.0))


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("k", [1, 8, 50, 64, 130])
def test_implicit_matches_jax_gram_scan(k, index_dtype):
    rng = np.random.default_rng(k * 3 + index_dtype().itemsize)
    right, cols, vals, mask, otor = _bucket(rng, k, index_dtype)
    A_ref, y_ref = jax_als._gram_scan_implicit(
        *(jnp.asarray(a)[None] for a in (cols, vals, mask)), jnp.asarray(right), jnp.asarray(otor)
    )
    A, y = gather_gram(
        torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(mask), torch.from_numpy(right),
        otor=torch.from_numpy(otor),
    )  # fmt: skip
    assert A.shape == (B, k, k) and y.shape == (B, k)
    _assert_lower_close(A.numpy(), y.numpy(), np.asarray(A_ref)[0], np.asarray(y_ref)[0])
    # the padding-only row: A = otor, y = 0
    np.testing.assert_array_equal(A[-1].numpy(), otor)
    assert not y[-1].any()


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("k", [1, 8, 50, 64, 130])
def test_explicit_matches_jax_gram_scan(k, index_dtype):
    rng = np.random.default_rng(k * 5 + index_dtype().itemsize)
    right, cols, vals, mask, _ = _bucket(rng, k, index_dtype)
    A_ref, y_ref = jax_als._gram_scan_explicit(
        *(jnp.asarray(a)[None] for a in (cols, vals, mask)), jnp.asarray(right), jnp.float32(0.1)
    )
    A, y = gather_gram(
        torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(mask), torch.from_numpy(right), reg=0.1
    )
    _assert_lower_close(A.numpy(), y.numpy(), np.asarray(A_ref)[0], np.asarray(y_ref)[0])
    # the padding-only row: A = 0 (a singular system, as in the JAX package), y = 0
    assert not A[-1].any() and not y[-1].any()


def test_checks_and_cpu_never_launches():
    rng = np.random.default_rng(0)
    right, cols, vals, mask, otor = (torch.from_numpy(a) for a in _bucket(rng, 8, np.int32))
    before = gather_gram.launches
    gather_gram(cols, vals, mask, right, reg=0.1)
    assert gather_gram.launches == before  # CPU tensors never launch the kernel
    with pytest.raises(ValueError):
        gather_gram(cols, vals, mask, right)  # neither otor nor reg
    with pytest.raises(ValueError):
        gather_gram(cols, vals, mask, right, otor=otor, reg=0.1)  # both
    with pytest.raises(TypeError):
        gather_gram(cols.float(), vals, mask, right, reg=0.1)
    with pytest.raises(TypeError):
        gather_gram(cols, vals, mask.float(), right, reg=0.1)
    with pytest.raises(ValueError):
        gather_gram(cols, vals[:, :3], mask, right, reg=0.1)
    with pytest.raises(ValueError):
        gather_gram(cols, vals, mask, torch.zeros((5, 257)), reg=0.1)
    with pytest.raises(ValueError):
        gather_gram(cols, vals, mask, right, otor=otor[:4, :4])


@pytest.mark.parametrize("entry", ["chunk implicit", "chunk explicit", "bucket implicit", "bucket explicit", "row implicit", "row explicit"])
def test_solves_go_through_gather_gram(monkeypatch, entry):
    """``_solve_chunk``, ``solve_*_bucket`` and ``solve_row_*`` form their
    equations through ``gather_gram`` (once a call, the gather inside it)
    and call no separate row gather."""
    grams, plain_gathers = [], []

    def counting_gram(cols, values, mask, right, **kw):
        grams.append(tuple(cols.shape))
        return gather_gram(cols, values, mask, right, **kw)

    def counting_rows(table, idx):
        plain_gathers.append(tuple(idx.shape))
        return table.index_select(0, idx.reshape(-1)).view(*idx.shape, table.shape[1])

    monkeypatch.setattr(torch_als, "gather_gram", counting_gram)
    monkeypatch.setattr(gram_module, "gather_rows_plain", counting_rows)
    assert not hasattr(torch_als, "gather_rows") and not hasattr(torch_als, "_gather")
    rng = np.random.default_rng(4)
    right_np, cols_np, vals_np, mask_np, otor_np = _bucket(rng, 8, np.int32)
    right, cols, vals, mask, otor = map(torch.from_numpy, (right_np, cols_np, vals_np, mask_np, otor_np))
    kind, mode = entry.split()
    if kind == "chunk":
        x = torch_als._solve_chunk(cols, vals, mask, right, otor, 0.1, mode)
        want = (B, P)
    elif kind == "bucket":
        fn = torch_als.solve_implicit_bucket if mode == "implicit" else torch_als.solve_explicit_bucket
        x = fn(cols[:-1], vals[:-1], mask[:-1], right, otor if mode == "implicit" else 0.1)
        want = (B - 1, P)
    else:
        items = torch.from_numpy(cols_np[0, :5].astype(np.int64))
        if mode == "implicit":
            x = torch_als.solve_row_implicit(items, vals[0, :5], right, otor)
        else:
            x = torch_als.solve_row_explicit(items, vals[0, :5], right, 0.1)
        want = (1, 5)
    assert grams == [want] and plain_gathers == [want]
    assert torch.isfinite(x[: want[0] - (kind == "chunk" and mode == "explicit")]).all()


def test_plain_is_the_unfused_route():
    """The plain version is the route the port took before the kernel:
    ``index_select``, the weighted copy and two batched products."""
    rng = np.random.default_rng(6)
    right, cols, vals, mask, otor = (torch.from_numpy(a) for a in _bucket(rng, 16, np.int64))
    G = right[cols]
    m = mask.float()
    A = otor + torch.bmm((G * (vals * m)[:, :, None]).transpose(1, 2), G)
    y = torch.bmm(G.transpose(1, 2), ((vals + 1) * m)[:, :, None])[:, :, 0]
    A2, y2 = gather_gram_plain(cols, vals, mask, right, otor=otor)
    assert torch.equal(A, A2) and torch.equal(y, y2)


def test_copy_width_is_the_route():
    """The copy width, which alone chooses the kernel's route on the card
    (4: the tensor cores; 2 and 1: the FMA kernel), from k, the row stride
    and the table's alignment."""
    from lkpy_tpu_torch.ops.gather_gram import copy_width

    base = torch.zeros(40 * 66 + 4)
    assert copy_width(base[: 40 * 64].view(40, 64)) == 4
    assert copy_width(base[4 : 4 + 40 * 64].view(40, 64)) == 4  # 16 bytes past the start
    assert copy_width(base[2 : 2 + 40 * 64].view(40, 64)) == 2
    assert copy_width(base[1 : 1 + 40 * 64].view(40, 64)) == 1
    assert copy_width(base[: 40 * 50].view(40, 50)) == 2  # k = 50: the FMA route
    assert copy_width(base[: 40 * 66].view(40, 66)[:, :64]) == 2  # rows 66 floats apart
    assert copy_width(base[: 20 * 65].view(20, 65)) == 1
    assert copy_width(base[: 40 * 64].view(40, 64)[:1]) == 4


def _tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, nearest,
    ties away from zero (the magnitude's bits rounded up at half)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tensor_core_gram(A_op: np.ndarray, X: np.ndarray, passes: int) -> np.ndarray:
    """The tensor route's sum of ``A_opᵀ X`` over the entries (rows): each
    operand split as big = tf32(x), small = tf32(x − big); per stage of 32
    entries the products (exact in float64: 11-bit significands) of
    big·big, or of small·big + big·small + big·big, summed into fresh
    fragments, then added to a segment's running float32 sums; the
    segments' sums (2,048 slots each, the widest a launch plan gives) added
    in order in float32."""
    ab = _tf32(A_op).astype(np.float64)
    a_s = _tf32(A_op - _tf32(A_op)).astype(np.float64)
    bb = _tf32(X).astype(np.float64)
    b_s = _tf32(X - _tf32(X)).astype(np.float64)
    k = X.shape[1]
    total = np.zeros((k, k), np.float32)
    for s0 in range(0, X.shape[0], 2048):
        segment = np.zeros((k, k), np.float32)
        for p0 in range(s0, min(s0 + 2048, X.shape[0]), 32):
            st = slice(p0, p0 + 32)
            part = ab[st].T @ bb[st]
            if passes == 3:
                part += a_s[st].T @ bb[st] + ab[st].T @ b_s[st]
            segment += part.astype(np.float32)
        total += segment
    return total


@pytest.mark.parametrize("ratings", ["none", "half-stars"])
def test_three_pass_tf32_passes_the_card_gate_and_one_pass_does_not(ratings):
    """The tolerance that the card's tests hold the kernel to
    (``tests/test_torch_cuda.py::_assert_gram_agrees``: within 1e-5 of the
    float64 sums' largest magnitude, and within rtol 1e-5 plus 1e-6 of that
    magnitude, or the plain version's own distance where larger, of the
    plain version) can tell the tensor route's three passes from one.  An
    implicit bucket of the training cell's widest item chunk, (4, 79,120)
    at k = 64, against a 138,493-row user table, with its confidences
    c = 40 r (r = 1 without ratings, as in the cell).  Three passes lie
    within 1e-6 of the float64 sums' largest magnitude.  One pass lies
    within 1e-5 of it here (its roundings cancel over so many entries, about
    5e-6), and the comparison with the plain version refuses it, at about
    four times the tolerance."""
    rng = np.random.default_rng(21 + len(ratings))
    n, k, P = 138_493, 64, 79_120
    table = (0.1 * rng.standard_normal((n, k))).astype(np.float32)
    lens = rng.integers(58_609, P + 1, 4)
    cols = np.stack([rng.choice(n, P, replace=False) for _ in lens]).astype(np.int32)
    r = np.ones((4, P)) if ratings == "none" else rng.integers(1, 11, (4, P)) / 2
    vals = (40.0 * r).astype(np.float32)
    mask = np.arange(P)[None, :] < lens[:, None]
    low = np.tril_indices(k)
    Ap, _ = gather_gram_plain(
        torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(mask), torch.from_numpy(table),
        otor=torch.zeros((k, k)),
    )  # fmt: skip
    plain, want, got = [], [], {1: [], 3: []}
    for b, m in enumerate(lens):
        X = table[cols[b, :m]]
        A_op = X * vals[b, :m, None]  # the weight scales the A operand in float32 before its split
        want.append((X.astype(np.float64) * vals[b, :m, None].astype(np.float64)).T @ X.astype(np.float64))
        plain.append(Ap[b].numpy().astype(np.float64))
        for passes in got:
            got[passes].append(_tensor_core_gram(A_op, X, passes).astype(np.float64))
    want, plain = np.stack(want)[:, low[0], low[1]], np.stack(plain)[:, low[0], low[1]]
    top = float(np.abs(want).max())
    share = max(1e-6, float(np.abs(plain - want).max()) / top)

    def gate(sums):
        sums = np.stack(sums)[:, low[0], low[1]]
        f64 = float(np.abs(sums - want).max()) / top
        over = float((np.abs(sums - plain) / (1e-5 * np.abs(plain) + share * top)).max())
        return f64, over

    f64_3, over_3 = gate(got[3])
    f64_1, over_1 = gate(got[1])
    assert f64_3 <= 1e-6 and over_3 <= 1.0
    assert f64_1 > 1e-5 or over_1 > 1.0
    assert over_1 > 2.0 and over_1 > 50 * over_3
