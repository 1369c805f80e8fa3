"""
Smoke run of the PyTorch/CUDA port (``lkpy_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every kernel under ``lkpy_tpu_torch/csrc`` (one ``nvcc`` per source,
   started together).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, and times kernel, plain version and a library
   yardstick: the fold-in solve (``spd_solve``) and the training solve
   (``spd_solve_chunked``).
3. Makes bench.py's synthetic ML-20M-scale interactions (138k users x 27k
   items, seed 42) once, and drives two paths of the port at full width
   (``features=64``), each with the launch counters set to 0 just before it
   and read just after:
   - serving: ``device_recommend`` with fold-in of 16,384 users, random
     factors, checked against a float64 NumPy/SciPy oracle and timed;
   - training: ``ImplicitMFScorer.train`` for 10 epochs on bench.py's
     training split, then epoch times, a profile of one epoch, a float64
     check of one user half-epoch, NDCG@10 on the held-out split through
     ``device_recommend``, and the trained scorer served again with fold-in.
4. Prints one JSON line describing each kernel, and as its last line
   ``{"ok": true, "device": {...}}``.

Every check raises on failure, so the script exits non-zero and prints no
result.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: H100 SXM data-sheet peaks: HBM3 bandwidth and dense FP32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# bench.py's ML-20M-scale synthetic set
N_USERS = 138_000
N_ITEMS = 27_000
NNZ = 20_000_000
N_GROUPS = 50
N_TEST_USERS = 10_000
FEATURES = 64
SERVE_USERS = 16_384
SERVE_N = 100
SERVE_CHUNK = 1024
EPOCHS = 10
#: bench.py's quality bar for NDCG@10 on the held-out split (its C++ CPU
#: baseline scores 0.2097 there)
NDCG_MIN = 0.20

#: (B, k) shapes of the fold-in solve's kernel phase: the serving block and
#: batch at k=64, then ragged and extreme widths
SPD_SHAPES = [(1024, 64), (16384, 64), (1000, 50), (7, 8), (333, 128), (64, 256)]
SPD_MAIN_SHAPE = (SERVE_CHUNK, FEATURES)
#: (N, k) shapes of the training solve's kernel phase: the largest chunk of
#: the training split (4 x 30,024 rows of width 120), then the same widths
CHUNKED_SHAPES = [(30024, 64), (16384, 64), (1000, 50), (7, 8), (333, 128), (64, 256)]
CHUNKED_MAIN_SHAPE = (30024, FEATURES)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``reps`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spd_bound(B: int, k: int) -> tuple[float, str]:
    """Least time (ms) for B k-by-k solves: A's lower triangle (all the kernel
    reads of A) and y read once, x written once; Cholesky plus two triangular
    solves in f32 outside the tensor cores."""
    t_bytes = (B * k * (k + 1) // 2 * 4 + 2 * B * k * 4) / PEAK_BYTES_PER_S
    t_ops = B * (k**3 / 3 + 2 * k * k) / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def spd_inputs(rng: np.random.Generator, B: int, k: int, dev):
    """SPD systems A = X Xᵀ/k + I (eigenvalues in about [1, 5]) from a numpy seed."""
    X = torch.from_numpy(rng.standard_normal((B, k, k), dtype=np.float32)).to(dev, torch.float64)
    A = (X @ X.transpose(1, 2) / k + torch.eye(k, dtype=torch.float64, device=dev)).to(torch.float32)
    y = torch.from_numpy(rng.standard_normal((B, k), dtype=np.float32)).to(dev)
    return A.contiguous(), y


def solve_kernel_phase(name, kernel, plain, shapes, main_shape, plain_tol: float, seed: int, dev) -> dict:
    """Hold one SPD-solve kernel against its plain version and a float64
    solve at each shape, time kernel, plain version and
    ``cholesky`` + ``cholesky_solve``, and check that a zero system gives
    non-finite output in its own row only.  Returns the main shape's row of
    the kernels line."""
    rng = np.random.default_rng(seed)
    row = None
    for B, k in shapes:
        A, y = spd_inputs(rng, B, k, dev)
        x = kernel(A, y)
        torch.cuda.synchronize()
        p = plain(A, y)
        torch.cuda.synchronize()
        abs_err = float((x - p).abs().max())
        rel_err = abs_err / float(p.abs().max())
        x64 = torch.linalg.solve(A.double(), y.double())
        err64 = float((x.double() - x64).abs().max() / x64.abs().max())
        resid = float((A.double() @ x.double()[:, :, None])[:, :, 0].sub(y.double()).abs().max() / y.abs().max())
        if not (np.isfinite(abs_err) and rel_err <= plain_tol):
            raise AssertionError(f"{name} ({B},{k}): kernel vs plain max relative error {rel_err}")
        if not (err64 <= 1e-4 and resid <= 1e-4):
            raise AssertionError(f"{name} ({B},{k}): error vs float64 {err64}, residual {resid}")
        ms = cuda_ms(lambda: kernel(A, y), reps=20)
        plain_ms = cuda_ms(lambda: plain(A, y), reps=3, warm=1)
        lib_ms = cuda_ms(lambda: torch.cholesky_solve(y[:, :, None], torch.linalg.cholesky(A)), reps=10)
        bound_ms, bound_by = spd_bound(B, k)
        log(
            f"{name} B={B} k={k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cholesky+cholesky_solve {lib_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}, "
            f"kernel {ms / bound_ms:.1f}x); vs plain max abs {abs_err:.3e} rel {rel_err:.3e}; "
            f"vs float64 {err64:.3e}; residual {resid:.3e}"
        )
        if (B, k) == main_shape:
            row = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
    # a zero system must give non-finite output, as the TPU kernels' do, and
    # leave the other systems alone (explicit ALS's padding rows have A = 0)
    A, y = spd_inputs(rng, 5, FEATURES, dev)
    A[[1, 3]] = 0.0
    x = kernel(A, y)
    torch.cuda.synchronize()
    if torch.isfinite(x[[1, 3]]).any() or not torch.isfinite(x[[0, 2, 4]]).all():
        raise AssertionError(f"{name}: a zero system must give non-finite output, the others finite")
    log(f"{name} zero systems: non-finite output in their own rows only, as required")
    return row


def synth_interactions(rng: np.random.Generator):
    """bench.py's generator: MovieLens-like popularity skew plus planted
    user-group/item-group structure, deduplicated."""
    item_w = 1.0 / np.arange(1, N_ITEMS + 1) ** 0.8
    cdf = np.cumsum(item_w / item_w.sum())
    users = rng.integers(0, N_USERS, size=NNZ).astype(np.int64)
    user_group = rng.integers(0, N_GROUPS, size=N_USERS)
    in_group = rng.random(NNZ) < 0.75
    raw = np.searchsorted(cdf, rng.random(NNZ)).astype(np.int64)
    g = user_group[users]
    snapped = np.minimum((raw // N_GROUPS) * N_GROUPS + g, N_ITEMS - 1)
    items = np.where(in_group, snapped, raw)
    uniq = np.unique(users * N_ITEMS + items)
    return (uniq // N_ITEMS).astype(np.int64), (uniq % N_ITEMS).astype(np.int64)


def split_holdout(users, items, rng: np.random.Generator):
    """bench.py's split: hold out ~20% of the interactions of N_TEST_USERS
    sampled users."""
    test_users = rng.choice(N_USERS, size=N_TEST_USERS, replace=False)
    is_test_user = np.zeros(N_USERS, dtype=bool)
    is_test_user[test_users] = True
    cand = is_test_user[users] & (rng.random(len(users)) < 0.2)
    return ~cand, users[cand], items[cand]


def ndcg10(u_idx, top_items, test_u, test_i):
    """bench.py's NDCG@10 of (B, 10) recommendations against held-out items."""
    import pandas as pd

    df = pd.DataFrame({"u": test_u, "i": test_i})
    by_user = df.groupby("u")["i"].apply(set)
    disc = 1.0 / np.log2(np.arange(2, 12))
    vals = []
    for u, recs in zip(u_idx, top_items):
        rel = by_user.get(u)
        if not rel:
            continue
        hits = np.fromiter((r in rel for r in recs), dtype=float, count=len(recs))
        dcg = float(hits @ disc[: len(recs)])
        ideal = float(disc[: min(len(rel), 10)].sum())
        vals.append(dcg / ideal if ideal > 0 else 0.0)
    return float(np.mean(vals)) if vals else float("nan")


def oracle_topn(hist: np.ndarray, Y: np.ndarray, otor: np.ndarray, weight: float, n: int):
    """Float64 fold-in (Hu et al.), scoring, history masking and top-n for one user."""
    import scipy.linalg as sla

    G = Y[hist]
    A = otor + weight * (G.T @ G)
    u = sla.cho_solve(sla.cho_factor(A), G.T @ np.full(len(hist), weight + 1.0))
    s = Y @ u
    s[hist] = -np.inf
    top = np.argsort(-s, kind="stable")[:n]
    return top, s


def check_lists(recs, csr, users_vocab, n: int):
    """Every list: n finite, descending scores, no history item."""
    for key, il in recs.items():
        s = il.scores()
        if len(il) != n or not np.isfinite(s).all() or (np.diff(s) > 0).any():
            raise AssertionError(f"user {key.user_id}: bad list (len {len(il)})")
        if np.isin(il.numbers(), csr.row_cols(users_vocab.number(key.user_id))).any():
            raise AssertionError(f"user {key.user_id}: a history item was recommended")


def profile_device(fn, wall_ms: float, label: str, top: int = 10, mark: str | None = None):
    """Profile one call of ``fn`` on the card; log device busy time, the
    device idle share against ``wall_ms`` (the mean unprofiled call) and
    the ``top`` kernels.  Returns (busy ms, idle share, share of the kernels
    whose name holds ``mark``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device activities only: aten:: operators repeat their kernels' time
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    total_ms = sum(e.self_device_time_total for e in evs) / 1e3
    idle = 1 - total_ms / wall_ms
    log(
        f"profile of {label}: device busy {total_ms:.3f} ms in {len(evs)} kinds of kernel and copy; "
        f"mean unprofiled call {wall_ms:.3f} ms -> device idle share {idle:.3f}"
    )
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} {e.key[:110]}")
    share = None
    if mark is not None and total_ms > 0:
        share = sum(e.self_device_time_total for e in evs if mark in e.key) / 1e3 / total_ms
        log(f"  share of device busy time in {mark}: {share:.3f}")
    return total_ms, idle, share


def slice_phase(dev, users, items, rng: np.random.Generator) -> dict:
    """The serving path: ``device_recommend`` with fold-in on random factors."""
    import pandas as pd

    from lkpy_tpu_torch.batch.device import device_recommend
    from lkpy_tpu_torch.data import from_interactions_df
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.ops.als import implicit_otor
    from lkpy_tpu_torch.ops.spd_solve import spd_solve
    from lkpy_tpu_torch.ops.spd_solve_chunked import spd_solve_chunked

    t0 = time.perf_counter()
    ds = from_interactions_df(pd.DataFrame({"user_id": users, "item_id": items}))
    matrix = ds.interaction_matrix()
    csr = matrix.csr(None)
    log(
        f"dataset: {ds.user_count} users x {ds.item_count} items, {csr.nnz} interactions, "
        f"history length max {csr.row_lengths().max()} ({time.perf_counter() - t0:.1f}s to build)"
    )
    # random factors from the seed; OtOr = YᵀY + 0.1 I by the port's own function
    Y = (rng.standard_normal((ds.item_count, FEATURES)) * 0.1).astype(np.float32)
    U = (rng.standard_normal((ds.user_count, FEATURES)) * 0.1).astype(np.float32)
    otor = implicit_otor(torch.from_numpy(Y).to(dev), 0.1).cpu().numpy()
    scorer = ImplicitMFScorer.from_numpy(
        {"user_embeddings": U, "item_embeddings": Y, "_OtOr": otor}, {"features": FEATURES}, ds.users, ds.items, device=dev
    )
    serve = rng.choice(ds.users.ids, size=SERVE_USERS, replace=False)

    # the serving path: counts are read from this call alone
    spd_solve.launches = 0
    spd_solve_chunked.launches = 0
    torch.cuda.synchronize()
    tw = time.perf_counter()
    recs = device_recommend(scorer, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev)
    warm_s = time.perf_counter() - tw
    launches = {"spd_solve": spd_solve.launches, "spd_solve_chunked": spd_solve_chunked.launches}
    log(f"serving path: device_recommend of {SERVE_USERS} users, first call {warm_s:.3f}s; launches {launches}")
    if launches["spd_solve"] == 0:
        raise AssertionError("the serving path launched no spd_solve kernel")

    if len(recs) != SERVE_USERS:
        raise AssertionError(f"{len(recs)} lists for {SERVE_USERS} users")
    check_lists(recs, csr, ds.users, SERVE_N)
    log(f"all {SERVE_USERS} lists: {SERVE_N} finite, descending scores, no history item")

    # float64 oracle on 256 sampled users
    Y64, otor64 = Y.astype(np.float64), Y.astype(np.float64).T @ Y.astype(np.float64) + 0.1 * np.eye(FEATURES)
    hits = 0
    score_err = 0.0
    for uid in rng.choice(serve, size=256, replace=False):
        il = recs.lookup(uid)
        top, s = oracle_topn(csr.row_cols(ds.users.number(uid)), Y64, otor64, scorer.config.weight, SERVE_N)
        hits += len(np.intersect1d(il.numbers(), top))
        score_err = max(score_err, float(np.abs(il.scores() - s[il.numbers()]).max() / np.abs(s[top]).max()))
    recall = hits / (256 * SERVE_N)
    log(f"oracle (float64, 256 users): recall@{SERVE_N} {recall:.5f}, max relative score error {score_err:.3e}")
    if recall < 0.99 or score_err > 1e-3:
        raise AssertionError(f"oracle check failed: recall {recall}, score error {score_err}")

    unknown = np.array([-1, 10**9])
    mixed = device_recommend(scorer, np.concatenate([serve[:5], unknown]), SERVE_N, matrix, device=dev)
    if any(len(mixed.lookup(u)) for u in unknown) or any(len(mixed.lookup(u)) != SERVE_N for u in serve[:5]):
        raise AssertionError("unknown users must get empty lists and known users full ones")
    log("unknown user ids get empty lists")

    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        ts = time.perf_counter()
        device_recommend(scorer, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev)
        times.append(time.perf_counter() - ts)
    qps = [SERVE_USERS / t for t in times]
    log(f"serving: {SERVE_USERS} users per call, calls {times} s -> queries/s {qps}")
    profile_device(
        lambda: device_recommend(scorer, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev),
        float(np.mean(times)) * 1e3,
        "one serving call",
    )
    return launches


def training_phase(dev, users, items, rng: np.random.Generator) -> tuple[dict, dict]:
    """The training path: ``ImplicitMFScorer.train`` on bench.py's split,
    checked, timed, profiled, and served.  Returns the launches of the
    training run and of the fold-in serving of the trained scorer."""
    import pandas as pd

    from lkpy_tpu_torch.batch.device import device_recommend
    from lkpy_tpu_torch.data import from_interactions_df
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.ops.spd_solve import spd_solve
    from lkpy_tpu_torch.ops.spd_solve_chunked import spd_solve_chunked
    from lkpy_tpu_torch.training import TrainingOptions

    t0 = time.perf_counter()
    train_mask, test_u, test_i = split_holdout(users, items, rng)
    tr_u, tr_i = users[train_mask], items[train_mask]
    ds = from_interactions_df(pd.DataFrame({"user_id": tr_u, "item_id": tr_i}))
    matrix = ds.interaction_matrix()
    csr = matrix.csr(None)
    lens = csr.row_lengths()
    log(
        f"training split: {len(tr_u)} training / {len(test_u)} held-out interactions, "
        f"{ds.user_count} users x {ds.item_count} items, longest user {lens.max()}, longest item "
        f"{np.bincount(csr.colind).max()} ({time.perf_counter() - t0:.1f}s to build)"
    )
    # full float32 products, as the JAX package's f32 path asks for (HIGHEST)
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("training needs full float32 matrix products (no TF32)")

    # the training path: counts are read from this call alone
    scorer = ImplicitMFScorer(features=FEATURES, epochs=EPOCHS, user_embeddings="prefer")
    spd_solve.launches = 0
    spd_solve_chunked.launches = 0
    torch.cuda.synchronize()
    tw = time.perf_counter()
    scorer.train(ds, TrainingOptions(rng=42))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - tw
    launches = {"spd_solve": spd_solve.launches, "spd_solve_chunked": spd_solve_chunked.launches}
    log(
        f"training path: ImplicitMFScorer.train, {EPOCHS} epochs, {train_s:.3f}s with set-up; launches {launches}, "
        f"{launches['spd_solve_chunked'] / EPOCHS:g} spd_solve_chunked launches per epoch"
    )
    if launches["spd_solve_chunked"] == 0:
        raise AssertionError("the training path launched no spd_solve_chunked kernel")
    for name in ("user_embeddings", "item_embeddings", "_OtOr"):
        t = getattr(scorer, name)
        if t.device.type != dev.type or not torch.isfinite(t).all():
            raise AssertionError(f"trained {name} must be finite and on {dev} ({t.device})")

    # epoch times: a second trainer of the same seed, one readback per epoch
    trainer = scorer.create_trainer(ds, TrainingOptions(rng=42))
    log("chunks: users " + str([tuple(c.cols.shape) for c in trainer.u_buckets]))
    log("chunks: items " + str([tuple(c.cols.shape) for c in trainer.i_buckets]))
    times, deltas = [], []
    for _ in range(EPOCHS):
        ts = time.perf_counter()
        deltas.append(float(trainer.train_epoch()))
        times.append(time.perf_counter() - ts)
    if not np.isfinite(deltas).all():
        raise AssertionError(f"non-finite epoch deltas {deltas}")
    steady = times[1:]
    examples_s = 2 * len(tr_u) * len(steady) / sum(steady)
    log(f"epoch wall times (s, readback each): {times}; deltas {deltas}")
    log(
        f"epochs 2-{EPOCHS}: mean {np.mean(steady) * 1e3:.3f} ms, min {min(steady) * 1e3:.3f} ms, "
        f"max {max(steady) * 1e3:.3f} ms -> {examples_s:.4e} examples/s (2 x nnz x epochs / s)"
    )
    same = max(
        float((trainer.i_factors - scorer.item_embeddings).abs().max()),
        float((trainer.u_factors - scorer.user_embeddings).abs().max()),
    )
    log(f"second trainer of the same seed vs the trained scorer: max abs difference {same:.3e}")
    profile_device(
        lambda: trainer.train_epoch(), float(np.mean(steady)) * 1e3, "one training epoch", mark="spd_solve_chunked"
    )

    # one user half-epoch against a float64 solve of the same normal equations
    Y = trainer.i_factors.double().cpu().numpy()
    trainer._half_epoch("user")
    U = trainer.u_factors.cpu().numpy()
    otor64 = Y.T @ Y + scorer.config.user_reg * np.eye(FEATURES)
    w = scorer.config.weight
    check_rng = np.random.default_rng(3)
    worst = 0.0
    for u in check_rng.choice(np.nonzero(lens > 0)[0], size=256, replace=False):
        G = Y[csr.row_cols(u)]
        x64 = np.linalg.solve(otor64 + w * (G.T @ G), G.T @ np.full(len(G), w + 1.0))
        worst = max(worst, float(np.abs(U[u] - x64).max() / np.abs(x64).max()))
    log(f"user half-epoch vs float64 (256 users): max relative error {worst:.3e}")
    if not worst <= 1e-3:
        raise AssertionError(f"half-epoch check failed: max relative error {worst}")

    # NDCG@10 on the held-out split through the port's serving path
    tq = time.perf_counter()
    recs = device_recommend(scorer, np.unique(test_u), 10, matrix, device=dev)
    rec_users, rec10 = [], []
    for key, il in recs.items():
        rec_users.append(key[0])
        rec10.append(list(il.ids()))
    nd = ndcg10(rec_users, rec10, test_u, test_i)
    log(f"NDCG@10 on the held-out split: {nd:.4f} ({len(rec_users)} users, {time.perf_counter() - tq:.1f}s)")
    if not nd >= NDCG_MIN:
        raise AssertionError(f"NDCG@10 {nd} below {NDCG_MIN}")

    # the trained scorer served with fold-in: B2 on trained factors
    fold = ImplicitMFScorer(features=FEATURES, epochs=EPOCHS, user_embeddings=True)
    fold.load_parameters(scorer.get_parameters())
    fold._OtOr, fold.users, fold.items = scorer._OtOr, scorer.users, scorer.items
    serve = np.random.default_rng(4).choice(ds.users.ids, size=SERVE_USERS, replace=False)
    spd_solve.launches = 0
    spd_solve_chunked.launches = 0
    recs = device_recommend(fold, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev)
    served = {"spd_solve": spd_solve.launches, "spd_solve_chunked": spd_solve_chunked.launches}
    log(f"trained scorer, fold-in serving of {SERVE_USERS} users: launches {served}")
    if served["spd_solve"] == 0:
        raise AssertionError("fold-in serving of the trained scorer launched no spd_solve kernel")
    check_lists(recs, csr, ds.users, SERVE_N)
    Y32 = scorer.item_embeddings.double().cpu().numpy()
    otor = scorer._OtOr.double().cpu().numpy()
    hits, score_err = 0, 0.0
    for uid in serve[:256]:
        il = recs.lookup(uid)
        top, s = oracle_topn(csr.row_cols(ds.users.number(uid)), Y32, otor, w, SERVE_N)
        hits += len(np.intersect1d(il.numbers(), top))
        score_err = max(score_err, float(np.abs(il.scores() - s[il.numbers()]).max() / np.abs(s[top]).max()))
    log(
        f"trained fold-in vs float64 (256 users): recall@{SERVE_N} {hits / (256 * SERVE_N):.5f}, "
        f"max relative score error {score_err:.3e}"
    )
    if score_err > 1e-3:
        raise AssertionError(f"trained fold-in check failed: score error {score_err}")
    return launches, served


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lkpy_tpu_torch  # noqa: F401 — fails where the port is absent
    from lkpy_tpu_torch.ops import _build
    from lkpy_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain
    from lkpy_tpu_torch.ops.spd_solve_chunked import spd_solve_chunked, spd_solve_chunked_plain

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(
        f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}; "
        f"float32 matmul precision {torch.get_float32_matmul_precision()}; "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
    )
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def timed_load(name: str) -> float:
        ts = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - ts

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    names = _build.sources()
    with ThreadPoolExecutor(len(names)) as pool:
        build_s = dict(zip(names, pool.map(timed_load, names)))
    log(f"build: {build_s} ({time.perf_counter() - t0:.2f}s in all)")

    spd = solve_kernel_phase("spd_solve", spd_solve, spd_solve_plain, SPD_SHAPES, SPD_MAIN_SHAPE, 1e-4, 7, dev)
    chunked = solve_kernel_phase(
        "spd_solve_chunked", spd_solve_chunked, spd_solve_chunked_plain, CHUNKED_SHAPES, CHUNKED_MAIN_SHAPE, 1e-5, 8, dev
    )

    # bench.py's interactions, made once; each path continues the generator
    # from the state it had right after them, as bench.py does
    t0 = time.perf_counter()
    rng = np.random.default_rng(42)
    users, items = synth_interactions(rng)
    state = rng.bit_generator.state
    log(f"interactions: {len(users)} ({time.perf_counter() - t0:.1f}s to generate)")

    def continued() -> np.random.Generator:
        g = np.random.default_rng()
        g.bit_generator.state = state
        return g

    serving = slice_phase(dev, users, items, continued())
    training, served = training_phase(dev, users, items, continued())

    paths = {"serving": serving, "training": training, "serving_trained": served}
    kernels = [
        dict(
            name="spd_solve",
            route="cuda",
            source="lkpy_tpu_torch/csrc/spd_solve.cu",
            replaces="lkpy_tpu/ops/pallas_solve.py:42",
            launches=serving["spd_solve"],
            launches_by_path={p: c["spd_solve"] for p, c in paths.items()},
            **spd,
        ),
        dict(
            name="spd_solve_chunked",
            route="cuda",
            source="lkpy_tpu_torch/csrc/spd_solve_chunked.cu",
            replaces="lkpy_tpu/ops/pallas_gj.py:43",
            launches=training["spd_solve_chunked"],
            launches_by_path={p: c["spd_solve_chunked"] for p, c in paths.items()},
            **chunked,
        ),
    ]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s after the start of the checks")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
