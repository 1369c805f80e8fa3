"""
Smoke run of the PyTorch/CUDA port (``lkpy_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every kernel under ``lkpy_tpu_torch/csrc`` (one ``nvcc`` per source,
   started together).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, and times kernel, plain version and a library
   yardstick: the fold-in solve (``spd_solve``: the route its shape takes
   beside the kernel's first form at every shape, every compiled thread
   mapping against ``cholesky`` + ``cholesky_solve`` and the training solve
   on a grid of batch sizes and widths, which ``fold_route`` is held
   against, and one system's chain alone), the training solve
   (``spd_solve_chunked``: the register route beside the shared-memory
   route at every shape, widths on both sides of each route boundary),
   singular systems among regular ones on every route of both solves, and
   the fused MIPS top-k
   (``mips_topk``: the number of item ranges per case, the merge kernel
   alone, the three-pass TF32 product beside the f32 FMA product, ties
   across a range boundary, and kernel against ``torch.topk(q @ I.T)`` on
   a grid of catalog and batch sizes, which the dispatch of
   ``retrieval_topk`` is held against), and the row gather
   (``gather_rows``, bit for bit against ``index_select`` at the shapes of
   ``benchmarks/probe_gather.py`` and at edge cases; at the epochs' own
   shapes within the training phases).
3. Makes bench.py's synthetic ML-20M-scale interactions (138k users x 27k
   items, seed 42) once, and drives the paths of the port at full width,
   each with the launch counters set to 0 just before it and read just
   after:
   every path checks that the solves and the row gather launched once a
   chunk or a block:
   - serving: ``device_recommend`` with fold-in of 16,384 users, random
     factors (``features=64``), checked against a float64 NumPy/SciPy oracle
     and timed;
   - training: ``ImplicitMFScorer.train`` for 10 epochs on bench.py's
     training split, then epoch times, a profile of one epoch, a float64
     check of one user half-epoch, NDCG@10 on the held-out split through
     ``device_recommend``, and the trained scorer served again with fold-in;
   - retrieval: ``retrieval_topk`` of 4,096 trained user rows against the
     trained item table tiled to 500,000 items (bench.py's large catalog),
     checked against float64 scores and timed;
   - the explicit family: ``BiasedMFScorer.train`` (``features=50``) on
     bench.py's synthetic ratings over the same split, hold-out RMSE through
     the scorer against the bias-only RMSE, then ``device_recommend`` with
     the explicit fold-in of 16,384 users against a float64 oracle;
   - the user's path: ``topn_pipeline(ImplicitMFScorer(...), n=10)`` →
     ``Pipeline.train`` → ``lkpy_tpu_torch.batch.recommend`` of the 10,000
     test users through the device route (NDCG@10 against the direct
     path's), and per-query ``recommend`` against the batch lists;
   - offline evaluation: ``quick_measure_model`` of ``ImplicitMFScorer``
     on all the interactions, 5 % of the users (split, ``Pipeline.train``,
     the per-query runner, which folds each user in and scores on the card,
     ``RunAnalysis`` against the script's own means),
     the same pipeline through the device route, then of
     ``BiasedMFScorer`` with ``predicts_ratings=True`` on bench.py's
     synthetic ratings, 2 % of the users (RMSE against the bias model's on
     the same split).
4. Prints one JSON line describing each kernel, and as its last line
   ``{"ok": true, "device": {...}}``.

Every check raises on failure, so the script exits non-zero and prints no
result.  Without a CUDA device it exits non-zero at once.

    python3 chip_smoke.py --sweeps

times, and checks nothing: the fused top-k kernel's two products over forced
numbers of item ranges and over a grid of batch, catalog and list sizes (what
``ops/mips_topk.py``'s ``RANGE_START_ITEMS`` and ``TENSOR_CORE_MIN_SCORES``
were set from).
"""

from __future__ import annotations

import inspect
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
#: timed serving calls a phase: enough to show the host clock's spread
SERVE_CALLS = 8
EPOCHS = 10
#: bench.py's quality bar for NDCG@10 on the held-out split (its C++ CPU
#: baseline scores 0.2097 there)
NDCG_MIN = 0.20

# bench.py's explicit configuration (its section 5): 50 factors
EXPLICIT_FEATURES = 50
#: rows of the largest chunk of the training split (4 x 30,024 rows of width
#: 120); both training phases check it against the chunks they were given
LARGEST_CHUNK_ROWS = 30024

#: (B, k) shapes of the fold-in solve's kernel phase: the serving block and
#: batch at k=64, the explicit family's serving block at k=50, one query's
#: fold-in in the per-query runner at both widths, then widths on
#: both sides of every boundary of the register route's templates (32, 64,
#: 96, 128) and of the route boundary (128 | 129), odd widths, and batches
#: that are no multiple of the systems a block
SPD_SHAPES = [
    (1024, 64), (16384, 64), (SERVE_CHUNK, EXPLICIT_FEATURES), (1, FEATURES), (1, EXPLICIT_FEATURES), (1000, 50), (7, 8),
    (1000, 32), (1001, 33), (1023, 63), (1000, 65), (500, 96), (501, 97), (333, 128), (333, 129), (64, 256),
]  # fmt: skip
SPD_MAIN_SHAPE = (SERVE_CHUNK, FEATURES)
SPD_EXPLICIT_SHAPE = (SERVE_CHUNK, EXPLICIT_FEATURES)
#: (N, k) shapes of the training solve's kernel phase: the largest chunk of
#: the training split at the implicit and the explicit width, then widths on
#: both sides of every boundary of the register route's templates (32, 64,
#: 96, 128) and of the route boundary itself (128 | 129)
CHUNKED_SHAPES = [
    (LARGEST_CHUNK_ROWS, 64), (16384, 64), (LARGEST_CHUNK_ROWS, EXPLICIT_FEATURES), (1000, 50), (7, 8), (1000, 32),
    (1000, 33), (1000, 65), (500, 96), (500, 97), (333, 128), (333, 129), (64, 256),
]  # fmt: skip
#: (N, k, every) batches with a zero system at every ``every``-th place
SINGULAR_SHAPES = [(1000, 64, 7), (1000, EXPLICIT_FEATURES, 3), (300, 96, 5), (200, 129, 4)]
#: batch sizes and widths on which every thread mapping of the fold-in solve
#: is timed: what ``fold_route`` is set from
FOLD_GRID_B = [1, 64, 256, 512, 1024, 4096, 16384]
FOLD_GRID_K = [32, 50, 64, 96, 128]
#: cycles the card spins before a timing starts (over 2 ms), so that the
#: host has the launches queued before the first one runs
HOLD_CYCLES = 5_000_000
CHUNKED_MAIN_SHAPE = (LARGEST_CHUNK_ROWS, FEATURES)
CHUNKED_EXPLICIT_SHAPE = (LARGEST_CHUNK_ROWS, EXPLICIT_FEATURES)

# bench.py's large catalog: 500k items, a batch of 4,096 queries
RETR_ITEMS = 500_000
RETR_QUERIES = 4_096
#: bench.py's history length of the large catalog's users: 100 of 500,000
#: entries of a row are excluded
EXCLUDE_PER_ROW = 100
#: (B, N, D, k, variant) cases of the top-k kernel phase: the retrieval
#: path's shape at both list lengths, bare, with an item bias and with an
#: exclusion mask; the small catalog; a small batch; an odd shape
TOPK_CASES = [
    (RETR_QUERIES, RETR_ITEMS, FEATURES, k, variant) for k in (10, 64) for variant in ("bare", "bias", "exclude")
] + [(1024, N_ITEMS, FEATURES, 10, "bare"), (64, RETR_ITEMS, FEATURES, 10, "bare"), (37, 1001, 48, 7, "bare")]
TOPK_MAIN_CASE = (RETR_QUERIES, RETR_ITEMS, FEATURES, 10, "bare")
#: rows the plain version and the float64 scores are timed and checked on
#: where the whole batch would take too long
TOPK_PLAIN_TIMED_ROWS = 512
TOPK_F64_ROWS = 256
#: catalog size of the tie-rule and empty-slot cases (78 item tiles)
TOPK_EDGE_ITEMS = 20_000
#: catalog and batch sizes on which kernel and ``torch.topk(q @ I.T)`` are
#: timed at k = 10: what the dispatch of ``retrieval_topk`` is set from
GRID_ITEMS = [27_000, 50_000, 100_000, 200_000, 500_000]
GRID_QUERIES = [64, 1024, 4096]
#: H100 SXM dense TF32 tensor-core rate; the three-pass product does 3x the operations
PEAK_TF32_FLOP_PER_S = 495e12

#: the row gather at the probe's shapes (benchmarks/probe_gather.py): its
#: tables of 27,000 and 131,072 rows of 128 floats and, from its docstring,
#: 27,000 rows of 64, each gathered by its Pallas kernels' 65,536 rows a call
#: and its XLA baseline's 4,194,304
GATHER_PROBE_TABLES = [(27_000, 128), (131_072, 128), (27_000, 64)]
GATHER_PROBE_ROWS = [1 << 16, 1 << 22]
#: (K, M) edge cases of the row gather: widths that take 4-, 8- and 16-byte
#: vectors, rows wider than a warp's 32 vectors, no rows
GATHER_EDGE_CASES = [(1, 37), (3, 37), (50, 1), (63, 37), (64, 1), (65, 1000), (128, 37), (256, 37), (64, 0)]
#: (M, K) of one query in the per-query runner: a history of the mean length
#: and the candidates (the items less the history) against the item table
PER_QUERY_GATHERS = [(103, FEATURES), (N_ITEMS - 103, FEATURES), (103, EXPLICIT_FEATURES), (N_ITEMS - 103, EXPLICIT_FEATURES)]
#: users of the per-query check of the pipeline phase
PER_QUERY_USERS = 20
#: how far the pipeline's NDCG@10 may lie from the direct path's, each served
#: the same way (fold-in, and from the user table): the two train from
#: different seeds, since a pipeline derives its scorer's from the node name
NDCG_PIPELINE_TOL = 0.005

#: quick_measure_model's user sample in the evaluation phase: the reference's
#: 0.2 cut to 0.05 (6,900 users) for implicit feedback and 0.02 (2,760) for
#: ratings, since its runner serves one query at a time on the host
EVAL_USER_FRAC = 0.05
EVAL_EXPLICIT_USER_FRAC = 0.02
EVAL_N = 20
#: users on which the runner's lists must equal the device route's, at least
EVAL_MIN_COMPARED = 200
#: how far the device route's NDCG@20 may lie from the runner's, and
#: RunAnalysis's means from the script's own computation
EVAL_NDCG_TOL = 0.005
EVAL_METRIC_TOL = 1e-6

#: hold-out RMSE bounds of the explicit model on bench.py's synthetic
#: ratings: the JAX package's recorded run scored 0.5782 against a bias-only
#: 0.7424 there (BENCH_r05.json)
RMSE_MAX = 0.65
RMSE_MIN_GAIN = 0.08


def log(*args):
    print(*args, flush=True)


def kernel_wrappers() -> dict:
    """The port's kernel wrappers by name; each counts its launches."""
    from lkpy_tpu_torch.ops.gather_rows import gather_rows
    from lkpy_tpu_torch.ops.mips_topk import mips_topk
    from lkpy_tpu_torch.ops.spd_solve import spd_solve
    from lkpy_tpu_torch.ops.spd_solve_chunked import spd_solve_chunked

    return {
        "spd_solve": spd_solve,
        "spd_solve_chunked": spd_solve_chunked,
        "mips_topk": mips_topk,
        "gather_rows": gather_rows,
    }


def zero_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


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
    """Mean device time of ``fn()`` in ms, by CUDA events around ``reps`` calls.
    The card spins first while the host queues the calls, so that a kernel
    shorter than its wrapper's host time is timed back to back."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
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


def solve_kernel_phase(
    name, kernel, plain, shapes, main_shape, explicit_shape, plain_tol: float, seed: int, dev, previous, route_of
) -> dict:
    """Hold one SPD-solve kernel against its plain version and a float64
    solve at each shape, time kernel, plain version and
    ``cholesky`` + ``cholesky_solve``, and check that a zero system gives
    non-finite output in its own row only.  ``previous`` is the kernel's
    earlier design (the shared-memory route), held against the plain version
    and the float64 solve and timed at the same shapes in the same run;
    ``route_of(B, k)`` names the route the kernel takes.  At the two path
    shapes the kernel must beat the earlier design and be no slower than the
    library call.  Returns the main shape's row of the kernels line, with
    the explicit path's shape under ``explicit`` and every shape's times
    under ``shapes``."""
    rng = np.random.default_rng(seed)
    row = explicit = None
    by_shape = []
    for B, k in shapes:
        A, y = spd_inputs(rng, B, k, dev)
        x = kernel(A, y)
        torch.cuda.synchronize()
        p = plain(A, y)
        torch.cuda.synchronize()
        abs_err = float((x - p).abs().max())
        rel_err = abs_err / float(p.abs().max())
        x64 = torch.linalg.solve(A.double(), y.double())
        xp = previous(A, y)
        torch.cuda.synchronize()
        prev_err = float((xp - p).abs().max() / p.abs().max())
        prev_err64 = float((xp.double() - x64).abs().max() / x64.abs().max())
        if not (prev_err <= plain_tol and prev_err64 <= 1e-4):
            raise AssertionError(f"{name} ({B},{k}): the shared-memory route vs plain {prev_err}, vs float64 {prev_err64}")
        err64 = float((x.double() - x64).abs().max() / x64.abs().max())
        resid = float((A.double() @ x.double()[:, :, None])[:, :, 0].sub(y.double()).abs().max() / y.abs().max())
        if not (np.isfinite(abs_err) and rel_err <= plain_tol):
            raise AssertionError(f"{name} ({B},{k}): kernel vs plain max relative error {rel_err}")
        if not (err64 <= 1e-4 and resid <= 1e-4):
            raise AssertionError(f"{name} ({B},{k}): error vs float64 {err64}, residual {resid}")
        ms = cuda_ms(lambda: kernel(A, y), reps=50)
        previous_ms = cuda_ms(lambda: previous(A, y), reps=50)
        plain_ms = cuda_ms(lambda: plain(A, y), reps=3, warm=1)
        lib_ms = cuda_ms(lambda: torch.cholesky_solve(y[:, :, None], torch.linalg.cholesky(A)), reps=10)
        bound_ms, bound_by = spd_bound(B, k)
        route = route_of(B, k)
        log(
            f"{name} B={B} k={k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cholesky+cholesky_solve {lib_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}, "
            f"kernel {ms / bound_ms:.1f}x); vs plain max abs {abs_err:.3e} rel {rel_err:.3e}; "
            f"vs float64 {err64:.3e}; residual {resid:.3e}"
        )
        log(
            f"{name} B={B} k={k}: route {route}; the shared-memory route, the design before, "
            f"{previous_ms:.4f} ms in the same run ({previous_ms / ms:.2f}x the kernel's time)"
        )
        measured = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            solve_route=route, previous_ms=previous_ms,
        )  # fmt: skip
        by_shape.append(dict(shape=[B, k], route=route, ms=ms, previous_ms=previous_ms, library_ms=lib_ms, rel_err_vs_plain=rel_err))
        if (B, k) in (main_shape, explicit_shape):
            # on an idle card the host sets the pace where the wrapper's own time is longer than the kernel's
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                kernel(A, y)
            torch.cuda.synchronize()
            measured["host_paced_ms"] = (time.perf_counter() - t0) * 1e3 / 50
            log(f"{name} B={B} k={k}: {measured['host_paced_ms']:.4f} ms a call on the host's clock, 50 calls into an idle card")
            if not ms < previous_ms:
                raise AssertionError(f"{name} ({B},{k}): the register route ({ms} ms) must beat the design before ({previous_ms} ms)")
            if not ms <= lib_ms:
                raise AssertionError(f"{name} ({B},{k}): the kernel ({ms} ms) must be no slower than cholesky + cholesky_solve ({lib_ms} ms)")
        if (B, k) == main_shape:
            row = measured
        if (B, k) == explicit_shape:
            explicit = dict(shape=[B, k], **measured)
    # a zero system must give non-finite output, as the TPU kernels' do, and
    # leave the other systems alone (explicit ALS's padding rows have A = 0)
    A, y = spd_inputs(rng, 5, FEATURES, dev)
    A[[1, 3]] = 0.0
    x = kernel(A, y)
    torch.cuda.synchronize()
    if torch.isfinite(x[[1, 3]]).any() or not torch.isfinite(x[[0, 2, 4]]).all():
        raise AssertionError(f"{name}: a zero system must give non-finite output, the others finite")
    log(f"{name} zero systems: non-finite output in their own rows only, as required")
    return dict(row, explicit=explicit, shapes=by_shape)


def fold_grid_phase(dev) -> dict:
    """Time every compiled thread mapping of ``spd_solve`` on a grid of batch
    sizes and widths, beside the kernel's first form (the shared-memory
    route), ``spd_solve_chunked`` and ``cholesky`` + ``cholesky_solve`` at
    the same shape, each mapping held against a float64 solve.  The mapping
    ``fold_route`` takes must be within 10 % of the fastest at the two
    serving shapes.  Then one system's chain alone: the time of B = 1 and of
    B = 132 (a system an SM) over the 2k dependent steps."""
    from lkpy_tpu_torch.ops.spd_solve import _launch, fold_mappings, fold_route, register_route_info
    from lkpy_tpu_torch.ops.spd_solve_chunked import spd_solve_chunked

    rng = np.random.default_rng(13)
    grid = []
    agree = 0
    for k in FOLD_GRID_K:
        A_all, y_all = spd_inputs(rng, max(FOLD_GRID_B), k, dev)
        x64_all = torch.linalg.solve(A_all.double(), y_all.double())
        for B in FOLD_GRID_B:
            A, y, x64 = A_all[:B], y_all[:B], x64_all[:B]
            taken = fold_route(B, k)
            ms = {}
            for route, threads in fold_mappings(k):
                x = _launch(A, y, route, threads)
                torch.cuda.synchronize()
                err64 = float((x.double() - x64).abs().max() / x64.abs().max())
                if not err64 <= 1e-4:
                    raise AssertionError(f"spd_solve ({B},{k}) {route} over {threads} threads: error vs float64 {err64}")
                ms[(route, threads)] = cuda_ms(lambda: _launch(A, y, route, threads), reps=50)
            chunked_ms = cuda_ms(lambda: spd_solve_chunked(A, y), reps=50)
            lib_ms = cuda_ms(lambda: torch.cholesky_solve(y[:, :, None], torch.linalg.cholesky(A)), reps=10)
            best = min(ms, key=ms.get)
            ok = ms[taken] <= 1.1 * ms[best]
            agree += ok
            cells = ", ".join(f"{r} x{t} {v:.4f}{'*' if (r, t) == taken else ''}" for (r, t), v in ms.items())
            log(
                f"fold grid B={B} k={k}: {cells} ms (* fold_route's); spd_solve_chunked {chunked_ms:.4f} ms, "
                f"cholesky+cholesky_solve {lib_ms:.4f} ms"
                + ("" if ok else f": the mapping taken is SLOWER than {best} by more than 10 %")
            )
            grid.append(dict(B=B, k=k, taken=list(taken), ms={f"{r}-{t}": v for (r, t), v in ms.items()},
                             chunked_ms=chunked_ms, library_ms=lib_ms))  # fmt: skip
            if (B, k) in (SPD_MAIN_SHAPE, SPD_EXPLICIT_SHAPE) and not ok:
                raise AssertionError(f"fold_route({B}, {k}) = {taken} loses to {best} by more than 10 %: {ms}")
    log(f"fold_route: the mapping taken is within 10 % of the fastest on {agree} of {len(grid)} grid points")
    # the floor of one system's dependent chain, the card otherwise idle: one system, and one an SM
    chain = []
    for k in (FEATURES, EXPLICIT_FEATURES):
        A, y = spd_inputs(rng, 132, k, dev)
        for route, threads in fold_mappings(k)[:-1]:
            one = cuda_ms(lambda: _launch(A[:1], y[:1], route, threads), reps=50)
            per_sm = cuda_ms(lambda: _launch(A, y, route, threads), reps=50)
            log(
                f"spd_solve chain floor k={k}, {threads} threads a system: B=1 {one * 1e3:.2f} us, B=132 {per_sm * 1e3:.2f} us: "
                f"{one * 1e6 / (2 * k):.1f} ns a step over 2k = {2 * k} dependent steps"
            )
            chain.append(dict(k=k, threads=threads, one_system_ms=one, one_per_sm_ms=per_sm, steps=2 * k))
    info = [register_route_info(k, t) for k in (32, 64, 96, 128) for r, t in fold_mappings(k) if r == "registers"]
    log(f"spd_solve register route as compiled: {info}")
    return dict(grid=grid, chain_floor=chain, register_route=info)


def singular_neighbours_phase(dev) -> None:
    """Zero systems among regular ones (explicit ALS's padding rows, the
    explicit fold-in of a user without history): on both routes of
    ``spd_solve_chunked`` and on every route and thread mapping of
    ``spd_solve`` the zero systems' rows are non-finite and every other row
    is, to the bit, what the same kernel gives for the batch without them."""
    from lkpy_tpu_torch.ops.spd_solve import _launch as launch_fold
    from lkpy_tpu_torch.ops.spd_solve import fold_mappings
    from lkpy_tpu_torch.ops.spd_solve_chunked import _launch, solve_route

    rng = np.random.default_rng(12)
    for N, k, every in SINGULAR_SHAPES:
        A, y = spd_inputs(rng, N, k, dev)
        zero = torch.arange(N, device=dev) % every == 1
        A0 = A.clone()
        A0[zero] = 0.0
        launches = {f"spd_solve_chunked {route}": (_launch, (route,)) for route in dict.fromkeys([solve_route(k), "shared"])}
        launches.update({f"spd_solve {route} x{threads}": (launch_fold, (route, threads)) for route, threads in fold_mappings(k)})
        for label, (launch, args) in launches.items():
            clean = launch(A, y, *args)
            got = launch(A0, y, *args)
            torch.cuda.synchronize()
            if torch.isfinite(got[zero]).any():
                raise AssertionError(f"{label} ({N},{k}): a zero system gave finite output")
            if not torch.equal(got[~zero], clean[~zero]):
                raise AssertionError(f"{label} ({N},{k}): a zero system disturbed its neighbours")
        log(f"({N},{k}): {int(zero.sum())} zero systems, their neighbours unchanged to the bit on {sorted(launches)}")


def gather_bound(table, idx) -> tuple[float, str]:
    """Least time (ms) for ``table[idx]``: the output written once, the
    indices read once and each table row that this ``idx`` touches read
    once; nothing is computed, so bytes bound it."""
    M, K = idx.numel(), table.shape[1]
    touched = int(torch.unique(idx).numel()) if M else 0
    nbytes = M * K * 4 + M * idx.element_size() + touched * K * 4
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def gather_case(label: str, table, idx, reps: int = 20) -> dict:
    """Hold the row-gather kernel against ``index_select`` (its plain
    version) bit for bit, and time kernel, plain version and one
    ``torch.index_select`` call beside its bytes bound."""
    from lkpy_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain, vector_width

    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    want = gather_rows_plain(table, idx)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"gather_rows {label}: the kernel differs from index_select")
    M, K = idx.numel(), table.shape[1]
    row = dict(label=label, table=list(table.shape), rows=M, index_type=str(idx.dtype).removeprefix("torch."), max_abs_err=0.0)
    if M == 0:
        log(f"gather_rows {label}: no rows, equal (empty)")
        return row
    ms = cuda_ms(lambda: gather_rows(table, idx), reps)
    plain_ms = cuda_ms(lambda: gather_rows_plain(table, idx), reps)
    lib_ms = cuda_ms(lambda: torch.index_select(table, 0, idx.reshape(-1)), reps)
    bound_ms, bound_by = gather_bound(table, idx)
    width = vector_width(table, got.view(M, K))
    log(
        f"gather_rows {label}: table {tuple(table.shape)}, {M} {row['index_type']} rows: kernel {ms:.4f} ms "
        f"({M * K * 4 / ms / 1e9:.3f} TB/s written, {width * 4}-byte vectors), plain {plain_ms:.4f} ms, "
        f"index_select {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; kernel {ms / bound_ms:.2f}x, "
        f"index_select {lib_ms / bound_ms:.2f}x); equal to the bit"
    )
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, vector_bytes=width * 4)
    return row


def gather_kernel_phase(dev) -> list:
    """The row gather at the probe's own shapes, and its edge cases: odd
    widths, no rows, a table that is a view 4 bytes past an aligned start
    and one whose rows lie further apart than their width, int64 rows."""
    rng = np.random.default_rng(42)
    rows = []
    for n, K in GATHER_PROBE_TABLES:
        table = torch.from_numpy(rng.standard_normal((n, K), dtype=np.float32)).to(dev)
        for M in GATHER_PROBE_ROWS:
            idx = torch.from_numpy(rng.integers(0, n, M).astype(np.int32)).to(dev)
            rows.append(gather_case(f"probe ({n}, {K}) x {M}", table, idx, reps=20 if M < (1 << 20) else 10))
        del table
    edge = np.random.default_rng(43)
    for K, M in GATHER_EDGE_CASES:
        table = torch.from_numpy(edge.standard_normal((5000, K), dtype=np.float32)).to(dev)
        idx = torch.from_numpy(edge.integers(0, 5000, M).astype(np.int32)).to(dev)
        if M > 1:
            idx[0], idx[-1] = 0, 4999
        gather_case(f"edge K={K} M={M}", table, idx, reps=5)
    base = torch.from_numpy(edge.standard_normal(400 * 67 + 1, dtype=np.float32)).to(dev)
    idx64 = torch.from_numpy(edge.integers(0, 400, (64, 37))).to(dev)
    gather_case("edge view 4 bytes past an aligned start, int64 rows", base[1 : 1 + 400 * 64].view(400, 64), idx64, reps=5)
    gather_case("edge rows 67 floats apart at an offset, int64 rows", base[: 400 * 67].view(400, 67)[:, 3:53], idx64, reps=5)
    for M, K in PER_QUERY_GATHERS:
        table = torch.from_numpy(edge.standard_normal((N_ITEMS, K), dtype=np.float32)).to(dev)
        idx = torch.from_numpy(edge.permutation(N_ITEMS)[:M].astype(np.int32)).to(dev)
        gather_case(f"per-query ({N_ITEMS}, {K}) x {M}", table, idx, reps=20)
    return rows


def gather_epoch_cases(trainer, k: int) -> list:
    """The row gather at an epoch's own shapes: the user half's largest
    chunk against the item table, and the item half's widest chunk against
    the user table, with the training run's own column numbers."""
    u_chunk = max((c for c in trainer.u_buckets), key=lambda c: c.cols.shape[1] * c.cols.shape[2])
    i_chunk = max((c for c in trainer.i_buckets), key=lambda c: c.cols.shape[2])
    return [
        gather_case(f"epoch k={k}: user chunk {tuple(u_chunk.cols.shape[1:])} of the item table", trainer.i_factors, u_chunk.cols[0]),
        gather_case(f"epoch k={k}: widest item chunk {tuple(i_chunk.cols.shape[1:])} of the user table", trainer.u_factors, i_chunk.cols[0]),
    ]


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


def check_chunk_rows(trainer, k: int) -> None:
    """The largest system batch a training run hands ``spd_solve_chunked``
    (the rows of its largest chunk, at width ``k``) must be a shape that the
    kernel phase held against the plain version."""
    rows = max(c.cols.shape[1] for c in trainer.u_buckets + trainer.i_buckets)
    if (rows, k) not in CHUNKED_SHAPES:
        raise AssertionError(f"the largest chunk has {rows} rows at k={k}: not a shape of the kernel phase {CHUNKED_SHAPES}")
    log(f"largest chunk: {rows} systems of width {k} a launch, a shape of the kernel phase")


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


def slice_phase(dev, users, items, rng: np.random.Generator):
    """The serving path: ``device_recommend`` with fold-in on random factors.
    Returns its launches and the dataset of all interactions."""
    import pandas as pd

    from lkpy_tpu_torch.batch.device import device_recommend
    from lkpy_tpu_torch.data import from_interactions_df
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.ops.als import implicit_otor

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
    zero_counts()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    recs = device_recommend(scorer, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev)
    warm_s = time.perf_counter() - tw
    launches = read_counts()
    log(f"serving path: device_recommend of {SERVE_USERS} users, first call {warm_s:.3f}s; launches {launches}")
    blocks = -(-SERVE_USERS // SERVE_CHUNK)
    if launches["spd_solve"] != blocks or launches["gather_rows"] != blocks:
        raise AssertionError(f"the serving path must launch spd_solve and gather_rows once a block ({blocks}): {launches}")

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
    for _ in range(SERVE_CALLS):
        ts = time.perf_counter()
        device_recommend(scorer, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev)
        times.append(time.perf_counter() - ts)
    qps = [SERVE_USERS / t for t in times]
    log(f"serving: {SERVE_USERS} users per call, calls {times} s -> queries/s {qps}")
    profile_device(
        lambda: device_recommend(scorer, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev),
        float(np.mean(times)) * 1e3,
        "one serving call",
        mark="spd_solve",
    )
    return launches, ds


def training_phase(dev, users, items, rng: np.random.Generator) -> tuple[dict, dict, dict]:
    """The training path: ``ImplicitMFScorer.train`` on bench.py's split,
    checked, timed, profiled, and served.  Returns the launches of the
    training run and of the fold-in serving of the trained scorer, and the
    trained scorer with the split and the generator for the later phases."""
    import pandas as pd

    from lkpy_tpu_torch.batch.device import device_recommend
    from lkpy_tpu_torch.data import from_interactions_df
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
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
    zero_counts()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    scorer.train(ds, TrainingOptions(rng=42))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - tw
    launches = read_counts()
    log(
        f"training path: ImplicitMFScorer.train, {EPOCHS} epochs, {train_s:.3f}s with set-up; launches {launches}, "
        f"{launches['spd_solve_chunked'] / EPOCHS:g} spd_solve_chunked launches per epoch"
    )
    if launches["spd_solve_chunked"] == 0 or launches["gather_rows"] != launches["spd_solve_chunked"]:
        raise AssertionError(f"the training path must launch spd_solve_chunked and gather_rows once a chunk: {launches}")
    for name in ("user_embeddings", "item_embeddings", "_OtOr"):
        t = getattr(scorer, name)
        if t.device.type != dev.type or not torch.isfinite(t).all():
            raise AssertionError(f"trained {name} must be finite and on {dev} ({t.device})")

    # epoch times: a second trainer of the same seed, one readback per epoch
    trainer = scorer.create_trainer(ds, TrainingOptions(rng=42))
    log("chunks: users " + str([tuple(c.cols.shape) for c in trainer.u_buckets]))
    log("chunks: items " + str([tuple(c.cols.shape) for c in trainer.i_buckets]))
    check_chunk_rows(trainer, FEATURES)
    gather_epoch = gather_epoch_cases(trainer, FEATURES)
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
    blocks = -(-SERVE_USERS // SERVE_CHUNK)
    zero_counts()
    recs = device_recommend(fold, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev)
    served = read_counts()
    log(f"trained scorer, fold-in serving of {SERVE_USERS} users: launches {served}")
    if served["spd_solve"] != blocks or served["gather_rows"] != blocks:
        raise AssertionError(f"fold-in serving of the trained scorer must launch spd_solve and gather_rows once a block: {served}")
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
    # NDCG@10 of the same trained tables with every test user folded in, as the pipeline phase serves them
    recs = device_recommend(fold, np.unique(test_u), 10, matrix, device=dev)
    nd_fold = ndcg10(rec_users, [list(recs.lookup(u).ids()) for u in rec_users], test_u, test_i)
    log(f"NDCG@10 on the held-out split with fold-in of the test users: {nd_fold:.4f} (from the user table {nd:.4f})")
    split = dict(
        scorer=scorer, ds=ds, tr_u=tr_u, tr_i=tr_i, test_u=test_u, test_i=test_i, rng=rng, ndcg=nd, ndcg_fold=nd_fold,
        gather_epoch=gather_epoch,
        chunks_per_epoch=sum(c.rows.shape[0] for c in trainer.u_buckets + trainer.i_buckets),
    )  # fmt: skip
    return launches, served, split


def topk_bound(B: int, N: int, D: int, k: int, biased: bool, masked: bool, tensor_cores: bool = False) -> tuple[float, str]:
    """Least time (ms) for a fused MIPS top-k: queries, items, bias and mask
    read once, the (B, k) values and indices written once; 2·B·N·D f32
    operations outside the tensor cores or, with ``tensor_cores``, the three
    passes' 6·B·N·D operations at the TF32 tensor-core rate (the selection is
    not counted)."""
    nbytes = 4 * (B * D + N * D) + 8 * B * k + (4 * N if biased else 0) + (B * N if masked else 0)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 6.0 * B * N * D / PEAK_TF32_FLOP_PER_S if tensor_cores else 2.0 * B * N * D / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def scores_at(q, items, bias, idx):
    """f32 scores of the (B, k) item numbers ``idx`` (empty slots clamped)."""
    safe = idx.long().clamp(max=items.shape[0] - 1)
    s = torch.empty(idx.shape, dtype=torch.float32, device=q.device)
    for lo in range(0, len(q), 1024):  # (rows, k, D) gathered rows at a time
        s[lo : lo + 1024] = (q[lo : lo + 1024, None, :] * items[safe[lo : lo + 1024]]).sum(-1)
    return s if bias is None else s + bias[safe]


def check_topk(label, q, items, k, bias, excl, got) -> float:
    """Hold a (values, indices) result against ``mips_topk_plain`` and
    against float64 scores; raises on any breach.  Returns the largest
    absolute difference of a value from the plain version's."""
    from lkpy_tpu_torch.ops.mips_topk import INT32_MAX, mips_topk_plain

    gv, gi = got
    pv, pi = mips_topk_plain(q, items, k, i_bias=bias, exclude=excl)
    finite = torch.isfinite(pv)
    if not torch.equal(torch.isfinite(gv), finite):
        raise AssertionError(f"{label}: the empty slots differ from the plain version's")
    if not ((gv[~finite] == -torch.inf).all() and (gi[~finite] == INT32_MAX).all()):
        raise AssertionError(f"{label}: an empty slot must hold (-inf, INT32_MAX)")
    if not (gv[:, :-1] >= gv[:, 1:]).all():
        raise AssertionError(f"{label}: values are not in descending order")
    # values: rtol 1e-5 / atol 1e-5 (the kernel sums over D in order, a library product does not)
    diff = (gv - pv)[finite].abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    if (diff > 1e-5 + 1e-5 * pv[finite].abs()).any():
        raise AssertionError(f"{label}: kernel vs plain values differ by up to {max_abs}")
    # indices: equal wherever both neighbouring ranks are more than 1e-4 away
    w = torch.where(finite, pv, torch.zeros_like(pv))
    gap = (w[:, :-1] - w[:, 1:]).abs()
    clear = finite.clone()
    clear[:, :-1] &= gap > 1e-4
    clear[:, 1:] &= gap > 1e-4
    clear[:, -1] = False  # the rank below the last is not known
    mismatch = int((gi != pi)[clear].sum())
    if mismatch:
        raise AssertionError(f"{label}: {mismatch} indices differ from the plain version's at clear gaps")
    # each value is the score of its index
    at = scores_at(q, items, bias, gi)
    off = (gv - at)[finite].abs()
    if (off > 1e-5 + 1e-5 * at[finite].abs()).any():
        raise AssertionError(f"{label}: a value is not the score of its index (off by {float(off.max())})")
    # equal scores: the smaller index first; no index twice; no excluded item
    tied = finite[:, 1:] & (gv[:, :-1] == gv[:, 1:])
    if (gi[:, :-1] >= gi[:, 1:])[tied].any():
        raise AssertionError(f"{label}: equal scores must come smaller index first")
    srt = torch.sort(torch.where(finite, gi, -1 - torch.arange(k, device=gi.device, dtype=gi.dtype)), dim=1).values
    if (srt[:, :-1] == srt[:, 1:]).any():
        raise AssertionError(f"{label}: an item is listed twice")
    if excl is not None and (excl.gather(1, gi.long().clamp(max=items.shape[0] - 1)) != 0)[finite].any():
        raise AssertionError(f"{label}: an excluded item was returned")
    # float64 scores of the first rows: every returned item within 1e-5 of the true k-th score
    rows = min(TOPK_F64_ROWS, len(q))
    s64 = q[:rows].double() @ items.double().T
    if bias is not None:
        s64 += bias.double()
    if excl is not None:
        s64.masked_fill_(excl[:rows] != 0, -torch.inf)
    tv, ti = torch.topk(s64, min(k, items.shape[0]), dim=1)
    got64 = s64.gather(1, gi[:rows].long().clamp(max=items.shape[0] - 1))
    fin = finite[:rows]
    if (got64 < tv[:, -1:] - 1e-5)[fin].any():
        raise AssertionError(f"{label}: an item below the float64 top-{k} (by more than 1e-5) was returned")
    hits = int(((gi[:rows, :, None] == ti[:, None, :]) & fin[:, :, None]).any(-1).sum())
    recall = hits / max(int(torch.isfinite(tv).sum()), 1)
    log(f"{label}: vs plain max abs {max_abs:.3e}, {int((gi != pi).sum())} indices differ (all at gaps <= 1e-4); "
        f"float64 recall@{k} on {rows} rows {recall:.5f}")  # fmt: skip
    return max_abs


def f64_rel_err(q, items, bias, got) -> float:
    """Largest relative error of the returned values against float64 scores
    of the returned items, on the first ``TOPK_F64_ROWS`` rows."""
    gv, gi = got
    rows = min(TOPK_F64_ROWS, len(q))
    safe = gi[:rows].long().clamp(max=items.shape[0] - 1)
    s64 = (q[:rows, None, :].double() * items[safe].double()).sum(-1)
    if bias is not None:
        s64 += bias[safe].double()
    fin = torch.isfinite(gv[:rows])
    return float(((gv[:rows].double() - s64).abs() / s64.abs())[fin].max())


def merge_kernel_check(B: int, S: int, k: int, dev) -> float:
    """Hold the merge kernel alone against its plain version on random
    sorted partial lists with many equal values and some empty slots, and
    time it.  Returns its time in ms."""
    from lkpy_tpu_torch.ops.mips_topk import INT32_MAX, _merge_lists, _merge_lists_plain

    g = torch.Generator(device=dev).manual_seed(B + S + k)
    # values from a small set, so that equal values meet across lists; a range's indices lie in its own block
    part_v = torch.randint(0, 4 * k, (B, S, k), device=dev, generator=g).float().sort(dim=2, descending=True).values
    part_i = torch.rand((B, S, 1000), device=dev, generator=g).argsort(dim=2)[:, :, :k].sort(dim=2).values.int()
    part_i += 1000 * torch.arange(S, device=dev, dtype=torch.int32)[None, :, None]
    empty = torch.arange(k, device=dev)[None, None, :] >= torch.randint(0, k + 1, (B, S, 1), device=dev, generator=g)
    part_v[empty] = -torch.inf
    part_i[empty] = INT32_MAX
    part_v, part_i = part_v.contiguous(), part_i.contiguous()
    got = _merge_lists(part_v, part_i)
    torch.cuda.synchronize()
    want = _merge_lists_plain(part_v, part_i)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"mips_topk merge kernel ({B},{S},{k}) disagrees with its plain version")
    return cuda_ms(lambda: _merge_lists(part_v, part_i), reps=20)


def topk_kernel_phase(dev) -> dict:
    """Hold the fused MIPS top-k kernel against its plain version and float64
    scores at each case, on the path's product (f32 FMA) and on the
    three-pass TF32 product, and time kernel, plain version (on fewer rows
    where the batch is large) and ``torch.topk`` of the whole score matrix;
    then the merge kernel alone, the tie and empty-slot cases across item
    ranges, and the grid the dispatch of ``retrieval_topk`` is set from.
    Returns the main case's row of the kernels line."""
    from lkpy_tpu_torch.ops.mips_topk import (
        INT32_MAX, PRODUCT_FMA, PRODUCT_TF32X3, TENSOR_CORE_MAX_D, _launch, choose_product, mips_topk, mips_topk_plain,
        range_items,
    )  # fmt: skip
    from lkpy_tpu_torch.ops.topk import fused_route

    names = {PRODUCT_FMA: "f32 FMA", PRODUCT_TF32X3: "three-pass TF32"}

    rng = np.random.default_rng(9)
    made: dict = {}
    row = None
    cases: list = []
    for B, N, D, k, variant in TOPK_CASES:
        if D not in made:  # one table per depth, cut to each case's size
            nq = max(c[0] for c in TOPK_CASES if c[2] == D)
            ni = max(c[1] for c in TOPK_CASES if c[2] == D)
            made[D] = (
                torch.from_numpy(rng.standard_normal((nq, D), dtype=np.float32) * 0.35).to(dev),
                torch.from_numpy(rng.standard_normal((ni, D), dtype=np.float32) * 0.35).to(dev),
                torch.from_numpy(rng.standard_normal(ni, dtype=np.float32) * 0.3).to(dev),
            )
        q, items, bias = made[D][0][:B], made[D][1][:N], made[D][2][:N] if variant == "bias" else None
        excl = None
        if variant == "exclude":
            # EXCLUDE_PER_ROW random items of each row, and the row's five best, so that the mask matters
            excl = torch.zeros((B, N), dtype=torch.bool, device=dev)
            excl.scatter_(1, torch.from_numpy(rng.integers(0, N, size=(B, EXCLUDE_PER_ROW))).to(dev), True)
            excl.scatter_(1, mips_topk(q, items, 5)[1].long(), True)
        label = f"mips_topk B={B} N={N} D={D} k={k} {variant}"
        got = mips_topk(q, items, k, i_bias=bias, exclude=excl)
        torch.cuda.synchronize()
        splits, product = mips_topk.last_splits, mips_topk.last_product
        if product != choose_product(B, N, D, k):
            raise AssertionError(f"{label}: the launch took product {product}, not the one its shape gives")
        max_abs = check_topk(label, q, items, k, bias, excl, got)
        ms = cuda_ms(lambda: mips_topk(q, items, k, i_bias=bias, exclude=excl), reps=20)
        err = {product: f64_rel_err(q, items, bias, got)}
        by_product = {product: (ms, splits)}
        # the other product, which this shape does not take: same checks, its time and error beside
        other = PRODUCT_FMA if product == PRODUCT_TF32X3 else PRODUCT_TF32X3
        if D <= TENSOR_CORE_MAX_D:
            got2 = _launch(q, items, k, bias, excl, product=other)
            torch.cuda.synchronize()
            check_topk(f"{label} [{names[other]}]", q, items, k, bias, excl, got2)
            by_product[other] = (cuda_ms(lambda: _launch(q, items, k, bias, excl, product=other), reps=20), mips_topk.last_splits)
            err[other] = f64_rel_err(q, items, bias, got2)
            del got2
        merge_ms = merge_kernel_check(B, splits, k, dev) if splits > 1 else 0.0
        prow = min(B, TOPK_PLAIN_TIMED_ROWS)
        plain_ms = cuda_ms(
            lambda: mips_topk_plain(q[:prow], items, k, i_bias=bias, exclude=None if excl is None else excl[:prow]),
            reps=1,
            warm=0,
        )

        def library():
            s = q @ items.T
            if bias is not None:
                s += bias
            if excl is not None:
                s.masked_fill_(excl, -torch.inf)
            return torch.topk(s, k, dim=1)

        lib_ms = cuda_ms(library, reps=3, warm=1)
        # the bound of the product this launch took, and both products' beside
        bound_ms, bound_by = topk_bound(B, N, D, k, bias is not None, excl is not None, product == PRODUCT_TF32X3)
        bound1_ms = topk_bound(B, N, D, k, bias is not None, excl is not None)[0]
        bound3_ms = topk_bound(B, N, D, k, bias is not None, excl is not None, True)[0]
        products = "; ".join(
            f"{names[p]} {t:.4f} ms with S={sp}, largest relative error vs float64 {err[p]:.3e}"
            for p, (t, sp) in sorted(by_product.items())
        )
        log(
            f"{label}: kernel {ms:.4f} ms on the {names[product]} product with S={splits} item ranges (merge kernel alone "
            f"{merge_ms:.4f} ms), plain {plain_ms:.4f} ms on {prow} rows, torch.topk(q @ I.T) {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, kernel {ms / bound_ms:.2f}x; f32 FMA product {bound1_ms:.4f} ms, three passes "
            f"at the TF32 tensor-core rate {bound3_ms:.4f} ms); by product: {products}"
        )
        fma_ms, tf32x3_ms = (by_product.get(p, (None, None))[0] for p in (PRODUCT_FMA, PRODUCT_TF32X3))
        if (B, N, D, k, variant) == TOPK_MAIN_CASE:
            if not (product == PRODUCT_TF32X3 and tf32x3_ms < fma_ms):
                raise AssertionError(f"{label}: the tensor-core product is on this path because it is the faster: {by_product}")
            row = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, plain_rows=prow, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, product=names[product], splits=splits, merge_ms=merge_ms, fma_ms=fma_ms,
                fma_bound_ms=bound1_ms, fma_max_rel_err_f64=err[PRODUCT_FMA], tf32x3_ms=tf32x3_ms, tf32x3_bound_ms=bound3_ms,
                tf32x3_max_rel_err_f64=err[PRODUCT_TF32X3], cases=[],
            )  # fmt: skip
        cases.append(dict(case=[B, N, D, k, variant], product=names[product], ms=ms, splits=splits, merge_ms=merge_ms,
                          library_ms=lib_ms, fma_ms=fma_ms, tf32x3_ms=tf32x3_ms))  # fmt: skip
        del excl, got

    row["cases"] = cases

    # duplicated item rows: equal scores come smaller index first, also across
    # tiles and across item ranges, for every S and on both products
    half = TOPK_EDGE_ITEMS // 2
    q, items = made[FEATURES][0][:64], made[FEATURES][1][: 2 * half].clone()
    items[half:] = items[:half]
    # and equal scores on the two sides of a range boundary, next to each other (S = 4: ranges of 5,120 items)
    edge = range_items(2 * half, 4)
    items[edge] = items[edge - 1]
    items[edge - 1] *= 4.0  # so that the pair is among the best of many rows
    items[edge] *= 4.0
    want_v, want_i = mips_topk_plain(q, items, 16)
    # the three-pass product rounds otherwise than the plain version, so it is held to the plain version's
    # indices where the plain values are equal (and, by check_topk, wherever the gap is clear)
    tied = torch.zeros_like(want_i, dtype=torch.bool)
    tied[:, :-1] |= want_v[:, :-1] == want_v[:, 1:]
    tied[:, 1:] |= want_v[:, :-1] == want_v[:, 1:]
    pair_rows = int(((want_i == edge - 1).any(1) & (want_i == edge).any(1)).sum())
    if pair_rows == 0:
        raise AssertionError("the tie case must have the boundary pair in some row's list")
    for product in (PRODUCT_FMA, PRODUCT_TF32X3):
        for forced in (None, 1, 2, 4, 7):
            gv, gi = _launch(q, items, 16, splits=forced, product=product)
            label = f"mips_topk duplicated item rows, {names[product]}, S={mips_topk.last_splits}"
            check_topk(label, q, items, 16, None, None, (gv, gi))
            if not (torch.equal(gi, want_i) if product == PRODUCT_FMA else torch.equal(gi[tied], want_i[tied])):
                raise AssertionError(f"{label}: equal scores must be listed as in the plain version")
            if forced is None and mips_topk.last_splits < 2:
                raise AssertionError("the tie case must run with several item ranges")
    log(f"mips_topk ties: duplicates {half} items apart and a pair astride a range boundary (in {pair_rows} rows' lists) "
        "come smaller index first for S in {auto, 1, 2, 4, 7} on both products")  # fmt: skip
    # a row wholly excluded, a row with three scoreable items, k past the catalog
    excl = torch.zeros((64, 2 * half), dtype=torch.int8, device=dev)
    excl[0] = 1
    excl[1, 3:] = 1
    for product in (PRODUCT_FMA, PRODUCT_TF32X3):
        gv, gi = _launch(q, items, 8, None, excl, product=product)
        if mips_topk.last_splits < 2:
            raise AssertionError("the excluded-rows case must run with several item ranges")
        check_topk(f"mips_topk excluded rows, {names[product]}, S={mips_topk.last_splits}", q, items, 8, None, excl, (gv, gi))
        if not ((gi[0] == INT32_MAX).all() and (gi[1, 3:] == INT32_MAX).all() and sorted(gi[1, :3].tolist()) == [0, 1, 2]):
            raise AssertionError("mips_topk: empty slots of excluded rows are wrong")
        gv, gi = _launch(q, items[:5], 9, product=product)
        check_topk(f"mips_topk k past the catalog, {names[product]}", q, items[:5], 9, None, None, (gv, gi))
        if not (torch.isfinite(gv[:, :5]).all() and (gi[:, 5:] == INT32_MAX).all()):
            raise AssertionError("mips_topk: k past the catalog must leave empty slots")
    log("mips_topk tie rule, excluded rows (fewer than k scoreable items under S > 1) and k past the catalog: as required")

    # kernel against torch.topk(q @ I.T) at k = 10 over catalog and batch sizes: the dispatch's measure
    grid = []
    agree = 0
    for N in GRID_ITEMS:
        for B in GRID_QUERIES:
            q, items = made[FEATURES][0][:B], made[FEATURES][1][:N]
            ms = cuda_ms(lambda: mips_topk(q, items, 10), reps=20)
            lib_ms = cuda_ms(lambda: torch.topk(q @ items.T, 10, dim=1), reps=5, warm=1)
            fused = fused_route("cuda", B, N, 10)
            taken, other = (ms, lib_ms) if fused else (lib_ms, ms)
            ok = taken <= 1.1 * other
            agree += ok
            grid.append(dict(B=B, N=N, ms=ms, library_ms=lib_ms, splits=mips_topk.last_splits,
                             product=names[mips_topk.last_product], fused=fused))  # fmt: skip
            log(
                f"grid N={N} B={B} k=10: kernel {ms:.4f} ms ({names[mips_topk.last_product]}, S={mips_topk.last_splits}), "
                f"torch.topk(q @ I.T) {lib_ms:.4f} ms; "
                f"retrieval_topk takes the {'kernel' if fused else 'library route'}"
                + ("" if ok else ": SLOWER than the other route by more than 10 %")
            )
    log(f"dispatch of retrieval_topk: the route taken is within 10 % of the faster one on {agree} of {len(grid)} grid points")
    row["grid"] = grid
    small = next(g for g in grid if (g["B"], g["N"]) == (64, RETR_ITEMS))
    if not small["ms"] <= small["library_ms"]:
        raise AssertionError(f"mips_topk at (64, {RETR_ITEMS}) must not be slower than torch.topk(q @ I.T): {small}")
    return row


def sweeps(dev) -> None:
    """Time ``mips_topk``'s two products at forced numbers of item ranges,
    then both products with the number the wrapper chooses over batch,
    catalog and list sizes."""
    from lkpy_tpu_torch.ops.mips_topk import PRODUCT_FMA, PRODUCT_TF32X3, _launch, choose_product, mips_topk

    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((16384, FEATURES), dtype=np.float32) * 0.35).to(dev)
    items = torch.from_numpy(rng.standard_normal((RETR_ITEMS, FEATURES), dtype=np.float32) * 0.35).to(dev)
    names = {PRODUCT_FMA: "fma", PRODUCT_TF32X3: "tf32x3"}
    log("sweep 1: ms by forced number of item ranges S (auto = the wrapper's choice)")
    for B, N, k in [(4096, 500_000, 10), (4096, 500_000, 64), (1024, 500_000, 10), (64, 500_000, 10), (1024, 27_000, 10), (64, 27_000, 10)]:
        forced = [None, 1, 2, 4, 8, 16, 33] if B == 4096 else [None, 4, 16, 33, 66, 132, 264] if N > 100_000 else [None, 1, 4, 8, 26]
        for product in (PRODUCT_FMA, PRODUCT_TF32X3):
            cells = []
            for S in forced:
                ms = cuda_ms(lambda: _launch(q[:B], items[:N], k, splits=S, product=product), reps=10)
                cells.append(f"{'auto' if S is None else S}->{mips_topk.last_splits}: {ms:.4f}")
            log(f"  B={B} N={N} k={k} {names[product]}: " + ", ".join(cells))
    log("sweep 2: ms of each product with the wrapper's S; * marks the product the wrapper takes")
    for k in (10, 64):
        for N in GRID_ITEMS:
            cells = []
            for B in (256, 1024, 2048, 4096, 16384):
                t = {}
                for product in (PRODUCT_FMA, PRODUCT_TF32X3):
                    t[product] = cuda_ms(lambda: _launch(q[:B], items[:N], k, product=product), reps=10)
                taken = choose_product(B, N, FEATURES, k)
                cells.append(
                    f"B={B} fma {t[PRODUCT_FMA]:.4f}{'*' if taken == PRODUCT_FMA else ''} "
                    f"tf32x3 {t[PRODUCT_TF32X3]:.4f}{'*' if taken == PRODUCT_TF32X3 else ''}"
                )
            log(f"  k={k} N={N}: " + "; ".join(cells))


def retrieval_phase(dev, scorer, rng: np.random.Generator) -> dict:
    """The retrieval path: ``retrieval_topk`` of trained user rows against
    bench.py's large catalog (the trained item table tiled with jitter)."""
    from lkpy_tpu_torch.ops.topk import fused_route, retrieval_topk

    i_np = scorer.item_embeddings.cpu().numpy()
    reps = -(-RETR_ITEMS // len(i_np))
    jitter = rng.normal(0, 0.02 * np.abs(i_np).mean(), size=(RETR_ITEMS, i_np.shape[1])).astype(np.float32)
    items = torch.from_numpy(np.tile(i_np, (reps, 1))[:RETR_ITEMS] + jitter).to(dev)
    pick = np.sort(rng.choice(scorer.user_embeddings.shape[0], size=RETR_QUERIES, replace=False))
    q = scorer.user_embeddings[torch.from_numpy(pick).to(dev)].contiguous()
    # an item bias of a tenth of the scores' size
    scale = 0.1 * float((q[:64] @ items[:4096].T).abs().mean())
    bias = torch.from_numpy(rng.normal(0, scale, RETR_ITEMS).astype(np.float32)).to(dev)
    large = fused_route("cuda", RETR_QUERIES, RETR_ITEMS, 10) and fused_route("cuda", RETR_QUERIES, RETR_ITEMS, 64)
    log(f"retrieval: {RETR_QUERIES} trained user rows x {RETR_ITEMS} items (the trained table of {len(i_np)} tiled with jitter)")

    # the retrieval path: counts are read from these calls alone
    zero_counts()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    results = {
        "k=10": retrieval_topk(q, items, 10),
        "k=64": retrieval_topk(q, items, 64, exact=False),
        "k=10 with bias": retrieval_topk(q, items, 10, i_bias=bias),
    }
    torch.cuda.synchronize()
    first_s = time.perf_counter() - tw
    launches = read_counts()
    log(f"retrieval path: 3 retrieval_topk calls, {first_s:.3f}s; launches {launches}")
    if large and launches["mips_topk"] != 3:
        raise AssertionError(f"the retrieval path must launch mips_topk once a call, counted {launches['mips_topk']}")

    # float64 scores on the first rows: every returned item within 1e-5 of the true k-th score
    rows = min(TOPK_F64_ROWS, RETR_QUERIES)
    for name, (v, ix) in results.items():
        k = v.shape[1]
        if v.shape != (RETR_QUERIES, k) or ix.dtype != torch.int32 or not torch.isfinite(v).all():
            raise AssertionError(f"retrieval {name}: bad result {tuple(v.shape)} {ix.dtype}")
        if not (v[:, :-1] >= v[:, 1:]).all():
            raise AssertionError(f"retrieval {name}: scores not descending")
        s64 = q[:rows].double() @ items.double().T
        if "bias" in name:
            s64 += bias.double()
        tv, ti = torch.topk(s64, k, dim=1)
        got64 = s64.gather(1, ix[:rows].long())
        recall = float((ix[:rows, :, None] == ti[:, None, :]).any(-1).float().mean())
        err = float((v[:rows].double() - got64).abs().max() / tv.abs().max())
        log(f"retrieval {name} vs float64 ({rows} queries): recall@{k} {recall:.5f}, max relative score error {err:.3e}")
        if (got64 < tv[:, -1:] - 1e-5).any() or err > 1e-5:
            raise AssertionError(f"retrieval {name}: float64 check failed (recall {recall}, score error {err})")
        del s64

    for k in (10, 64):
        times = []
        for _ in range(8):
            ts = time.perf_counter()
            retrieval_topk(q, items, k)[1].cpu()
            times.append(time.perf_counter() - ts)
        log(
            f"retrieval k={k}: {RETR_QUERIES} queries per call, 8 calls with readback {sum(times):.4f}s -> "
            f"{RETR_QUERIES * 8 / sum(times):.4e} queries/s (min call {min(times) * 1e3:.3f} ms, max {max(times) * 1e3:.3f} ms)"
        )

    # the routes beside the kernel: a list longer than the kernel takes; and the small catalog, on the
    # route the dispatch rule gives it
    before = read_counts()["mips_topk"]
    ts = time.perf_counter()
    v100, i100 = retrieval_topk(q, items, 100)
    i100.cpu()
    t100 = time.perf_counter() - ts
    if read_counts()["mips_topk"] != before:
        raise AssertionError("k=100 must not launch the kernel")
    if not (torch.equal(i100[:, :10], results["k=10"][1]) or (v100[:, :10] - results["k=10"][0]).abs().max() < 1e-4):
        raise AssertionError("k=100 (torch.topk route) disagrees with the kernel's top 10")
    small = items[:N_ITEMS].contiguous()
    fused_small = fused_route("cuda", RETR_QUERIES, N_ITEMS, 10)
    vs, ixs = retrieval_topk(q, small, 10)
    torch.cuda.synchronize()
    if read_counts()["mips_topk"] != before + int(fused_small):
        raise AssertionError(f"the {N_ITEMS}-item call must take the route of the dispatch rule (fused: {fused_small})")
    ref = torch.topk(q @ small.T, 10, dim=1)
    if not torch.allclose(vs, ref.values, rtol=1e-5, atol=1e-5):
        raise AssertionError("the small catalog's scores disagree with the product and torch.topk")
    log(
        f"retrieval k=100 (product + torch.topk in row chunks, 0 launches): one call {t100:.4f}s; "
        f"{N_ITEMS}-item call: {int(fused_small)} launches, scores as torch.topk(q @ I.T)"
    )
    return launches


def explicit_ratings(rng: np.random.Generator, n_users: int, n_items: int):
    """bench.py's synthetic ratings (its section 5): per-item quality, per-user
    shift, a planted rank-8 interaction and noise, clipped to [0.5, 5]."""
    q_i = rng.normal(0, 0.5, size=n_items).astype(np.float32)
    s_u = rng.normal(0, 0.3, size=n_users).astype(np.float32)
    Up = rng.normal(0, 1, size=(n_users, 8)).astype(np.float32)
    Vp = rng.normal(0, 1, size=(n_items, 8)).astype(np.float32)

    def true_r(uu, ii):
        low = np.sum(Up[uu] * Vp[ii], axis=1) * (0.6 / np.sqrt(8))
        noise = rng.normal(0, 0.5, size=len(uu)).astype(np.float32)
        return np.clip(3.5 + q_i[ii] + s_u[uu] + low + noise, 0.5, 5.0).astype(np.float32)

    return true_r


def explicit_oracle_topn(hist, ratings, Y, b_i, g, damping, reg, n):
    """Float64 explicit fold-in for one user (bias removal, damped user bias,
    ridge solve), scoring with global + item + user bias, history masking and
    top-n."""
    resid = ratings - g - b_i[hist]
    ub = resid.sum() / (len(hist) + damping)
    G = Y[hist]
    u = np.linalg.solve(G.T @ G + reg * len(hist) * np.eye(Y.shape[1]), G.T @ (resid - ub))
    s = Y @ u + g + b_i + ub
    s[hist] = -np.inf
    return np.argsort(-s, kind="stable")[:n], s


def explicit_phase(dev, split: dict, rng: np.random.Generator) -> tuple[dict, dict]:
    """The explicit family: ``BiasedMFScorer.train`` on bench.py's synthetic
    ratings over the training split, hold-out RMSE through the scorer, then
    ``device_recommend`` with the explicit fold-in.  Returns the launches of
    the training run and of the serving call."""
    import pandas as pd

    from lkpy_tpu_torch.batch.device import device_recommend
    from lkpy_tpu_torch.data import ItemList, from_interactions_df
    from lkpy_tpu_torch.models.als import BiasedMFScorer
    from lkpy_tpu_torch.training import TrainingOptions

    t0 = time.perf_counter()
    tr_u, tr_i, test_u, test_i = split["tr_u"], split["tr_i"], split["test_u"], split["test_i"]
    true_r = explicit_ratings(rng, N_USERS, N_ITEMS)
    ratings, test_r = true_r(tr_u, tr_i), true_r(test_u, test_i)
    ds = from_interactions_df(pd.DataFrame({"user_id": tr_u, "item_id": tr_i, "rating": ratings}))
    matrix = ds.interaction_matrix()
    csr = matrix.csr("rating")
    log(f"explicit ratings: {len(ratings)} training, {len(test_r)} held-out, mean {ratings.mean():.4f} ({time.perf_counter() - t0:.1f}s to build)")

    # the explicit training path: counts are read from this call alone
    scorer = BiasedMFScorer(features=EXPLICIT_FEATURES, epochs=EPOCHS, regularization=0.1, damping=5.0)
    zero_counts()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    scorer.train(ds, TrainingOptions(rng=42))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - tw
    launches = read_counts()
    trainer = scorer.create_trainer(ds, TrainingOptions(rng=42))
    per_epoch = sum(c.rows.shape[0] for c in trainer.u_buckets + trainer.i_buckets)
    check_chunk_rows(trainer, EXPLICIT_FEATURES)
    log(
        f"explicit training path: BiasedMFScorer.train, k={EXPLICIT_FEATURES}, {EPOCHS} epochs, {train_s:.3f}s with set-up "
        f"(bias fit included); launches {launches}; {per_epoch} chunks per epoch"
    )
    if launches["spd_solve_chunked"] != per_epoch * EPOCHS or launches["gather_rows"] != per_epoch * EPOCHS:
        raise AssertionError(f"explicit training must launch spd_solve_chunked and gather_rows once a chunk: {launches}, {per_epoch} chunks")
    split["gather_epoch"] += gather_epoch_cases(trainer, EXPLICIT_FEATURES)
    for name in ("user_embeddings", "item_embeddings"):
        t = getattr(scorer, name)
        if t.device.type != dev.type or not torch.isfinite(t).all():
            raise AssertionError(f"trained {name} must be finite and on {dev} ({t.device})")
    times = []
    for _ in range(EPOCHS):
        ts = time.perf_counter()
        delta = float(trainer.train_epoch())
        times.append(time.perf_counter() - ts)
        if not np.isfinite(delta):
            raise AssertionError("non-finite explicit epoch delta")
    steady = times[1:] or times
    log(
        f"explicit epochs 2-{EPOCHS}: mean {np.mean(steady) * 1e3:.3f} ms, min {min(steady) * 1e3:.3f} ms, max "
        f"{max(steady) * 1e3:.3f} ms -> {2 * len(tr_u) * len(steady) / sum(steady):.4e} examples/s"
    )
    profile_device(lambda: trainer.train_epoch(), float(np.mean(steady)) * 1e3, "one explicit epoch", mark="spd_solve_chunked")

    # hold-out RMSE of clipped predictions through the scorer, beside the bias model's
    tq = time.perf_counter()
    order = np.argsort(test_u, kind="stable")
    bounds = np.flatnonzero(np.diff(test_u[order])) + 1
    sq_mf = sq_bias = 0.0
    for rows in np.split(order, bounds):
        uid = test_u[rows[0]]
        cand = ItemList(item_ids=test_i[rows])
        pred = scorer(uid, cand).scores()
        base, _ = scorer.bias.compute_for_items(cand, uid)
        if not np.isfinite(pred).all():
            raise AssertionError(f"user {uid}: non-finite prediction")
        sq_mf += float(np.sum((np.clip(pred, 0.5, 5.0) - test_r[rows]) ** 2))
        sq_bias += float(np.sum((np.clip(base, 0.5, 5.0) - test_r[rows]) ** 2))
    rmse, rmse_bias = np.sqrt(sq_mf / len(test_r)), np.sqrt(sq_bias / len(test_r))
    log(
        f"explicit hold-out RMSE through the scorer: {rmse:.4f} (bias only {rmse_bias:.4f}; "
        f"{len(bounds) + 1} users, {time.perf_counter() - tq:.1f}s)"
    )
    if not (rmse <= RMSE_MAX and rmse <= rmse_bias - RMSE_MIN_GAIN):
        raise AssertionError(f"explicit RMSE {rmse} (bias only {rmse_bias}) misses its bounds")

    # the explicit serving path: fold-in of 16,384 users, counts from this call alone
    serve = np.random.default_rng(5).choice(ds.users.ids, size=SERVE_USERS, replace=False)
    zero_counts()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    recs = device_recommend(scorer, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev)
    first_s = time.perf_counter() - tw
    served = read_counts()
    log(f"explicit serving path: device_recommend of {SERVE_USERS} users with fold-in, first call {first_s:.3f}s; launches {served}")
    blocks = -(-SERVE_USERS // SERVE_CHUNK)
    if served["spd_solve"] != blocks or served["gather_rows"] != blocks:
        raise AssertionError(f"explicit fold-in serving must launch spd_solve and gather_rows once a block ({blocks}): {served}")
    if len(recs) != SERVE_USERS:
        raise AssertionError(f"{len(recs)} lists for {SERVE_USERS} users")
    check_lists(recs, csr, ds.users, SERVE_N)
    Y = scorer.item_embeddings.double().cpu().numpy()
    b_i = scorer.bias.item_biases.astype(np.float64)
    hits, score_err = 0, 0.0
    for uid in serve[:256]:
        il = recs.lookup(uid)
        s, e = csr.row_extent(ds.users.number(uid))
        top, sc = explicit_oracle_topn(
            csr.colind[s:e], csr.values[s:e].astype(np.float64), Y, b_i, scorer.bias.global_bias, 5.0, 0.1, SERVE_N
        )
        hits += len(np.intersect1d(il.numbers(), top))
        score_err = max(score_err, float(np.abs(il.scores() - sc[il.numbers()]).max() / np.abs(sc[top]).max()))
    recall = hits / (256 * SERVE_N)
    log(f"explicit fold-in vs float64 (256 users): recall@{SERVE_N} {recall:.5f}, max relative score error {score_err:.3e}")
    if recall < 0.99 or score_err > 1e-3:
        raise AssertionError(f"explicit fold-in check failed: recall {recall}, score error {score_err}")
    times = []
    for _ in range(SERVE_CALLS):
        ts = time.perf_counter()
        device_recommend(scorer, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev)
        times.append(time.perf_counter() - ts)
    log(f"explicit serving: {SERVE_USERS} users per call, calls {times} s -> queries/s {[SERVE_USERS / t for t in times]}")
    return launches, served


def same_ids_at_clear_gaps(got, want) -> bool:
    """Equal item ids wherever the score gap to the next rank exceeds 1e-4."""
    s = want.scores()
    gap = np.abs(np.diff(s)) > 1e-4
    clear = np.ones(len(s), bool)
    clear[:-1] &= gap
    clear[1:] &= gap
    clear[-1] = False  # the rank below the last is not known
    return len(got) == len(want) and bool((np.asarray(got.ids())[clear] == np.asarray(want.ids())[clear]).all())


def pipeline_phase(dev, split: dict) -> tuple[dict, dict]:
    """The user's path: ``topn_pipeline(ImplicitMFScorer(...), n=10)`` →
    ``Pipeline.train`` on bench.py's split → ``recommend(pipe, users, n=10)``
    for the held-out split's test users, which takes the device route
    (``try_device_recommend``, fold-in of every user: B2 and the row gather
    once a block).  NDCG@10 against the direct path's, and per-query
    ``operations.recommend`` against the batch lists.  Returns the launches
    of the training call and of the serving call."""
    import lkpy_tpu_torch
    from lkpy_tpu_torch.batch import device as batch_device
    from lkpy_tpu_torch.batch import recommend
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.training import TrainingOptions

    ds, test_u, test_i = split["ds"], split["test_u"], split["test_i"]
    # user_embeddings=True, the reference's default: the batch route folds each user in ("prefer" would serve
    # the trained user table and run neither B2 nor the gather)
    scorer = ImplicitMFScorer(features=FEATURES, epochs=EPOCHS, weight=40.0, regularization=0.1, user_embeddings=True)
    pipe = lkpy_tpu_torch.topn_pipeline(scorer, n=10)
    zero_counts()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    pipe.train(ds, TrainingOptions(rng=42))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - tw
    trained = read_counts()
    per_epoch = split["chunks_per_epoch"]
    log(f"pipeline path: Pipeline.train, {train_s:.3f}s with set-up (every component); launches {trained}")
    if trained["spd_solve_chunked"] != per_epoch * EPOCHS or trained["gather_rows"] != per_epoch * EPOCHS or trained["spd_solve"]:
        raise AssertionError(f"Pipeline.train must launch B1 and the gather once a chunk ({per_epoch * EPOCHS}): {trained}")
    if scorer.item_embeddings.device.type != dev.type or not torch.isfinite(scorer.item_embeddings).all():
        raise AssertionError("the pipeline's trained item table must be finite and on the card")

    users = np.unique(test_u)
    taken = []
    route = batch_device.try_device_recommend

    def recording(*a, **kw):
        out = route(*a, **kw)
        taken.append(out)
        return out

    batch_device.try_device_recommend = recording
    try:
        zero_counts()
        torch.cuda.synchronize()
        tw = time.perf_counter()
        recs = recommend(pipe, users, n=10)
        serve_s = time.perf_counter() - tw
        served = read_counts()
    finally:
        batch_device.try_device_recommend = route
    # recommend serves in device_recommend's default block of users
    block = inspect.signature(batch_device.device_recommend_async).parameters["chunk"].default
    blocks = -(-len(users) // block)
    log(f"pipeline path: recommend of {len(users)} users, n=10, {serve_s:.3f}s; launches {served}; {blocks} blocks")
    if len(taken) != 1 or taken[0] is None or taken[0] is not recs:
        raise AssertionError("recommend(pipe, users, n=10) must take the device route (try_device_recommend)")
    if served["spd_solve"] != blocks or served["gather_rows"] != blocks or served["spd_solve_chunked"]:
        raise AssertionError(f"the pipeline's serving call must launch B2 and the gather once a block ({blocks}): {served}")
    rec_users, rec10 = [], []
    for key, il in recs.items():
        rec_users.append(key[0])
        rec10.append(list(il.ids()))
    nd = ndcg10(rec_users, rec10, test_u, test_i)
    # the same trained tables served from the user table, as "prefer" (and the direct path) would serve them
    table_route = ImplicitMFScorer(features=FEATURES, epochs=EPOCHS, user_embeddings="prefer")
    table_route.load_parameters(scorer.get_parameters())
    table_route.users, table_route.items = scorer.users, scorer.items
    lookup = pipe.node("history-lookup").component
    by_table = batch_device.device_recommend(table_route, users, 10, lookup.interactions, device=dev)
    nd_table = ndcg10(rec_users, [list(by_table.lookup(u).ids()) for u in rec_users], test_u, test_i)
    log(
        f"pipeline NDCG@10 on the held-out split: {nd:.4f} with fold-in, {nd_table:.4f} from its user table "
        f"(direct path {split['ndcg_fold']:.4f} and {split['ndcg']:.4f}, {len(rec_users)} users)"
    )
    if not (nd >= NDCG_MIN and max(abs(nd - split["ndcg_fold"]), abs(nd_table - split["ndcg"])) <= NDCG_PIPELINE_TOL):
        raise AssertionError(
            f"pipeline NDCG@10 {nd} (fold-in), {nd_table} (user table) must be >= {NDCG_MIN} and within "
            f"{NDCG_PIPELINE_TOL} of the direct path's {split['ndcg_fold']}, {split['ndcg']}"
        )

    # per query: history lookup, candidates, the scorer's host fold-in, the ranker
    tq = time.perf_counter()
    for u in users[:PER_QUERY_USERS]:
        one = lkpy_tpu_torch.recommend(pipe, u, n=10)
        if not same_ids_at_clear_gaps(one, recs.lookup(u)):
            raise AssertionError(f"user {u}: per-query recommend {list(one.ids())} differs from the batch list {list(recs.lookup(u).ids())}")
    log(f"per-query recommend of {PER_QUERY_USERS} users equals the batch lists at clear gaps ({time.perf_counter() - tq:.1f}s)")
    return trained, served


def chunks_per_epoch(ds) -> int:
    """Chunks of one ALS epoch over ``ds`` (both halves), bucketed and
    chunked as the trainers do it, on the host."""
    from lkpy_tpu_torch.models.als import LADDER_RATIO
    from lkpy_tpu_torch.ops.als import chunk_buckets
    from lkpy_tpu_torch.ops.sparse import bucket_rows

    csr = ds.interaction_matrix().csr(None)
    return sum(c.rows.shape[0] for m in (csr, csr.transpose()) for c in chunk_buckets(bucket_rows(m, ratio=LADDER_RATIO), device="cpu"))


def instrumented_quick(*args, **kwargs):
    """``quick_measure_model(*args, **kwargs)`` with its split,
    ``Pipeline.train`` and runner timed on the host clock (each ending in a
    synchronize) and the kernels each step launched; returns the results,
    the trained pipeline, the times and the launches by step."""
    from lkpy_tpu_torch.metrics import quick

    saved = quick.sample_users, quick.topn_pipeline, quick.BatchPipelineRunner
    times, steps, pipes = {}, {}, []

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            before = read_counts()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t
            steps[name] = {k: v - before[k] for k, v in read_counts().items()}
            return out

        return call

    def pipeline(*a, **kw):
        pipe = saved[1](*a, **kw)
        pipe.train = timed("train", pipe.train)
        pipes.append(pipe)
        return pipe

    class Runner(saved[2]):
        def run(self, *a, **kw):
            return timed("run", super().run)(*a, **kw)

    quick.sample_users, quick.topn_pipeline, quick.BatchPipelineRunner = timed("split", saved[0]), pipeline, Runner
    try:
        t = time.perf_counter()
        res = quick.quick_measure_model(*args, **kwargs)
        times["total"] = time.perf_counter() - t
    finally:
        quick.sample_users, quick.topn_pipeline, quick.BatchPipelineRunner = saved
    return res, pipes[0], times, steps


def check_quick_launches(label: str, steps: dict, res, scorer, predicts: bool) -> None:
    """Under ``quick_measure_model``, ``Pipeline.train`` launches B1 and P
    once a training chunk and no B2; the per-query runner launches no B1,
    and for every scorer call P and B2 to fold the user's training history
    in and P for the rows of the call's known items.  Each test user's
    query is one recommend call (the unseen training items) and, with
    ``predicts``, one predict call (the user's test items)."""
    per_chunk = chunks_per_epoch(res.split.train) * EPOCHS
    test = res.split.test
    calls = len(test) * (2 if predicts else 1)
    unknown = sum(not (scorer.items.numbers(t.ids(), missing="negative") >= 0).any() for _, t in test.items()) if predicts else 0
    want = {
        "train": {"spd_solve": 0, "spd_solve_chunked": per_chunk, "mips_topk": 0, "gather_rows": per_chunk},
        "run": {"spd_solve": calls, "spd_solve_chunked": 0, "mips_topk": 0, "gather_rows": 2 * calls - unknown},
    }
    log(f"{label}: launches by step {steps}; {per_chunk} training chunks, {calls} scorer calls ({unknown} with no known item)")
    for step, counts in want.items():
        if steps[step] != counts:
            raise AssertionError(f"{label}: {step} must launch {counts}, launched {steps[step]}")


def own_ranking_means(recs, test, n: int) -> tuple[float, float]:
    """Mean NDCG@n and Recall@n of ``recs`` against ``test``, as
    ``metrics/ranking.py`` defines them (binary gain, weight 1/max(log2 rank,
    1), ideal over min(|test|, n) ranks; hits over |test|), computed here."""
    w = 1.0 / np.maximum(np.log2(np.arange(1, n + 1)), 1.0)
    ndcg, recall = [], []
    for key, il in recs.items():
        t = test.lookup(key.user_id)
        good = np.isin(np.asarray(il.ids())[:n], t.ids())
        ndcg.append(float(w[: len(good)][good].sum()) / float(w[: min(len(t), n)].sum()))
        recall.append(float(good.sum()) / len(t))
    return float(np.mean(ndcg)), float(np.mean(recall))


def own_rmse(preds, test) -> float:
    """Mean over users of each user's RMSE of the predicted test ratings
    (a user without a finite prediction is skipped), computed here."""
    vals = []
    for key, t in test.items():
        p = preds.lookup(key.user_id)
        if p is None:
            continue
        s = dict(zip(p.ids().tolist(), p.scores().astype(np.float64)))
        pairs = [(s[i], r) for i, r in zip(t.ids().tolist(), t.field("rating").astype(np.float64)) if np.isfinite(s.get(i, np.nan))]
        if pairs:
            vals.append(float(np.sqrt(np.mean([(a - b) ** 2 for a, b in pairs]))))
    return float(np.mean(vals))


def log_quick(label: str, res, times: dict) -> None:
    n = len(res.split.test)
    log(
        f"{label}: quick_measure_model {times['total']:.3f}s: split {times['split']:.3f}s, train {times['train']:.3f}s, "
        f"run {times['run']:.3f}s ({n} queries, {times['run'] * 1e3 / n:.3f} ms a query); "
        f"{res.split.train.interaction_count} training and {res.split.test_size} test interactions"
    )
    log(f"{label}: global_metrics() " + json.dumps({k: float(v) for k, v in res.global_metrics().items()}))


def evaluation_phase(dev, ds, rng: np.random.Generator):
    """Offline evaluation: ``quick_measure_model`` of implicit ALS on all of
    bench.py's interactions (split, ``Pipeline.train`` on the card, the
    per-query runner with each query's fold-in and scores on the card,
    ``RunAnalysis``), its metrics against the script's own,
    the same trained pipeline served through the device route; then of
    biased MF with ``predicts_ratings=True`` on bench.py's synthetic ratings
    of the same interactions, its RMSE against the bias model's on the same
    split.  Returns the launches of the implicit call, of the device route's
    call and of the explicit call."""
    import pandas as pd

    from lkpy_tpu_torch.batch import device as batch_device
    from lkpy_tpu_torch.batch import recommend
    from lkpy_tpu_torch.data import ItemList, ItemListCollection, from_interactions_df
    from lkpy_tpu_torch.metrics import NDCG, RunAnalysis
    from lkpy_tpu_torch.models.als import BiasedMFScorer, ImplicitMFScorer
    from lkpy_tpu_torch.models.bias import BiasScorer
    from lkpy_tpu_torch.training import TrainingOptions

    scorer = ImplicitMFScorer(features=FEATURES, epochs=EPOCHS, weight=40.0, regularization=0.1)
    zero_counts()
    res, pipe, times, steps = instrumented_quick(scorer, ds, n_recs=EVAL_N, user_frac=EVAL_USER_FRAC, rng=42)
    trained = read_counts()
    log_quick("evaluation", res, times)
    check_quick_launches("evaluation", steps, res, scorer, predicts=False)
    for name in ("user_embeddings", "item_embeddings", "_OtOr"):
        t = getattr(scorer, name)
        if t.device.type != dev.type or not torch.isfinite(t).all():
            raise AssertionError(f"the evaluated scorer's {name} must be finite and on {dev} ({t.device})")
    gm = res.global_metrics()
    ndcg, rec = own_ranking_means(res.recommendations, res.split.test, EVAL_N)
    log(f"evaluation: NDCG@{EVAL_N} {ndcg:.10f} and Recall@{EVAL_N} {rec:.10f} computed here, RunAnalysis {gm[f'NDCG@{EVAL_N}']:.10f} and {gm[f'Recall@{EVAL_N}']:.10f}")
    if max(abs(ndcg - gm[f"NDCG@{EVAL_N}"]), abs(rec - gm[f"Recall@{EVAL_N}"])) > EVAL_METRIC_TOL:
        raise AssertionError(f"RunAnalysis's means differ from the script's own: {gm.to_dict()} against {ndcg}, {rec}")

    # the same trained pipeline through the device route: B2 and the gather once a block
    users = np.array([k.user_id for k in res.split.test.keys()])
    taken = []
    route = batch_device.try_device_recommend

    def recording(*a, **kw):
        out = route(*a, **kw)
        taken.append(out)
        return out

    batch_device.try_device_recommend = recording
    try:
        zero_counts()
        torch.cuda.synchronize()
        tw = time.perf_counter()
        fast = recommend(pipe, users, n=EVAL_N)
        serve_s = time.perf_counter() - tw
        served = read_counts()
    finally:
        batch_device.try_device_recommend = route
    block = inspect.signature(batch_device.device_recommend_async).parameters["chunk"].default
    blocks = -(-len(users) // block)
    log(f"evaluation: device route of the {len(users)} evaluated users, {serve_s:.3f}s; launches {served}; {blocks} blocks")
    if len(taken) != 1 or taken[0] is None or taken[0] is not fast:
        raise AssertionError("recommend(pipe, users, n=20) must take the device route (try_device_recommend)")
    if served["spd_solve"] != blocks or served["gather_rows"] != blocks or served["spd_solve_chunked"]:
        raise AssertionError(f"the device route must launch B2 and the gather once a block ({blocks}): {served}")
    differ = [u for u in users if not same_ids_at_clear_gaps(res.recommendations.lookup(u), fast.lookup(u))]
    nd_fast = float(RunAnalysis(NDCG(EVAL_N)).measure(fast, res.split.test).global_metrics()[f"NDCG@{EVAL_N}"])
    log(
        f"evaluation: runner lists equal to the device route's at clear gaps for {len(users) - len(differ)} of {len(users)} users; "
        f"NDCG@{EVAL_N} {gm[f'NDCG@{EVAL_N}']:.6f} (runner) and {nd_fast:.6f} (device route)"
    )
    if differ or len(users) < EVAL_MIN_COMPARED:
        raise AssertionError(f"the runner's lists differ from the device route's for users {differ[:10]} ({len(users)} compared)")
    if abs(nd_fast - gm[f"NDCG@{EVAL_N}"]) > EVAL_NDCG_TOL:
        raise AssertionError(f"NDCG@{EVAL_N} {gm[f'NDCG@{EVAL_N}']} (runner) and {nd_fast} (device route) differ by more than {EVAL_NDCG_TOL}")

    # explicit: predicts_ratings=True runs the predict invocation and RMSE/MAE
    t0 = time.perf_counter()
    tbl = ds.interaction_table(ids=True)
    uid, iid = tbl["user_id"].to_numpy(), tbl["item_id"].to_numpy()
    ratings = explicit_ratings(rng, N_USERS, N_ITEMS)(uid, iid)
    rated = from_interactions_df(pd.DataFrame({"user_id": uid, "item_id": iid, "rating": ratings}))
    log(f"evaluation: {len(ratings)} synthetic ratings ({time.perf_counter() - t0:.1f}s to build)")
    mf = BiasedMFScorer(features=EXPLICIT_FEATURES, epochs=EPOCHS, regularization=0.1, damping=5.0)
    zero_counts()
    eres, _, etimes, esteps = instrumented_quick(mf, rated, predicts_ratings=True, n_recs=EVAL_N, user_frac=EVAL_EXPLICIT_USER_FRAC, rng=42)
    explicit = read_counts()
    log_quick("explicit evaluation", eres, etimes)
    check_quick_launches("explicit evaluation", esteps, eres, mf, predicts=True)
    rmse = float(eres.global_metrics()["RMSE"])
    own = own_rmse(eres.predictions, eres.split.test)
    bias = BiasScorer(damping=5.0)
    bias.train(eres.split.train, TrainingOptions(device=dev))
    base = {k.user_id: bias(k.user_id, ItemList(item_ids=t.ids())) for k, t in eres.split.test.items()}
    rmse_bias = own_rmse(ItemListCollection.from_dict(base, "user_id"), eres.split.test)
    log(f"explicit evaluation: RMSE {rmse:.10f} (RunAnalysis), {own:.10f} computed here; the bias model's on the same split {rmse_bias:.10f}")
    if abs(rmse - own) > EVAL_METRIC_TOL:
        raise AssertionError(f"RunAnalysis's RMSE {rmse} differs from the script's own {own}")
    if not (rmse <= RMSE_MAX and rmse < rmse_bias):
        raise AssertionError(f"explicit evaluation RMSE {rmse} must be <= {RMSE_MAX} and below the bias model's {rmse_bias}")
    return trained, served, explicit


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lkpy_tpu_torch  # noqa: F401 — fails where the port is absent
    from lkpy_tpu_torch.ops import _build
    from lkpy_tpu_torch.ops.spd_solve import _launch as launch_fold
    from lkpy_tpu_torch.ops.spd_solve import fold_mappings, fold_route, spd_solve, spd_solve_plain
    from lkpy_tpu_torch.ops.spd_solve_chunked import _launch as launch_chunked
    from lkpy_tpu_torch.ops.spd_solve_chunked import (
        register_route_info, solve_route, spd_solve_chunked, spd_solve_chunked_plain,
    )  # fmt: skip

    missing = {"gather_rows", "mips_topk", "spd_solve", "spd_solve_chunked"} - set(_build.sources())
    if missing:
        raise AssertionError(f"kernel sources missing from the checkout: {sorted(missing)}")
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
    if sys.argv[1:] == ["--sweeps"]:
        sweeps(dev)
        log(card)
        return 0

    # plain_tol 1e-5: the register route rounds otherwise than the plain version (fmaf, a reciprocal of the
    # pivot); on these well-conditioned systems (eigenvalues in about [1, 5]) they differ by under 1e-6
    spd = solve_kernel_phase(
        "spd_solve", spd_solve, spd_solve_plain, SPD_SHAPES, SPD_MAIN_SHAPE, SPD_EXPLICIT_SHAPE, 1e-5, 7, dev,
        previous=lambda A, y: launch_fold(A, y, *fold_mappings(y.shape[1])[-1]), route_of=lambda B, k: "%s x%d" % fold_route(B, k),
    )  # fmt: skip
    spd.update(fold_grid_phase(dev))
    chunked = solve_kernel_phase(
        "spd_solve_chunked", spd_solve_chunked, spd_solve_chunked_plain, CHUNKED_SHAPES, CHUNKED_MAIN_SHAPE,
        CHUNKED_EXPLICIT_SHAPE, 1e-5, 8, dev, previous=lambda A, y: launch_chunked(A, y, "shared"),
        route_of=lambda N, k: solve_route(k),
    )  # fmt: skip
    singular_neighbours_phase(dev)
    chunked["register_route"] = [register_route_info(k) for k in (32, 64, 96, 128)]
    log(f"spd_solve_chunked register route as compiled: {chunked['register_route']}")
    topk = topk_kernel_phase(dev)
    gather_probe = gather_kernel_phase(dev)

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

    serving, full = slice_phase(dev, users, items, continued())
    training, served, split = training_phase(dev, users, items, continued())
    # the later phases draw on from the generator where the split left it, as bench.py does
    retrieval = retrieval_phase(dev, split["scorer"], split["rng"])
    explicit_training, explicit_serving = explicit_phase(dev, split, split["rng"])
    pipeline_training, pipeline_serving = pipeline_phase(dev, split)
    evaluation_training, evaluation_serving, explicit_evaluation = evaluation_phase(dev, full, split["rng"])

    paths = {
        "serving": serving,
        "training": training,
        "serving_trained": served,
        "retrieval": retrieval,
        "explicit_training": explicit_training,
        "explicit_serving": explicit_serving,
        "pipeline_training": pipeline_training,
        "pipeline_serving": pipeline_serving,
        "evaluation_training": evaluation_training,
        "evaluation_serving": evaluation_serving,
        "explicit_evaluation": explicit_evaluation,
    }
    for path, kernel in [
        ("retrieval", "mips_topk"), ("explicit_training", "spd_solve_chunked"), ("explicit_serving", "spd_solve"),
        ("pipeline_training", "spd_solve_chunked"), ("pipeline_training", "gather_rows"), ("pipeline_serving", "spd_solve"),
        ("pipeline_serving", "gather_rows"), ("evaluation_training", "spd_solve_chunked"),
        ("evaluation_training", "gather_rows"), ("evaluation_training", "spd_solve"), ("evaluation_serving", "spd_solve"),
        ("evaluation_serving", "gather_rows"), ("explicit_evaluation", "spd_solve_chunked"),
        ("explicit_evaluation", "gather_rows"), ("explicit_evaluation", "spd_solve"),
    ]:  # fmt: skip
        if paths[path][kernel] == 0:
            raise AssertionError(f"the {path} path launched no {kernel} kernel")
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
        dict(
            name="mips_topk",
            route="cuda",
            source="lkpy_tpu_torch/csrc/mips_topk.cu",
            replaces="lkpy_tpu/ops/pallas_topk.py:62",
            launches=retrieval["mips_topk"],
            launches_by_path={p: c["mips_topk"] for p, c in paths.items()},
            **topk,
        ),
        dict(
            name="gather_rows",
            route="cuda",
            source="lkpy_tpu_torch/csrc/gather_rows.cu",
            replaces="benchmarks/probe_gather.py:113",
            launches=pipeline_training["gather_rows"] + pipeline_serving["gather_rows"],
            launches_by_path={p: c["gather_rows"] for p, c in paths.items()},
            # the main row: the implicit epoch's largest chunk, the user half's (30024, 120) against the item table
            **{k: v for k, v in split["gather_epoch"][0].items() if k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            shape=split["gather_epoch"][0]["label"],
            epoch_shapes=split["gather_epoch"],
            probe_shapes=gather_probe,
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
