"""
Smoke run of the PyTorch/CUDA port (``lkpy_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every kernel under ``lkpy_tpu_torch/csrc`` (one ``nvcc`` per source,
   started together).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and times kernel, plain version and a
   library yardstick.
3. Drives the port's main path at full width: implicit-ALS batch serving
   (``device_recommend`` with fold-in, ``features=64``) of 16,384 users on a
   synthetic ML-20M-scale set (138k users x 27k items, bench.py's generator),
   counts the kernel launches it made, checks the results against a float64
   NumPy/SciPy oracle, and times it.
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
FEATURES = 64
SERVE_USERS = 16_384
SERVE_N = 100
SERVE_CHUNK = 1024

#: (B, k) shapes of the SPD-solve kernel phase: the serving block and batch
#: at k=64, then ragged and extreme widths
SPD_SHAPES = [(1024, 64), (16384, 64), (1000, 50), (7, 8), (333, 128), (64, 256)]
SPD_MAIN_SHAPE = (SERVE_CHUNK, FEATURES)


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


def spd_phase(dev) -> dict:
    from lkpy_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain

    rng = np.random.default_rng(7)
    row = None
    for B, k in SPD_SHAPES:
        A, y = spd_inputs(rng, B, k, dev)
        x = spd_solve(A, y)
        torch.cuda.synchronize()
        p = spd_solve_plain(A, y)
        torch.cuda.synchronize()
        abs_err = float((x - p).abs().max())
        rel_err = abs_err / float(p.abs().max())
        x64 = torch.linalg.solve(A.double(), y.double())
        err64 = float((x.double() - x64).abs().max() / x64.abs().max())
        resid = float((A.double() @ x.double()[:, :, None])[:, :, 0].sub(y.double()).abs().max() / y.abs().max())
        if not (np.isfinite(abs_err) and rel_err <= 1e-4):
            raise AssertionError(f"spd_solve ({B},{k}): kernel vs plain max relative error {rel_err}")
        if not (err64 <= 1e-4 and resid <= 1e-4):
            raise AssertionError(f"spd_solve ({B},{k}): error vs float64 {err64}, residual {resid}")
        ms = cuda_ms(lambda: spd_solve(A, y), reps=20)
        plain_ms = cuda_ms(lambda: spd_solve_plain(A, y), reps=3, warm=1)
        lib_ms = cuda_ms(lambda: torch.cholesky_solve(y[:, :, None], torch.linalg.cholesky(A)), reps=10)
        bound_ms, bound_by = spd_bound(B, k)
        log(
            f"spd_solve B={B} k={k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cholesky+cholesky_solve {lib_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}); "
            f"vs plain max abs {abs_err:.3e} rel {rel_err:.3e}; vs float64 {err64:.3e}; residual {resid:.3e}"
        )
        if (B, k) == SPD_MAIN_SHAPE:
            row = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
    # a zero diagonal must give non-finite output, as the TPU kernel's does
    A, y = spd_inputs(rng, 3, FEATURES, dev)
    A[1] = 0.0
    x = spd_solve(A, y)
    torch.cuda.synchronize()
    if torch.isfinite(x[1]).any() or not torch.isfinite(x[[0, 2]]).all():
        raise AssertionError("spd_solve: a zero-diagonal system must give non-finite output, the others finite")
    log("spd_solve zero-diagonal system: non-finite output, as required")
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


def slice_phase(dev) -> dict:
    import pandas as pd

    from lkpy_tpu_torch.batch.device import device_recommend
    from lkpy_tpu_torch.data import from_interactions_df
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.ops.als import implicit_otor
    from lkpy_tpu_torch.ops.spd_solve import spd_solve

    t0 = time.perf_counter()
    rng = np.random.default_rng(42)
    users, items = synth_interactions(rng)
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

    # the main path: counts are read from this call alone
    spd_solve.launches = 0
    torch.cuda.synchronize()
    tw = time.perf_counter()
    recs = device_recommend(scorer, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev)
    warm_s = time.perf_counter() - tw
    launches = {"spd_solve": spd_solve.launches}
    log(f"main path: device_recommend of {SERVE_USERS} users, first call {warm_s:.3f}s; launches {launches}")
    if launches["spd_solve"] == 0:
        raise AssertionError("the main path launched no spd_solve kernel")

    # shape, finiteness, order and history exclusion for every user
    if len(recs) != SERVE_USERS:
        raise AssertionError(f"{len(recs)} lists for {SERVE_USERS} users")
    for key, il in recs.items():
        s = il.scores()
        if len(il) != SERVE_N or not np.isfinite(s).all() or (np.diff(s) > 0).any():
            raise AssertionError(f"user {key.user_id}: bad list (len {len(il)})")
        if np.isin(il.numbers(), csr.row_cols(ds.users.number(key.user_id))).any():
            raise AssertionError(f"user {key.user_id}: a history item was recommended")
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

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        device_recommend(scorer, serve, SERVE_N, matrix, chunk=SERVE_CHUNK, device=dev)
        torch.cuda.synchronize()
    # device activities only: aten:: operators repeat their kernels' time
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    total_ms = sum(e.self_device_time_total for e in evs) / 1e3
    wall_ms = float(np.mean(times)) * 1e3
    log(
        f"profile of one call: device busy {total_ms:.3f} ms in {len(evs)} kinds of kernel and copy; "
        f"mean unprofiled call {wall_ms:.3f} ms -> device idle share {1 - total_ms / wall_ms:.3f}"
    )
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} {e.key[:110]}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lkpy_tpu_torch  # noqa: F401 — fails where the port is absent
    from lkpy_tpu_torch.ops import _build

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(
        f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}; "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
    )
    dev = torch.device("cuda")

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

    spd = spd_phase(dev)
    launches = slice_phase(dev)

    kernels = [
        dict(
            name="spd_solve",
            route="cuda",
            source="lkpy_tpu_torch/csrc/spd_solve.cu",
            replaces="lkpy_tpu/ops/pallas_solve.py:42",
            launches=launches["spd_solve"],
            **spd,
        )
    ]
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
