"""
The two SPD solves' blocked route (``csrc/spd_blocked.cuh``) on one NVIDIA GPU.

    python3 scripts/spd_blocked_probe.py [--check-only | --clocks]

Builds the two solves, prints the blocked instances' registers and spilled
bytes as compiled, then holds the blocked route of both solves (the training
solve's own choice of threads, and the fold-in solve's 256 and 512 threads a
system) against the plain version and a float64 solve at widths from 1 to
256, on inputs aligned to 16 bytes and not, with zero and negative systems
among regular ones.  Then times, by CUDA events, the blocked route beside
``cholesky`` + ``cholesky_solve`` and the bound: the training solve at the
tuner's chunk shapes and the fold-in solve on the grid B ∈ {1, 64, 1024,
16384} × k ∈ {129, 160, 192, 256} that ``fold_route``'s rule is set from.  With
``--check-only`` it stops after the checks.  With ``--clocks`` it builds
``scripts/spd_blocked_clocks.cu`` (the same solve with its phase clocks on)
and prints, for one system of each shape, the cycles of each phase: the
load, the first diagonal tile, the panel solves, the trailing updates (with
the next diagonal tile), the back substitution's sums and diagonal solves.
Prints the card's name and power limit first and last.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

#: widths on both sides of every tile boundary, and the register route's
CHECK_K = [1, 8, 31, 32, 33, 64, 100, 128, 129, 130, 160, 192, 200, 255, 256]
CHECK_N = [1, 7, 333]
#: the training solve at the tuner's chunk shapes
CHUNKED_TIMED = [(29936, 256), (16384, 192), (333, 129), (64, 256)]
GRID_B = [1, 64, 1024, 16384]
GRID_K = [129, 160, 192, 256]


def agree(x, plain, A, y) -> tuple[float, float]:
    """The error of x and of the plain version against float64, per row's scale."""
    x64 = torch.linalg.solve(A.double(), y.double()[:, :, None])[:, :, 0]
    scale = x64.abs().amax(dim=1, keepdim=True)
    return float(((x.double() - x64).abs() / scale).max()), float(((plain.double() - x64).abs() / scale).max())


def check(dev) -> None:
    from lkpy_tpu_torch.ops.spd_solve import _launch as launch_fold
    from lkpy_tpu_torch.ops.spd_solve import BLOCKED_THREADS, spd_solve_plain
    from lkpy_tpu_torch.ops.spd_solve_chunked import _launch as launch_chunked

    worst = 0.0
    for k in CHECK_K:
        for N in CHECK_N:
            A, y = cs.spd_inputs_on_card(1000 * N + k, N, k, dev)
            plain = spd_solve_plain(A, y)
            runs = {"chunked": launch_chunked(A, y, "blocked")}
            runs.update({f"fold x{t}": launch_fold(A, y, "blocked", t) for t in BLOCKED_THREADS})
            # A one float into its storage: 4-byte copies; y too
            A1 = torch.empty(A.numel() + 1, device=dev)[1:].view_as(A).copy_(A)
            y1 = torch.empty(y.numel() + 1, device=dev)[1:].view_as(y).copy_(y)
            runs["chunked misaligned"] = launch_chunked(A1, y1, "blocked")
            torch.cuda.synchronize()
            for label, x in runs.items():
                e, ep = agree(x, plain, A, y)
                worst = max(worst, e)
                if not (e <= max(2 * ep, 1e-6) and e <= 1e-4):
                    raise AssertionError(f"blocked {label} ({N}, {k}): error vs float64 {e}, plain's {ep}")
            if not torch.equal(runs["chunked misaligned"], runs["chunked"]):
                raise AssertionError(f"blocked ({N}, {k}): the misaligned input's result differs from the aligned one's")
    cs.log(f"blocked route: every width and batch within 2x the plain version's float64 error, worst {worst:.3e}")
    for k in (40, 129, 256):
        A, y = cs.spd_inputs_on_card(k, 21, k, dev)
        A0 = A.clone()
        A0[[3, 4, 11, 20]] = 0.0
        A0[7] = -A0[7]
        bad = torch.zeros(21, dtype=torch.bool, device=dev)
        bad[[3, 4, 7, 11, 20]] = True
        for label, fn in [("chunked", lambda a: launch_chunked(a, y, "blocked"))] + [
            (f"fold x{t}", lambda a, t=t: launch_fold(a, y, "blocked", t)) for t in BLOCKED_THREADS
        ]:
            clean, got = fn(A), fn(A0)
            torch.cuda.synchronize()
            if torch.isfinite(got[bad]).any() or not torch.equal(got[~bad], clean[~bad]):
                raise AssertionError(f"blocked {label} k={k}: zero or negative systems must be non-finite in their own rows only")
    cs.log("blocked route: zero and negative systems non-finite in their own rows, neighbours unchanged to the bit")


def lib_ms(A, y) -> float:
    return cs.cuda_ms(lambda: torch.cholesky_solve(y[:, :, None], torch.linalg.cholesky(A)), reps=5, warm=1)


def time_chunked(dev) -> list:
    from lkpy_tpu_torch.ops.spd_solve import _launch as launch_fold
    from lkpy_tpu_torch.ops.spd_solve_chunked import _launch as launch_chunked

    rows = []
    for N, k in CHUNKED_TIMED:
        A, y = cs.spd_inputs_on_card(N + k, N, k, dev)
        big = N * k > 1000 * 256
        ms = cs.cuda_ms(lambda: launch_chunked(A, y, "blocked"), reps=5 if big else 50)
        by_threads = {t: cs.cuda_ms(lambda t=t: launch_fold(A, y, "blocked", t), reps=5 if big else 50) for t in (256, 512)}
        lib = lib_ms(A, y)
        bound, by = cs.spd_bound(N, k)
        cs.log(
            f"spd_solve_chunked ({N}, {k}): blocked {ms:.4f} ms ({ms / bound:.2f}x the {bound:.4f} ms {by} bound; "
            f"256 threads {by_threads[256]:.4f}, 512 threads {by_threads[512]:.4f}), "
            f"cholesky+cholesky_solve {lib:.4f} ms ({lib / ms:.2f}x)"
        )
        rows.append(dict(shape=[N, k], ms=ms, by_threads=by_threads, library_ms=lib, bound_ms=bound, bound_by=by))
        del A, y
    return rows


def time_grid(dev) -> list:
    from lkpy_tpu_torch.ops.spd_solve import _launch as launch_fold
    from lkpy_tpu_torch.ops.spd_solve import fold_route

    rows = []
    for k in GRID_K:
        A_all, y_all = cs.spd_inputs_on_card(k, max(GRID_B), k, dev)
        for B in GRID_B:
            A, y = A_all[:B], y_all[:B]
            ms = {t: cs.cuda_ms(lambda t=t: launch_fold(A, y, "blocked", t), reps=20) for t in (256, 512)}
            lib = lib_ms(A, y)
            bound, by = cs.spd_bound(B, k)
            taken = fold_route(B, k)
            cs.log(
                f"fold grid B={B} k={k}: blocked x256 {ms[256]:.4f}, x512 {ms[512]:.4f} ms (fold_route {taken}); "
                f"cholesky+cholesky_solve {lib:.4f} ms; bound {bound:.4f} ms ({by})"
            )
            rows.append(dict(B=B, k=k, blocked_ms=ms, library_ms=lib, bound_ms=bound, taken=list(taken)))
        del A_all, y_all
    one_sm = (256**3 / 3 + 2 * 256**2) / (cs.PEAK_F32_FLOP_PER_S / 132) * 1e3
    cs.log(f"one k = 256 system at one SM's f32 rate: {one_sm * 1e3:.2f} us")
    return rows


CLOCK_SHAPES = [(1, 256, 512), (1, 256, 256), (29936, 256, 512), (1, 192, 256), (16384, 192, 256), (1, 160, 512)]
PHASES = ["load", "first diagonal", "panel solves", "updates", "inverses", "back sums", "back solves", "write"]


def clocks(dev) -> list:
    from lkpy_tpu_torch.ops import _build

    src = Path(__file__).resolve().parent / "spd_blocked_clocks.cu"
    out = Path(__file__).resolve().parents[1] / "build" / "lkpy_tpu_torch" / "libspd_blocked_clocks.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], check=True)
    fn = ctypes.CDLL(str(out)).lkt_spd_blocked_clocks
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), ptr]
    fn.restype = ctypes.c_int
    rows = []
    for n, k, threads in CLOCK_SHAPES:
        A, y = cs.spd_inputs_on_card(n + k, n, k, dev)
        x = torch.empty_like(y)
        cyc = (ctypes.c_ulonglong * 8)()
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(2):  # the second launch is the one read
            err = fn(A.data_ptr(), y.data_ptr(), x.data_ptr(), n, k, threads, cyc, stream)
            if err != 0:
                raise RuntimeError(f"the clocks build failed with CUDA error {err}")
        total = sum(cyc[: len(PHASES)])
        shares = {name: round(cyc[i] / total, 4) for i, name in enumerate(PHASES)}
        cs.log(f"phase clocks ({n}, {k}) x{threads}, block 0: {total} cycles; " + ", ".join(f"{p} {cyc[i]}" for i, p in enumerate(PHASES)))
        rows.append(dict(shape=[n, k], threads=threads, cycles=total, by_phase={p: cyc[i] for i, p in enumerate(PHASES)}, shares=shares))
        del A, y, x
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("spd_blocked_probe: no CUDA device", file=sys.stderr)
        return 1
    from lkpy_tpu_torch.ops import _build
    from lkpy_tpu_torch.ops.spd_solve import BLOCKED_THREADS, blocked_route_info

    card = cs.card_line()
    cs.log(card)
    cs.log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.load, ["spd_solve", "spd_solve_chunked"]))
    cs.log(f"build: {time.perf_counter() - t:.1f}s")
    cs.log(f"blocked route as compiled: {[blocked_route_info(t) for t in BLOCKED_THREADS]}")
    t = time.perf_counter()
    check(dev)
    cs.log(f"checks: {time.perf_counter() - t:.1f}s")
    if sys.argv[1:] == ["--clocks"]:
        out = dict(clocks=clocks(dev))
    elif sys.argv[1:] != ["--check-only"]:
        out = dict(chunked=time_chunked(dev), grid=time_grid(dev))
    if sys.argv[1:] != ["--check-only"]:
        Path("chiprun_out").mkdir(exist_ok=True)
        Path(f"chiprun_out/spd_blocked_probe{'_clocks' if '--clocks' in sys.argv else ''}.json").write_text(json.dumps(out, indent=1))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
