"""
The row gather (``csrc/gather_rows.cu``) against ``index_select`` over a grid
of shapes, on one NVIDIA GPU.

    python3 scripts/gather_sweep.py [--source OLDER/gather_rows.cu ...]

Builds the repository's ``csrc/gather_rows.cu`` and each ``--source`` given
(another version of the file, such as a parent commit's from ``git show``)
with ``nvcc -Xptxas -v`` and prints what ptxas reports for every kernel
instance.  Then for M in {100, 1,000, 27,000, 4,194,304} int32 rows and K in
{50, 64, 128}, from a (27,000, K) table (it stays in the 50 MB L2) and at
K = 128 also from the gather probe's (131,072, 128) table (64 MB, it does
not), it times ``index_select`` and every build in turns (``index_select``,
the builds, the builds in reverse order, ``index_select``; each time the
mean of CUDA events around 20 launches, 5 at 4M rows) and prints the mean
of the two turns beside the bytes bound.  The repository's build is timed
at its own choice of units a thread and at each of 1 and 4.  Every
build is checked bit-equal to ``index_select`` at every shape.  Prints the
rows as one JSON line and the card's name and power limit first and last.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROWS = [100, 1_000, 27_000, 1 << 22]
WIDTHS = [50, 64, 128]
TABLES = {50: [27_000], 64: [27_000], 128: [27_000, 131_072]}


def build(source: Path) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` with the port's flags and ``-Xptxas -v`` into
    ``build/gather_sweep/``; returns the library and ptxas's report."""
    from lkpy_tpu_torch.ops import _build

    text = source.read_bytes()
    out = ROOT / "build" / "gather_sweep" / f"lib{hashlib.sha256(text).hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}")
    return ctypes.CDLL(str(out)), proc.stdout


def caller(lib: ctypes.CDLL, depth: int | None):
    """``fn(table, idx) -> out`` through ``lib``'s gather; ``depth`` is
    passed where the library takes one (the redesigned interface)."""
    fn = lib.lkt_gather_rows_f32
    takes_depth = hasattr(lib, "lkt_gather_rows_depth")
    args = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    args += [ctypes.c_longlong, ctypes.c_int] + ([ctypes.c_int] if takes_depth else []) + [ctypes.c_void_p]
    fn.argtypes, fn.restype = args, ctypes.c_int

    def call(table, idx):
        M, (n, K) = idx.numel(), table.shape
        out = torch.empty((M, K), dtype=torch.float32, device=table.device)
        extra = [depth or 0] if takes_depth else []
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), K, n, idx.data_ptr(), idx.element_size(), out.data_ptr(), M, K, *extra, stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    sources = [("repo", ROOT / "lkpy_tpu_torch" / "csrc" / "gather_rows.cu")]
    argv = sys.argv[1:]
    while argv:
        if argv[0] != "--source" or len(argv) < 2:
            raise SystemExit(__doc__)
        sources.append((Path(argv[1]).parent.name or argv[1], Path(argv[1])))
        argv = argv[2:]
    variants = {}
    for name, path in sources:
        lib, report = build(path)
        print(f"--- ptxas, {name} ({path}):\n{report}", flush=True)
        if name == "repo":
            variants["repo auto"] = caller(lib, None)
            for d in (1, 4):
                variants[f"repo d={d}"] = caller(lib, d)
        else:
            variants[name] = caller(lib, None)
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    rows = []
    for K in WIDTHS:
        for n in TABLES[K]:
            table = torch.from_numpy(rng.standard_normal((n, K), dtype=np.float32)).to(dev)
            for M in ROWS:
                idx = torch.from_numpy(rng.integers(0, n, M).astype(np.int32)).to(dev)
                want = table.index_select(0, idx)
                for name, fn in variants.items():
                    if not torch.equal(fn(table, idx), want):
                        raise AssertionError(f"{name} differs from index_select at M={M}, table ({n}, {K})")
                reps = 5 if M > 100_000 else 20
                order = ["index_select", *variants, *reversed(variants), "index_select"]
                fns = {"index_select": lambda: torch.index_select(table, 0, idx), **variants}
                times: dict[str, list[float]] = {}
                for name in order:
                    f = fns[name]
                    times.setdefault(name, []).append(cs.cuda_ms(f if name == "index_select" else (lambda f=f: f(table, idx)), reps))
                bound, _ = cs.gather_bound(table, idx)
                row = dict(M=M, K=K, n=n, bound_ms=bound, **{k: float(np.mean(v)) for k, v in times.items()})
                rows.append(row)
                print(
                    f"M={M:>8} table ({n}, {K}): bound {bound:.4f} ms; "
                    + ", ".join(f"{k} {float(np.mean(v)):.4f}" for k, v in times.items()),
                    flush=True,
                )
            del table
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
