"""
Time and check the gather-and-Gram kernel (``csrc/gather_gram.cu``) on the
card, per route, at the port's own shapes.

    python3 scripts/gram_probe.py [--ptxas] [--reps N] [--tag NAME]

For each shape (the training cell's user chunk, split user bucket and
widest item chunk, a serving block, a per-query fold-in, and the largest
chunk at k = 128 and 256) it launches the tensor route (copy width 4) and
the FMA route (copy width 2 forced on the same aligned table), holds each
against float64 sums and the plain version as ``tests/test_torch_cuda.py``
does, and times both in turns with CUDA events (``ms``: a launch from the host,
its cost included) and with the profiler (``device_ms``: the kernel's own
time, from which the roofline share is taken), beside the bound of
``portbench/roofline/counts.py``.  One JSON line a (shape, route), also
written to ``chiprun_out/gram_probe_<tag>.jsonl``.  ``--ptxas`` first builds
the source with ``-Xptxas -v`` and prints each kernel's registers, spills
and shared memory.  Where the importable ``lkpy_tpu_torch`` has no copy
width argument (an older checkout on ``PYTHONPATH``), only its one route is
timed, as ``route: "only"``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.roofline import counts  # noqa: E402

#: (label, B, P, k, table rows, index dtype, shortest real length)
SHAPES = [
    ("user chunk", 25_896, 48, 64, 26_744, np.int32, 36),
    ("split user bucket", 1_312, 1_072, 64, 26_744, np.int32, 795),
    ("widest item chunk", 40, 79_120, 64, 138_493, np.int32, 58_609),
    ("serving block", 1_024, 256, 64, 26_744, np.int64, 20),
    ("runner", 1, 103, 64, 26_744, np.int32, 103),
    ("largest chunk k=128", 29_936, 120, 128, 26_744, np.int32, 89),
    ("largest chunk k=256", 29_936, 120, 256, 26_744, np.int32, 89),
]


def ptxas_report() -> None:
    from lkpy_tpu_torch.ops import _build

    out = Path("build/gram_probe")
    out.mkdir(parents=True, exist_ok=True)
    src = Path(_build.__file__).resolve().parents[1] / "csrc" / "gather_gram.cu"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / "libgg_probe.so"), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    name = None
    for line in proc.stdout.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)], stdout=subprocess.PIPE, text=True).stdout.strip()
        elif "registers" in line or "spill" in line:
            print(f"ptxas {name}: {line.strip()}")
    print(f"ptxas build exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")


def inputs(rng, B, P, k, n, index_dtype, shortest, dev):
    table = torch.from_numpy((0.1 * rng.standard_normal((n, k))).astype(np.float32)).to(dev)
    cols = torch.from_numpy(rng.integers(0, n, (B, P)).astype(index_dtype)).to(dev)
    vals = torch.full((B, P), 40.0, dtype=torch.float32, device=dev)
    lens = rng.integers(shortest, P + 1, B)
    mask = torch.from_numpy(np.arange(P)[None, :] < lens[:, None]).to(dev)
    X = table[:4096]
    otor = X.T @ X + 0.1 * torch.eye(k, device=dev)
    return cols, vals, mask, table, otor


def gate(A, y, A2, y2, cols, vals, mask, right, otor) -> dict:
    """``tests/test_torch_cuda.py::_assert_gram_agrees``'s readings, in row
    blocks so that the float64 sums fit."""
    from lkpy_tpu_torch.ops.gather_gram import gather_gram_plain

    k = right.shape[1]
    li = torch.tril_indices(k, k, device=right.device)
    equal = bool(torch.equal(A[:, li[0], li[1]], A2[:, li[0], li[1]]) and torch.equal(y, y2))
    step = max(1, int(2e8 // (cols.shape[1] * k)))
    got, plain, want = [], [], []
    for lo in range(0, cols.shape[0], step):
        sl = slice(lo, lo + step)
        Ap, yp = gather_gram_plain(cols[sl], vals[sl], mask[sl], right, otor=otor)
        G = right.double()[cols[sl].long()]
        m = mask[sl].double()
        A64 = torch.bmm((G * (vals[sl].double() * m)[:, :, None]).transpose(1, 2), G)[:, li[0], li[1]]
        A64 += otor.double()[li[0], li[1]]
        y64 = torch.bmm(G.transpose(1, 2), ((vals[sl].double() + 1) * m)[:, :, None])[:, :, 0]
        got.append((A[sl, li[0], li[1]], y[sl]))
        plain.append((Ap[:, li[0], li[1]], yp))
        want.append((A64, y64))
    out = {"equal_launches": equal}
    for i, name in enumerate(("A", "y")):
        g = torch.cat([x[i] for x in got])
        p = torch.cat([x[i] for x in plain])
        w = torch.cat([x[i] for x in want])
        top = max(float(w.abs().max()), 1e-30)
        share = max(1e-6, float((p.double() - w).abs().max()) / top)
        out[f"{name}_f64"] = float((g.double() - w).abs().max()) / top
        out[f"{name}_plain_f64"] = float((p.double() - w).abs().max()) / top
        out[f"{name}_over"] = float(((g - p).abs() / (1e-5 * p.abs() + share * top)).max())
    out["passes"] = equal and max(out["A_f64"], out["y_f64"]) <= 1e-5 and max(out["A_over"], out["y_over"]) <= 1
    return out


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """The kernel's own device time a launch (the profiler's, as the
    benchmark's roofline reads it): free of the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total for e in prof.events() if "gather_gram" in e.name and str(e.device_type).endswith("CUDA")]
    return sum(us) / max(len(us), 1) / 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--only", default="", help="comma-separated shape labels")
    args = ap.parse_args()
    from lkpy_tpu_torch.ops import gather_gram as gg

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"], stdout=subprocess.PIPE, text=True
    ).stdout.strip()
    print(f"device {name}, power limit {limit}, torch {torch.__version__}, module {gg.__file__}")
    if args.ptxas:
        ptxas_report()
    has_width = "width" in inspect.signature(gg._launch).parameters
    out = Path("chiprun_out") / f"gram_probe_{args.tag}.jsonl"
    out.parent.mkdir(exist_ok=True)
    rng = np.random.default_rng(2026)
    wanted = {s.strip() for s in args.only.split(",") if s.strip()}
    with out.open("w") as fh:
        for label, B, P, k, n, idx, shortest in SHAPES:
            if wanted and label not in wanted:
                continue
            cols, vals, mask, right, otor = inputs(rng, B, P, k, n, idx, shortest, dev)
            routes = {"tensor": 4, "fma": 2} if has_width else {"only": None}
            fns = {
                r: (lambda w=w: gg._launch(cols, vals, mask, right, otor, None, width=w)) if has_width
                else (lambda: gg._launch(cols, vals, mask, right, otor, None))
                for r, w in routes.items()
            }  # fmt: skip
            real = int(mask.sum())
            bound_ms = 1e3 * counts.bound_s(counts.gram_ops(real, k), counts.gram_bytes(real, B, k))
            S, L, _, _ = gg.launch_plan(B, P, k)
            times = {r: [] for r in routes}
            order = list(routes) + list(routes)[::-1]
            for r in order:
                times[r].append(cuda_ms(fns[r], args.reps if B * P > 1000 else 10 * args.reps))
            for r in routes:
                dev_ms = device_ms(fns[r], 5)
                before_tc = getattr(gg.gather_gram, "launches_tc", 0)
                A, y = fns[r]()
                A2, y2 = fns[r]()
                torch.cuda.synchronize()
                tc = getattr(gg.gather_gram, "launches_tc", 0) - before_tc
                rec = dict(
                    label=label, B=B, P=P, k=k, index=np.dtype(idx).name, real=real, S=S, L=L, route=r,
                    tc_launches_of_2=tc, ms=float(np.mean(times[r])), times=times[r], device_ms=dev_ms, bound_ms=bound_ms,
                    roofline_pct=100 * bound_ms / dev_ms, entries_per_s=real / dev_ms * 1e3,
                    **gate(A, y, A2, y2, cols, vals, mask, right, otor),
                )  # fmt: skip
                del A, y, A2, y2
                line = json.dumps(rec)
                print(line, flush=True)
                fh.write(line + "\n")
            del cols, vals, mask, right, otor
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
