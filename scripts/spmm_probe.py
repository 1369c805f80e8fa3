"""
Time and check the hand SpMM (``csrc/spmm.cu``) on the card at the LightGCN
cell's shapes.

    python3 scripts/spmm_probe.py [--ptxas] [--reps N] [--k 64,16]
        [--group 8,64] [--tile-seg 128,512] [--tile-bytes 65536,131072] [--wide 8,32]

Draws the graph of ``portbench/configs/lightgcn-ml20m.json`` on the card
(MovieLens 20M's counts, 20,000,263 edges, LightGCN's symmetric weights),
builds both orientations' plans (timed, with the device memory their build
holds at its peak) and, for each table width and direction, SU (user rows
from item rows) and SI (item rows from user rows, its wide rows from tiles
of user rows in shared memory), times in turns the kernel, the
plain version (``spmm_plain``, float32) and ``torch.sparse.mm`` of the same
CSR matrix as the yardstick (the port never calls it on the card), each by
CUDA events (``ms``, a call from the host) and the kernel also by the
profiler (``device_ms``: every kernel named ``spmm``, as the benchmark's
readers count them), beside the benchmark's bound
(``portbench/roofline/graph.py``).  The kernel's output is held against
``spmm_plain`` in float64.  ``--group`` times both with other rows a work item,
``--tile-seg``, ``--tile-bytes`` and ``--wide`` SI with other work items,
tiles and wide rows (the kernel alone past the first setting).  One JSON
line a (k, direction, setting) on standard output.  ``--ptxas`` first builds
the source with ``-Xptxas -v`` and prints each kernel's registers, spills
and shared memory.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.core.data import make_interactions  # noqa: E402
from portbench.roofline import graph as bounds  # noqa: E402

CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "lightgcn-ml20m.json"


def ptxas_report() -> None:
    from lkpy_tpu_torch.ops import _build

    out = Path("build/spmm_probe")
    out.mkdir(parents=True, exist_ok=True)
    src = Path(_build.__file__).resolve().parents[1] / "csrc" / "spmm.cu"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / "libspmm_probe.so"), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    name = None
    for line in proc.stdout.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)], stdout=subprocess.PIPE, text=True).stdout.strip()
        elif "registers" in line or "spill" in line:
            print(f"ptxas {name}: {line.strip()}")
    print(f"ptxas build exit {proc.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode:
        print(proc.stdout[-4000:])


def cell_conv(seed: int, dev):
    """The cell's graph as the 8-tuple of ``sorted_conv``, built on the card."""
    spec = json.loads(CONFIG.read_text())["data"]
    inter = make_interactions(spec, seed, dev)
    nu, ni = inter.n_users, inter.n_items
    deg_u = torch.bincount(inter.users, minlength=nu).clamp(min=1).float()
    deg_i = torch.bincount(inter.items, minlength=ni).clamp(min=1).float()
    vals = torch.rsqrt(deg_u[inter.users] * deg_i[inter.items])
    rows, cols = inter.users.int(), inter.items.int()
    order = torch.argsort(cols, stable=True)
    return (rows, cols, vals, nu, ni, rows[order], cols[order], vals[order])


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


def device_ms(fn, reps: int, match) -> tuple[float, dict]:
    """Device ms a call of the kernels whose names ``match`` accepts (the
    profiler's), and each such kernel's ms a call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and match(e.name):
            by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.device_time_total / 1e3 / reps
    return sum(by_name.values()), by_name


def _values(text: str, default) -> list:
    return [int(v) for v in text.split(",") if v.strip()] or [default]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=3141592653)
    ap.add_argument("--k", default="64,16")
    ap.add_argument("--tile-bytes", default="", help="SI: comma-separated bytes of source rows a tile")
    ap.add_argument("--wide", default="", help="SI: comma-separated edges a block that make a row wide")
    ap.add_argument("--tile-seg", default="", help="SI: comma-separated edges a work item of the tiled part")
    ap.add_argument("--group", default="", help="comma-separated rows a work item at most")
    args = ap.parse_args()
    from lkpy_tpu_torch.ops import graph

    dev = torch.device("cuda")
    limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], stdout=subprocess.PIPE, text=True).stdout.strip()
    print(f"device {limit}, torch {torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    if args.ptxas:
        ptxas_report()
    t0 = time.perf_counter()
    conv = cell_conv(args.seed, dev)
    torch.cuda.synchronize()
    print(f"graph: {conv[3]} users, {conv[4]} items, {conv[0].shape[0]} edges, drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    nnz, n_rows = conv[0].shape[0], conv[3] + conv[4]
    groups = _values(args.group, graph._GROUP_ROWS)
    settings = {"SU": [{"_GROUP_ROWS": g} for g in groups]}
    settings["SI"] = [
        {"_TILE_BYTES": t, "_WIDE_EDGES": w, "_TILE_SEG": ts, "_GROUP_ROWS": g}
        for g in groups
        for ts in _values(args.tile_seg, graph._TILE_SEG)
        for t in _values(args.tile_bytes, graph._TILE_BYTES)
        for w in _values(args.wide, graph._WIDE_EDGES)
    ]
    gen = torch.Generator(device=dev).manual_seed(7)
    for k in (int(v) for v in args.k.split(",")):
        tables = {side: torch.rand((n, k), generator=gen, device=dev) - 0.5 for side, n in (("users", conv[3]), ("items", conv[4]))}
        for name, side, x, src, dst, n_dst in (
            ("SU", 0, tables["items"], conv[1], conv[0], conv[3]),
            ("SI", 1, tables["users"], conv[0], conv[1], conv[4]),
        ):
            for n_set, setting in enumerate(settings[name]):
                for key, value in setting.items():
                    setattr(graph, key, value)
                graph._pairs.clear()
                op = graph._csr_pair(conv)[side]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                t = time.perf_counter()
                parts = op.plan(k)
                torch.cuda.synchronize()
                plan_s = time.perf_counter() - t
                plan_peak, plan_kept = torch.cuda.max_memory_allocated() - held, torch.cuda.memory_allocated() - held
                fns = {"kernel": lambda op=op, x=x: graph.spmm(op, x)}
                if n_set == 0:
                    csr = op.csr()
                    fns["plain"] = lambda x=x, src=src, dst=dst, n=n_dst: graph.spmm_plain(conv[2], src.long(), dst.long(), x, n)
                    fns["library"] = lambda csr=csr, x=x: torch.sparse.mm(csr, x)
                times = {f: [] for f in fns}
                for f in list(fns) + list(fns)[::-1]:
                    times[f].append(cuda_ms(fns[f], args.reps))
                dev_ms, kernels = device_ms(fns["kernel"], 5, lambda s: "spmm" in s.lower())
                got, hot_edges = graph.spmm(op, x)
                want = graph.spmm_plain(conv[2].double(), src.long(), dst.long(), x.double(), n_dst)
                err = float((got.double() - want).abs().max() / want.abs().max())
                lib_err = float((fns["library"]().double() - want).abs().max() / want.abs().max()) if "library" in fns else None
                del got, want
                mean = {f: sum(v) / len(v) for f, v in times.items()}
                bound_ms = 1e3 * bounds.spmm_bound_s(1, nnz, n_rows, k)
                rec = dict(
                    k=k, direction=name, **setting, ms=mean["kernel"], device_ms=dev_ms, kernels=kernels,
                    plain_ms=mean.get("plain"), library_ms=mean.get("library"), times=times, bound_ms=bound_ms,
                    roofline_pct=100 * bound_ms / dev_ms, f64_err=err, library_f64_err=lib_err,
                    hot_edges=hot_edges,
                    hot_share=hot_edges / nnz, parts=len(parts), part_edges=[p.src.shape[0] for p in parts],
                    wide_rows=parts[-1].red_rows.shape[0] if len(parts) > 1 else 0,
                    work_items=[p.work_slot.shape[0] for p in parts], scratch_rows=[p.n_slots for p in parts],
                    plan_s=plan_s, plan_peak_bytes=plan_peak, plan_kept_bytes=plan_kept, edges=nnz,
                )  # fmt: skip
                print(json.dumps(rec), flush=True)
                if err > 1e-5:
                    raise AssertionError(f"{name} at k={k}, {setting}: float64 error {err}")
        del tables
        torch.cuda.empty_cache()
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
