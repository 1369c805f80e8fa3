"""The command line of ``run.py``: checks the card, runs the cell, guards
against JAX and prints the result."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from portbench.core.cell import load_benchmark, run_cell

__all__ = ["BANNED", "banned_modules", "main", "result_line"]

#: top-level module names that no run may load: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "lkpy_tpu")


def banned_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of :data:`BANNED`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in BANNED)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, timeout=60
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_line(res: dict, device: dict) -> str:
    """The result's JSON line: its fixed keys, then ``check``, the numbers compared, last."""
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"], "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["check"] = {k: {"value": v, "limit": res["limits"][k]} for k, v in res["numbers"].items()}
    return json.dumps(line)


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_benchmark()
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {wl['chips']} CUDA device(s); {n} available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), dev, t_start=t_start)

    found = banned_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": wl["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device.update(res["trace"])
    print("setup parts (s): " + json.dumps(res["setup"]))
    print("data: " + json.dumps(res["data"]))
    print("window host: " + json.dumps(res["host"]))
    print(f"card: {card_line()}")
    for k, v in res["numbers"].items():
        print(f"check {k} {v!r} limit {res['limits'][k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(res, device), flush=True)
    return 0
