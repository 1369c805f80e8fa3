"""
Read the comparison's numbers over many seeds in one process: the
program's (the lower readings of each limit) and the control's, the plain
reference in the configuration's lower precision put in the program's place
(the upper readings).  The benchmark's own runs do not run the control.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --control-seeds 1,2,3 --seconds 3

Prints one JSON line a seed.  Needs the card, as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    import torch

    from portbench import faults
    from portbench.core.cell import run_cell
    from portbench.faults import planted

    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None, help="a fault of portbench/faults.py planted under the timed path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    t = T_START
    for seed in seeds + sorted(controls - set(seeds)):
        with contextlib.nullcontext() if args.fault is None else planted(getattr(faults, args.fault)):
            res = run_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0), t_start=t, control=seed in controls)
        line = {"seed": seed, "fault": args.fault, "correct": res["correct"], "numbers": res["numbers"], "control": res.get("control")}
        line["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
        print(json.dumps(line), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    build = ROOT / "build"
    os.environ["LKT_CACHE_DIR"] = str(build / "lkpy_tpu_torch")
    sys.path.insert(0, str(ROOT))
    sys.exit(main(sys.argv[1:]))
